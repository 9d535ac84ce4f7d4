"""Placement of the Llama parameters over a mesh (counterpart of
``LLAMA_PARAM_SPECS``, ``param_shardings``, ``opt_state_shardings`` and
``batch_sharding`` in ``skypilot_tpu/parallel/sharding.py``).

Tensor parallelism: each leaf has a :class:`Rule`, how it splits over
``tp`` and along which axis of the stacked leaf.

- ``column``: the output axis splits (``wq``/``wk``/``wv`` over heads,
  ``w_gate``/``w_up`` over the ffn, ``lm_head`` over the vocabulary);
  the rank's product is its slice of the output.
- ``row``: the contraction axis splits (``wo``, ``w_down``); the rank's
  product is a partial sum, all-reduced.
- ``vocab``: the embedding's rows split; a token outside the rank's rows
  gathers zeros, all-reduced.
- norms are replicated (no rule).

An int8 leaf (``ops/quant.py`` ``QuantArray``) shards its ``q`` like the
weight; its ``scale`` dropped the contraction axis, so it splits with a
column weight, is replicated with a row weight (a per-column scale covers
the whole contraction axis: quantize before slicing, never per shard),
and splits by row with the embedding. :func:`shard_params` slices a host
tree for one rank; the slices are copies, so the whole leaf can be freed.

Training (ZeRO-3 x Megatron): :func:`train_spec` gives each leaf the axis
split over ``fsdp`` (:data:`FSDP_AXES`, the model dimension) and the axis
split over ``tp`` (the serving rule's axis: the two agree). Optimizer
moments shard like their parameter; :func:`shard_train_tree` slices a
whole tree for one rank, :func:`gather_to_first` puts the whole tree back
together on rank 0, a piece at a time.
The batch's rows split over ``dp`` x ``fsdp`` jointly, dp-major, the same
on every ``tp`` rank of one (dp, fsdp) (:func:`batch_rows`).
:class:`RankOps` is what a rank's forward calls: each layer gathers its
``fsdp`` shards, enters and leaves ``tp`` through Megatron's collectives,
and gathers the whole ``lm_head``. :func:`reduce_grad` and
:func:`global_norm` finish the gradients.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from skypilot_tpu_torch.ops import quant as quant_lib
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel.mesh import TrainMesh


class Rule(NamedTuple):
    kind: str    # 'column' | 'row' | 'vocab'
    axis: int    # the split axis of the (stacked) weight


# The reference's LLAMA_PARAM_SPECS with its fsdp axis dropped: the axis
# that names 'tp' there is the split axis here.
TP_RULES: Dict[str, object] = {
    'embed': Rule('vocab', 0),               # P('tp', 'fsdp')
    'layers': {
        'attn_norm': None,
        'wq': Rule('column', 2),             # P(None, 'fsdp', 'tp')
        'wk': Rule('column', 2),
        'wv': Rule('column', 2),
        'wo': Rule('row', 1),                # P(None, 'tp', 'fsdp')
        'mlp_norm': None,
        'w_gate': Rule('column', 2),
        'w_up': Rule('column', 2),
        'w_down': Rule('row', 1),
    },
    'final_norm': None,
    'lm_head': Rule('column', 1),            # P('fsdp', 'tp')
}


def rule(path: Tuple[str, ...]) -> Optional[Rule]:
    """The rule of the leaf at ``path`` (``('layers', 'wq')``), None for a
    replicated one."""
    node = TP_RULES
    for key in path:
        node = node[key]
    return node


def check_divisible(config, tp: int, fsdp: int = 1) -> None:
    """The reference engine's checks: ``tp`` divides the heads, the KV
    heads, the ffn and the vocabulary; and ``fsdp`` divides the model
    dimension, the axis it splits."""
    for name in ('n_heads', 'n_kv_heads', 'ffn_dim', 'vocab_size'):
        dim = getattr(config, name)
        if dim % tp:
            raise ValueError(f'tp={tp} must divide {name}={dim}')
    if config.dim % fsdp:
        raise ValueError(f'fsdp={fsdp} must divide dim={config.dim}')


def _split(t: torch.Tensor, axis: int, rank: int, tp: int) -> torch.Tensor:
    n = t.shape[axis] // tp
    return t.narrow(axis, rank * n, n).contiguous().clone()


def scale_axis(r: Rule) -> Optional[int]:
    """The split axis of an int8 leaf's scale under ``r``: the weight's
    output axis for a column weight (the scale's last), none for a row
    weight, the rows for the embedding."""
    if r.kind == 'row':
        return None
    return 0 if r.kind == 'vocab' else -1


def shard_leaf(path: Tuple[str, ...], leaf, rank: int, tp: int):
    """Rank ``rank``'s slice of the leaf at ``path`` (a tensor or a
    ``QuantArray``); a replicated leaf comes back as it is."""
    r = rule(path)
    if r is None or tp == 1:
        return leaf
    if isinstance(leaf, quant_lib.QuantArray):
        axis = scale_axis(r)
        return quant_lib.QuantArray(
            q=_split(leaf.q, r.axis, rank, tp),
            scale=(leaf.scale if axis is None
                   else _split(leaf.scale, axis, rank, tp)))
    return _split(leaf, r.axis, rank, tp)


def map_tree(fn, params, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a Llama param tree (a ``QuantArray`` is one
    leaf)."""
    if isinstance(params, dict):
        return {k: map_tree(fn, v, path + (k,)) for k, v in params.items()}
    return fn(path, params)


def tree_leaves(params) -> Dict[Tuple[str, ...], object]:
    """``{path: leaf}`` over a param tree, in :func:`map_tree`'s order;
    ``map_tree(lambda path, _: flat[path], params)`` nests such a dict
    again."""
    flat: Dict[Tuple[str, ...], object] = {}
    map_tree(flat.__setitem__, params)
    return flat


def shard_params(params, rank: int, tp: int):
    """Rank ``rank``'s slices of a whole param tree, bf16 or int8."""
    return map_tree(lambda path, leaf: shard_leaf(path, leaf, rank, tp),
                    params)


def is_whole(params, config) -> bool:
    """Whether ``params`` is an unsharded tree of ``config`` (its
    embedding holds every vocabulary row)."""
    return params['embed'].shape[0] == config.vocab_size


# ---------------------------------------------------------------------------
# Training: ZeRO-3 over fsdp composed with Megatron over tp
# ---------------------------------------------------------------------------
# The reference's LLAMA_PARAM_SPECS, the axis named 'fsdp' there (the
# model dimension of each weight); norms are replicated.
FSDP_AXES: Dict[str, object] = {
    'embed': 1,                                  # P('tp', 'fsdp')
    'layers': {
        'attn_norm': None,                       # P(None, None)
        'wq': 1, 'wk': 1, 'wv': 1,               # P(None, 'fsdp', 'tp')
        'wo': 2,                                 # P(None, 'tp', 'fsdp')
        'mlp_norm': None,
        'w_gate': 1, 'w_up': 1,
        'w_down': 2,
    },
    'final_norm': None,                          # P(None)
    'lm_head': 0,                                # P('fsdp', 'tp')
}


class Spec(NamedTuple):
    fsdp: Optional[int]    # the axis split over fsdp, None: replicated
    tp: Optional[int]      # the axis split over tp, None: replicated


def train_spec(path: Tuple[str, ...]) -> Spec:
    """The leaf at ``path``'s axes over ``fsdp`` and ``tp``."""
    node = FSDP_AXES
    for key in path:
        node = node[key]
    r = rule(path)
    return Spec(node, None if r is None else r.axis)


def _block(t: torch.Tensor, axis: Optional[int], i: int,
           n: int) -> torch.Tensor:
    if axis is None or n == 1:
        return t
    size = t.shape[axis] // n
    return t.narrow(axis, i * size, size)


def shard_for(path: Tuple[str, ...], leaf: torch.Tensor,
              mesh: TrainMesh) -> torch.Tensor:
    """This rank's block of a whole leaf (a parameter or one of its
    moments): its fsdp block of the fsdp axis and its tp block of the tp
    axis, as a copy (the whole leaf can be freed)."""
    spec = train_spec(path)
    _, f, t = mesh.coords
    out = _block(_block(leaf, spec.fsdp, f, mesh.shape.fsdp), spec.tp, t,
                 mesh.shape.tp)
    return out.contiguous().clone() if out is not leaf else leaf


def shard_train_tree(tree, mesh: TrainMesh):
    """This rank's blocks of a whole param-shaped tree."""
    return map_tree(lambda path, leaf: shard_for(path, leaf, mesh), tree)


# A mesh gather's piece: at most this many bytes of one rank's block
# (whole rows of the block's axis 0, one row at least) cross to rank 0 at
# a time.
PIECE_BYTES = 64 << 20


def _whole_shape(path: Tuple[str, ...], block: torch.Tensor,
                mesh: TrainMesh) -> Tuple[int, ...]:
    """The whole leaf's shape from one rank's block of it."""
    spec = train_spec(path)
    shape = list(block.shape)
    for axis, n in ((spec.fsdp, mesh.shape.fsdp), (spec.tp, mesh.shape.tp)):
        if axis is not None:
            shape[axis] *= n
    return tuple(shape)


def _block_index(path: Tuple[str, ...], shape: Tuple[int, ...],
                coords: Tuple[int, int, int],
                mesh_shape) -> Tuple[slice, ...]:
    """Where the block of the rank at ``coords`` (dp, fsdp, tp) lies in the
    whole leaf of ``shape``: its fsdp block, then its tp block of that, as
    :func:`shard_for` cuts."""
    spec = train_spec(path)
    start, size = [0] * len(shape), list(shape)
    _, f, t = coords
    for axis, i, n in ((spec.fsdp, f, mesh_shape.fsdp),
                       (spec.tp, t, mesh_shape.tp)):
        if axis is not None and n > 1:
            size[axis] //= n
            start[axis] += i * size[axis]
    return tuple(slice(a, a + n) for a, n in zip(start, size))


def _holders(path: Tuple[str, ...], mesh: TrainMesh) -> List[int]:
    """The ranks, in rank order, that hold the leaf's distinct blocks:
    those at dp 0, one for each block of the axes its spec splits (fsdp 0
    or tp 0 where the leaf is replicated along that axis)."""
    spec = train_spec(path)
    s = mesh.shape
    return [s.rank_of(0, f, t)
            for f in range(s.fsdp if spec.fsdp is not None else 1)
            for t in range(s.tp if spec.tp is not None else 1)]


def gather_to_first(tree, mesh: TrainMesh, alloc: Callable):
    """The whole param-shaped tree from every rank's blocks, on rank 0's
    host; None on the other ranks. A collective: every rank calls it.

    Each distinct block (:func:`_holders`; the dp replicas send nothing)
    crosses to rank 0 over the mesh's ``gloo`` host group in pieces of at
    most :data:`PIECE_BYTES` (whole rows of its axis 0, one row at least),
    and rank 0 copies each piece into its place in the whole leaf as it
    arrives. So no rank allocates more than one piece beyond its own
    blocks, and rank 0 takes each whole leaf from ``alloc(shape, dtype)``
    (``checkpoint.save_mesh`` gives file-backed tensors, so a large state
    is not held in host memory)."""
    lead = mesh.rank == 0

    def leaf(path, block):
        shape = _whole_shape(path, block, mesh)
        whole = alloc(shape, block.dtype) if lead else None
        senders = _holders(path, mesh)
        if not lead and mesh.rank not in senders:
            return None
        rows = block.shape[0] if block.dim() else 1
        row_bytes = block[0].nbytes if block.dim() else block.nbytes
        per = max(1, PIECE_BYTES // max(1, row_bytes))
        for r0 in range(0, rows, per):
            n = min(per, rows - r0)
            for src in senders:
                if src == mesh.rank:
                    piece = (block.narrow(0, r0, n) if block.dim()
                             else block).contiguous().cpu()
                    if not lead:
                        dist.send(piece, dst=0, group=mesh.host_pg)
                        continue
                elif lead:
                    piece = torch.empty((n, *block.shape[1:]) if block.dim()
                                        else (), dtype=block.dtype)
                    dist.recv(piece, src=src, group=mesh.host_pg)
                else:
                    continue
                index = list(_block_index(path, shape,
                                         mesh.shape.coords(src), mesh.shape))
                if block.dim():
                    first = index[0].start + r0
                    index[0] = slice(first, first + n)
                whole[tuple(index)].copy_(piece)
        return whole

    out = map_tree(leaf, tree)
    return out if lead else None


def batch_rows(batch: Dict[str, torch.Tensor],
               mesh: TrainMesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch: rows split over dp x fsdp
    jointly, dp-major (``BATCH_SPEC = P(('dp', 'fsdp'), None)``)."""
    n = mesh.shape.dp * mesh.shape.fsdp
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f'batch of {v.shape[0]} rows does not split '
                             f'over dp x fsdp = {n}')
        out[k] = _block(v, 0, mesh.data_index(), n)
    return out


class RankOps:
    """The collectives a mesh rank's forward calls (``models/llama.py``
    takes this as ``shard``): each layer's weights gathered over fsdp,
    Megatron's copy into and reduction from tp, the vocab-parallel
    embedding's rank and the whole ``lm_head`` for the loss; and the data
    axes' sums that make the loss the global mean.

    ``spec(path)`` gives each leaf's split axes (``.fsdp``, ``.tp``;
    :func:`train_spec` for Llama) and ``data`` names the mesh's group of
    the batch's axes (``'data'``: dp x fsdp), so ``models/moe.py`` runs
    its ``('fsdp', 'tp', 'ep')`` mesh through the same collectives."""

    def __init__(self, mesh, spec: Callable = train_spec,
                 data: str = 'data'):
        self.mesh = mesh
        self.spec = spec
        tp = mesh.group('tp')
        self.tp, self.tp_rank = tp.world, tp.rank
        self.data = mesh.group(data)
        self.data_world = self.data.world

    def gather(self, path: Tuple[str, ...],
               shard: torch.Tensor) -> torch.Tensor:
        """The leaf's fsdp shards put together (its tp block stays); the
        gradient is reduce-scattered back over fsdp. A ``('layers', k)``
        path takes one layer's slice of the stacked leaf."""
        axis = self.spec(path).fsdp
        if axis is None:
            return shard
        if path[0] == 'layers':
            axis -= 1
        return collectives.gather_shards(shard, self.mesh.group('fsdp'),
                                         axis)

    def copy_tp(self, x: torch.Tensor) -> torch.Tensor:
        return collectives.copy_to(x, self.mesh.group('tp'))

    def reduce_tp(self, x: torch.Tensor) -> torch.Tensor:
        return collectives.reduce_from(x, self.mesh.group('tp'))

    def whole_head(self, shard: torch.Tensor) -> torch.Tensor:
        """The whole ``lm_head``: gathered over fsdp, then over tp for a
        loss that every tp rank computes whole (the reference's XLA
        cannot partition the loss's Pallas call either)."""
        x = self.gather(('lm_head',), shard)
        return collectives.gather_replicated(x, self.mesh.group('tp'),
                                             self.spec(('lm_head',)).tp)

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the data axes of a tensor without gradient."""
        return collectives.all_reduce_sum(x.detach().clone(), self.data)


def reduce_grad(path: Tuple[str, ...], g: torch.Tensor,
                mesh: TrainMesh) -> torch.Tensor:
    """Finish a rank's gradient of its block of the leaf at ``path``: an
    fsdp-split leaf's gradient was reduce-scattered over fsdp by its
    gather's backward, so it is summed over dp; any other leaf's is summed
    over dp x fsdp. tp needs nothing: Megatron's collectives already gave
    each tp rank its block's whole gradient. The block comes back
    contiguous, as the optimizer's kernel takes it (the reduce-scatter
    leaves the embedding's, split on its axis 1, transposed)."""
    axis = 'dp' if train_spec(path).fsdp is not None else 'data'
    return collectives.all_reduce_sum(g.contiguous(), mesh.group(axis))


def global_norm(paths: List[Tuple[str, ...]], grads: List[torch.Tensor],
                mesh: TrainMesh) -> torch.Tensor:
    """optax's ``global_norm`` of the whole gradient from the ranks'
    blocks: each element counted once. A leaf's sum of squares adds over
    the axes that split it (fsdp, tp) and not over its replicas."""
    f32 = torch.float32
    # [fsdp and tp, fsdp only, tp only, neither]
    parts = torch.zeros(4, dtype=f32, device=grads[0].device)
    for path, g in zip(paths, grads):
        spec = train_spec(path)
        split_f = spec.fsdp is not None and mesh.shape.fsdp > 1
        split_t = spec.tp is not None and mesh.shape.tp > 1
        parts[(0 if split_t else 1) if split_f else (2 if split_t else 3)] \
            += torch.sum(g.float() * g.float())
    head = parts[:2].clone()
    parts[:2] = collectives.all_reduce_sum(head, mesh.group('fsdp'))
    both_t = parts[0::2].clone()
    parts[0::2] = collectives.all_reduce_sum(both_t, mesh.group('tp'))
    return torch.sqrt(parts.sum())
