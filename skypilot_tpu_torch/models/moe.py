"""Mixture-of-Experts transformer, Mixtral-style, with expert parallelism
(counterpart of ``skypilot_tpu/models/moe.py``).

- GShard fixed-capacity routing (:func:`_route`): the router in fp32,
  top-k gates renormalised, each (token, choice) placed in its expert's
  ``[capacity]`` buffer by a token-major cumsum, overflow dropped; dense
  dispatch and combine tensors ``[T, E, C]``, and the experts as batched
  products over ``[E, C, d]``.
- Attention, norms and RoPE are ``models/llama.py``'s (the same
  ``attention_block``); only the MLP is the routed expert MLP.
- The Switch load-balance loss and the router z-loss come back apart so
  the caller weights them (:func:`loss_fn`).

On a mesh rank (``shard``, a :class:`MeshOps` over the ``('fsdp', 'tp',
'ep')`` layout of ``parallel/mesh.py``) the batch's rows split over the
data axes ``fsdp`` x ``ep`` and each leaf over the axes of
:data:`PARAM_SPECS`: the experts over ``ep``, the expert hidden dim over
``tp`` (``w_gate``/``w_up`` by column, ``w_down`` by row, summed over
``tp``), the model dim over ``fsdp`` (gathered a layer at a time, as
``sharding.RankOps`` does for Llama), the attention block as the Llama
mesh's. The semantics stay the unsharded batch's: capacity, slot
positions and drops are those of the global token-major order (a rank
offsets its cumsum by the earlier ranks' counts per expert), so a slot
belongs to one rank's token, and the ``[E, C, d]`` buffers of the ``ep``
group reduce-scatter along E exactly onto the experts' ranks; the
experts' outputs all-gather back and each rank combines its own tokens.
The aux losses are global means (sums reduced over the data axes).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import norms
from skypilot_tpu_torch.ops import rope as rope_lib
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.parallel.mesh import AxesMesh, TPGroup, group_name

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32_000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14_336          # per-expert hidden dim
    n_experts: int = 8
    experts_per_token: int = 2     # top-k routing
    capacity_factor: float = 1.25  # expert capacity vs perfect balance
    max_seq_len: int = 8192
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: str = 'bfloat16'
    attention_impl: str = 'auto'
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def num_params(self) -> int:
        d, f, v = self.dim, self.ffn_dim, self.vocab_size
        per_layer = (d * self.n_heads * self.head_dim
                     + 2 * d * self.n_kv_heads * self.head_dim
                     + self.n_heads * self.head_dim * d
                     + self.n_experts * 3 * d * f
                     + d * self.n_experts      # router
                     + 2 * d)
        return self.n_layers * per_layer + 2 * v * d + d

    @staticmethod
    def mixtral_8x7b(**kw) -> 'MoEConfig':
        return MoEConfig(**kw)

    @staticmethod
    def tiny(**kw) -> 'MoEConfig':
        base = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                    n_kv_heads=2, ffn_dim=96, n_experts=4,
                    experts_per_token=2, max_seq_len=128,
                    dtype='float32')
        base.update(kw)
        return MoEConfig(**base)

    def as_llama(self) -> llama.LlamaConfig:
        """Attention-relevant view for reusing llama layer pieces."""
        return llama.LlamaConfig(
            vocab_size=self.vocab_size, dim=self.dim,
            n_layers=self.n_layers, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, ffn_dim=self.ffn_dim,
            max_seq_len=self.max_seq_len, rope_theta=self.rope_theta,
            norm_eps=self.norm_eps, dtype=self.dtype,
            attention_impl=self.attention_impl, remat=self.remat)


# Tree skeleton for sharding specs (see llama.LLAMA_LAYER_TREE).
MOE_LAYER_TREE: Dict[str, int] = {
    'attn_norm': 0, 'wq': 0, 'wk': 0, 'wv': 0, 'wo': 0,
    'mlp_norm': 0, 'router': 0, 'w_gate': 0, 'w_up': 0, 'w_down': 0,
}


def init_params(config: MoEConfig, generator: Optional[torch.Generator],
                device='cpu') -> Params:
    """Scaled-normal init with the reference's shapes and scales (the
    router in fp32), drawn from ``generator`` on ``device`` one layer at a
    time, as ``llama.init_params``. Tests that compare with JAX carry the
    reference's own draws across with ``llama.params_from_jax``."""
    dtype = llama.torch_dtype(config.dtype)
    d, hd, f = config.dim, config.head_dim, config.ffn_dim
    L, E = config.n_layers, config.n_experts

    def normal(shape, scale, stacked=True, out_dtype=dtype):
        out = torch.empty(shape, dtype=out_dtype, device=device)
        for i in range(shape[0] if stacked else 1):
            part = out[i] if stacked else out
            part.copy_(torch.randn(part.shape, generator=generator,
                                   dtype=torch.float32, device=device)
                       * scale)
        return out

    scale = d ** -0.5
    out_scale = scale / (2 * L) ** 0.5
    layers = {
        'attn_norm': torch.ones((L, d), dtype=dtype, device=device),
        'wq': normal((L, d, config.n_heads * hd), scale),
        'wk': normal((L, d, config.n_kv_heads * hd), scale),
        'wv': normal((L, d, config.n_kv_heads * hd), scale),
        'wo': normal((L, config.n_heads * hd, d), out_scale),
        'mlp_norm': torch.ones((L, d), dtype=dtype, device=device),
        # Router in fp32: routing logits are precision-sensitive.
        'router': normal((L, d, E), scale, out_dtype=torch.float32),
        'w_gate': normal((L, E, d, f), scale),
        'w_up': normal((L, E, d, f), scale),
        'w_down': normal((L, E, f, d), out_scale),
    }
    return {
        'embed': normal((config.vocab_size, d), 1.0, stacked=False),
        'layers': layers,
        'final_norm': torch.ones((d,), dtype=dtype, device=device),
        'lm_head': normal((d, config.vocab_size), scale, stacked=False),
    }


# ---------------------------------------------------------------------------
# Placement over ('fsdp', 'tp', 'ep')
# ---------------------------------------------------------------------------
class Spec(NamedTuple):
    """The axis of a (stacked) leaf split over each mesh axis; None:
    replicated along it."""
    fsdp: Optional[int]
    tp: Optional[int]
    ep: Optional[int]


_REPLICATED = Spec(None, None, None)
# The reference's param_specs() with its leading (layer) axis counted.
PARAM_SPECS: Dict[str, Any] = {
    'embed': Spec(1, 0, None),                    # P('tp', 'fsdp')
    'layers': {
        'attn_norm': _REPLICATED,                 # P(None, None)
        'wq': Spec(1, 2, None),                   # P(None, 'fsdp', 'tp')
        'wk': Spec(1, 2, None),
        'wv': Spec(1, 2, None),
        'wo': Spec(2, 1, None),                   # P(None, 'tp', 'fsdp')
        'mlp_norm': _REPLICATED,
        'router': Spec(1, None, None),            # P(None, 'fsdp', None)
        'w_gate': Spec(2, 3, 1),                  # P(None, 'ep', 'fsdp', 'tp')
        'w_up': Spec(2, 3, 1),
        'w_down': Spec(3, 2, 1),                  # P(None, 'ep', 'tp', 'fsdp')
    },
    'final_norm': _REPLICATED,                    # P(None)
    'lm_head': Spec(0, 1, None),                  # P('fsdp', 'tp')
}


def param_specs() -> Dict[str, Any]:
    """Each leaf's :class:`Spec`: experts over ``ep``, Megatron ``tp`` on
    the expert hidden dim (and the attention heads), ``fsdp`` on the
    model dims."""
    return PARAM_SPECS


def leaf_spec(path: Tuple[str, ...]) -> Spec:
    """The :class:`Spec` of the leaf at ``path`` (``('layers', 'wq')``)."""
    node = PARAM_SPECS
    for key in path:
        node = node[key]
    return node


def shard_for(path: Tuple[str, ...], leaf: torch.Tensor,
              mesh: AxesMesh) -> torch.Tensor:
    """This rank's block of a whole leaf along each axis its spec splits
    (a copy)."""
    spec = leaf_spec(path)
    out = leaf
    for axis in ('fsdp', 'tp', 'ep'):
        out = sharding._block(out, getattr(spec, axis), mesh.coord(axis),
                              mesh.group(axis).world)
    return out.contiguous().clone()


def shard_params(params: Params, mesh: AxesMesh) -> Params:
    """This rank's blocks of a whole tree."""
    return sharding.map_tree(lambda path, leaf: shard_for(path, leaf, mesh),
                             params)


def check_divisible(config: MoEConfig, mesh: AxesMesh) -> None:
    """Each split axis divides by its mesh axis."""
    for name, axis in (('n_heads', 'tp'), ('n_kv_heads', 'tp'),
                       ('ffn_dim', 'tp'), ('vocab_size', 'tp'),
                       ('dim', 'fsdp'), ('n_experts', 'ep')):
        n = mesh.group(axis).world
        if getattr(config, name) % n:
            raise ValueError(f'{axis}={n} must divide '
                             f'{name}={getattr(config, name)}')


class MeshOps(sharding.RankOps):
    """The collectives a rank of the ``('fsdp', 'tp', 'ep')`` mesh calls:
    ``sharding.RankOps``' over :data:`PARAM_SPECS` (fsdp gathers,
    Megatron's tp, the whole head), with the data axes ``fsdp`` x ``ep``
    (``data``: the batch's rows, for the global routing order and means)
    and ``ep``, the expert exchange's group."""

    def __init__(self, mesh: AxesMesh):
        super().__init__(mesh, leaf_spec, group_name(('fsdp', 'ep')))
        self.ep = mesh.group('ep')


def reduce_grads(grads: Params, mesh: AxesMesh) -> Params:
    """A rank's gradients of the global loss from its own: a leaf that
    ``fsdp`` splits had its gradient reduce-scattered over ``fsdp`` by its
    gather's backward, any other is summed over ``fsdp``; a leaf that
    ``ep`` does not split (all but the experts) is summed over ``ep``, the
    other data axis. ``tp`` needs nothing (Megatron's collectives)."""
    def finish(path, g):
        spec = leaf_spec(path)
        if spec.fsdp is None:
            g = collectives.all_reduce_sum(g, mesh.group('fsdp'))
        if spec.ep is None:
            g = collectives.all_reduce_sum(g, mesh.group('ep'))
        return g
    return sharding.map_tree(finish, grads)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
def _route(config: MoEConfig, h: torch.Tensor, router_w: torch.Tensor,
           capacity: int, data: Optional[TPGroup] = None
           ) -> Tuple[torch.Tensor, torch.Tensor,
                      Tuple[torch.Tensor, torch.Tensor]]:
    """Top-k routing with fixed capacity.

    h: [T, d] tokens. Returns (dispatch [T, E, C] one-hot, combine [T, E,
    C] gate-weighted, (load-balance loss, z-loss)). Tokens overflowing an
    expert's capacity are dropped for that expert (Switch/GShard
    semantics). With ``data`` (the ranks holding the batch's rows in
    order, this rank's tokens contiguous in the global token-major order)
    the positions count every earlier rank's choices first and the aux
    losses are global means."""
    T = h.shape[0]
    E, K = config.n_experts, config.experts_per_token
    logits = h.float() @ router_w.float()                 # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)  # [T, K]
    # Renormalize the top-k gates (Mixtral convention).
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    onehot = F.one_hot(expert_idx, E)                     # [T, K, E] int
    flat = onehot.reshape(T * K, E)
    # K choices of one token occupy distinct slots: cumsum over the
    # flattened (token-major) order, after the earlier ranks' choices.
    before = torch.cumsum(flat, dim=0) - flat             # [T*K, E]
    n_data = data.world if data is not None else 1
    if n_data > 1:
        counts = collectives.gather_along(flat.sum(0, keepdim=True), data,
                                          0)              # [ranks, E]
        before = before + counts[:data.rank].sum(0)
    pos = (before * flat).sum(-1).reshape(T, K)
    keep = pos < capacity
    gate_vals = gate_vals * keep

    cap_onehot = (pos[..., None] == torch.arange(
        capacity, device=h.device)).float()               # [T, K, C]
    onehot = onehot.float()
    dispatch = torch.einsum('tke,tkc->tec', onehot,
                            cap_onehot * keep[..., None])
    combine = torch.einsum('tke,tkc->tec', onehot,
                           cap_onehot * gate_vals[..., None])

    # Aux: Switch load-balance loss + router z-loss, means over the global
    # batch (sums reduced over the data ranks, each rank's gradient its
    # share).
    T_all = T * n_data
    total = collectives.reduce_from
    frac_tokens = total(onehot.sum(1).sum(0), data) / T_all      # [E]
    frac_probs = total(probs.sum(0), data) / T_all               # [E]
    lb_loss = E * torch.sum(frac_tokens * frac_probs)
    z_loss = total((torch.logsumexp(logits, dim=-1) ** 2).sum(),
                   data) / T_all
    return dispatch, combine, (lb_loss, z_loss)


def _moe_mlp(config: MoEConfig, h: torch.Tensor, layer: Params,
             shard: Optional[MeshOps] = None
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Routed expert MLP. h: [b, s, d] (this rank's rows on a mesh)."""
    b, s, d = h.shape
    T = b * s
    data = shard.data if shard is not None else None
    T_all = T * (data.world if data is not None else 1)
    E, K = config.n_experts, config.experts_per_token
    capacity = max(1, int(config.capacity_factor * T_all * K / E))
    flat = h.reshape(T, d)
    dispatch, combine, aux = _route(config, flat, layer['router'],
                                    capacity, data)
    dtype = flat.dtype
    xs = torch.einsum('tec,td->ecd', dispatch.to(dtype), flat)
    if shard is not None:
        # Each slot holds one rank's token: the sum over ep is exact, and
        # lands each expert's slots on its rank.
        xs = shard.copy_tp(collectives.scatter_shards(xs, shard.ep, 0))
    gate = F.silu(torch.einsum('ecd,edf->ecf', xs, layer['w_gate']))
    up = torch.einsum('ecd,edf->ecf', xs, layer['w_up'])
    out = torch.einsum('ecf,efd->ecd', gate * up, layer['w_down'])
    if shard is not None:
        out = collectives.gather_shards(shard.reduce_tp(out), shard.ep, 0)
    y = torch.einsum('tec,ecd->td', combine.to(dtype), out)
    return y.reshape(b, s, d), aux


def _layer(config: MoEConfig, x: torch.Tensor, layer: Params,
           cos: torch.Tensor, sin: torch.Tensor,
           shard: Optional[MeshOps] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention block, then the routed MLP; returns (x, lb, z)."""
    if shard is None:
        x, _, _ = llama.attention_block(config.as_llama(), x, layer, cos,
                                        sin, None)
    else:
        # The whole layer (its tp and ep blocks) from the fsdp shards,
        # inside the checkpoint region.
        layer = {k: shard.gather(('layers', k), v) for k, v in layer.items()}
        x, _, _ = llama.attention_block(config.as_llama(), x, layer, cos,
                                        sin, None, shard.reduce_tp,
                                        shard.copy_tp)
    h = norms.rms_norm(x, layer['mlp_norm'], config.norm_eps)
    y, (lb, z) = _moe_mlp(config, h, layer, shard)
    return x + y, lb, z


def forward(config: MoEConfig, params: Params, tokens: torch.Tensor,
            shard: Optional[MeshOps] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens [b, s] -> (logits [b, s, vocab] fp32, aux losses). On a
    mesh rank (``shard``): this rank's rows and blocks; the aux losses
    are the global batch's."""
    x = llama._embed(params, tokens, shard)
    cos, sin = rope_lib.rope_frequencies(config.head_dim,
                                         config.max_seq_len,
                                         config.rope_theta,
                                         device=x.device)
    layers = params['layers']
    lbs, zs = [], []
    for values in zip(*(layers[k].unbind(0) for k in layers)):
        layer = dict(zip(layers, values))
        if config.remat:
            x, lb, z = torch.utils.checkpoint.checkpoint(
                _layer, config, x, layer, cos, sin, shard,
                use_reentrant=False)
        else:
            x, lb, z = _layer(config, x, layer, cos, sin, shard)
        lbs.append(lb)
        zs.append(z)
    x = norms.rms_norm(x, params['final_norm'], config.norm_eps)
    head = params['lm_head'] if shard is None \
        else shard.whole_head(params['lm_head'])
    logits = (x @ head).float()
    return logits, {'load_balance_loss': torch.stack(lbs).mean(),
                    'router_z_loss': torch.stack(zs).mean()}


def loss_fn(config: MoEConfig, params: Params, tokens: torch.Tensor,
            targets: torch.Tensor, *, lb_coef: float = 0.01,
            z_coef: float = 1e-3, shard: Optional[MeshOps] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(total loss, {'ce_loss', 'load_balance_loss', 'router_z_loss'}).
    On a mesh rank every value is the global batch's, the same on every
    rank; a rank's gradients, finished by :func:`reduce_grads`, are the
    global loss's."""
    logits, aux = forward(config, params, tokens, shard)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    if shard is None:
        ce = nll.mean()
    else:
        ce = collectives.reduce_from(nll.sum(), shard.data) / (
            nll.numel() * shard.data.world)
    total = (ce + lb_coef * aux['load_balance_loss']
             + z_coef * aux['router_z_loss'])
    return total, {'ce_loss': ce, **aux}
