"""Megatron placement of the Llama parameters over ``tp`` ranks (the
``tp`` half of ``LLAMA_PARAM_SPECS`` and ``param_shardings`` in
``skypilot_tpu/parallel/sharding.py``).

Each leaf has a :class:`Rule`: how it splits and along which axis of the
stacked leaf.

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
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from skypilot_tpu_torch.ops import quant as quant_lib


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


def check_divisible(config, tp: int) -> None:
    """The reference engine's checks: ``tp`` divides the heads, the KV
    heads, the ffn and the vocabulary."""
    for name in ('n_heads', 'n_kv_heads', 'ffn_dim', 'vocab_size'):
        dim = getattr(config, name)
        if dim % tp:
            raise ValueError(f'tp={tp} must divide {name}={dim}')


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


def shard_params(params, rank: int, tp: int):
    """Rank ``rank``'s slices of a whole param tree, bf16 or int8."""
    return map_tree(lambda path, leaf: shard_leaf(path, leaf, rank, tp),
                    params)


def is_whole(params, config) -> bool:
    """Whether ``params`` is an unsharded tree of ``config`` (its
    embedding holds every vocabulary row)."""
    return params['embed'].shape[0] == config.vocab_size
