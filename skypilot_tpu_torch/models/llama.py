"""Llama-family decoder (counterpart of ``skypilot_tpu/models/llama.py``).

The config with its presets, the stacked ``[n_layers, ...]`` parameter
layout and init, the shared ``attention_block``/``mlp_block``, the
training ``backbone``/``forward``/``loss_fn``, and ``params_from_jax``,
which carries a parameter tree of numpy arrays (made by the JAX
package) across so both sides compute the same function in the
differential tests.

Params are a plain dict of tensors with the reference's layout. A
Python loop over the stacked layers stands in for ``lax.scan``; with
``config.remat`` each layer runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint``), so its activations are recomputed in
the backward pass. The remat policies are the reference's, as selective
activation checkpointing (``context_fn``), which sees dispatcher
operators:

- ``full``: nothing saved, everything recomputed;
- ``dots``: the outputs of 2-D products (``aten.mm``, ``aten.addmm``)
  saved, as ``dots_with_no_batch_dims_saveable``; batched products and
  everything else recomputed;
- ``save_attn``: the attention's output saved, as the reference's
  ``save_only_these_names('attn_out')``: the flash operator's outputs
  (out and lse, what its backward needs), so the flash forward runs once
  a layer a step; with dense attention the ``attn_out`` operator's copy.

A rank of a training mesh (``parallel/mesh.py``) passes ``shard``, a
``parallel.sharding.RankOps``: each layer gathers its fsdp shards inside
its checkpoint region (so the whole weights are gathered again for the
backward and never kept), runs its ``n_heads / tp`` and ``n_kv_heads /
tp`` heads with column-parallel QKV, gate and up products and
row-parallel ``wo`` and ``w_down`` (reduced over tp), the embedding is
vocab-parallel over tp, and the loss runs on the rank's rows over the
whole ``lm_head`` as the global mean's share.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from skypilot_tpu_torch.ops import attention as attention_lib
from skypilot_tpu_torch.ops import cross_entropy as ce
from skypilot_tpu_torch.ops import norms
from skypilot_tpu_torch.ops import quant as quant_lib
from skypilot_tpu_torch.ops import rope as rope_lib

Params = Dict[str, Any]

# Tree skeleton of one stacked layer group (leaves are placeholders).
LLAMA_LAYER_TREE: Dict[str, int] = {
    'attn_norm': 0, 'wq': 0, 'wk': 0, 'wv': 0, 'wo': 0,
    'mlp_norm': 0, 'w_gate': 0, 'w_up': 0, 'w_down': 0,
}

_DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32,
           'float16': torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype behind a config dtype name ('bfloat16', ...)."""
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Copy of the reference config. The serving path ignores the
    training fields (attention_impl, attn_block_*, remat*,
    loss_vocab_chunks, fused_loss)."""
    vocab_size: int = 128_256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14_336
    max_seq_len: int = 8192
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: str = 'bfloat16'
    attention_impl: str = 'auto'
    attn_block_q: Optional[int] = None
    attn_block_k: Optional[int] = None
    remat: bool = True
    remat_policy: str = 'full'
    loss_vocab_chunks: Optional[int] = None
    fused_loss: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def num_params(self) -> int:
        d, f, v = self.dim, self.ffn_dim, self.vocab_size
        per_layer = (d * self.n_heads * self.head_dim            # wq
                     + 2 * d * self.n_kv_heads * self.head_dim   # wk, wv
                     + self.n_heads * self.head_dim * d          # wo
                     + 3 * d * f                                 # gate/up/down
                     + 2 * d)                                    # norms
        return self.n_layers * per_layer + 2 * v * d + d

    # ---- presets --------------------------------------------------------
    @staticmethod
    def llama3_8b(**kw) -> 'LlamaConfig':
        kw.setdefault('loss_vocab_chunks', 16)
        return LlamaConfig(**kw)

    @staticmethod
    def llama3_70b(**kw) -> 'LlamaConfig':
        kw.setdefault('loss_vocab_chunks', 16)
        return LlamaConfig(dim=8192, n_layers=80, n_heads=64, n_kv_heads=8,
                           ffn_dim=28_672, **kw)

    @staticmethod
    def bench_350m(**kw) -> 'LlamaConfig':
        base = dict(vocab_size=32_768, dim=1024, n_layers=16,
                    n_heads=16, n_kv_heads=8, ffn_dim=4096,
                    max_seq_len=2048)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def bench_1b(**kw) -> 'LlamaConfig':
        base = dict(vocab_size=32_768, dim=1536, n_layers=24,
                    n_heads=12, n_kv_heads=12, ffn_dim=6144,
                    max_seq_len=2048, remat_policy='full',
                    attn_block_q=512, attn_block_k=512)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def tiny(**kw) -> 'LlamaConfig':
        """Test-sized config (CPU-fast)."""
        base = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                    n_kv_heads=2, ffn_dim=128, max_seq_len=128,
                    dtype='float32')
        base.update(kw)
        return LlamaConfig(**base)


def init_params(config: LlamaConfig,
                generator: Optional[torch.Generator],
                device='cpu', keep=None) -> Params:
    """Scaled-normal init, layers stacked on axis 0, with the
    reference's shapes and scales. The numbers come from ``generator``
    (on ``device``), so they are not the reference's ``jax.random``
    bits; tests that compare with JAX use :func:`params_from_jax`.

    Each stacked weight is drawn one layer at a time in fp32 and cast
    into a preallocated tensor, so the fp32 temporaries stay one layer
    large (an 8B model's stacked fp32 draw would not fit beside it).
    On the ``'meta'`` device nothing is drawn (``generator`` may be
    None): the tree's shapes and dtypes alone, what a checkpoint restore
    checks against. ``keep(path, leaf)``, when given, maps each leaf as
    soon as it is drawn, before the next one is (a tensor-parallel rank
    keeps its slice, so the whole tree never exists at once); the draws
    are the same with or without it."""
    dtype = torch_dtype(config.dtype)
    d, hd = config.dim, config.head_dim
    L = config.n_layers

    def kept(path, leaf):
        return leaf if keep is None else keep(path, leaf)

    def normal(path, shape, scale, stacked=False):
        out = torch.empty(shape, dtype=dtype, device=device)
        if out.is_meta:
            return kept(path, out)
        for i in range(shape[0] if stacked else 1):
            part = out[i] if stacked else out
            part.copy_(torch.randn(part.shape, generator=generator,
                                   dtype=torch.float32, device=device)
                       * scale)
        return kept(path, out)

    def ones(path, shape):
        return kept(path, torch.ones(shape, dtype=dtype, device=device))

    scale = d ** -0.5
    out_scale = scale / (2 * L) ** 0.5   # GPT-2-style residual scaling

    def layer(name):
        return ('layers', name)

    layers = {
        'attn_norm': ones(layer('attn_norm'), (L, d)),
        'wq': normal(layer('wq'), (L, d, config.n_heads * hd), scale, True),
        'wk': normal(layer('wk'), (L, d, config.n_kv_heads * hd), scale,
                     True),
        'wv': normal(layer('wv'), (L, d, config.n_kv_heads * hd), scale,
                     True),
        'wo': normal(layer('wo'), (L, config.n_heads * hd, d), out_scale,
                     True),
        'mlp_norm': ones(layer('mlp_norm'), (L, d)),
        'w_gate': normal(layer('w_gate'), (L, d, config.ffn_dim), scale,
                         True),
        'w_up': normal(layer('w_up'), (L, d, config.ffn_dim), scale, True),
        'w_down': normal(layer('w_down'), (L, config.ffn_dim, d), out_scale,
                         True),
    }
    return {
        'embed': normal(('embed',), (config.vocab_size, d), 1.0),
        'layers': layers,
        'final_norm': ones(('final_norm',), (d,)),
        'lm_head': normal(('lm_head',), (d, config.vocab_size), scale),
    }


def params_from_jax(tree: Params, device='cpu') -> Params:
    """Carry a reference parameter tree across: ``tree`` holds numpy
    arrays (``jax.tree.map(np.asarray, params)`` on the JAX side) in the
    reference's layout; the result is the same dict of tensors on
    ``device``. bf16 leaves arrive as ml_dtypes bfloat16 arrays and are
    reinterpreted bit for bit. A quantized tree keeps the reference's
    ``QuantArray`` nodes (``jax.tree.map`` maps their ``q`` and ``scale``
    fields); the port cannot import that class, so it recognises them by
    those two fields and builds its own :class:`quant_lib.QuantArray`."""
    def convert(a):
        a = np.asarray(a)
        if a.dtype.name == 'bfloat16':
            t = torch.from_numpy(a.view(np.int16).copy())
            return t.view(torch.bfloat16).to(device)
        # A private copy: JAX hands out read-only buffers.
        return torch.from_numpy(np.array(a)).to(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if hasattr(node, 'q') and hasattr(node, 'scale'):
            return quant_lib.QuantArray(q=convert(node.q),
                                        scale=convert(node.scale))
        return convert(node)
    return walk(tree)


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked layer weights (views; a
    quantized leaf gives the layer's int8 weight and scales)."""
    return {k: v[i] for k, v in params['layers'].items()}


def mlp_block(config: LlamaConfig, x: torch.Tensor,
              layer: Params, reduce=None, copy=None) -> torch.Tensor:
    """norm -> SwiGLU -> residual. ``copy`` and ``reduce`` are a
    tensor-parallel rank's entry into and exit from its parallel region:
    the normed input enters the column-parallel gate and up products, and
    the row-parallel ``w_down`` product's partials are summed before the
    residual add."""
    h = norms.rms_norm(x, layer['mlp_norm'], config.norm_eps)
    if copy is not None:
        h = copy(h)
    gate = F.silu(quant_lib.qdot(h, layer['w_gate']))
    down = quant_lib.qdot(gate * quant_lib.qdot(h, layer['w_up']),
                          layer['w_down'])
    return x + (down if reduce is None else reduce(down))


def _tags_attention(config: LlamaConfig, seq: int, on_cuda: bool) -> bool:
    """Whether the attention output needs the ``attn_out`` tag: the
    ``save_attn`` policy where the flash operator does not produce it."""
    return (config.remat and config.remat_policy == 'save_attn'
            and not attention_lib.uses_flash(config.attention_impl, seq,
                                             on_cuda))


def attention_block(config: LlamaConfig, x: torch.Tensor, layer: Params,
                    cos: torch.Tensor, sin: torch.Tensor,
                    positions: Optional[torch.Tensor], reduce=None,
                    copy=None) -> tuple:
    """norm -> QKV -> RoPE -> attention -> residual. Returns (x, k, v)
    with k/v post-RoPE [b, s, kv_heads, head_dim], as the reference's
    shared block does. The head counts are the weights' (a
    tensor-parallel rank's ``n_heads / tp``); ``copy`` and ``reduce`` as
    in :func:`mlp_block`, around the QKV and ``wo`` products."""
    b, s, d = x.shape
    hd = config.head_dim
    h = norms.rms_norm(x, layer['attn_norm'], config.norm_eps)
    if copy is not None:
        h = copy(h)
    q = quant_lib.qdot(h, layer['wq'])
    k = quant_lib.qdot(h, layer['wk'])
    v = quant_lib.qdot(h, layer['wv'])
    hq, hkv = q.shape[-1] // hd, k.shape[-1] // hd
    q = rope_lib.apply_rope(q.reshape(b, s, hq, hd), cos, sin, positions)
    k = rope_lib.apply_rope(k.reshape(b, s, hkv, hd), cos, sin, positions)
    v = v.reshape(b, s, hkv, hd)
    # [b, s, h, hd] -> [b, h, s, hd] for the attention kernels.
    att = attention_lib.attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, impl=config.attention_impl,
        block_q=config.attn_block_q, block_k=config.attn_block_k)
    if _tags_attention(config, s, x.is_cuda):
        att = attention_lib.attn_out(att)
    att = att.transpose(1, 2).reshape(b, s, hq * hd)
    out = quant_lib.qdot(att, layer['wo'])
    return x + (out if reduce is None else reduce(out)), k, v


def _layer(config: LlamaConfig, x: torch.Tensor, layer: Params,
           cos: torch.Tensor, sin: torch.Tensor,
           positions: Optional[torch.Tensor], shard=None) -> torch.Tensor:
    if shard is None:
        x, _, _ = attention_block(config, x, layer, cos, sin, positions)
        return mlp_block(config, x, layer)
    # A mesh rank: the whole layer (its tp blocks) from the fsdp shards,
    # here inside the checkpoint region.
    layer = {k: shard.gather(('layers', k), v) for k, v in layer.items()}
    x, _, _ = attention_block(config, x, layer, cos, sin, positions,
                              shard.reduce_tp, shard.copy_tp)
    return mlp_block(config, x, layer, shard.reduce_tp, shard.copy_tp)


def _saved_ops(policy: str):
    """The operators whose outputs ``policy`` saves."""
    if policy == 'dots':
        return {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}
    return {torch.ops.skypilot_tpu_torch.flash_fwd.default,
            torch.ops.skypilot_tpu_torch.attn_out.default}


def _remat_kwargs(config: LlamaConfig) -> Dict[str, Any]:
    """``torch.utils.checkpoint`` arguments of the remat policy."""
    if config.remat_policy == 'full':
        return {}
    if config.remat_policy not in ('dots', 'save_attn'):
        # A typo must not silently bench as full remat.
        raise ValueError(
            f'Unknown remat_policy {config.remat_policy!r}; '
            f"expected 'full', 'dots' or 'save_attn'")
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    saved = _saved_ops(config.remat_policy)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return {'context_fn': functools.partial(
        create_selective_checkpoint_contexts, policy)}


def _embed(params: Params, tokens: torch.Tensor, shard) -> torch.Tensor:
    """The embedding rows of ``tokens``; on a mesh rank the table is
    gathered over fsdp and vocab-parallel over tp: a token outside the
    rank's rows gathers zeros, and the tp reduction sums the one rank's
    row with zeros (exact)."""
    if shard is None:
        return params['embed'][tokens]
    table = shard.gather(('embed',), params['embed'])
    if shard.tp == 1:
        return table[tokens]
    rows = table.shape[0]
    local = tokens.long() - shard.tp_rank * rows
    hit = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)]
    x = torch.where(hit[..., None], x, torch.zeros_like(x))
    return shard.reduce_tp(x)


def backbone(config: LlamaConfig, params: Params, tokens: torch.Tensor,
             positions: Optional[torch.Tensor] = None,
             shard=None) -> torch.Tensor:
    """tokens [b, s] int -> final-norm hidden states [b, s, d]. ``shard``:
    a mesh rank's ``parallel.sharding.RankOps`` (None on one device)."""
    remat_kw = _remat_kwargs(config) if config.remat else {}
    x = _embed(params, tokens, shard)
    cos, sin = rope_lib.rope_frequencies(config.head_dim,
                                         config.max_seq_len,
                                         config.rope_theta,
                                         device=x.device)
    # One unbind per stacked weight, not one index per layer: autograd
    # then stacks the per-layer gradients once, where indexing would
    # materialize and add a full-size zero gradient for every layer.
    layers = params['layers']
    for values in zip(*(layers[k].unbind(0) for k in layers)):
        layer = dict(zip(layers, values))
        if config.remat:
            x = torch.utils.checkpoint.checkpoint(
                _layer, config, x, layer, cos, sin, positions, shard,
                use_reentrant=False, **remat_kw)
        else:
            x = _layer(config, x, layer, cos, sin, positions, shard)
    return norms.rms_norm(x, params['final_norm'], config.norm_eps)


def forward(config: LlamaConfig, params: Params, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [b, s] int -> logits [b, s, vocab] (fp32)."""
    x = backbone(config, params, tokens, positions)
    return quant_lib.qdot(x, params['lm_head']).float()


def loss_fn(config: LlamaConfig, params: Params, tokens: torch.Tensor,
            targets: torch.Tensor,
            mask: Optional[torch.Tensor] = None, shard=None) -> torch.Tensor:
    """Causal LM cross-entropy: the fused kernel forward with
    ``config.fused_loss``, else the vocab-chunked path with
    ``config.loss_vocab_chunks``, else the dense fp32 log-softmax. With
    ``mask``, the masked mean over at least one token.

    On a mesh rank (``shard``) every branch runs unchanged on the rank's
    rows over the whole ``lm_head``, and the result is the rank's share
    of the global mean: its rows' sum over the global count (the mask's
    count summed over dp x fsdp), so the shares add to the reference's
    loss over the global batch."""
    head = params['lm_head'] if shard is None \
        else shard.whole_head(params['lm_head'])
    if config.fused_loss or config.loss_vocab_chunks:
        b, s = tokens.shape
        x = backbone(config, params, tokens, shard=shard).reshape(
            b * s, config.dim)
        flat = targets.reshape(b * s).to(torch.int32)
        if config.fused_loss:
            nll = ce.fused_cross_entropy(x, head, flat)
        else:
            nll = ce.chunked_cross_entropy(x, head, flat,
                                           config.loss_vocab_chunks)
        nll = nll.reshape(b, s)
    else:
        x = backbone(config, params, tokens, shard=shard)
        logits = quant_lib.qdot(x, head).float()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    if shard is None:
        if mask is not None:
            return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
        return nll.mean()
    if mask is not None:
        count = shard.data_sum(mask.sum())
        return (nll * mask).sum() / torch.clamp(count, min=1)
    return nll.sum() / (nll.numel() * shard.data_world)


def flops_per_token(config: LlamaConfig) -> float:
    """Training FLOPs/token ~ 6 * params + attention quadratic term
    (2*2*3*s*d per token at seq s, fwd+bwd)."""
    base = 6.0 * config.num_params
    attn = 12.0 * config.n_layers * config.max_seq_len * config.head_dim \
        * config.n_heads
    return base + attn
