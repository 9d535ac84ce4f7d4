"""Paged prefill, decode and speculative verify over ``models/llama.py``
parameters (counterpart of the paged half of
``skypilot_tpu/infer/model.py``).

- ``paged_prefill_chunk``: one prompt chunk of one slot with cache
  context; its attention launches the paged prefill kernel.
- ``paged_decode_step``: one token for every slot; its attention
  launches the paged decode kernel.
- ``paged_verify_step``: R = spec_k + 1 tokens for every slot; its
  attention launches the paged verify kernel.

All keep the reference's write-then-attend order: a layer writes the new
K/V into the slot's pages first, then attends (the new token sees
itself). Decode and verify share one fixed-width dense block
(``STEP_ROWS``), so that a token's bits do not depend on which kind of
step computed it. On int8 pages the writes quantize and the attention takes the
layer's scale pages, the int8 flavor of each kernel. A Python loop over
layers stands in for ``lax.scan``; the page tensors and ``lengths`` are
updated in place. The rotary tables are computed once by the caller (the
engine) and passed in as ``rope``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.infer import paged_cache as paged_cache_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import norms
from skypilot_tpu_torch.ops import paged_attention as paged_attn
from skypilot_tpu_torch.ops import quant as quant_lib
from skypilot_tpu_torch.ops import rope as rope_lib

Rope = Tuple[torch.Tensor, torch.Tensor]


def rope_tables(config: llama.LlamaConfig, device='cpu') -> Rope:
    """The (cos, sin) tables both paths gather from."""
    return rope_lib.rope_frequencies(config.head_dim, config.max_seq_len,
                                     config.rope_theta, device=device)


def _qkv(config: llama.LlamaConfig, x: torch.Tensor, layer, rope: Rope,
         positions: torch.Tensor):
    """norm -> QKV -> RoPE. x: [b, s, d]; positions: [b, s]."""
    b, s, _ = x.shape
    hq, hkv, hd = config.n_heads, config.n_kv_heads, config.head_dim
    h = norms.rms_norm(x, layer['attn_norm'], config.norm_eps)
    q = quant_lib.qdot(h, layer['wq']).reshape(b, s, hq, hd)
    k = quant_lib.qdot(h, layer['wk']).reshape(b, s, hkv, hd)
    v = quant_lib.qdot(h, layer['wv']).reshape(b, s, hkv, hd)
    cos, sin = rope
    q = rope_lib.apply_rope(q, cos, sin, positions)
    k = rope_lib.apply_rope(k, cos, sin, positions)
    return q, k, v


def _layer_pages(pkv: paged_cache_lib.PagedKVCache, i: int) -> dict:
    """Layer ``i``'s page tensors as keyword arguments of the cache
    writes and the attention wrappers: its scale pages too on int8."""
    kv = {'k_pages': pkv.k_pages[i], 'v_pages': pkv.v_pages[i]}
    if pkv.k_scales is not None:
        kv.update(k_scales=pkv.k_scales[i], v_scales=pkv.v_scales[i])
    return kv


def _scales(kv: dict) -> dict:
    return {k: kv[k] for k in ('k_scales', 'v_scales') if k in kv}


def paged_prefill_chunk(config: llama.LlamaConfig, params: llama.Params,
                        pkv: paged_cache_lib.PagedKVCache, slot: int,
                        table_row: torch.Tensor, tokens: torch.Tensor,
                        offset: int, true_len: int, rope: Rope
                        ) -> Tuple[paged_cache_lib.PagedKVCache,
                                   torch.Tensor]:
    """Process ONE chunk of a prompt over the paged cache.

    tokens: [C] int, the chunk padded to its bucket; offset: tokens of
    this slot already cached (page-aligned, not necessarily
    C-aligned); true_len: valid tokens in the chunk; table_row: [maxp]
    int32, already covering positions [0, offset + C). The chunk's K/V
    land in the slot's pages, its queries attend to the cached prefix
    plus the chunk itself (causal), and lengths[slot] becomes
    offset + true_len. Returns (cache, logits [vocab] fp32 at local
    position true_len - 1, meaningful on the final chunk).

    The pad tail writes garbage at [offset+true_len, offset+C), beyond
    the slot's frontier: no mask reaches it, and the next chunk or
    decode write overwrites it before the frontier does."""
    C = tokens.shape[0]
    hq, hkv, hd = config.n_heads, config.n_kv_heads, config.head_dim
    group = hq // hkv
    x = quant_lib.qembed(params['embed'], tokens)[None]   # [1, C, d]
    positions = offset + torch.arange(C, dtype=torch.int32,
                                      device=tokens.device)
    for i in range(config.n_layers):
        layer = llama.layer_params(params, i)
        q, k, v = _qkv(config, x, layer, rope, positions[None])
        kv = _layer_pages(pkv, i)
        paged_attn.write_chunk_pages(k_new=k[0], v_new=v[0],
                                     table_row=table_row, offset=offset, **kv)
        att = paged_attn.paged_prefill_attention(
            q[0].reshape(C, hkv, group, hd), kv['k_pages'], kv['v_pages'],
            table_row, offset, true_len, **_scales(kv))
        att = att.reshape(1, C, hq * hd).to(x.dtype)
        x = x + quant_lib.qdot(att, layer['wo'])
        x = llama.mlp_block(config, x, layer)
    x = norms.rms_norm(x, params['final_norm'], config.norm_eps)
    last = x[0, true_len - 1]
    logits = quant_lib.qdot(last, params['lm_head']).float()
    pkv.lengths[slot] = offset + true_len
    return pkv, logits


# Decode and verify steps run their dense layers (embedding, norms,
# projections, MLP, lm_head) on one [slots, STEP_ROWS] block of rows, the
# step's run zero-padded to it (STEP_ROWS covers the widest verify run the
# CUDA kernel takes). On the card a GEMM's (or a reduction's) per-row
# result depends on the kernel cuBLAS picks for the whole shape, so a
# token computed by a verify step would otherwise differ in its last bits
# from the same token computed by a decode step; with one shape for both,
# and the verify kernel's query rows bitwise the decode kernel's, a token
# gets the same bits whichever step computes it, and greedy outputs with
# speculation on are those of speculation off.
STEP_ROWS = 8


def _step(config: llama.LlamaConfig, params: llama.Params,
          pkv: paged_cache_lib.PagedKVCache, tokens: torch.Tensor,
          rope: Rope, attend) -> torch.Tensor:
    """The dense half of a decode or verify step. tokens: [slots, R] at
    positions lengths[slot] + i; ``attend(i, q, k, v)`` writes layer i's
    run K/V (k, v: [slots, R, hkv, hd]) and returns its attention for q
    [slots, R, hq, hd] as [slots, R, hq * hd]. Padded rows compute
    garbage that is never read. Returns logits [slots, R, vocab] fp32."""
    slots, R = tokens.shape
    width = max(STEP_ROWS, R)
    lengths = pkv.lengths
    # Rows past the run (and a run near the cache end) may run past the
    # rotary tables: clamp them as JAX's gather does; their K/V land in
    # the sink page or beyond the frontier and their logits are not read.
    positions = (lengths[:, None] + torch.arange(
        width, dtype=lengths.dtype, device=lengths.device)[None, :]).clamp(
            max=rope[0].shape[0] - 1)
    block = torch.zeros((slots, width), dtype=tokens.dtype,
                        device=tokens.device)
    block[:, :R] = tokens
    x = quant_lib.qembed(params['embed'], block)          # [slots, width, d]
    for i in range(config.n_layers):
        layer = llama.layer_params(params, i)
        q, k, v = _qkv(config, x, layer, rope, positions)
        att = torch.zeros((slots, width, config.n_heads * config.head_dim),
                          dtype=x.dtype, device=x.device)
        att[:, :R] = attend(i, q[:, :R], k[:, :R], v[:, :R])
        x = x + quant_lib.qdot(att, layer['wo'])
        x = llama.mlp_block(config, x, layer)
    x = norms.rms_norm(x, params['final_norm'], config.norm_eps)
    return quant_lib.qdot(x, params['lm_head']).float()[:, :R]


def paged_decode_step(config: llama.LlamaConfig, params: llama.Params,
                      pkv: paged_cache_lib.PagedKVCache,
                      block_tables: torch.Tensor, tokens: torch.Tensor,
                      rope: Rope, active: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor,
                                 paged_cache_lib.PagedKVCache]:
    """One token for every slot over the paged cache. tokens: [slots];
    block_tables: [slots, maxp] int32, covering position lengths[slot]
    of every active slot. Inactive slots compute garbage whose K/V row
    lands in their own frontier or the sink page; ``lengths`` advances
    only on ``active`` slots (all when None). Returns (logits
    [slots, vocab] fp32, cache)."""
    slots = tokens.shape[0]
    hkv, hd = config.n_kv_heads, config.head_dim
    group = config.n_heads // hkv
    positions = pkv.lengths.clone()

    def attend(i, q, k, v):
        kv = _layer_pages(pkv, i)
        paged_attn.append_token_pages(k_new=k[:, 0], v_new=v[:, 0],
                                      block_tables=block_tables,
                                      lengths=positions, **kv)
        att = paged_attn.paged_decode_attention(
            q[:, 0].reshape(slots, hkv, group, hd).contiguous(),
            kv['k_pages'], kv['v_pages'], block_tables, positions + 1,
            **_scales(kv))
        return att.reshape(slots, 1, -1)

    logits = _step(config, params, pkv, tokens[:, None], rope, attend)[:, 0]
    if active is None:
        pkv.lengths += 1
    else:
        pkv.lengths += active.to(pkv.lengths.dtype)
    return logits, pkv


def paged_verify_step(config: llama.LlamaConfig, params: llama.Params,
                      pkv: paged_cache_lib.PagedKVCache,
                      block_tables: torch.Tensor, tokens: torch.Tensor,
                      rope: Rope) -> Tuple[torch.Tensor,
                                           paged_cache_lib.PagedKVCache]:
    """Speculative verify over the paged cache: R = spec_k + 1 tokens for
    every slot. tokens: [slots, R], column 0 the slot's last token,
    columns 1..R-1 the (padded) drafts. Each layer writes the run's K/V
    at positions lengths[slot]..lengths[slot]+R-1 (positions past the
    block table's coverage go to the sink page), then every query
    attends through the cache and the run up to itself in one verify
    launch, each owned page read once for all R queries. ``lengths`` is
    NOT advanced: only the engine knows how many tokens it accepts.
    Returns (logits [slots, R, vocab] fp32, cache)."""
    slots, R = tokens.shape
    hkv, hd = config.n_kv_heads, config.head_dim
    group = config.n_heads // hkv
    lengths = pkv.lengths.clone()

    def attend(i, q, k, v):
        kv = _layer_pages(pkv, i)
        paged_attn.append_run_pages(k_new=k, v_new=v,
                                    block_tables=block_tables,
                                    lengths=lengths, **kv)
        att = paged_attn.paged_verify_attention(
            q.reshape(slots, R, hkv, group, hd).contiguous(),
            kv['k_pages'], kv['v_pages'], block_tables, lengths,
            **_scales(kv))
        return att.reshape(slots, R, -1)

    return _step(config, params, pkv, tokens, rope, attend), pkv
