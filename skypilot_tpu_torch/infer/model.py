"""Paged prefill and decode over ``models/llama.py`` parameters
(counterpart of the paged half of ``skypilot_tpu/infer/model.py``).

- ``paged_prefill_chunk``: one prompt chunk of one slot with cache
  context; its attention launches the paged prefill kernel.
- ``paged_decode_step``: one token for every slot; its attention
  launches the paged decode kernel.

Both keep the reference's write-then-attend order: a layer writes the new
K/V into the slot's pages first, then attends (the new token sees
itself). A Python loop over layers stands in for ``lax.scan``; the page
tensors and ``lengths`` are updated in place. The rotary tables are
computed once by the caller (the engine) and passed in as ``rope``.
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
        k_pages, v_pages = pkv.k_pages[i], pkv.v_pages[i]
        paged_attn.write_chunk_pages(k_pages, v_pages, k[0], v[0],
                                     table_row, offset)
        att = paged_attn.paged_prefill_attention(
            q[0].reshape(C, hkv, group, hd), k_pages, v_pages, table_row,
            offset, true_len)
        att = att.reshape(1, C, hq * hd).to(x.dtype)
        x = x + quant_lib.qdot(att, layer['wo'])
        x = llama.mlp_block(config, x, layer)
    x = norms.rms_norm(x, params['final_norm'], config.norm_eps)
    last = x[0, true_len - 1]
    logits = quant_lib.qdot(last, params['lm_head']).float()
    pkv.lengths[slot] = offset + true_len
    return pkv, logits


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
    hq, hkv, hd = config.n_heads, config.n_kv_heads, config.head_dim
    group = hq // hkv
    positions = pkv.lengths.clone()
    x = quant_lib.qembed(params['embed'], tokens)[:, None]   # [slots, 1, d]
    for i in range(config.n_layers):
        layer = llama.layer_params(params, i)
        q, k, v = _qkv(config, x, layer, rope, positions[:, None])
        k_pages, v_pages = pkv.k_pages[i], pkv.v_pages[i]
        paged_attn.append_token_pages(k_pages, v_pages, k[:, 0], v[:, 0],
                                      block_tables, positions)
        att = paged_attn.paged_decode_attention(
            q[:, 0].reshape(slots, hkv, group, hd), k_pages, v_pages,
            block_tables, positions + 1)
        att = att.reshape(slots, 1, hq * hd).to(x.dtype)
        x = x + quant_lib.qdot(att, layer['wo'])
        x = llama.mlp_block(config, x, layer)
    x = norms.rms_norm(x, params['final_norm'], config.norm_eps)
    logits = quant_lib.qdot(x[:, 0], params['lm_head']).float()
    if active is None:
        pkv.lengths += 1
    else:
        pkv.lengths += active.to(pkv.lengths.dtype)
    return logits, pkv
