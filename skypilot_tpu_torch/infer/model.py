"""Prefill, decode, speculative verify and the fused mixed step over
``models/llama.py`` parameters, on the paged cache and on the dense one
(counterpart of ``skypilot_tpu/infer/model.py``).

- ``paged_prefill_chunk``: one prompt chunk of one slot with cache
  context; its attention launches the paged prefill kernel. The slot,
  offset and true length may be host integers or 0-d device tensors
  (then nothing in the chunk reads them on the host, and a CUDA graph
  captured over it serves any chunk of its bucket).
- ``paged_decode_step``: one token for every slot; its attention
  launches the paged decode kernel.
- ``paged_verify_step``: R = spec_k + 1 tokens for every slot; its
  attention launches the paged verify kernel.
- ``paged_mixed_step``: one prefill chunk and one decode step in one
  call, layer by layer (the chunk's layer, then the decode's), each
  half with exactly the products its standalone step runs.

The dense steps (``prefill_chunk``, ``decode_step``, ``verify_step``,
``mixed_step``, over ``cache.KVCache``) are the same functions over the
dense cache's page view and its identity block table (``cache.py``): the
reference computes their attention as fp32 einsums over the whole static
cache with a length mask, the port launches the same paged kernels as
the paged flavor, so that no step re-reads and casts a slot's whole
``[S]`` rows on the card. Only the writes differ: the dense ones index the
slot's own rows (``cache.append_token`` and friends), where the paged ones
send out-of-range positions to the sink page.

All keep the reference's write-then-attend order: a layer writes the new
K/V into the slot's pages first, then attends (the new token sees
itself). Decode and verify share one fixed-width dense block
(``STEP_ROWS``), so that a token's bits do not depend on which kind of
step computed it. On int8 pages the writes quantize and the attention takes the
layer's scale pages, the int8 flavor of each kernel. A Python loop over
layers stands in for ``lax.scan``; the page tensors and ``lengths`` are
updated in place. The rotary tables are computed once by the caller (the
engine) and passed in as ``rope``.

Tensor parallelism (``tp``, a ``parallel.mesh.TPGroup`` of more than one
rank; dense cache only, as the reference's engine allows): each rank holds
its Megatron slices of the weights (``parallel/sharding.py``) and
``n_kv_heads / tp`` KV heads of the cache, computes QKV, RoPE and the
attention over its ``n_heads / tp`` query heads (the group stays
``n_heads / n_kv_heads``, so the kernels run as before at fewer heads),
and the collectives go where Megatron's rules put them: the
vocab-parallel embedding and the row-parallel ``wo`` and ``w_down``
products are all-reduced, the column-parallel ``lm_head``'s logits are
all-gathered along the vocabulary, so every rank samples from the same
full logits. At world size 1 (``tp`` None or of one rank) no collective
is called and every step runs exactly its single-card launches. The
paged steps raise for ``tp > 1``.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from skypilot_tpu_torch.infer import cache as cache_lib
from skypilot_tpu_torch.infer import paged_cache as paged_cache_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import norms
from skypilot_tpu_torch.ops import paged_attention as paged_attn
from skypilot_tpu_torch.ops import quant as quant_lib
from skypilot_tpu_torch.ops import rope as rope_lib
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel.mesh import TPGroup

Rope = Tuple[torch.Tensor, torch.Tensor]
Cache = Union[paged_cache_lib.PagedKVCache, cache_lib.KVCache]


def rope_tables(config: llama.LlamaConfig, device='cpu') -> Rope:
    """The (cos, sin) tables both paths gather from."""
    return rope_lib.rope_frequencies(config.head_dim, config.max_seq_len,
                                     config.rope_theta, device=device)


def _world(tp: Optional[TPGroup]) -> int:
    return 1 if tp is None else tp.world


def _heads(config: llama.LlamaConfig,
           tp: Optional[TPGroup]) -> Tuple[int, int, int]:
    """(query heads, KV heads, head_dim) of this rank."""
    w = _world(tp)
    return config.n_heads // w, config.n_kv_heads // w, config.head_dim


def _embed(params: llama.Params, tokens: torch.Tensor,
           tp: Optional[TPGroup]) -> torch.Tensor:
    """The embedding rows of ``tokens``; with ``tp`` ranks the
    vocab-parallel gather: a token outside this rank's rows gives zeros,
    and the all-reduce sums the one rank's row with zeros (exact)."""
    embed = params['embed']
    if _world(tp) == 1:
        return quant_lib.qembed(embed, tokens)
    rows = embed.shape[0]
    local = tokens.long() - tp.rank * rows
    inside = (local >= 0) & (local < rows)
    x = quant_lib.qembed(embed, local.clamp(0, rows - 1))
    x = torch.where(inside[..., None], x, torch.zeros_like(x))
    return collectives.all_reduce_sum(x, tp)


def _row_reduce(tp: Optional[TPGroup]):
    """The row-parallel products' all-reduce, None at world size 1."""
    if _world(tp) == 1:
        return None
    return lambda t: collectives.all_reduce_sum(t, tp)


def _out_proj(att: torch.Tensor, layer, tp: Optional[TPGroup]
              ) -> torch.Tensor:
    """``att @ wo``, all-reduced over the ranks' heads."""
    return collectives.all_reduce_sum(quant_lib.qdot(att, layer['wo']), tp)


def _lm_head(x: torch.Tensor, params: llama.Params,
             tp: Optional[TPGroup]) -> torch.Tensor:
    """Logits fp32 over the whole vocabulary: each rank's column slice,
    all-gathered in rank order."""
    return collectives.all_gather_last(
        quant_lib.qdot(x, params['lm_head']), tp).float()


def _check_paged(pkv: Cache, tp: Optional[TPGroup]) -> None:
    if _world(tp) > 1 and isinstance(pkv, paged_cache_lib.PagedKVCache):
        raise ValueError('paged KV is single-device for now; use the dense '
                         'cache for tp > 1')


def _qkv(config: llama.LlamaConfig, x: torch.Tensor, layer, rope: Rope,
         positions: torch.Tensor, tp: Optional[TPGroup] = None):
    """norm -> QKV -> RoPE over this rank's heads. x: [b, s, d];
    positions: [b, s]."""
    b, s, _ = x.shape
    hq, hkv, hd = _heads(config, tp)
    h = norms.rms_norm(x, layer['attn_norm'], config.norm_eps)
    q = quant_lib.qdot(h, layer['wq']).reshape(b, s, hq, hd)
    k = quant_lib.qdot(h, layer['wk']).reshape(b, s, hkv, hd)
    v = quant_lib.qdot(h, layer['wv']).reshape(b, s, hkv, hd)
    cos, sin = rope
    q = rope_lib.apply_rope(q, cos, sin, positions)
    k = rope_lib.apply_rope(k, cos, sin, positions)
    return q, k, v


def _layer_pages(pkv: Cache, i: int) -> dict:
    """Layer ``i``'s page tensors as keyword arguments of the cache
    writes and the attention wrappers: its scale pages too on int8; the
    page view of the dense cache."""
    if isinstance(pkv, cache_lib.KVCache):
        k_pages, v_pages = cache_lib.page_view(pkv, i)
        return {'k_pages': k_pages, 'v_pages': v_pages}
    kv = {'k_pages': pkv.k_pages[i], 'v_pages': pkv.v_pages[i]}
    if pkv.k_scales is not None:
        kv.update(k_scales=pkv.k_scales[i], v_scales=pkv.v_scales[i])
    return kv


def _scales(kv: dict) -> dict:
    return {k: kv[k] for k in ('k_scales', 'v_scales') if k in kv}


IntLike = paged_attn.IntLike


def _write_chunk(pkv: Cache, i: int, kv: dict, k: torch.Tensor,
                 v: torch.Tensor, slot: IntLike, table_row: torch.Tensor,
                 offset: IntLike) -> None:
    """Layer ``i``'s chunk K/V [C, hkv, hd] into the slot: its pages, or
    its own rows of the dense cache."""
    if isinstance(pkv, cache_lib.KVCache):
        cache_lib.write_chunk(pkv.k[i], pkv.v[i], k, v, slot, offset)
    else:
        paged_attn.write_chunk_pages(k_new=k, v_new=v, table_row=table_row,
                                     offset=offset, **kv)


def _write_token(pkv: Cache, i: int, kv: dict, k: torch.Tensor,
                 v: torch.Tensor, block_tables: torch.Tensor,
                 positions: torch.Tensor) -> None:
    """Layer ``i``'s one-token K/V [slots, hkv, hd] at ``positions``."""
    if isinstance(pkv, cache_lib.KVCache):
        cache_lib.append_token(pkv.k[i], pkv.v[i], k, v, positions)
    else:
        paged_attn.append_token_pages(k_new=k, v_new=v,
                                      block_tables=block_tables,
                                      lengths=positions, **kv)


def _write_run(pkv: Cache, i: int, kv: dict, k: torch.Tensor,
               v: torch.Tensor, block_tables: torch.Tensor,
               lengths: torch.Tensor) -> None:
    """Layer ``i``'s run K/V [slots, R, hkv, hd] at lengths + 0..R-1."""
    if isinstance(pkv, cache_lib.KVCache):
        cache_lib.append_run(pkv.k[i], pkv.v[i], k, v, lengths)
    else:
        paged_attn.append_run_pages(k_new=k, v_new=v,
                                    block_tables=block_tables,
                                    lengths=lengths, **kv)


def _chunk_layer(config: llama.LlamaConfig, x: torch.Tensor, i: int,
                 params: llama.Params, pkv: Cache, slot: IntLike,
                 table_row: torch.Tensor, positions: torch.Tensor,
                 offset: IntLike, true_len: IntLike, rope: Rope,
                 tp: Optional[TPGroup] = None) -> torch.Tensor:
    """Layer ``i`` of a prefill chunk, x: [1, C, d]: write the chunk's
    K/V into the slot, then attend over the prefix plus the chunk."""
    C = x.shape[1]
    hq, hkv, hd = _heads(config, tp)
    layer = llama.layer_params(params, i)
    q, k, v = _qkv(config, x, layer, rope, positions[None], tp)
    kv = _layer_pages(pkv, i)
    _write_chunk(pkv, i, kv, k[0], v[0], slot, table_row, offset)
    att = paged_attn.paged_prefill_attention(
        q[0].reshape(C, hkv, hq // hkv, hd), kv['k_pages'], kv['v_pages'],
        table_row, offset, true_len, **_scales(kv))
    att = att.reshape(1, C, hq * hd).to(x.dtype)
    x = x + _out_proj(att, layer, tp)
    return llama.mlp_block(config, x, layer, _row_reduce(tp))


def _chunk_logits(config: llama.LlamaConfig, params: llama.Params,
                  x: torch.Tensor, true_len: IntLike,
                  tp: Optional[TPGroup] = None) -> torch.Tensor:
    """Logits [vocab] fp32 of the chunk's row true_len - 1 (a device
    true_len picks it on the device; the row is the same either way)."""
    x = norms.rms_norm(x, params['final_norm'], config.norm_eps)
    if isinstance(true_len, torch.Tensor):
        last = x[0].index_select(0, (true_len.long() - 1).reshape(1))[0]
    else:
        last = x[0, true_len - 1]
    return _lm_head(last, params, tp)


def _set_length(pkv: Cache, slot: IntLike,
                value: IntLike) -> None:
    """lengths[slot] = value, on the device when either is a tensor."""
    if isinstance(slot, torch.Tensor) or isinstance(value, torch.Tensor):
        index = torch.as_tensor(slot, device=pkv.lengths.device).long()
        value = torch.as_tensor(value, device=pkv.lengths.device)
        pkv.lengths.index_put_((index.reshape(1),),
                               value.to(pkv.lengths.dtype).reshape(1))
    else:
        pkv.lengths[slot] = value


def paged_prefill_chunk(config: llama.LlamaConfig, params: llama.Params,
                        pkv: paged_cache_lib.PagedKVCache, slot: IntLike,
                        table_row: torch.Tensor, tokens: torch.Tensor,
                        offset: IntLike, true_len: IntLike, rope: Rope,
                        tp: Optional[TPGroup] = None
                        ) -> Tuple[paged_cache_lib.PagedKVCache,
                                   torch.Tensor]:
    """Process ONE chunk of a prompt over the paged cache.

    tokens: [C] int, the chunk padded to its bucket; offset: tokens of
    this slot already cached (page-aligned, not necessarily
    C-aligned); true_len: valid tokens in the chunk; table_row: [maxp]
    int32, already covering positions [0, offset + C). slot, offset and
    true_len are host integers, or 0-d int32 tensors on the device (the
    engine's, read there: the same bits, no host sync). The chunk's K/V
    land in the slot's pages, its queries attend to the cached prefix
    plus the chunk itself (causal), and lengths[slot] becomes
    offset + true_len. Returns (cache, logits [vocab] fp32 at local
    position true_len - 1, meaningful on the final chunk).

    The pad tail writes garbage at [offset+true_len, offset+C), beyond
    the slot's frontier: no mask reaches it, and the next chunk or
    decode write overwrites it before the frontier does."""
    _check_paged(pkv, tp)
    C = tokens.shape[0]
    x = _embed(params, tokens, tp)[None]   # [1, C, d]
    positions = offset + torch.arange(C, dtype=torch.int32,
                                      device=tokens.device)
    for i in range(config.n_layers):
        x = _chunk_layer(config, x, i, params, pkv, slot, table_row,
                         positions, offset, true_len, rope, tp)
    logits = _chunk_logits(config, params, x, true_len, tp)
    _set_length(pkv, slot, offset + true_len)
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


class _Step:
    """The dense half of a decode or verify step, layer by layer (the
    mixed step runs a chunk layer between two of its layers). tokens:
    [slots, R] at positions lengths[slot] + i; ``attend(i, q, k, v)``
    writes layer i's run K/V (k, v: [slots, R, hkv, hd]) and returns its
    attention for q [slots, R, hq, hd] as [slots, R, hq * hd]. Padded
    rows compute garbage that is never read."""

    def __init__(self, config: llama.LlamaConfig, params: llama.Params,
                 pkv: Cache, tokens: torch.Tensor,
                 rope: Rope, attend, tp: Optional[TPGroup] = None) -> None:
        slots, self.R = tokens.shape
        width = max(STEP_ROWS, self.R)
        lengths = pkv.lengths
        # Rows past the run (and a run near the cache end) may run past
        # the rotary tables: clamp them as JAX's gather does; their K/V
        # land in the sink page (dense: the slot's last row, keeping its
        # value) or beyond the frontier and their logits are not read.
        self.positions = (lengths[:, None] + torch.arange(
            width, dtype=lengths.dtype, device=lengths.device)[None, :]
        ).clamp(max=rope[0].shape[0] - 1)
        block = torch.zeros((slots, width), dtype=tokens.dtype,
                            device=tokens.device)
        block[:, :self.R] = tokens
        self.x = _embed(params, block, tp)  # [slots, width, d]
        self.config, self.params, self.rope = config, params, rope
        self.attend, self.tp = attend, tp

    def layer(self, i: int) -> None:
        config, x, R, tp = self.config, self.x, self.R, self.tp
        layer = llama.layer_params(self.params, i)
        q, k, v = _qkv(config, x, layer, self.rope, self.positions, tp)
        hq, _, hd = _heads(config, tp)
        att = torch.zeros((x.shape[0], x.shape[1], hq * hd),
                          dtype=x.dtype, device=x.device)
        att[:, :R] = self.attend(i, q[:, :R], k[:, :R], v[:, :R])
        x = x + _out_proj(att, layer, tp)
        self.x = llama.mlp_block(config, x, layer, _row_reduce(tp))

    def logits(self) -> torch.Tensor:
        """[slots, R, vocab] fp32."""
        x = norms.rms_norm(self.x, self.params['final_norm'],
                           self.config.norm_eps)
        return _lm_head(x, self.params, self.tp)[:, :self.R]


def _step(config: llama.LlamaConfig, params: llama.Params,
          pkv: Cache, tokens: torch.Tensor,
          rope: Rope, attend, tp: Optional[TPGroup] = None) -> torch.Tensor:
    """A whole :class:`_Step`: logits [slots, R, vocab] fp32."""
    step = _Step(config, params, pkv, tokens, rope, attend, tp)
    for i in range(config.n_layers):
        step.layer(i)
    return step.logits()


def _decode_attend(config: llama.LlamaConfig, pkv: Cache,
                   block_tables: torch.Tensor, positions: torch.Tensor,
                   tp: Optional[TPGroup] = None):
    """A decode step's ``attend``: append each slot's token K/V at
    ``positions``, then one decode launch over lengths positions + 1."""
    slots = positions.shape[0]
    _, hkv, hd = _heads(config, tp)
    group = config.n_heads // config.n_kv_heads

    def attend(i, q, k, v):
        kv = _layer_pages(pkv, i)
        _write_token(pkv, i, kv, k[:, 0], v[:, 0], block_tables, positions)
        att = paged_attn.paged_decode_attention(
            q[:, 0].reshape(slots, hkv, group, hd).contiguous(),
            kv['k_pages'], kv['v_pages'], block_tables, positions + 1,
            **_scales(kv))
        return att.reshape(slots, 1, -1)
    return attend


def _bump(pkv: Cache,
          active: Optional[torch.Tensor]) -> None:
    if active is None:
        pkv.lengths += 1
    else:
        pkv.lengths += active.to(pkv.lengths.dtype)


def paged_decode_step(config: llama.LlamaConfig, params: llama.Params,
                      pkv: paged_cache_lib.PagedKVCache,
                      block_tables: torch.Tensor, tokens: torch.Tensor,
                      rope: Rope, active: Optional[torch.Tensor] = None,
                      tp: Optional[TPGroup] = None
                      ) -> Tuple[torch.Tensor,
                                 paged_cache_lib.PagedKVCache]:
    """One token for every slot over the paged cache. tokens: [slots];
    block_tables: [slots, maxp] int32, covering position lengths[slot]
    of every active slot. Inactive slots compute garbage whose K/V row
    lands in their own frontier or the sink page; ``lengths`` advances
    only on ``active`` slots (all when None). Returns (logits
    [slots, vocab] fp32, cache)."""
    _check_paged(pkv, tp)
    attend = _decode_attend(config, pkv, block_tables, pkv.lengths.clone(),
                            tp)
    logits = _step(config, params, pkv, tokens[:, None], rope, attend,
                   tp)[:, 0]
    _bump(pkv, active)
    return logits, pkv


def paged_mixed_step(config: llama.LlamaConfig, params: llama.Params,
                     pkv: paged_cache_lib.PagedKVCache, slot: IntLike,
                     table_row: torch.Tensor, chunk_tokens: torch.Tensor,
                     offset: IntLike, true_len: IntLike,
                     block_tables: torch.Tensor,
                     decode_tokens: torch.Tensor, rope: Rope,
                     active: Optional[torch.Tensor] = None,
                     tp: Optional[TPGroup] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                paged_cache_lib.PagedKVCache]:
    """One prefill chunk of ``slot`` and one decode step of every slot
    in one call (the reference's ``paged_mixed_step``): arguments as in
    :func:`paged_prefill_chunk` and :func:`paged_decode_step`. The
    chunk's frontier (lengths[slot] = offset + true_len) is set first, so
    the decode half sees exactly the state the standalone chunk leaves;
    then each layer runs the chunk's layer and the decode's. The two
    halves' dense products stay separate (the chunk's [1, C] rows never
    join the decode's [slots, STEP_ROWS] block, whose shape fixes the
    decode rows' bits), so every value equals the standalone chunk's
    followed by the standalone decode step's. Returns (chunk logits
    [vocab], decode logits [slots, vocab], both fp32; cache)."""
    _check_paged(pkv, tp)
    C = chunk_tokens.shape[0]
    xc = _embed(params, chunk_tokens, tp)[None]
    cpos = offset + torch.arange(C, dtype=torch.int32,
                                 device=chunk_tokens.device)
    _set_length(pkv, slot, offset + true_len)
    step = _Step(config, params, pkv, decode_tokens[:, None], rope,
                 _decode_attend(config, pkv, block_tables,
                                pkv.lengths.clone(), tp), tp)
    for i in range(config.n_layers):
        xc = _chunk_layer(config, xc, i, params, pkv, slot, table_row,
                          cpos, offset, true_len, rope, tp)
        step.layer(i)
    chunk_logits = _chunk_logits(config, params, xc, true_len, tp)
    dec_logits = step.logits()[:, 0]
    _bump(pkv, active)
    return chunk_logits, dec_logits, pkv


def paged_verify_step(config: llama.LlamaConfig, params: llama.Params,
                      pkv: paged_cache_lib.PagedKVCache,
                      block_tables: torch.Tensor, tokens: torch.Tensor,
                      rope: Rope, tp: Optional[TPGroup] = None
                      ) -> Tuple[torch.Tensor, paged_cache_lib.PagedKVCache]:
    """Speculative verify over the paged cache: R = spec_k + 1 tokens for
    every slot. tokens: [slots, R], column 0 the slot's last token,
    columns 1..R-1 the (padded) drafts. Each layer writes the run's K/V
    at positions lengths[slot]..lengths[slot]+R-1 (positions past the
    block table's coverage go to the sink page), then every query
    attends through the cache and the run up to itself in one verify
    launch, each owned page read once for all R queries. ``lengths`` is
    NOT advanced: only the engine knows how many tokens it accepts.
    Returns (logits [slots, R, vocab] fp32, cache)."""
    _check_paged(pkv, tp)
    slots, R = tokens.shape
    _, hkv, hd = _heads(config, tp)
    group = config.n_heads // config.n_kv_heads
    lengths = pkv.lengths.clone()

    def attend(i, q, k, v):
        kv = _layer_pages(pkv, i)
        _write_run(pkv, i, kv, k, v, block_tables, lengths)
        att = paged_attn.paged_verify_attention(
            q.reshape(slots, R, hkv, group, hd).contiguous(),
            kv['k_pages'], kv['v_pages'], block_tables, lengths,
            **_scales(kv))
        return att.reshape(slots, R, -1)

    return _step(config, params, pkv, tokens, rope, attend, tp), pkv


# ---------------------------------------------------------------------------
# The dense cache: the same steps over its page view and identity table
# ---------------------------------------------------------------------------
def prefill_chunk(config: llama.LlamaConfig, params: llama.Params,
                  kv: cache_lib.KVCache, slot: IntLike, tokens: torch.Tensor,
                  offset: IntLike, true_len: IntLike, rope: Rope,
                  tp: Optional[TPGroup] = None
                  ) -> Tuple[cache_lib.KVCache, torch.Tensor]:
    """The reference's dense ``prefill_chunk``: one chunk of a prompt
    written into ``slot`` at rows offset..offset+C and attended causally
    over the slot's prefix plus itself, through the paged prefill kernel
    over the slot's identity row. Arguments and result as in
    :func:`paged_prefill_chunk` (offset a multiple of the cache's page)."""
    return paged_prefill_chunk(config, params, kv, slot,
                               cache_lib.table_row(kv, slot), tokens, offset,
                               true_len, rope, tp)


def decode_step(config: llama.LlamaConfig, params: llama.Params,
                kv: cache_lib.KVCache, tokens: torch.Tensor, rope: Rope,
                active: Optional[torch.Tensor] = None,
                tp: Optional[TPGroup] = None
                ) -> Tuple[torch.Tensor, cache_lib.KVCache]:
    """The reference's dense ``decode_step``: one token for every slot,
    its attention one decode launch over the identity table. Inactive
    slots write their garbage row at their own frontier and do not
    advance. Returns (logits [slots, vocab] fp32, cache)."""
    return paged_decode_step(config, params, kv, kv.tables, tokens, rope,
                             active, tp)


def verify_step(config: llama.LlamaConfig, params: llama.Params,
                kv: cache_lib.KVCache, tokens: torch.Tensor, rope: Rope,
                tp: Optional[TPGroup] = None
                ) -> Tuple[torch.Tensor, cache_lib.KVCache]:
    """The reference's dense ``verify_step``: R tokens for every slot, the
    run written with ``cache.append_run`` (positions past the cache end
    keep their value) and attended in one verify launch. ``lengths`` is
    not advanced. Returns (logits [slots, R, vocab] fp32, cache)."""
    return paged_verify_step(config, params, kv, kv.tables, tokens, rope, tp)


def mixed_step(config: llama.LlamaConfig, params: llama.Params,
               kv: cache_lib.KVCache, slot: IntLike,
               chunk_tokens: torch.Tensor, offset: IntLike,
               true_len: IntLike, decode_tokens: torch.Tensor, rope: Rope,
               active: Optional[torch.Tensor] = None,
               tp: Optional[TPGroup] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, cache_lib.KVCache]:
    """The reference's dense ``mixed_step``: one chunk of ``slot`` and one
    decode step of every slot in one call, layer by layer, as
    :func:`paged_mixed_step`. Returns (chunk logits [vocab], decode logits
    [slots, vocab], both fp32; cache)."""
    return paged_mixed_step(config, params, kv, slot,
                            cache_lib.table_row(kv, slot), chunk_tokens,
                            offset, true_len, kv.tables, decode_tokens, rope,
                            active, tp)
