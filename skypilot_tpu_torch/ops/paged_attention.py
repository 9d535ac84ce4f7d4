"""Paged attention over a block-table KV cache (counterpart of
``skypilot_tpu/ops/paged_attention.py``).

Layout (per layer), as in the reference:

    k_pages, v_pages: [n_kv_heads, n_pages, page_size, head_dim]
    block_tables:     [n_slots, max_pages] int32  (page ids)
    lengths:          [n_slots] int32             (tokens per slot)

int8 pages (``kv_dtype='int8'``) hold int8 values plus one fp32 absmax
scale per cached row per KV head, ``k_scales/v_scales: [hkv, P, page]``,
pool-aligned with the pages: rows are quantized on write
(:func:`quantize_rows`) and dequantized in the kernel, row by row, before
the products.

Three attention entry points, each with a plain PyTorch version beside
it, each taking optional ``k_scales``/``v_scales`` (given: the int8
flavor):

- ``paged_decode_attention``: one query token per slot; on CUDA tensors
  it launches ``csrc/paged_decode.cu``.
- ``paged_verify_attention``: R = spec_k + 1 query tokens per slot (the
  speculative verify step); the same templated body in
  ``csrc/paged_decode.cu``, of which decode is the one-query instance.
- ``paged_prefill_attention``: a C-token chunk of one slot, causal over
  its cached prefix plus itself; on CUDA tensors it launches
  ``csrc/paged_prefill.cu``.

A wrapper runs the plain version only because the tensors it was given
lie on the CPU; on CUDA tensors it launches its kernel or raises (int8
pages never reach a bf16 kernel or a plain version). Each wrapper adds
one to its entry of :data:`launches` where it launches its kernel, and
nowhere else, so a run can show that its main path went through the
kernels.

The cache writes (``write_chunk_pages``, ``append_token_pages``,
``append_run_pages``) are the reference's XLA scatters as indexed
assignment, in place; with scales they quantize on write.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple, Union

import torch

_NEG_INF = -1e30

# Kernel launches per wrapper and flavor since the process started (or
# the last reset_launches()).
launches: Dict[str, int] = {
    'paged_decode_attention': 0,
    'paged_prefill_attention': 0,
    'paged_verify_attention': 0,
    'paged_decode_attention_int8': 0,
    'paged_prefill_attention_int8': 0,
    'paged_verify_attention_int8': 0,
}

IntLike = Union[int, torch.Tensor]

# The shapes the CUDA kernels take. ``chip_smoke.py`` holds every
# combination of these against the plain versions on the card; any
# other shape raises rather than reach an unchecked kernel variant.
CUDA_HEAD_DIMS = (64, 128)
CUDA_PAGE_SIZES = (16, 32, 64)
CUDA_GROUPS = (1, 2, 4, 8)
# Verify queries per slot (spec_k 1..7), with at most CUDA_MAX_ROWS
# query rows (queries x group) per (slot, KV head) block.
CUDA_VERIFY_QUERIES = tuple(range(2, 9))
CUDA_MAX_ROWS = 64
# The decode/verify kernel splits a slot's pages across blocks, this many
# consecutive pages to a split (by page index alone); it equals
# kPagesPerSplit in csrc/paged_decode.cu, checked at the first launch.
PAGES_PER_SPLIT = 4
# The same for the prefill kernel: a chunk's prefix pages split across
# blocks, kPagesPerSplit in csrc/paged_prefill.cu.
PREFILL_PAGES_PER_SPLIT = 16

# Per (kernel, CUDA device): a split kernel's workspace and counters,
# grown when a launch needs more (launches that share them are ordered on
# one stream).
_split_buffers: Dict[Tuple[str, torch.device],
                     Tuple[torch.Tensor, torch.Tensor]] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# int8 row quantization (quant-on-write / dequant-in-kernel)
# ---------------------------------------------------------------------------
def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization over the trailing head_dim
    axis, the reference's rules: ``(values int8[...], scales
    fp32[...[:-1]])`` with ``x ≈ values * scales[..., None]``, scale =
    absmax / 127, round half to even, clip to ±127, and an all-zero row
    gets scale 1.0."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _deq(pages: torch.Tensor, scales: Optional[torch.Tensor]
         ) -> torch.Tensor:
    """Plain-path dequant: fp32 values, the scale applied per row."""
    out = pages.float()
    if scales is not None:
        out = out * scales.float()[..., None]
    return out


def _gather(pages, scales, index):
    """Pages (dequantized when scales are given) at page ids ``index``:
    [hkv, *index.shape, page, hd] fp32."""
    return _deq(pages[:, index], None if scales is None
                else scales[:, index])


# ---------------------------------------------------------------------------
# Plain versions (ground truth in tests; the CPU path of the wrappers)
# ---------------------------------------------------------------------------
def paged_decode_attention_reference(
        q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
        block_tables: torch.Tensor, lengths: torch.Tensor, *,
        sm_scale: Optional[float] = None,
        k_scales: Optional[torch.Tensor] = None,
        v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: [slots, hkv, group, hd]; pages: [hkv, P, page, hd];
    block_tables: [slots, maxp]; lengths: [slots]. Attends to positions
    < lengths[slot]. Returns [slots, hkv, group, hd] fp32."""
    slots, hkv, group, hd = q.shape
    page = k_pages.shape[2]
    maxp = block_tables.shape[1]
    if sm_scale is None:
        sm_scale = hd ** -0.5
    tables = block_tables.long()
    # Gather each slot's pages: [slots, hkv, maxp*page, hd].
    k = _gather(k_pages, k_scales, tables).permute(1, 0, 2, 3, 4).reshape(
        slots, hkv, maxp * page, hd)
    v = _gather(v_pages, v_scales, tables).permute(1, 0, 2, 3, 4).reshape(
        slots, hkv, maxp * page, hd)
    s = torch.einsum('bkgd,bksd->bkgs', q.float(), k) * sm_scale
    pos = torch.arange(maxp * page, device=q.device)[None, None, None, :]
    s = torch.where(pos < lengths.long()[:, None, None, None], s,
                    torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum('bkgs,bksd->bkgd', p, v)


def paged_prefill_attention_reference(
        q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
        table_row: torch.Tensor, offset: IntLike, true_len: IntLike, *,
        sm_scale: Optional[float] = None,
        k_scales: Optional[torch.Tensor] = None,
        v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: [C, hkv, group, hd] (chunk queries of ONE slot, global
    positions offset..offset+C); pages: [hkv, P, page, hd]; table_row:
    [maxp]. Causal over prefix+chunk: query at global position i attends
    to cached positions <= i. Returns [C, hkv, group, hd] fp32."""
    del true_len   # rows past it are garbage the caller drops
    C, hkv, group, hd = q.shape
    page = k_pages.shape[2]
    maxp = table_row.shape[0]
    if sm_scale is None:
        sm_scale = hd ** -0.5
    row = table_row.long()
    k = _gather(k_pages, k_scales, row).reshape(hkv, maxp * page, hd)
    v = _gather(v_pages, v_scales, row).reshape(hkv, maxp * page, hd)
    s = torch.einsum('ckgd,ksd->ckgs', q.float(), k) * sm_scale
    qpos = int(offset) + torch.arange(C, device=q.device)
    kpos = torch.arange(maxp * page, device=q.device)
    mask = kpos[None, :] <= qpos[:, None]       # [C, S]
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum('ckgs,ksd->ckgd', p, v)


def paged_verify_attention_reference(
        q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
        block_tables: torch.Tensor, lengths: torch.Tensor, *,
        sm_scale: Optional[float] = None,
        k_scales: Optional[torch.Tensor] = None,
        v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: [slots, R, hkv, group, hd], R = spec_k + 1 verify queries per
    slot at positions lengths[slot]..lengths[slot]+R-1 (their K/V
    already written). Query i attends to positions < lengths[slot] + i
    + 1. Returns [slots, R, hkv, group, hd] fp32."""
    slots, R, hkv, group, hd = q.shape
    page = k_pages.shape[2]
    maxp = block_tables.shape[1]
    if sm_scale is None:
        sm_scale = hd ** -0.5
    tables = block_tables.long()
    k = _gather(k_pages, k_scales, tables).permute(1, 0, 2, 3, 4).reshape(
        slots, hkv, maxp * page, hd)
    v = _gather(v_pages, v_scales, tables).permute(1, 0, 2, 3, 4).reshape(
        slots, hkv, maxp * page, hd)
    s = torch.einsum('brkgd,bksd->brkgs', q.float(), k) * sm_scale
    pos = torch.arange(maxp * page, device=q.device)
    horizon = (lengths.long()[:, None]
               + torch.arange(R, device=q.device)[None, :] + 1)
    valid = pos[None, None, :] < horizon[:, :, None]   # [slots, R, S]
    s = torch.where(valid[:, :, None, None, :], s,
                    torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum('brkgs,bksd->brkgd', p, v)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry point -> (csrc library, argument types): the pointers (q,
# pages, the int8 flavor's scales, tables/lengths or the table row, out,
# the split workspace and counters), the integer shape arguments,
# sm_scale and the stream; and each source's pages per split.
_SIGNATURES = {
    'paged_decode_attention_bf16': (
        'paged_decode', [_P] * 8 + [_I] * 7 + [_F, _P]),
    'paged_decode_attention_int8': (
        'paged_decode', [_P] * 10 + [_I] * 7 + [_F, _P]),
    'paged_verify_attention_bf16': (
        'paged_decode', [_P] * 8 + [_I] * 8 + [_F, _P]),
    'paged_verify_attention_int8': (
        'paged_decode', [_P] * 10 + [_I] * 8 + [_F, _P]),
    'paged_pages_per_split': ('paged_decode', []),
    'paged_prefill_attention_bf16': (
        'paged_prefill', [_P] * 7 + [_I] * 8 + [_F, _P]),
    'paged_prefill_attention_int8': (
        'paged_prefill', [_P] * 9 + [_I] * 8 + [_F, _P]),
    'paged_prefill_pages_per_split': ('paged_prefill', []),
}


@functools.lru_cache(maxsize=None)
def _kernel(symbol: str):
    """The C entry point ``symbol``, its library built and bound on first
    use."""
    from skypilot_tpu_torch.ops import _build
    lib_name, argtypes = _SIGNATURES[symbol]
    fn = getattr(_build.library(lib_name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _on_cpu(*tensors: Optional[torch.Tensor]) -> bool:
    devices = {t.device.type for t in tensors if t is not None}
    if devices == {'cpu'}:
        return True
    if devices != {'cuda'}:
        raise ValueError(f'tensors must all lie on the CPU or all on one '
                         f'CUDA device, got {sorted(devices)}')
    return False


def check_cuda_shape(head_dim: int, group: int, page: int,
                     r_queries: int = 1) -> None:
    """Raise ValueError unless the CUDA kernels take this head_dim,
    query-heads-per-KV-head group and page size, and (``r_queries`` > 1,
    the verify kernel) this many queries per slot."""
    if head_dim not in CUDA_HEAD_DIMS or group not in CUDA_GROUPS \
            or page not in CUDA_PAGE_SIZES:
        raise ValueError(
            f'the CUDA paged attention kernels take head_dim in '
            f'{CUDA_HEAD_DIMS}, group in {CUDA_GROUPS} and page_size in '
            f'{CUDA_PAGE_SIZES}; got head_dim {head_dim}, group {group}, '
            f'page_size {page}')
    if r_queries != 1 and (r_queries not in CUDA_VERIFY_QUERIES
                           or r_queries * group > CUDA_MAX_ROWS):
        raise ValueError(
            f'the CUDA paged verify kernel takes {CUDA_VERIFY_QUERIES[0]}'
            f'..{CUDA_VERIFY_QUERIES[-1]} queries per slot (spec_k + 1) '
            f'with queries x group <= {CUDA_MAX_ROWS}; got {r_queries} '
            f'queries at group {group}')


def _check_cuda(name: str, q, k_pages, v_pages, k_scales, v_scales,
                *index_tensors) -> bool:
    """Validate a CUDA launch; returns whether the pages are int8."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError(f'{name}: pass both k_scales and v_scales or '
                         f'neither')
    quantized = k_scales is not None
    pages = torch.int8 if quantized else torch.bfloat16
    if q.dtype != torch.bfloat16 or k_pages.dtype != pages \
            or v_pages.dtype != pages:
        raise TypeError(
            f'{name}: the CUDA kernel takes bf16 q and '
            f'{"int8 pages with fp32 scales" if quantized else "bf16 pages"}'
            f', got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}'
            + ('' if quantized else ' (int8 pages need k_scales/v_scales)'))
    for t in index_tensors:
        if t.dtype != torch.int32:
            raise TypeError(f'{name}: block tables and lengths must be '
                            f'int32, got {t.dtype}')
    scales = (k_scales, v_scales) if quantized else ()
    for t in scales:
        if t.dtype != torch.float32 or t.shape != k_pages.shape[:3]:
            raise TypeError(f'{name}: scales must be fp32 '
                            f'{tuple(k_pages.shape[:3])}, got {t.dtype} '
                            f'{tuple(t.shape)}')
    for t in (q, k_pages, v_pages, *scales, *index_tensors):
        if not t.is_contiguous():
            raise ValueError(f'{name}: inputs must be contiguous')
        if t.device != q.device:
            raise ValueError(f'{name}: inputs must share one device')
    if k_pages.shape != v_pages.shape:
        raise ValueError(f'{name}: k/v page shapes differ: '
                         f'{tuple(k_pages.shape)} vs {tuple(v_pages.shape)}')
    if k_pages.shape[0] != q.shape[-3] or k_pages.shape[3] != q.shape[-1]:
        raise ValueError(f'{name}: q {tuple(q.shape)} does not match pages '
                         f'{tuple(k_pages.shape)}')
    r_queries = q.shape[1] if q.dim() == 5 else 1
    check_cuda_shape(q.shape[-1], q.shape[-2], k_pages.shape[2], r_queries)
    return quantized


@functools.lru_cache(maxsize=None)
def _checked_pages_per_split(symbol: str = 'paged_pages_per_split',
                             wrapper: int = PAGES_PER_SPLIT) -> int:
    """``wrapper`` (a kernel's pages per split as this module holds it),
    once the built library's ``symbol`` agrees."""
    built = _kernel(symbol)()
    if built != wrapper:
        raise RuntimeError(f'csrc/{_SIGNATURES[symbol][0]}.cu splits every '
                           f'{built} pages, the wrapper every {wrapper}')
    return built


def _scratch(kind: str, device: torch.device, n_ws: int, n_counters: int):
    """The workspace (``n_ws`` fp32) and counters (``n_counters`` int32,
    zero between launches: the kernels return them to zero) that ``kind``
    keeps on ``device``, grown when this launch needs more."""
    ws, counters = _split_buffers.get((kind, device), (None, None))
    if ws is None or ws.numel() < n_ws:
        ws = torch.empty(n_ws, dtype=torch.float32, device=device)
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(n_counters, dtype=torch.int32, device=device)
    _split_buffers[kind, device] = ws, counters
    return ws, counters


def _split_scratch(q: torch.Tensor, slots: int, hkv: int, rows: int,
                   hd: int, max_pages: int):
    """This device's decode/verify workspace (room for one fp32 partial
    of ``rows`` x (hd + 2) per slot, KV head and split) and counters
    (slots x hkv)."""
    n_splits = -(-max_pages // _checked_pages_per_split())
    return _scratch('decode', q.device,
                    slots * hkv * n_splits * rows * (hd + 2), slots * hkv)


def _prefill_scratch(q: torch.Tensor, hkv: int, rows: int, hd: int,
                     live_pages: int):
    """This device's prefill workspace (room for one fp32 partial of the
    chunk's ``rows`` x (hd + 2) per KV head and split of the
    ``live_pages`` pages up to the frontier) and counters (one per KV
    head and 16-row tile: enough for any row tile the kernel takes)."""
    n_splits = -(-live_pages // _checked_pages_per_split(
        'paged_prefill_pages_per_split', PREFILL_PAGES_PER_SPLIT))
    return _scratch('prefill', q.device, hkv * n_splits * rows * (hd + 2),
                    hkv * -(-rows // 16))


def _launch(name: str, quantized: bool, q, k_pages, v_pages, k_scales,
            v_scales, index, ints, sm_scale: float,
            scratch=()) -> torch.Tensor:
    """Allocate the fp32 output, launch the bf16 or int8 entry point of
    ``name`` on the current stream (``scratch``: buffers passed after the
    output), raise on a refused launch, count it."""
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scales = [k_scales.data_ptr(), v_scales.data_ptr()] if quantized else []
    err = _kernel(f'{name}_{"int8" if quantized else "bf16"}')(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), *scales,
        *[t.data_ptr() for t in index], out.data_ptr(),
        *[t.data_ptr() for t in scratch], *ints, float(sm_scale), stream)
    if err == -1:
        raise ValueError(f'{name}: the CUDA kernel does not take shape '
                         f'{(tuple(q.shape), tuple(k_pages.shape))}')
    if err:
        raise RuntimeError(f'{name}: kernel launch failed with CUDA error '
                           f'{err}')
    launches[name + ('_int8' if quantized else '')] += 1
    return out


def _check_slots(name, slots, block_tables, lengths) -> None:
    if block_tables.shape[0] != slots or lengths.shape != (slots,):
        raise ValueError(f'{name}: tables {tuple(block_tables.shape)} / '
                         f'lengths {tuple(lengths.shape)} do not match '
                         f'{slots} slots')


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor,
                           block_tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           sm_scale: Optional[float] = None,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """One decode token for every slot over the paged cache.

    q: [slots, hkv, group, hd]; k_pages/v_pages: [hkv, P, page, hd]
    (bf16, or int8 with fp32 ``k_scales``/``v_scales`` [hkv, P, page]);
    block_tables: [slots, maxp] int32; lengths: [slots] int32 (attends
    to positions < length: callers that write the new token's K/V first
    pass the already-bumped length). Returns [slots, hkv, group, hd]
    fp32. CPU tensors take the plain version; CUDA tensors launch
    ``csrc/paged_decode.cu`` (bf16 q, the shapes of
    :func:`check_cuda_shape`) or raise."""
    if _on_cpu(q, k_pages, v_pages, block_tables, lengths, k_scales,
               v_scales):
        return paged_decode_attention_reference(
            q, k_pages, v_pages, block_tables, lengths, sm_scale=sm_scale,
            k_scales=k_scales, v_scales=v_scales)
    name = 'paged_decode_attention'
    quantized = _check_cuda(name, q, k_pages, v_pages, k_scales, v_scales,
                            block_tables, lengths)
    slots, hkv, group, hd = q.shape
    _, n_pages, page, _ = k_pages.shape
    _check_slots(name, slots, block_tables, lengths)
    maxp = block_tables.shape[1]
    return _launch(name, quantized, q, k_pages, v_pages, k_scales, v_scales,
                   (block_tables, lengths),
                   (slots, hkv, group, hd, n_pages, page, maxp),
                   hd ** -0.5 if sm_scale is None else sm_scale,
                   _split_scratch(q, slots, hkv, group, hd, maxp))


def paged_verify_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor,
                           block_tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           sm_scale: Optional[float] = None,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Speculative verify: R = spec_k + 1 query tokens for every slot
    in one launch over the paged cache.

    q: [slots, R, hkv, group, hd]; lengths: [slots] int32, the length
    BEFORE the run (query i sits at position lengths[slot] + i and
    attends to positions < lengths[slot] + i + 1; the run's K/V must
    already be written, see :func:`append_run_pages`). Pages and scales
    as in :func:`paged_decode_attention`. Returns [slots, R, hkv, group,
    hd] fp32. Query 0's output is bitwise the decode kernel's for
    lengths + 1 (the exact-greedy acceptance rule rests on it). CPU
    tensors take the plain version; CUDA tensors launch the verify
    instance of ``csrc/paged_decode.cu`` or raise."""
    if _on_cpu(q, k_pages, v_pages, block_tables, lengths, k_scales,
               v_scales):
        return paged_verify_attention_reference(
            q, k_pages, v_pages, block_tables, lengths, sm_scale=sm_scale,
            k_scales=k_scales, v_scales=v_scales)
    name = 'paged_verify_attention'
    quantized = _check_cuda(name, q, k_pages, v_pages, k_scales, v_scales,
                            block_tables, lengths)
    slots, R, hkv, group, hd = q.shape
    _, n_pages, page, _ = k_pages.shape
    _check_slots(name, slots, block_tables, lengths)
    maxp = block_tables.shape[1]
    return _launch(name, quantized, q, k_pages, v_pages, k_scales, v_scales,
                   (block_tables, lengths),
                   (slots, R, hkv, group, hd, n_pages, page, maxp),
                   hd ** -0.5 if sm_scale is None else sm_scale,
                   _split_scratch(q, slots, hkv, R * group, hd, maxp))


def paged_prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor,
                            table_row: torch.Tensor, offset: IntLike,
                            true_len: IntLike, *,
                            sm_scale: Optional[float] = None,
                            k_scales: Optional[torch.Tensor] = None,
                            v_scales: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """One prompt chunk of ONE slot attending over its paged prefix.

    q: [C, hkv, group, hd] (global positions offset..offset+C-1, the
    chunk's K/V already written into the pages); table_row: [maxp]
    int32; offset (page-aligned, not necessarily C-aligned) and true_len
    are host integers. Pages and scales as in
    :func:`paged_decode_attention`. Rows past true_len are pad whose
    values the caller discards. Returns [C, hkv, group, hd] fp32. CPU
    tensors take the plain version; CUDA tensors launch
    ``csrc/paged_prefill.cu`` or raise."""
    if _on_cpu(q, k_pages, v_pages, table_row, k_scales, v_scales):
        return paged_prefill_attention_reference(
            q, k_pages, v_pages, table_row, offset, true_len,
            sm_scale=sm_scale, k_scales=k_scales, v_scales=v_scales)
    name = 'paged_prefill_attention'
    quantized = _check_cuda(name, q, k_pages, v_pages, k_scales, v_scales,
                            table_row)
    C, hkv, group, hd = q.shape
    _, n_pages, page, _ = k_pages.shape
    offset, true_len = int(offset), int(true_len)
    maxp = table_row.shape[0]
    if not 1 <= true_len <= C or offset % page \
            or -(-(offset + true_len) // page) > maxp:
        raise ValueError(f'{name}: offset {offset} / true_len {true_len} '
                         f'outside a {C}-token chunk over {maxp} pages of '
                         f'{page}')
    return _launch(name, quantized, q, k_pages, v_pages, k_scales, v_scales,
                   (table_row,),
                   (C, hkv, group, hd, n_pages, page, offset, true_len),
                   hd ** -0.5 if sm_scale is None else sm_scale,
                   _prefill_scratch(q, hkv, C * group, hd,
                                    -(-(offset + true_len) // page)))


# ---------------------------------------------------------------------------
# Paged cache writes
# ---------------------------------------------------------------------------
def _store(pages, scales, index, rows):
    """``pages[index] = rows`` (quantized on write into ``scales`` when
    given); rows: [hkv, ..., hd]."""
    if scales is None:
        pages[index] = rows.to(pages.dtype)
    else:
        values, row_scales = quantize_rows(rows)
        pages[index] = values
        scales[index] = row_scales


def _written(k_pages, v_pages, k_scales, v_scales):
    if k_scales is None:
        return k_pages, v_pages
    return k_pages, v_pages, k_scales, v_scales


def write_chunk_pages(k_pages: torch.Tensor, v_pages: torch.Tensor,
                      k_new: torch.Tensor, v_new: torch.Tensor,
                      table_row: torch.Tensor, offset: IntLike,
                      k_scales: Optional[torch.Tensor] = None,
                      v_scales: Optional[torch.Tensor] = None):
    """Write a C-token chunk's K/V into a slot's pages, IN PLACE.

    k_new/v_new: [C, hkv, hd] with C a multiple of page_size and offset
    page-aligned (the engine's chunk cap guarantees both), so the chunk
    covers whole pages at table-looked-up page ids. With
    ``k_scales``/``v_scales`` (int8 pages) the rows are quantized on
    write and their scales land beside them. Returns the (same, updated)
    tensors: ``(k_pages, v_pages)``, plus the scales on the int8
    flavor."""
    C, hkv, hd = k_new.shape
    page = k_pages.shape[2]
    if C % page:
        raise ValueError(f'chunk {C} is not a multiple of page {page}')
    n = C // page
    first = int(offset) // page
    pids = table_row[first:first + n].long()
    for pages, scales, new in ((k_pages, k_scales, k_new),
                               (v_pages, v_scales, v_new)):
        _store(pages, scales, (slice(None), pids),
               new.permute(1, 0, 2).reshape(hkv, n, page, hd))
    return _written(k_pages, v_pages, k_scales, v_scales)


def append_token_pages(k_pages: torch.Tensor, v_pages: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor,
                       block_tables: torch.Tensor, lengths: torch.Tensor,
                       k_scales: Optional[torch.Tensor] = None,
                       v_scales: Optional[torch.Tensor] = None):
    """Append one token's K/V per slot at position lengths[slot], IN
    PLACE: slot i's row lands in page table[i, len//page] at row
    len%page. k_new/v_new: [slots, hkv, hd]. Inactive slots (zeroed
    table rows) write into the sink page 0; a position past the table's
    coverage is redirected there too. Quantized on write with scales.
    Returns the (same, updated) tensors."""
    page = k_pages.shape[2]
    maxp = block_tables.shape[1]
    col = (lengths // page).long()
    pids = block_tables.gather(1, col.clamp(max=maxp - 1)[:, None])[:, 0]
    pids = torch.where(col < maxp, pids.long(), torch.zeros_like(col))
    rows = (lengths % page).long()
    for pages, scales, new in ((k_pages, k_scales, k_new),
                               (v_pages, v_scales, v_new)):
        _store(pages, scales, (slice(None), pids, rows),
               new.permute(1, 0, 2))
    return _written(k_pages, v_pages, k_scales, v_scales)


def append_run_pages(k_pages: torch.Tensor, v_pages: torch.Tensor,
                     k_new: torch.Tensor, v_new: torch.Tensor,
                     block_tables: torch.Tensor, lengths: torch.Tensor,
                     k_scales: Optional[torch.Tensor] = None,
                     v_scales: Optional[torch.Tensor] = None):
    """Append a RUN of R tokens' K/V per slot at positions ``lengths[slot]
    + i``, IN PLACE: the speculative verify write (the input token plus
    the padded draft candidates). k_new/v_new: [slots, R, hkv, hd].
    Positions past the slot's block-table coverage (padded drafts,
    inactive slots' garbage lanes) redirect to the SINK page 0, never to
    a live page through a clamped index. One vectorized write per tensor
    (the reference chains R scatters; they differ only in which garbage
    row wins where two lanes hit the sink at one row). Quantized on
    write with scales. Returns the (same, updated) tensors."""
    page = k_pages.shape[2]
    maxp = block_tables.shape[1]
    R = k_new.shape[1]
    pos = lengths.long()[:, None] + torch.arange(
        R, device=lengths.device)[None, :]                  # [slots, R]
    col = pos // page
    pids = block_tables.long().gather(1, col.clamp(max=maxp - 1))
    pids = torch.where(col < maxp, pids, torch.zeros_like(pids))
    rows = pos % page
    for pages, scales, new in ((k_pages, k_scales, k_new),
                               (v_pages, v_scales, v_new)):
        _store(pages, scales, (slice(None), pids, rows),
               new.permute(2, 0, 1, 3))
    return _written(k_pages, v_pages, k_scales, v_scales)
