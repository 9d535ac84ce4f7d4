"""Paged attention over a block-table KV cache (counterpart of
``skypilot_tpu/ops/paged_attention.py``).

Layout (per layer), as in the reference:

    k_pages, v_pages: [n_kv_heads, n_pages, page_size, head_dim]
    block_tables:     [n_slots, max_pages] int32  (page ids)
    lengths:          [n_slots] int32             (tokens per slot)

Two attention entry points, each with a plain PyTorch version beside it:

- ``paged_decode_attention``: one query token per slot; on a CUDA tensor
  it launches ``csrc/paged_decode.cu``.
- ``paged_prefill_attention``: a C-token chunk of one slot, causal over
  its cached prefix plus itself; on a CUDA tensor it launches
  ``csrc/paged_prefill.cu``.

A wrapper runs the plain version only because the tensors it was given
lie on the CPU; on CUDA tensors it launches its kernel or raises. Each
wrapper adds one to its entry of :data:`launches` where it launches its
kernel, and nowhere else, so a run can show that its main path went
through the kernels.

The cache writes (``write_chunk_pages``, ``append_token_pages``) are the
reference's XLA scatters as indexed assignment, bf16 pages only; the
int8 flavor is a later slice of the port.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple, Union

import torch

_NEG_INF = -1e30

# Kernel launches per wrapper since the process started (or the last
# reset_launches()).
launches: Dict[str, int] = {'paged_decode_attention': 0,
                            'paged_prefill_attention': 0}

IntLike = Union[int, torch.Tensor]

# The shapes the CUDA kernels take. ``chip_smoke.py`` holds every
# combination of these against the plain versions on the card; any
# other shape raises rather than reach an unchecked kernel variant.
CUDA_HEAD_DIMS = (64, 128)
CUDA_PAGE_SIZES = (16, 32, 64)
CUDA_GROUPS = (1, 2, 4, 8)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# Plain versions (ground truth in tests; the CPU path of the wrappers)
# ---------------------------------------------------------------------------
def paged_decode_attention_reference(
        q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
        block_tables: torch.Tensor, lengths: torch.Tensor, *,
        sm_scale: Optional[float] = None) -> torch.Tensor:
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
    k = k_pages[:, tables].float().permute(1, 0, 2, 3, 4).reshape(
        slots, hkv, maxp * page, hd)
    v = v_pages[:, tables].float().permute(1, 0, 2, 3, 4).reshape(
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
        sm_scale: Optional[float] = None) -> torch.Tensor:
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
    k = k_pages[:, row].float().reshape(hkv, maxp * page, hd)
    v = v_pages[:, row].float().reshape(hkv, maxp * page, hd)
    s = torch.einsum('ckgd,ksd->ckgs', q.float(), k) * sm_scale
    qpos = int(offset) + torch.arange(C, device=q.device)
    kpos = torch.arange(maxp * page, device=q.device)
    mask = kpos[None, :] <= qpos[:, None]       # [C, S]
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum('ckgs,ksd->ckgd', p, v)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    'paged_decode_attention_bf16': (
        'paged_decode',
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P]),
    'paged_prefill_attention_bf16': (
        'paged_prefill',
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]),
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


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devices = {t.device.type for t in tensors}
    if devices == {'cpu'}:
        return True
    if devices != {'cuda'}:
        raise ValueError(f'tensors must all lie on the CPU or all on one '
                         f'CUDA device, got {sorted(devices)}')
    return False


def check_cuda_shape(head_dim: int, group: int, page: int) -> None:
    """Raise ValueError unless the CUDA kernels take this head_dim,
    query-heads-per-KV-head group and page size."""
    if head_dim not in CUDA_HEAD_DIMS or group not in CUDA_GROUPS \
            or page not in CUDA_PAGE_SIZES:
        raise ValueError(
            f'the CUDA paged attention kernels take head_dim in '
            f'{CUDA_HEAD_DIMS}, group in {CUDA_GROUPS} and page_size in '
            f'{CUDA_PAGE_SIZES}; got head_dim {head_dim}, group {group}, '
            f'page_size {page}')


def _check_cuda(name: str, q, k_pages, v_pages, *index_tensors) -> None:
    if q.dtype != torch.bfloat16 or k_pages.dtype != torch.bfloat16 \
            or v_pages.dtype != torch.bfloat16:
        raise TypeError(f'{name}: the CUDA kernel takes bf16 q and pages, '
                        f'got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}')
    for t in index_tensors:
        if t.dtype != torch.int32:
            raise TypeError(f'{name}: block tables and lengths must be '
                            f'int32, got {t.dtype}')
    for t in (q, k_pages, v_pages, *index_tensors):
        if not t.is_contiguous():
            raise ValueError(f'{name}: inputs must be contiguous')
        if t.device != q.device:
            raise ValueError(f'{name}: inputs must share one device')
    if k_pages.shape != v_pages.shape:
        raise ValueError(f'{name}: k/v page shapes differ: '
                         f'{tuple(k_pages.shape)} vs {tuple(v_pages.shape)}')
    if k_pages.shape[0] != q.shape[1] or k_pages.shape[3] != q.shape[3]:
        raise ValueError(f'{name}: q {tuple(q.shape)} does not match pages '
                         f'{tuple(k_pages.shape)}')
    check_cuda_shape(q.shape[3], q.shape[2], k_pages.shape[2])


def _raise_on(err: int, name: str, shape) -> None:
    if err == -1:
        raise ValueError(f'{name}: the CUDA kernel does not take shape '
                         f'{shape}')
    if err:
        raise RuntimeError(f'{name}: kernel launch failed with CUDA error '
                           f'{err}')


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor,
                           block_tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           sm_scale: Optional[float] = None
                           ) -> torch.Tensor:
    """One decode token for every slot over the paged cache.

    q: [slots, hkv, group, hd]; k_pages/v_pages: [hkv, P, page, hd];
    block_tables: [slots, maxp] int32; lengths: [slots] int32 (attends
    to positions < length: callers that write the new token's K/V first
    pass the already-bumped length). Returns [slots, hkv, group, hd]
    fp32. CPU tensors take the plain version; CUDA tensors launch
    ``csrc/paged_decode.cu`` (bf16 q and pages, the shapes of
    :func:`check_cuda_shape`) or raise."""
    if _on_cpu(q, k_pages, v_pages, block_tables, lengths):
        return paged_decode_attention_reference(
            q, k_pages, v_pages, block_tables, lengths, sm_scale=sm_scale)
    name = 'paged_decode_attention'
    _check_cuda(name, q, k_pages, v_pages, block_tables, lengths)
    slots, hkv, group, hd = q.shape
    _, n_pages, page, _ = k_pages.shape
    if block_tables.shape[0] != slots or lengths.shape != (slots,):
        raise ValueError(f'{name}: tables {tuple(block_tables.shape)} / '
                         f'lengths {tuple(lengths.shape)} do not match '
                         f'{slots} slots')
    if sm_scale is None:
        sm_scale = hd ** -0.5
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel('paged_decode_attention_bf16')(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        slots, hkv, group, hd, n_pages, page, block_tables.shape[1],
        float(sm_scale), stream)
    _raise_on(err, name, (tuple(q.shape), tuple(k_pages.shape)))
    launches[name] += 1
    return out


def paged_prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor,
                            table_row: torch.Tensor, offset: IntLike,
                            true_len: IntLike, *,
                            sm_scale: Optional[float] = None
                            ) -> torch.Tensor:
    """One prompt chunk of ONE slot attending over its paged prefix.

    q: [C, hkv, group, hd] (global positions offset..offset+C-1, the
    chunk's K/V already written into the pages); table_row: [maxp]
    int32; offset (page-aligned, not necessarily C-aligned) and true_len
    are host integers. Rows past true_len are pad whose values the
    caller discards. Returns [C, hkv, group, hd] fp32. CPU tensors take
    the plain version; CUDA tensors launch ``csrc/paged_prefill.cu``
    (bf16 q and pages, the shapes of :func:`check_cuda_shape`) or
    raise."""
    if _on_cpu(q, k_pages, v_pages, table_row):
        return paged_prefill_attention_reference(
            q, k_pages, v_pages, table_row, offset, true_len,
            sm_scale=sm_scale)
    name = 'paged_prefill_attention'
    _check_cuda(name, q, k_pages, v_pages, table_row)
    C, hkv, group, hd = q.shape
    _, n_pages, page, _ = k_pages.shape
    offset, true_len = int(offset), int(true_len)
    maxp = table_row.shape[0]
    if not 1 <= true_len <= C or offset % page \
            or -(-(offset + true_len) // page) > maxp:
        raise ValueError(f'{name}: offset {offset} / true_len {true_len} '
                         f'outside a {C}-token chunk over {maxp} pages of '
                         f'{page}')
    if sm_scale is None:
        sm_scale = hd ** -0.5
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel('paged_prefill_attention_bf16')(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        table_row.data_ptr(), out.data_ptr(), C, hkv, group, hd, n_pages,
        page, offset, true_len, float(sm_scale), stream)
    _raise_on(err, name, (tuple(q.shape), tuple(k_pages.shape)))
    launches[name] += 1
    return out


# ---------------------------------------------------------------------------
# Paged cache writes
# ---------------------------------------------------------------------------
def write_chunk_pages(k_pages: torch.Tensor, v_pages: torch.Tensor,
                      k_new: torch.Tensor, v_new: torch.Tensor,
                      table_row: torch.Tensor, offset: IntLike
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write a C-token chunk's K/V into a slot's pages, IN PLACE.

    k_new/v_new: [C, hkv, hd] with C a multiple of page_size and offset
    page-aligned (the engine's chunk cap guarantees both), so the chunk
    covers whole pages at table-looked-up page ids. Returns the (same,
    updated) page tensors."""
    C, hkv, hd = k_new.shape
    page = k_pages.shape[2]
    if C % page:
        raise ValueError(f'chunk {C} is not a multiple of page {page}')
    n = C // page
    first = int(offset) // page
    pids = table_row[first:first + n].long()
    k_pages[:, pids] = k_new.permute(1, 0, 2).to(k_pages.dtype).reshape(
        hkv, n, page, hd)
    v_pages[:, pids] = v_new.permute(1, 0, 2).to(v_pages.dtype).reshape(
        hkv, n, page, hd)
    return k_pages, v_pages


def append_token_pages(k_pages: torch.Tensor, v_pages: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor,
                       block_tables: torch.Tensor, lengths: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Append one token's K/V per slot at position lengths[slot], IN
    PLACE: slot i's row lands in page table[i, len//page] at row
    len%page. k_new/v_new: [slots, hkv, hd]. Inactive slots (zeroed
    table rows) write into the sink page 0; a position past the table's
    coverage is redirected there too. Returns the (same, updated) page
    tensors."""
    page = k_pages.shape[2]
    maxp = block_tables.shape[1]
    col = (lengths // page).long()
    pids = block_tables.gather(1, col.clamp(max=maxp - 1)[:, None])[:, 0]
    pids = torch.where(col < maxp, pids.long(), torch.zeros_like(col))
    rows = (lengths % page).long()
    k_pages[:, pids, rows] = k_new.permute(1, 0, 2).to(k_pages.dtype)
    v_pages[:, pids, rows] = v_new.permute(1, 0, 2).to(v_pages.dtype)
    return k_pages, v_pages
