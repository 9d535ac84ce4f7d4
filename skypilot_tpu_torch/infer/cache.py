"""Slotted dense KV cache (counterpart of ``skypilot_tpu/infer/cache.py``).

Device state:

    k, v:    [n_layers, n_kv_heads, n_slots, max_seq_len, head_dim]
    lengths: [n_slots] int32   tokens cached per slot
    tables:  [n_slots, max_seq_len / page] int32   the identity block table

One running sequence owns one slot of ``max_seq_len`` positions, as in the
reference; finishing frees the slot (its length goes to 0, the bytes stay).
The reference stores ``[L, slots, S, kv, hd]``; the port puts the KV heads
ahead of the slots, so that layer ``l``'s ``k[l]`` viewed as ``[hkv, slots *
S / page, page, hd]`` is a page pool in which slot ``s`` owns pages ``s * S /
page .. (s + 1) * S / page - 1`` (:func:`page_view`). The dense steps attend
through the paged kernels over that view and the fixed identity table
(:func:`identity_tables`); nothing is allocated or freed per page.

The writes are plain row indexing into the slot's own rows, with the
reference's meaning past the cache end: a one-token append at a position
>= S lands on row S - 1 (``dynamic_update_slice`` clamps its start), a run
keeps the value already there for its positions >= S, and a chunk's start
is clamped so the chunk ends at S. No write ever reaches another slot's
rows. (The paged writes instead send out-of-range positions to page 0,
which under the identity table is slot 0's first page.) All writes are in
place, where the reference returns new arrays.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple, Union

import torch

from skypilot_tpu_torch.ops import paged_attention as paged_attn

IntLike = Union[int, torch.Tensor]


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor        # [L, hkv, slots, S, hd]
    v: torch.Tensor        # [L, hkv, slots, S, hd]
    lengths: torch.Tensor  # [slots] int32
    tables: torch.Tensor   # [slots, S / page] int32, the identity table

    @property
    def n_slots(self) -> int:
        return self.k.shape[2]

    @property
    def max_seq_len(self) -> int:
        return self.k.shape[3]

    @property
    def page_size(self) -> int:
        return self.max_seq_len // self.tables.shape[1]

    def nbytes(self) -> int:
        """Device bytes of the K and V tensors."""
        return 2 * self.k.numel() * self.k.element_size()


def dense_page(max_seq_len: int, chunk: int) -> int:
    """The page of the dense cache's page view: the largest page the CUDA
    kernels take that divides both ``max_seq_len`` and the chunk cap (every
    chunk offset is a multiple of the cap). Where none does, their greatest
    common divisor: the plain versions take any page, and a CUDA launch
    then refuses the shape."""
    g = math.gcd(max_seq_len, chunk)
    fits = [p for p in paged_attn.CUDA_PAGE_SIZES if g % p == 0]
    return max(fits) if fits else g


def identity_tables(slots: int, max_seq_len: int, page: int,
                    device='cpu') -> torch.Tensor:
    """[slots, S / page] int32: slot ``s``'s row lists pages ``s * S /
    page`` onward, the pages its own rows form in the page view."""
    per_slot = max_seq_len // page
    return torch.arange(slots * per_slot, dtype=torch.int32,
                        device=device).reshape(slots, per_slot)


def init_cache(n_layers: int, n_slots: int, max_seq_len: int,
               n_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
               device='cpu', page: int = 64) -> KVCache:
    """A zeroed cache; ``page`` (dividing ``max_seq_len``) sets the page
    view the attention kernels read."""
    if max_seq_len % page:
        raise ValueError(f'max_seq_len {max_seq_len} is not a multiple of '
                         f'the page {page}')
    shape = (n_layers, n_kv_heads, n_slots, max_seq_len, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        lengths=torch.zeros((n_slots,), dtype=torch.int32, device=device),
        tables=identity_tables(n_slots, max_seq_len, page, device))


def page_view(cache: KVCache, layer: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer ``layer``'s K and V as page pools [hkv, slots * S / page,
    page, hd] (views: no copy; writes through the cache show in them)."""
    hkv, _, _, hd = cache.k.shape[1:]
    page = cache.page_size
    return (cache.k[layer].view(hkv, -1, page, hd),
            cache.v[layer].view(hkv, -1, page, hd))


def table_row(cache: KVCache, slot: IntLike) -> torch.Tensor:
    """Slot ``slot``'s identity row [S / page] (a 0-d device slot is
    looked up on the device)."""
    if isinstance(slot, torch.Tensor):
        return cache.tables.index_select(
            0, slot.to(cache.tables.device).long().reshape(1))[0]
    return cache.tables[slot]


def append_token(cache_k_layer: torch.Tensor, cache_v_layer: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 positions: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Append one token's K/V per slot at ``positions``, IN PLACE.

    cache_*_layer: [hkv, slots, S, hd]; k_new/v_new: [slots, hkv, hd];
    positions: [slots] int32 (the write offset = current length). A
    position >= S writes row S - 1 of its own slot, as the reference's
    ``dynamic_update_slice`` does."""
    slots, S = cache_k_layer.shape[1], cache_k_layer.shape[2]
    rows = torch.arange(slots, device=positions.device)
    pos = positions.long().clamp(max=S - 1)
    for cache, new in ((cache_k_layer, k_new), (cache_v_layer, v_new)):
        cache[:, rows, pos] = new.permute(1, 0, 2).to(cache.dtype)
    return cache_k_layer, cache_v_layer


def append_run(cache_k_layer: torch.Tensor, cache_v_layer: torch.Tensor,
               k_new: torch.Tensor, v_new: torch.Tensor,
               positions: torch.Tensor) -> Tuple[torch.Tensor,
                                                 torch.Tensor]:
    """Append a RUN of R tokens' K/V per slot at ``positions[slot] + i``,
    IN PLACE (the speculative verify write).

    cache_*_layer: [hkv, slots, S, hd]; k_new/v_new: [slots, R, hkv, hd];
    positions: [slots] int32 run starts. Positions past the cache end (a
    draft run padded beyond a near-full slot, an inactive slot's garbage
    lane) keep the value already there, as the reference's chained writes
    leave them. One write per tensor: every lane past the end is pointed
    at row S - 1 carrying the value that row ends with (the run's own
    token at S - 1 when the run reaches it, else the old row), so lanes
    that share the row agree on what they write."""
    slots, S = cache_k_layer.shape[1], cache_k_layer.shape[2]
    R = k_new.shape[1]
    dev = positions.device
    rows = torch.arange(slots, device=dev)[:, None]
    lanes = torch.arange(R, device=dev)[None, :]
    start = positions.long()[:, None]
    pos = (start + lanes).clamp(max=S - 1)                    # [slots, R]
    # The lane whose value each write carries: itself inside the cache,
    # else the lane that lands on S - 1 (-1 when none does).
    src = torch.minimum(lanes, (S - 1 - start).clamp(min=-1))
    keep = (src < 0)[None, :, :, None]
    gather = src.clamp(min=0)[:, :, None, None]
    for cache, new in ((cache_k_layer, k_new), (cache_v_layer, v_new)):
        run = new.gather(1, gather.expand(-1, -1, *new.shape[2:]))
        run = run.permute(2, 0, 1, 3).to(cache.dtype)       # [hkv, slots, R, hd]
        cache[:, rows, pos] = torch.where(keep, cache[:, rows, pos], run)
    return cache_k_layer, cache_v_layer


def write_chunk(cache_k_layer: torch.Tensor, cache_v_layer: torch.Tensor,
                k_new: torch.Tensor, v_new: torch.Tensor, slot: IntLike,
                offset: IntLike) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write a C-token chunk's K/V into ``slot`` at rows offset..offset+C,
    IN PLACE. k_new/v_new: [C, hkv, hd]. The start is clamped to S - C, as
    the reference's ``dynamic_update_slice`` clamps it (the engine keeps
    every chunk inside the cache, so the clamp never moves a real one).
    ``slot`` and ``offset`` are host integers or 0-d device tensors (then
    the rows are computed on the device, with no host sync)."""
    C = k_new.shape[0]
    S = cache_k_layer.shape[2]
    if isinstance(slot, torch.Tensor) or isinstance(offset, torch.Tensor):
        dev = cache_k_layer.device
        s = torch.as_tensor(slot, device=dev).long().reshape(1)
        start = torch.as_tensor(offset, device=dev).long().clamp(max=S - C)
        index = (slice(None), s, start + torch.arange(C, device=dev))
    else:
        start = min(int(offset), S - C)
        index = (slice(None), int(slot), slice(start, start + C))
    for cache, new in ((cache_k_layer, k_new), (cache_v_layer, v_new)):
        cache[index] = new.permute(1, 0, 2).to(cache.dtype)
    return cache_k_layer, cache_v_layer


def free_slot(cache: KVCache, slot: int) -> KVCache:
    """Mark a slot reusable, in place: its length goes to 0; the K/V bytes
    stay (unreachable past the length), so no memset on the hot path."""
    cache.lengths[slot] = 0
    return cache
