"""Paged KV cache: block tables over a shared page pool (counterpart of
``skypilot_tpu/infer/paged_cache.py``).

Device state:

    k_pages, v_pages:   [n_layers, n_kv_heads, n_pages, page, head_dim]
    lengths:            [n_slots] int32
    k_scales, v_scales: [n_layers, n_kv_heads, n_pages, page] fp32, on
                        int8 pages only (one absmax scale per cached row,
                        pool-aligned with the pages); None on bf16 pages

Host state: the :class:`PageAllocator` (free-page stack, refcounts and
per-slot block tables), a copy of the reference's, since the port
imports nothing of the JAX package. The port mutates the device tensors
in place where the reference returns new arrays.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class PagedKVCache:
    k_pages: torch.Tensor   # [L, hkv, P, page, hd]
    v_pages: torch.Tensor   # [L, hkv, P, page, hd]
    lengths: torch.Tensor   # [slots] int32
    k_scales: Optional[torch.Tensor] = None   # [L, hkv, P, page] fp32
    v_scales: Optional[torch.Tensor] = None

    @property
    def n_pages(self) -> int:
        return self.k_pages.shape[2]

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]


def init_paged_cache(n_layers: int, n_slots: int, n_pages: int,
                     page_size: int, n_kv_heads: int, head_dim: int,
                     dtype=torch.bfloat16, device='cpu') -> PagedKVCache:
    """Zeroed pages of ``dtype``; ``torch.int8`` adds zeroed fp32 row
    scales beside them."""
    shape = (n_layers, n_kv_heads, n_pages, page_size, head_dim)
    scales = ({'k_scales': torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device),
               'v_scales': torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)}
              if dtype == torch.int8 else {})
    return PagedKVCache(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device),
        lengths=torch.zeros((n_slots,), dtype=torch.int32, device=device),
        **scales)


def free_slot(cache: PagedKVCache, slot: int) -> PagedKVCache:
    """Device half of freeing: zero the slot's length, in place (the
    allocator's ``free`` is the host half)."""
    cache.lengths[slot] = 0
    return cache


def copy_page(cache: PagedKVCache, src: int, dst: int) -> PagedKVCache:
    """Device half of copy-on-write: duplicate physical page ``src``
    into ``dst`` across all layers and heads, in place, its row scales
    with it on int8 pages."""
    for t in (cache.k_pages, cache.v_pages, cache.k_scales, cache.v_scales):
        if t is not None:
            t[:, :, dst] = t[:, :, src]
    return cache


class PageAllocator:
    """Host-side free-page stack + per-slot block tables.

    Never touches the device: ``table()`` snapshots the current
    [slots, max_pages] int32 block table for the next step. Freed pages
    go back on the stack; their bytes stay on the device untouched (a
    slot's length makes stale pages unreachable).

    Pages are refcounted: ``extend`` hands out fresh pages at refcount
    1, ``attach`` maps already-resident pages into a slot (refcount++),
    and a page returns to the free stack only when its last reference
    drops. Engine-thread confined: it has no lock of its own.
    """

    def __init__(self, n_pages: int, page_size: int, n_slots: int,
                 max_pages_per_slot: int) -> None:
        self.page_size = page_size
        self.n_pages = n_pages
        self.max_pages_per_slot = max_pages_per_slot
        # Page 0 is the GARBAGE SINK, never allocated: the decode step
        # runs over every slot, so inactive slots still scatter a
        # garbage K/V row at table[slot, 0] -- with the table zeroed
        # that is page 0, which therefore belongs to nobody.
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._owned: List[List[int]] = [[] for _ in range(n_slots)]
        self._table = np.zeros((n_slots, max_pages_per_slot), np.int32)
        self._ref = np.zeros((n_pages,), np.int32)
        # Bumped on every table mutation: the engine keys its device
        # copy of the block table on it and uploads only on change.
        self.version = 0

    # -- queries -----------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_of(self, slot: int) -> int:
        return len(self._owned[slot])

    def owned_pages(self, slot: int) -> List[int]:
        return list(self._owned[slot])

    def page_at(self, slot: int, idx: int) -> int:
        """One page id, no list copy (per-token hot-path accessor)."""
        return self._owned[slot][idx]

    def refcount(self, pid: int) -> int:
        return int(self._ref[pid])

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def table(self) -> np.ndarray:
        """Current block table (a copy)."""
        return self._table.copy()

    # -- allocation --------------------------------------------------------
    def extend(self, slot: int, upto_tokens: int) -> bool:
        """Grow ``slot`` to cover ``upto_tokens`` positions. All or
        nothing: returns False, allocating nothing, when the pool or the
        per-slot ceiling cannot cover it."""
        need = self.pages_needed(upto_tokens) - len(self._owned[slot])
        if need <= 0:
            return True
        if need > len(self._free):
            return False
        if self.pages_needed(upto_tokens) > self.max_pages_per_slot:
            return False
        for _ in range(need):
            pid = self._free.pop()
            self._ref[pid] = 1
            self._table[slot, len(self._owned[slot])] = pid
            self._owned[slot].append(pid)
        self.version += 1
        return True

    def alloc_pages(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` fresh pages at refcount 1 WITHOUT binding them to a
        slot: a KV import lands pulled pages in the prefix tree directly,
        owned by the tree's reference alone until a slot attaches them.
        All or nothing; None when the pool cannot cover it. The caller
        must hand every returned page to the tree (or decref it)."""
        if n > len(self._free):
            return None
        out: List[int] = []
        for _ in range(n):
            pid = self._free.pop()
            self._ref[pid] = 1
            out.append(pid)
        return out

    # -- reference counting ------------------------------------------------
    def incref(self, pid: int) -> None:
        self._ref[pid] += 1

    def decref(self, pid: int) -> None:
        """Drop one reference; the page returns to the free stack when
        the last reference goes (never the sink page)."""
        if self._ref[pid] <= 0:
            raise AssertionError(f'double-free of page {pid}')
        self._ref[pid] -= 1
        if self._ref[pid] == 0 and pid != 0:
            self._free.append(pid)

    def attach(self, slot: int, pids: List[int]) -> None:
        """Map already-resident pages as the prefix of an empty slot's
        block table, taking one reference on each."""
        if self._owned[slot]:
            raise AssertionError('attach on a non-empty slot')
        if len(pids) > self.max_pages_per_slot:
            raise AssertionError('attach beyond the per-slot ceiling')
        for i, pid in enumerate(pids):
            self.incref(pid)
            self._table[slot, i] = pid
        self._owned[slot] = list(pids)
        if pids:
            self.version += 1

    def clear_slot(self, slot: int) -> None:
        """Reset a slot's table WITHOUT touching refcounts, for a caller
        (``PrefixCache.donate``) that already disposed of every reference
        the slot held."""
        if self._owned[slot]:
            self.version += 1
        self._owned[slot] = []
        self._table[slot, :] = 0

    def cow(self, slot: int, page_idx: int) -> Optional[tuple]:
        """Copy-on-write the slot's page at ``page_idx``: swap in a fresh
        private page and drop the slot's reference on the shared one.
        Returns (src_pid, dst_pid) for :func:`copy_page`, or None when the
        page is not shared or the pool has no free page."""
        pid = self._owned[slot][page_idx]
        if self._ref[pid] <= 1:
            return None
        if not self._free:
            return None
        dst = self._free.pop()
        self._ref[dst] = 1
        self.decref(pid)
        self._owned[slot][page_idx] = dst
        self._table[slot, page_idx] = dst
        self.version += 1
        return pid, dst

    def shrink(self, slot: int, upto_tokens: int) -> int:
        """Trim the slot's tail pages down to what covers
        ``upto_tokens`` positions. Returns the number of pages
        released."""
        keep = max(self.pages_needed(max(upto_tokens, 0)), 0)
        dropped = 0
        while len(self._owned[slot]) > keep:
            pid = self._owned[slot].pop()
            self._table[slot, len(self._owned[slot])] = 0
            self.decref(pid)
            dropped += 1
        if dropped:
            self.version += 1
        return dropped

    def free(self, slot: int) -> None:
        """Drop the slot's reference on all of its pages."""
        if self._owned[slot]:
            self.version += 1
        for pid in reversed(self._owned[slot]):
            self.decref(pid)
        self._owned[slot] = []
        self._table[slot, :] = 0

    def used_tokens_capacity(self) -> int:
        """Tokens coverable by currently-owned pages (observability)."""
        return sum(len(o) for o in self._owned) * self.page_size
