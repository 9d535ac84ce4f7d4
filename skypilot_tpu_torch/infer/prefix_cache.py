"""Shared-prefix KV cache: radix-tree page reuse over the paged pool (a
copy of ``skypilot_tpu/infer/prefix_cache.py`` over the port's
:class:`~skypilot_tpu_torch.infer.paged_cache.PageAllocator`).

Most production traffic shares long common prefixes — system prompts,
few-shot templates, multi-turn history. Without sharing, every request
re-prefills its whole prompt into private pages; with it, the repeated
prefill becomes a host-side tree walk (vLLM's prefix caching, SGLang's
RadixAttention — convergent design, re-derived here over this repo's
``PageAllocator``).

Structure: a radix tree at PAGE granularity. Each node is exactly one
full page of tokens; its edge key is that page's token block (the
``page_size``-tuple of token ids), so a node is reachable only through
the exact chain of blocks that precede it. That chaining is what makes
reuse SOUND: K/V at position p depends on every token <= p (causal
attention through all layers), so a cached page may only be reused when
the *entire* prefix matches — which the walk enforces structurally, and
exact tuple keys (not hashes) make collision-proof.

Ownership protocol (refcounts live in ``PageAllocator``):

- The tree holds ONE reference on every cached page; each slot whose
  block table maps the page holds one more. A page is *evictable* only
  at refcount 1 (tree-only) — pages under active slots are pinned.
- ``match`` returns the longest cached page-aligned prefix, capped at
  the last full page strictly BEFORE the prompt end: at least one
  token is always left to prefill (its logits seed the first sampled
  token), so the slot's frontier page is always private and decode
  never writes a shared page. The engine still guards the invariant
  with copy-on-write (``PageAllocator.cow`` + ``copy_page``) in case a
  future matching change shares the frontier.
- ``donate`` (called by the engine on finish AND preempt) walks the
  request's token sequence and hands the slot's full clean pages to the
  tree instead of freeing them: new blocks transfer the slot's
  reference to the tree; already-cached blocks just drop the slot's
  reference (duplicates deallocate); the partial last page is freed.
- ``evict`` reclaims leaf pages in LRU order, only under page pressure
  (the engine calls it when ``extend`` fails, before considering
  preemption). Leaves-first keeps every surviving node reachable.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from skypilot_tpu_torch.infer import paged_cache as paged_cache_lib
from skypilot_tpu_torch.utils import prefix_hash


@dataclasses.dataclass
class _Node:
    block: Optional[Tuple[int, ...]]        # None only for the root
    page_id: int                            # physical page (tree ref)
    parent: Optional['_Node']
    last_access: int
    # Chained prefix digest (utils/prefix_hash.py): commits to the
    # whole root->node token path, so the fleet index can advertise
    # "this replica holds this prefix" in 8 bytes. 0 only at the root.
    chain: int = 0
    children: Dict[Tuple[int, ...], '_Node'] = dataclasses.field(
        default_factory=dict)


class PrefixCache:
    """Radix tree of per-page token blocks -> physical page ids."""

    # The tree is confined to the engine thread: external code (the
    # server) goes through match/donate/evict/stats and the engine's
    # published index copy, never the node structures (a reach-in would
    # race the step loop's donations and corrupt refcount bookkeeping).

    def __init__(self,
                 allocator: paged_cache_lib.PageAllocator,
                 index_cap: int = 4096) -> None:
        self.allocator = allocator
        self.page = allocator.page_size
        self._root = _Node(block=None, page_id=-1, parent=None,
                           last_access=0, chain=0)
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.tokens_saved = 0
        self.evictions = 0
        self.cached_pages = 0
        # Fleet prefix index: a bounded mirror of the tree keyed on chain
        # digests, maintained incrementally so the LB's sync-tick fetch
        # ships DELTAS, not the whole set. Insertion is parent-first
        # (donate walks root-down) and a child is only indexed while
        # its parent is, so the advertised set stays prefix-closed —
        # the LB's longest-match walk can stop at the first miss.
        self.index_cap = index_cap
        self._by_hash: Dict[int, _Node] = {}
        self.index_gen = 0
        self._journal: Deque[Tuple[int, str, int]] = collections.deque(
            maxlen=1024)

    # -- fleet index bookkeeping -------------------------------------------
    def _index_add(self, node: _Node) -> None:
        if len(self._by_hash) >= self.index_cap:
            return
        parent = node.parent
        if parent is not self._root and parent.chain not in self._by_hash:
            return          # keep the advertised set prefix-closed
        if node.chain in self._by_hash:
            return          # 64-bit collision: first writer wins
        self._by_hash[node.chain] = node
        self.index_gen += 1
        self._journal.append((self.index_gen, '+', node.chain))

    def _index_del(self, node: _Node) -> None:
        if self._by_hash.get(node.chain) is not node:
            return
        del self._by_hash[node.chain]
        self.index_gen += 1
        self._journal.append((self.index_gen, '-', node.chain))

    def publishable(self) -> tuple:
        """Immutable copy of the index state — ``(gen, crc, page,
        journal, hashes)`` — for the engine's cross-thread publication:
        the tree is engine-thread-confined, so the engine snapshots
        this at step boundaries and the HTTP thread builds wire
        summaries from the copy (utils.prefix_hash.build_snapshot)."""
        return (self.index_gen, prefix_hash.fold_crc(self._by_hash),
                self.page, tuple(self._journal),
                frozenset(self._by_hash))

    def index_snapshot(self, since_gen: int) -> Dict[str, object]:
        """The on-wire radix summary for the LB's sync tick: delta
        against ``since_gen`` when the journal covers it, full list
        otherwise; ``crc`` is the XOR fold of the whole advertised set
        (the LB verifies its delta-maintained mirror against it and
        forces a full resync on mismatch)."""
        gen, crc, page, journal, hashes = self.publishable()
        return prefix_hash.build_snapshot(gen, crc, page, journal,
                                          hashes, since_gen)

    # -- lookup ------------------------------------------------------------
    def match(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached page-aligned prefix of ``tokens``.

        Returns (page_ids, n_tokens). Capped at the last full page
        strictly before the end of ``tokens`` so the caller always
        prefills >= 1 token (see module docstring). Touches the LRU
        clock along the matched path. The caller must ``attach`` the
        pages in the same engine step (nothing else runs between —
        evictions happen only on the engine thread)."""
        self._clock += 1
        limit = (len(tokens) - 1) // self.page
        node = self._root
        pages: List[int] = []
        for i in range(limit):
            child = node.children.get(
                tuple(tokens[i * self.page:(i + 1) * self.page]))
            if child is None:
                break
            child.last_access = self._clock
            pages.append(child.page_id)
            node = child
        matched = len(pages) * self.page
        if matched:
            self.hits += 1
            self.tokens_saved += matched
        else:
            self.misses += 1
        return pages, matched

    def peek(self, tokens: Sequence[int],
             whole: bool = False) -> Tuple[List[int], int]:
        """``match`` without the side effects: no hit/miss accounting,
        no LRU touch. The KV-export path uses it — a donor serving a
        remote pull must not skew its own cache statistics, and export
        never takes references (the pages are only READ, on the engine
        thread, with no eviction point between lookup and readback).

        ``whole=True`` drops the strictly-before-end cap and matches
        every full page — the import diff uses it (a transferred blob
        covers exactly full pages; the leave-one-token rule applies to
        the PROMPT the puller will prefill, not to the blob)."""
        limit = (len(tokens) // self.page if whole
                 else (len(tokens) - 1) // self.page)
        node = self._root
        pages: List[int] = []
        for i in range(limit):
            child = node.children.get(
                tuple(tokens[i * self.page:(i + 1) * self.page]))
            if child is None:
                break
            pages.append(child.page_id)
            node = child
        return pages, len(pages) * self.page

    # -- donation ----------------------------------------------------------
    def donate(self, tokens: Sequence[int], slot: int) -> int:
        """Release ``slot``'s pages into the tree: full pages covered by
        ``tokens`` (the exact sequence whose K/V the pages hold) are
        cached; everything else (the partial last page) is freed. Also
        clears the slot's block table — this REPLACES
        ``allocator.free(slot)`` on the finish/preempt paths. Returns
        the number of newly cached pages."""
        al = self.allocator
        owned = al.owned_pages(slot)
        self._clock += 1
        full = min(len(tokens) // self.page, len(owned))
        node = self._root
        added = 0
        for i in range(full):
            blk = tuple(tokens[i * self.page:(i + 1) * self.page])
            child = node.children.get(blk)
            if child is None:
                # Tree takes over the slot's reference — no decref.
                child = _Node(block=blk, page_id=owned[i], parent=node,
                              last_access=self._clock,
                              chain=prefix_hash.block_hash(node.chain,
                                                           blk))
                node.children[blk] = child
                self.cached_pages += 1
                self._index_add(child)
                added += 1
            else:
                # Block already cached (possibly by this very page, if
                # it was attached at match time): drop the slot's ref;
                # a privately-computed duplicate deallocates here.
                child.last_access = self._clock
                al.decref(owned[i])
            node = child
        for pid in owned[full:]:
            al.decref(pid)
        al.clear_slot(slot)
        return added

    def insert_remote(self, tokens: Sequence[int],
                      page_ids: Sequence[Optional[int]]) -> int:
        """Graft IMPORTED pages (a fleet KV transfer) into the tree.

        ``page_ids`` has one entry per full page of ``tokens``; a None
        entry means that block was already cached locally when the
        caller diffed (the walk just descends through it). Fresh pages
        must come from ``PageAllocator.alloc_pages`` — the tree takes
        over their single reference. A non-None page for a block that
        turns out cached is a duplicate and is released; the EXISTING
        page always wins (slots may already attach it, and overwriting
        it with transferred bytes would change their stream mid-flight).
        Returns the number of pages grafted."""
        al = self.allocator
        self._clock += 1
        node = self._root
        added = 0
        for i, pid in enumerate(page_ids):
            blk = tuple(tokens[i * self.page:(i + 1) * self.page])
            child = node.children.get(blk)
            if child is None:
                if pid is None:     # caller's diff went stale — stop
                    break
                child = _Node(block=blk, page_id=pid, parent=node,
                              last_access=self._clock,
                              chain=prefix_hash.block_hash(node.chain,
                                                           blk))
                node.children[blk] = child
                self.cached_pages += 1
                self._index_add(child)
                added += 1
            else:
                child.last_access = self._clock
                if pid is not None:
                    al.decref(pid)
            node = child
        return added

    # -- eviction ----------------------------------------------------------
    def evict(self, n_pages: int) -> int:
        """Reclaim up to ``n_pages`` cached pages, LRU leaf first.

        Only refcount-1 pages (tree-only — no slot maps them) are
        candidates; an attached page pins itself AND its ancestors
        (ancestors are never leaves while it exists). Called by the
        engine strictly under page pressure. Returns pages freed.

        One tree walk total, not one per freed page: the walk seeds a
        min-heap of evictable leaves; evicting a node may turn its
        parent into a leaf, which is pushed then. Multi-page
        shortfalls (a whole prefill chunk) stay O(tree + k log k)."""
        freed = 0
        heap = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            if (node is not self._root and not node.children
                    and self.allocator.refcount(node.page_id) == 1):
                heap.append((node.last_access, id(node), node))
            stack.extend(node.children.values())
        heapq.heapify(heap)
        while freed < n_pages and heap:
            _, _, victim = heapq.heappop(heap)
            if (victim.children or victim.parent is None
                    or victim.parent.children.get(victim.block)
                    is not victim
                    or self.allocator.refcount(victim.page_id) != 1):
                continue   # stale heap entry
            parent = victim.parent
            del parent.children[victim.block]
            self._index_del(victim)
            self.allocator.decref(victim.page_id)
            self.cached_pages -= 1
            self.evictions += 1
            freed += 1
            if (parent is not self._root and not parent.children
                    and self.allocator.refcount(parent.page_id) == 1):
                heapq.heappush(heap,
                               (parent.last_access, id(parent), parent))
        return freed

    # -- observability -----------------------------------------------------
    @property
    def indexed_pages(self) -> int:
        return len(self._by_hash)

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> Dict[str, object]:
        return {
            'prefix_hit_rate': round(self.hit_rate(), 4),
            'prefix_tokens_saved': self.tokens_saved,
            'prefix_cached_pages': self.cached_pages,
            'prefix_evictions': self.evictions,
            # Raw counters so consumers (bench_ttft's shared-prefix
            # sweep) can compute WINDOWED hit rates from deltas — the
            # rate above is cumulative since engine start.
            'prefix_hits': self.hits,
            'prefix_misses': self.misses,
            # Fleet-index advertisement size (<= index_cap; lags
            # cached_pages when the cap bites).
            'prefix_indexed_pages': self.indexed_pages,
        }
