"""Weighted fair queueing (deficit round robin) over per-tenant queues.

The multi-tenant isolation policy: one tenant's burst must never 429
(or starve) everyone else. Requests queue per tenant; service rotates
deficit-round-robin — each visit replenishes the tenant's deficit by
``quantum_tokens x weight`` and the head request is served once the
deficit covers its token cost (``base.request_cost``: prompt + already
generated output). Over time each backlogged tenant receives service
proportional to its weight, measured in TOKENS, not requests — a
tenant of few huge prompts cannot crowd out a tenant of many small
ones.

Deficit discipline (the carryover bounds the tests pin):

- replenish is capped at ``quantum x weight + head_cost``, so an
  unlucky tenant accumulates just enough to afford its head and a
  quantum of change — never unbounded credit;
- a tenant whose queue empties is GC'd (queue, deficit, rotation
  slot — cumulative stats survive for metrics): idle time earns
  nothing, the classic DRR anti-hoarding rule.

Admission quotas: the global ``max_queue_requests`` /
``max_queue_tokens`` bounds are split by weight across the tenants
currently holding queued work (plus the applicant), so shedding
answers 429 to the tenant that outran ITS share — the victim of an
aggressor's burst is never the one shed. Because every tenant is
guaranteed at least one queue slot (a newcomer must be admittable),
the quota sum can exceed the configured bound; a HARD ceiling of 2x
each bound caps the total — per-tenant fairness below it, finite
memory above it even against a client minting fresh tenant ids. The Retry-After estimate is
tenant-scoped: the tenant's own backlog over its weight share of the
engine's recent decode throughput.

Page-pressure preemption evicts the most-over-share tenant's youngest
slot, and the prefill chunk budget rotates across the prefilling
slots' tenants — fairness applies at every decision point, not just
the queue.
"""
from __future__ import annotations

import collections
import math
from typing import Any, Deque, Dict, List, Optional

from skypilot_tpu_torch.infer.sched import base


class WFQScheduler(base.Scheduler):
    name = 'wfq'

    # Guarded by the owning engine's _lock, like the base class
    # (methods are '# holds: _lock'; the scheduler has no lock).
    _GUARDED_BY = {
        '_queues': '_lock',
        '_order': '_lock',
        '_deficit': '_lock',
        '_cursor': '_lock',
        '_fresh': '_lock',
        '_prr': '_lock',
    }

    def __init__(self, config: Optional[base.SchedulerConfig] = None
                 ) -> None:
        super().__init__(config)
        # tenant -> FIFO of its queued requests. _order is the DRR
        # rotation (insertion order, stable); _cursor points at the
        # tenant currently being served; _fresh marks whether that
        # tenant still owes itself this visit's replenish.
        self._queues: Dict[str, Deque[Any]] = {}
        self._order: List[str] = []
        self._deficit: Dict[str, float] = {}
        self._cursor = 0
        self._fresh = True
        self._prr = 0   # prefill-chunk rotation over tenants

    # ---- queue -----------------------------------------------------------
    def enqueue(self, req) -> None:  # holds: _lock
        self._tstats(req.tenant).admitted += 1
        self._tenant_queue(req.tenant).append(req)

    def requeue(self, req) -> None:  # holds: _lock
        # Preempted: front of ITS tenant's queue (the deficit already
        # paid for it once; DRR will charge the recompute again, which
        # is honest — the recompute is real work).
        self._tenant_queue(req.tenant).appendleft(req)

    def _tenant_queue(self, tenant: str) -> Deque[Any]:  # holds: _lock
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = collections.deque()
            self._deficit.setdefault(tenant, 0.0)
            self._order.append(tenant)
        return q

    def _gc_tenant(self, tenant: str) -> None:  # holds: _lock
        """Empty-tenant GC: reclaim scheduling state (queue, deficit,
        rotation slot). Cumulative _stats survive — observability
        outlives the burst (bounded by the base class's stats cap)."""
        del self._queues[tenant]
        self._deficit.pop(tenant, None)
        i = self._order.index(tenant)
        del self._order[i]
        if i < self._cursor:
            self._cursor -= 1   # same tenant at the cursor: keep its
            #                     in-progress visit (_fresh untouched)
        elif i == self._cursor:
            # The cursor now points at the NEXT tenant: it is owed a
            # fresh replenish. (An i > cursor removal changes nothing
            # for the tenant in service — resetting _fresh there would
            # hand it a spurious extra quantum per unrelated GC.)
            self._fresh = True
        if self._cursor >= len(self._order):
            self._cursor = 0
            self._fresh = True

    def pending(self) -> int:  # holds: _lock
        return sum(len(q) for q in self._queues.values())

    def _queued_tenants(self):  # holds: _lock
        return set(self._order)

    def queued_requests(self) -> List[Any]:  # holds: _lock
        return [r for t in self._order for r in self._queues[t]]

    def sweep(self, now: float) -> List[tuple]:  # holds: _lock
        out = []
        for t in list(self._order):
            q = self._queues[t]
            keep = []
            for r in q:
                if r.cancelled:
                    out.append((r, 'cancelled'))
                elif r.deadline is not None and now > r.deadline:
                    out.append((r, 'deadline'))
                else:
                    keep.append(r)
            if not keep:
                self._gc_tenant(t)
            elif len(keep) != len(q):
                self._queues[t] = collections.deque(keep)
        self._count_swept(out)
        return out

    # ---- admission quotas ------------------------------------------------
    def _share(self, tenant: str) -> float:  # holds: _lock
        """This tenant's weight share over the tenants that currently
        hold queued work (plus itself) — the divisor adapts to who is
        actually contending, so a lone tenant gets the whole bound."""
        active = set(self._order) | {tenant}
        total = sum(self.weight(t) for t in active)
        return self.weight(tenant) / total if total else 1.0

    def admit(self, req, drain_tps: float = 0.0) -> None:  # holds: _lock
        t = req.tenant
        share = self._share(t)
        q = self._queues.get(t)
        cap = self.cfg.max_queue_requests
        if cap is not None:
            allowed = max(1, math.ceil(cap * share))
            if q is not None and len(q) >= allowed:
                self._shed(
                    req, f'tenant {t!r} queue full ({len(q)} waiting '
                         f'>= quota {allowed} of '
                         f'max_queue_requests={cap})', drain_tps)
            if self.pending() >= 2 * cap:
                # Hard global ceiling. Per-tenant quotas adapt to the
                # contending set (each tenant gets at least one slot),
                # so a client minting fresh tenant ids per request
                # could otherwise queue ~cap·H(n) work — unbounded.
                # 2x the configured bound keeps quota fairness in the
                # normal regime and memory finite in the adversarial
                # one.
                self._shed(
                    req, f'engine queue full ({self.pending()} '
                         f'waiting >= hard ceiling '
                         f'{2 * cap} = 2 x max_queue_requests={cap})',
                    drain_tps)
        tcap = self.cfg.max_queue_tokens
        if tcap is not None:
            cost = base.request_cost(req)
            if cost > tcap:
                # Outgrows even the GLOBAL bound: no amount of
                # queue-draining ever admits it.
                self._shed(req, f'request ({cost} tokens) exceeds '
                                f'max_queue_tokens={tcap}', drain_tps)
            queued = (sum(base.request_cost(r) for r in q)
                      if q else 0)
            allowed_tok = math.ceil(tcap * share)
            if queued and queued + cost > allowed_tok:
                self._shed(
                    req, f'tenant {t!r} queue full ({queued} queued '
                         f'tokens + {cost} > quota {allowed_tok} of '
                         f'max_queue_tokens={tcap})', drain_tps)
            if self.queued_tokens() + cost > 2 * tcap:
                # Same hard ceiling, token-denominated.
                self._shed(
                    req, f'engine queue full ({self.queued_tokens()} '
                         f'queued tokens + {cost} > hard ceiling '
                         f'{2 * tcap} = 2 x max_queue_tokens={tcap})',
                    drain_tps)

    def retry_after(self, tenant: str,  # holds: _lock
                    drain_tps: float) -> float:
        """Tenant-scoped drain estimate: its own backlog over its
        weight share of the engine's decode throughput."""
        q = self._queues.get(tenant)
        backlog = sum(base.request_cost(r) for r in q) if q else 0
        eff = drain_tps * self._share(tenant)
        if eff <= 0.0 or backlog <= 0:
            return 1.0
        return min(60.0, max(1.0, backlog / eff))

    # ---- DRR service -----------------------------------------------------
    def pop_next(self):  # holds: _lock
        if not self._order:
            return None
        quantum = max(1, self.cfg.quantum_tokens)
        # Worst-case rotations until SOME head is affordable:
        # ceil(max_head / (quantum * min_weight)) — deficits grow by
        # quantum*w per visit, capped at quantum*w + head (always
        # reachable). The bound makes the loop provably finite; the
        # tail return is a belt-and-braces fallback.
        max_head = max(base.request_cost(q[0])
                       for q in self._queues.values())
        min_w = min(self.weight(t) for t in self._order)
        rounds = int(max_head / (quantum * max(min_w, 1e-9))) + 2
        for _ in range(rounds * len(self._order)):
            t = self._order[self._cursor]
            q = self._queues[t]
            w = self.weight(t)
            head = base.request_cost(q[0])
            if self._fresh:
                # Carryover bound: never more than one quantum of
                # change beyond the head's own cost.
                self._deficit[t] = min(self._deficit[t] + quantum * w,
                                       quantum * w + head)
                self._fresh = False
            if self._deficit[t] >= head:
                req = q.popleft()
                self._deficit[t] -= head
                if not q:
                    self._gc_tenant(t)
                # else: stay on this tenant (classic DRR serves while
                # the deficit lasts); the next pop re-checks
                # affordability without replenishing.
                return req
            self._cursor = (self._cursor + 1) % len(self._order)
            self._fresh = True
        # Unreachable given the bound; serve strict FIFO as a failsafe
        # rather than wedging the step loop.
        for t in self._order:
            req = self._queues[t].popleft()
            if not self._queues[t]:
                self._gc_tenant(t)
            return req
        return None

    # ---- speculation budget ---------------------------------------------
    def spec_budget(self, req, spec_k: int) -> int:  # holds: _lock
        """Weight-share draft width under contention: speculation
        burns extra pages and verify lanes for latency, and when other
        tenants hold queued work that headroom belongs to the rotation
        — so a tenant drafts ``spec_k`` scaled by its weight share of
        the contending set (the uncontended engine always drafts full
        width). Floor 1, not 0: with many contenders the truncated
        share would zero EVERYONE's width and turn speculation off
        fleet-wide — a tenant at its fair share keeps at least one
        draft lane; the scaling only narrows wide drafting, it never
        disables it."""
        if not (set(self._order) - {req.tenant}):
            return spec_k
        # The same weight-share-of-the-contending-set rule admission
        # quotas use (_share) — one definition of "fair share".
        return min(spec_k,
                   max(1, int(spec_k * self._share(req.tenant))))

    # ---- step work selection --------------------------------------------
    def next_prefill_slot(self, candidates: List[int],  # holds: _lock
                          slots: List[Any]) -> int:
        """Rotate the chunk budget across the prefilling slots'
        tenants (FIFO within a tenant: lowest slot), so one tenant's
        burst of long prompts cannot monopolize prefill bandwidth."""
        tenants = sorted({slots[s].tenant for s in candidates})
        t = tenants[self._prr % len(tenants)]
        self._prr += 1
        return min(s for s in candidates if slots[s].tenant == t)

    def pick_victim(self, victims: List[int],  # holds: _lock
                    slots: List[Any]) -> int:
        """Evict the most-over-share tenant's youngest slot: service
        held in slots (token cost) per unit weight decides WHO pays
        for page pressure; recency decides WHICH of their slots
        (cheapest recompute), matching the fcfs rule within a
        tenant."""
        service: Dict[str, int] = {}
        for r in slots:
            if r is not None:
                service[r.tenant] = (service.get(r.tenant, 0)
                                     + base.request_cost(r))
        tenant = max({slots[s].tenant for s in victims},
                     key=lambda t: (service.get(t, 0) / self.weight(t),
                                    t))
        cands = [s for s in victims if slots[s].tenant == tenant]
        return max(cands, key=lambda s: slots[s].submitted_at)
