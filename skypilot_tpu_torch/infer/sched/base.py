"""Scheduler interface + FCFS policy (the engine's default).

The engine step loop's admission/ordering decisions — who gets
admitted, which queued request takes a freed slot, which prefilling
slot gets the next chunk, who is preempted under page pressure — used
to live inline in ``InferenceEngine``. This package factors them into
a narrow :class:`Scheduler` interface the engine calls at exactly
those decision points, so policies are swappable without touching the
device path (docs/serving.md "Engine scheduler"):

- ``fcfs`` (this module): bit-identical to the historical inline
  behavior — FIFO queue, round-robin chunking, youngest-victim
  preemption, global admission bounds.
- ``deadline`` (sched/deadline.py): earliest-deadline-first over the
  per-request wall-clock budgets (utils/common.DEADLINE_HEADER).
- ``wfq`` (sched/wfq.py): deficit-round-robin weighted fair queueing
  over per-tenant queues with token-cost accounting and per-tenant
  admission quotas.

Concurrency contract: a scheduler owns NO lock of its own — every
mutable field is guarded by the owning engine's ``_lock`` (the engine
calls in from ``submit()`` HTTP threads and the engine thread, always
under that lock). Methods are annotated ``# holds: _lock`` so
SKY-LOCK (docs/static-analysis.md) enforces the contract on the
declared ``_GUARDED_BY`` fields.

Tenant accounting: every request carries a ``tenant`` (the
``X-SkyTpu-Tenant`` header end to end; ``'default'`` otherwise). The
base class keeps per-tenant cumulative counters and recent windows
(queue wait, TTFT) for all policies — fairness must be observable
before it is enforceable. ``aggregate_stats`` turns one or many
scheduler snapshots into the per-tenant metric dict surfaced by
``engine.metrics()['tenants']`` (and merged across tiers by
``EnginePool``); its keys are cataloged in docs/observability.md and
gated by SKY-REGISTRY.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Deque, Dict, Iterable, List, Mapping, Optional

DEFAULT_TENANT = 'default'

# Recent-window sizes (per tenant): bounded so a long-lived replica's
# /metrics stays O(1) in memory and percentiles reflect current
# behavior, mirroring the engine's own TTFT window.
_WINDOW = 512


class AdmissionError(ValueError):
    """The scheduler refused new work — the tenant's (or the global)
    queue bound is hit: the caller sheds (HTTP 429 + Retry-After at
    the server) instead of queueing unboundedly. ``retry_after_s`` is
    the scheduler's queue-drain estimate (tokens ahead / recent decode
    throughput), not a constant. A ``ValueError`` subclass so the
    multihost lockstep tick's uniform-rejection rule applies unchanged
    on every host."""

    def __init__(self, msg: str, retry_after_s: float = 1.0) -> None:
        super().__init__(msg)
        self.retry_after_s = retry_after_s


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Policy knobs, carried over from ``EngineConfig``."""
    # Global queue bounds (fcfs/deadline shed against these directly;
    # wfq derives per-tenant quotas from them). None = unbounded.
    max_queue_requests: Optional[int] = None
    max_queue_tokens: Optional[int] = None
    # tenant -> relative weight (wfq); unknown tenants weigh 1.0.
    tenant_weights: Optional[Mapping[str, float]] = None
    # DRR replenish per rotation visit, in tokens (wfq). Also the
    # fairness granularity: one visit serves ~quantum/cost consecutive
    # requests before the rotation moves on, so a quantum much larger
    # than the typical request cost lets a bursty tenant monopolize
    # whole rounds (64 ≈ a page of tokens keeps interleave tight).
    quantum_tokens: int = 64


def request_cost(req) -> int:
    """Token cost of a queued request: what its (re-)prefill must
    cover — prompt plus already-generated output (resume tokens at
    submit; everything streamed so far for a preempted requeue). The
    same accounting the historical ``max_queue_tokens`` bound used."""
    return len(req.prompt_tokens) + len(req.output_tokens)


def _pct(sorted_vals: List[float], p: float) -> Optional[float]:
    if not sorted_vals:
        return None
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(len(sorted_vals) * p))]


class _TenantStats:
    """Cumulative per-tenant counters + recent windows. Survives the
    wfq empty-tenant GC (scheduling state is reclaimed; observability
    is not)."""

    __slots__ = ('admitted', 'shed', 'cancelled', 'expired',
                 'abandoned', 'decode_tokens', 'queue_waits', 'ttfts')

    def __init__(self) -> None:
        self.admitted = 0
        self.shed = 0
        self.cancelled = 0
        self.expired = 0
        self.abandoned = 0
        self.decode_tokens = 0
        self.queue_waits: Deque[float] = collections.deque(
            maxlen=_WINDOW)
        self.ttfts: Deque[float] = collections.deque(maxlen=_WINDOW)


class Scheduler:
    """FCFS policy and the interface every policy implements.

    The engine calls in at five decision points, always under its
    ``_lock``: ``admit``+``enqueue`` (submission), ``pop_next`` (slot
    refill), ``next_prefill_slot`` (chunk budget), ``pick_victim``
    (page-pressure preemption), ``sweep`` (deadline/cancel GC over the
    queue). Accounting hooks (``note_*``) feed the per-tenant metrics;
    ``snapshot`` exports them.
    """

    name = 'fcfs'

    # Guarded by the OWNING ENGINE's _lock (SKY-LOCK): the scheduler
    # has no lock of its own; every caller is an engine method that
    # already holds the engine lock, hence the '# holds: _lock'
    # annotations below.
    _GUARDED_BY = {
        '_queue': '_lock',      # submit() threads vs the step loop
        '_stats': '_lock',      # note_* (engine thread) vs metrics
        '_weights': '_lock',
        '_rr': '_lock',         # chunk round-robin cursor
    }

    def __init__(self, config: Optional[SchedulerConfig] = None) -> None:
        self.cfg = config or SchedulerConfig()
        self._queue: List[Any] = []
        self._stats: Dict[str, _TenantStats] = {}
        self._weights: Dict[str, float] = {
            str(k): float(v)
            for k, v in (self.cfg.tenant_weights or {}).items()}
        self._rr = 0   # round-robin cursor over prefilling slots

    # ---- weights ---------------------------------------------------------
    def weight(self, tenant: str) -> float:  # holds: _lock
        return self._weights.get(tenant, 1.0)

    def set_tenant_weights(self, weights: Mapping[str, float]  # holds: _lock
                           ) -> None:
        """Replace the weight map mid-flight (a runtime knob): queued
        work keeps its position; future scheduling decisions use the
        new weights."""
        self._weights = {str(k): float(v)
                         for k, v in (weights or {}).items()}

    # Distinct-tenant stats are bounded: tenant ids are
    # client-controlled (X-SkyTpu-Tenant), so an id-minting client
    # must not grow this map — or every /metrics snapshot — without
    # bound. At the cap, the oldest-created entries without queued
    # work are evicted (their windows/counters reset if they return).
    max_tenant_stats = 1024

    def _tstats(self, tenant: str) -> _TenantStats:  # holds: _lock
        st = self._stats.get(tenant)
        if st is None:
            if len(self._stats) >= self.max_tenant_stats:
                live = self._queued_tenants()
                for old in list(self._stats):
                    if old not in live:
                        del self._stats[old]
                        if len(self._stats) < self.max_tenant_stats:
                            break
            st = self._stats[tenant] = _TenantStats()
        return st

    def _queued_tenants(self):  # holds: _lock
        return {r.tenant for r in self._queue}

    # ---- admission -------------------------------------------------------
    def admit(self, req, drain_tps: float = 0.0) -> None:  # holds: _lock
        """Bounds check WITHOUT enqueueing (the engine enqueues on
        success). Raises :class:`AdmissionError` carrying the
        queue-drain Retry-After estimate. ``drain_tps`` is the
        engine's recent decode throughput (tokens/s)."""
        cap = self.cfg.max_queue_requests
        if cap is not None and self.pending() >= cap:
            self._shed(req, f'engine queue full ({self.pending()} '
                            f'waiting >= max_queue_requests={cap})',
                       drain_tps)
        tcap = self.cfg.max_queue_tokens
        if tcap is not None:
            queued = self.queued_tokens()
            total = request_cost(req)
            if queued + total > tcap:
                self._shed(req, f'engine queue full ({queued} queued '
                                f'tokens + {total} > '
                                f'max_queue_tokens={tcap})', drain_tps)

    def _shed(self, req, msg: str, drain_tps: float) -> None:  # holds: _lock
        self._tstats(req.tenant).shed += 1
        raise AdmissionError(
            msg, retry_after_s=self.retry_after(req.tenant, drain_tps))

    def retry_after(self, tenant: str,  # holds: _lock
                    drain_tps: float) -> float:
        """Queue-drain estimate: queued tokens ahead of this tenant
        over the recent decode throughput, clamped to [1, 60] s. 1.0
        when the engine has no throughput history yet."""
        backlog = self.queued_tokens()
        if drain_tps <= 0.0 or backlog <= 0:
            return 1.0
        return min(60.0, max(1.0, backlog / drain_tps))

    # ---- queue -----------------------------------------------------------
    def enqueue(self, req) -> None:  # holds: _lock
        self._tstats(req.tenant).admitted += 1
        self._queue.append(req)

    def requeue(self, req) -> None:  # holds: _lock
        """A preempted request resumes at the FRONT: it already holds
        streamed output and its pages were just reclaimed for someone
        else — making it wait again would double-charge it."""
        self._queue.insert(0, req)

    def pop_next(self):  # holds: _lock
        """Next request for a freed slot, or None."""
        return self._queue.pop(0) if self._queue else None

    def pending(self) -> int:  # holds: _lock
        return len(self._queue)

    def queued_tokens(self) -> int:  # holds: _lock
        return sum(request_cost(r) for r in self.queued_requests())

    def queued_requests(self) -> List[Any]:  # holds: _lock
        """Snapshot of the queue in service order (for sweeps, metrics
        and scheduler migration — never mutate the returned list)."""
        return list(self._queue)

    def sweep(self, now: float) -> List[tuple]:  # holds: _lock
        """Drop queued requests whose client is gone ('cancelled') or
        whose deadline passed ('deadline'); returns ``(request,
        reason)`` pairs for the engine to finish/notify. Policy queue
        state stays consistent (wfq GCs tenants emptied here)."""
        out = []
        keep = []
        for r in self._queue:
            if r.cancelled:
                out.append((r, 'cancelled'))
            elif r.deadline is not None and now > r.deadline:
                out.append((r, 'deadline'))
            else:
                keep.append(r)
        self._queue[:] = keep
        self._count_swept(out)
        return out

    def _count_swept(self, out: List[tuple]) -> None:  # holds: _lock
        for r, reason in out:
            st = self._tstats(r.tenant)
            if reason == 'cancelled':
                st.abandoned += 1   # never reached a slot
            else:
                st.expired += 1

    # ---- speculation budget ---------------------------------------------
    def spec_budget(self, req, spec_k: int) -> int:  # holds: _lock
        """Draft width allowed for ``req`` THIS step (speculative
        decoding, docs/serving.md). Speculation spends extra page and
        verify-lane budget chasing latency, so the scheduler — the
        owner of contention policy — gets the last word on how wide a
        request may draft. fcfs/deadline grant the global
        ``EngineConfig.spec_k`` unconditionally; wfq caps an
        over-share tenant's width under contention (its override)."""
        del req
        return spec_k

    # ---- step work selection --------------------------------------------
    def next_prefill_slot(self, candidates: List[int],  # holds: _lock
                          slots: List[Any]) -> int:
        """Which prefilling slot gets the next chunk. ``candidates``
        is sorted ascending. FCFS keeps the historical round-robin
        cursor arithmetic verbatim (the fcfs bit-identity gate)."""
        del slots
        self._rr = (self._rr + 1) % len(candidates)
        return candidates[self._rr]

    def pick_victim(self, victims: List[int],  # holds: _lock
                    slots: List[Any]) -> int:
        """Which active slot to preempt under page pressure. FCFS:
        the youngest (latest-submitted) — the historical rule."""
        return max(victims, key=lambda s: slots[s].submitted_at)

    # ---- accounting hooks (engine thread) --------------------------------
    def note_queue_wait(self, req, wait_s: float) -> None:  # holds: _lock
        self._tstats(req.tenant).queue_waits.append(wait_s)

    def note_first_token(self, req, ttft_s: float) -> None:  # holds: _lock
        self._tstats(req.tenant).ttfts.append(ttft_s)

    def note_tokens(self, req, n: int = 1) -> None:  # holds: _lock
        self._tstats(req.tenant).decode_tokens += n

    def note_outcome(self, req, reason: str) -> None:  # holds: _lock
        """An ACTIVE slot was torn down early ('cancelled' /
        'deadline') — the queued-side outcomes are counted by
        ``sweep`` itself."""
        st = self._tstats(req.tenant)
        if reason == 'cancelled':
            st.cancelled += 1
        elif reason == 'deadline':
            st.expired += 1

    # ---- metrics ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Dict[str, Any]]:  # holds: _lock
        """Raw per-tenant export (counters + copied windows), merged
        by ``aggregate_stats``. Taken under the engine lock so
        EnginePool's cross-tier merge never iterates a live deque the
        engine thread is appending to."""
        depth: Dict[str, int] = {}
        tokens: Dict[str, int] = {}
        for r in self.queued_requests():
            depth[r.tenant] = depth.get(r.tenant, 0) + 1
            tokens[r.tenant] = (tokens.get(r.tenant, 0)
                                + request_cost(r))
        out: Dict[str, Dict[str, Any]] = {}
        for t in set(self._stats) | set(depth):
            st = self._stats.get(t)
            out[t] = {
                'queue_depth': depth.get(t, 0),
                'queued_tokens': tokens.get(t, 0),
                'weight': self.weight(t),
                'queue_waits': list(st.queue_waits) if st else [],
                'ttfts': list(st.ttfts) if st else [],
                'decode_tokens': st.decode_tokens if st else 0,
                'shed': st.shed if st else 0,
                'cancelled': st.cancelled if st else 0,
                'expired': st.expired if st else 0,
                'abandoned': st.abandoned if st else 0,
            }
        return out


def _merge_snapshots(snapshots: Iterable[Dict[str, Dict[str, Any]]]
                     ) -> Dict[str, Dict[str, Any]]:
    """Sum counters and concatenate raw windows across tiers. Kept
    OUT of ``aggregate_stats`` on purpose: that function is a
    SKY-REGISTRY metric surface, and these accumulator keys are
    internal, not emitted metric names."""
    merged: Dict[str, Dict[str, Any]] = {}
    for snap in snapshots:
        for t, s in snap.items():
            m = merged.get(t)
            if m is None:
                m = merged[t] = {k: (list(v) if isinstance(v, list)
                                     else v) for k, v in s.items()}
                continue
            for k, v in s.items():
                if isinstance(v, list):
                    m[k] = m[k] + v
                elif k != 'weight':     # weights agree across tiers
                    m[k] = m[k] + v
    return merged


def aggregate_stats(snapshots: Iterable[Dict[str, Dict[str, Any]]],
                    decode_time_s: float = 0.0) -> Dict[str, Dict]:
    """Merge scheduler ``snapshot()``s (one per engine tier) into the
    per-tenant metric dict surfaced as ``metrics()['tenants']``.
    ``decode_time_s`` is the engines' combined decode wall-clock — the
    denominator that makes ``tokens_per_sec`` honest across
    interleaved tiers (the EnginePool rule). The dict keys below are
    cataloged in docs/observability.md (SKY-REGISTRY)."""
    out: Dict[str, Dict] = {}
    for t, m in _merge_snapshots(snapshots).items():
        waits = sorted(m['queue_waits'])
        ttfts = sorted(m['ttfts'])
        w50, w99 = _pct(waits, 0.50), _pct(waits, 0.99)
        out[t] = {
            'queue_depth': m['queue_depth'],
            'queued_tokens': m['queued_tokens'],
            'weight': m['weight'],
            'queue_wait_p50_ms': (round(w50 * 1e3, 3)
                                  if w50 is not None else None),
            'queue_wait_p99_ms': (round(w99 * 1e3, 3)
                                  if w99 is not None else None),
            'ttft_p50_s': _pct(ttfts, 0.50),
            'ttft_p99_s': _pct(ttfts, 0.99),
            'decode_tokens': m['decode_tokens'],
            'tokens_per_sec': (m['decode_tokens'] / decode_time_s
                               if decode_time_s else 0.0),
            'requests_shed': m['shed'],
            'requests_cancelled': m['cancelled'],
            'requests_expired': m['expired'],
            'requests_abandoned': m['abandoned'],
        }
    return out


class FCFSScheduler(Scheduler):
    """The default policy — the base class IS fcfs; this subclass only
    pins the registry name."""
    name = 'fcfs'
