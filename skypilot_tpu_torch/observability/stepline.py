"""Engine flight recorder: step-level timelines and anomaly dumps (a
copy of ``skypilot_tpu/observability/stepline.py`` for the port, which
imports nothing of the JAX package).

An always-on, low-overhead ring of per-engine-step records (one compact
:class:`StepRecord` per worked step: kind, the host intervals of its
stages, batch and chunk sizes, speculation accept counts, page
pressure, queue depth per tenant), a ring of step-program records (one
:class:`ProgramRecord` per device program the step loop dispatched: its
work as counts, its device time and the device's idle gap before it)
and a per-request timeline ring (submit -> first_dispatch -> first_token
-> done, with resume, cancel and shed events), all appended by the
engine step loop under the engine's ``_lock``. A snapshot lists each
step's program records under the step (``steps[i]['programs']``).

The train step keeps its own ring of :class:`TrainStepRecord` (the
device seconds of forward, backward, gradient sync and optimizer):
``train.trainer.make_train_step``'s ``step_fn.records()``.

Two export paths, as in the reference:

- **Perfetto**: :func:`to_perfetto` renders a snapshot as Chrome-trace
  JSON: the steps, one track per step-loop stage (schedule / dispatch /
  readback / drain, each interval where it ran), the programs on the
  device and the device's idle gaps between them, and one track per
  request.
- **Anomaly dumps**: a TTFT-SLO breach, preemption, ``cache_full``
  finish, admission shed or SDC hit snapshots the ring into the sqlite
  span store (``observability/store.py``: the same schema at the same
  default path, so ``sky-tpu profile`` reads a port's dump unchanged):
  one ``stepline.dump`` root span, one child span per step or request
  event. Writes happen on a background thread, never under the engine
  lock, rate-limited per trigger kind.

Determinism contract: the recorder reads clocks and counters only; it
never influences scheduling, sampling or page decisions, so greedy
outputs are identical recorder on vs off.

Profile smoke (the reference's ``make profile-smoke``): ``python -m
skypilot_tpu_torch.observability.stepline [--device cpu]`` runs a tiny
workload on the port's engine with a zero TTFT SLO, which forces a dump,
and exits 0 only if the live Perfetto export validates and draws every
program on its ``programs`` track and every stage interval at its
recorded offset, the dump writer drains, and the dump reads back from
the span store, renders, validates and holds its ``stepline.trigger``
span. It runs on the card unless
``--device cpu``: there on the smallest model preset whose shapes the
paged attention kernels take.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

# Ring capacities (records, not bytes). A step record is ~15 scalars;
# 1024 of them cover minutes of steady-state decode — enough context
# around any anomaly without growing replica RSS measurably.
CAP_ENV = 'SKY_TPU_STEPLINE_CAP'
DEFAULT_CAP = 1024
# Minimum seconds between two dumps of the SAME trigger kind: a
# preemption storm must not turn the span store into a write
# amplifier (each dump is O(ring) rows). 0 disables the limit.
DUMP_INTERVAL_ENV = 'SKY_TPU_STEPLINE_DUMP_INTERVAL_S'
DEFAULT_DUMP_INTERVAL_S = 30.0

TRIGGERS = ('ttft_slo', 'preemption', 'cache_full', 'admission_shed',
            'breaker_open', 'slo_page')

# Step-loop stage keys of the summary. 'host' is the remainder
# (scheduling, page accounting, drafting).
STAGES = ('dispatch', 'drain', 'readback', 'host')
# The stages a step record holds as intervals ``StepRecord.stages``:
# the scheduler's work (slot refill, the dead-request sweep, prefill
# picks), one dispatch a program, the wait on a read-back pair and the
# bookkeeping that consumes it.
INTERVALS = ('schedule', 'dispatch', 'readback', 'drain')


def default_cap() -> int:
    try:
        return max(8, int(os.environ.get(CAP_ENV, DEFAULT_CAP)))
    except ValueError:
        return DEFAULT_CAP


def dump_interval_s() -> float:
    try:
        return max(0.0, float(os.environ.get(
            DUMP_INTERVAL_ENV, DEFAULT_DUMP_INTERVAL_S)))
    except ValueError:
        return DEFAULT_DUMP_INTERVAL_S


@dataclasses.dataclass
class StepRecord:
    """One engine step, compactly. All times are wall seconds. ``stages``
    lists the step's stage intervals as (stage, start offset from ``t``,
    seconds) in the order they ran, disjoint (:data:`INTERVALS`);
    ``dispatch_s`` (device program launches), ``drain_s`` (consume
    bookkeeping while catching host state up) and ``readback_s`` (blocked
    on the device→host pair copy) are the sums of their intervals, and
    host = ``dur_s`` minus the three."""
    __slots__ = ('idx', 't', 'dur_s', 'kind', 'dispatch_s', 'drain_s',
                 'readback_s', 'batch', 'chunk_tokens', 'prefilling',
                 'spec_drafted', 'spec_accepted', 'pages_free',
                 'prefix_evictions', 'preemptions', 'queue_depth',
                 'tenant_depths', 'stages')
    idx: int                 # monotonic step index (survives wrap)
    t: float                 # wall-clock step start
    dur_s: float
    kind: str                # prefill | decode | mixed | verify | free
    dispatch_s: float
    drain_s: float
    readback_s: float
    batch: int               # decoding slots in the dispatch
    chunk_tokens: int        # prefill tokens dispatched this step
    prefilling: int          # slots mid-prefill after the step
    spec_drafted: int        # draft tokens consumed this step
    spec_accepted: int
    pages_free: int          # -1 on dense engines
    prefix_evictions: int    # cumulative (deltas = per-step evictions)
    preemptions: int         # cumulative
    queue_depth: int
    tenant_depths: Optional[Dict[str, int]]   # None when single-tenant
    stages: List[Tuple[str, float, float]]

    def host_s(self) -> float:
        return max(0.0, self.dur_s - self.dispatch_s - self.drain_s
                   - self.readback_s)

    def as_dict(self) -> Dict[str, Any]:
        d = {k: getattr(self, k) for k in self.__slots__}
        d['host_s'] = self.host_s()
        return d


@dataclasses.dataclass
class ProgramRecord:
    """One step program the engine dispatched (prefill chunk, decode,
    mixed or verify). The counts come from the engine's host state:
    ``rows`` the decoding slots (a standalone chunk: its true length),
    ``chunks`` (request id, offset, true length) of the prefill chunk it
    ran, ``kv_tokens`` the keys each layer's attention reads, summed over
    its rows (a decoding slot: its context; a verify slot: its context
    and the drafted run; a chunk: offset + true length).
    ``dispatch_s`` is the host time of its dispatch (staging, dispatch
    state, the launch or replay). Its start event is recorded after the
    staging copies, just before the launch, at wall time ``t``.
    ``device_s`` runs from its start event to its end event (after the
    read-back copy, where it has one); ``gap_before_s`` from the previous
    program's end event to its start event: the device's idle time
    before it (staging copies included), None for the first program and
    after an idle engine tick. On the CPU, which runs the ops as they
    are called, both are host intervals: from the start to the
    dispatch's end, and from the previous dispatch's end to the start."""
    __slots__ = ('step_idx', 'kind', 'bucket', 't', 'dispatch_s',
                 'device_s', 'gap_before_s', 'rows', 'chunks', 'kv_tokens')
    step_idx: int
    kind: str                # prefill | decode | mixed | verify
    bucket: int              # chunk bucket, or queries a slot
    t: float
    dispatch_s: float
    device_s: float
    gap_before_s: Optional[float]
    rows: int
    chunks: List[Tuple[int, int, int]]
    kv_tokens: int

    def as_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self.__slots__}


@dataclasses.dataclass
class TrainStepRecord:
    """One train step: ``t`` its wall start, ``dur_s`` its host time,
    and the device seconds of its phases between its events: ``forward``
    (the loss, chunked cross-entropy included), ``backward`` (the
    gradients, remat's recompute included), ``grad_sync`` (the mesh's
    gradient reduction and global norm; None off a mesh) and
    ``optimizer`` (the global norm, the clip and AdamW). On the CPU the
    phases are host intervals."""
    __slots__ = ('idx', 't', 'dur_s', 'forward', 'backward', 'grad_sync',
                 'optimizer')
    idx: int
    t: float
    dur_s: float
    forward: float
    backward: float
    grad_sync: Optional[float]
    optimizer: float

    def as_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self.__slots__}


class Ring:
    """Fixed-capacity ring buffer: O(1) append, oldest-first
    ``snapshot``, and a monotonic ``total`` so wraparound is
    observable (record ``idx`` continuity is testable). NOT
    thread-safe by itself — the owner (the engine) serializes access
    under its own lock."""

    __slots__ = ('_buf', '_cap', 'total')

    def __init__(self, cap: int) -> None:
        self._cap = max(1, int(cap))
        self._buf: List[Any] = [None] * self._cap
        self.total = 0

    def __len__(self) -> int:
        return min(self.total, self._cap)

    @property
    def cap(self) -> int:
        return self._cap

    def append(self, item: Any) -> None:
        self._buf[self.total % self._cap] = item
        self.total += 1

    def snapshot(self) -> List[Any]:
        n = len(self)
        start = self.total - n
        return [self._buf[i % self._cap]
                for i in range(start, self.total)]


class StepRecorder:
    """The engine-side recorder: a step ring + a program ring + a
    request-event ring + per-trigger dump rate limiting. Every method is
    called under the owning engine's ``_lock`` (the recorder owns no
    lock; same contract as the scheduler)."""

    def __init__(self, cap: Optional[int] = None,
                 min_dump_interval_s: Optional[float] = None) -> None:
        cap = cap if cap is not None else default_cap()
        self.steps = Ring(cap)
        # A step runs up to prefill_chunks_per_step chunk programs and a
        # decode program: the programs of the step ring's steps fit.
        self.programs = Ring(cap * 4)
        # Requests produce ~4 events each; give them a wider window so
        # the request timeline spans the same wall interval as steps.
        self.events = Ring(cap * 4)
        self.dumps = 0
        self._min_dump_s = (min_dump_interval_s
                            if min_dump_interval_s is not None
                            else dump_interval_s())
        self._last_dump: Dict[str, float] = {}

    # -- recording (holds: engine _lock) -----------------------------------
    def note_step(self, rec: StepRecord) -> None:
        self.steps.append(rec)

    def note_program(self, rec: ProgramRecord) -> None:
        self.programs.append(rec)

    def note_event(self, request_id: int, tenant: str, event: str,
                   t: float, **detail: Any) -> None:
        ev = {'request_id': request_id, 'tenant': tenant,
              'event': event, 't': t}
        if detail:
            ev.update(detail)
        self.events.append(ev)

    def should_dump(self, trigger: str, now: float) -> bool:
        """Per-trigger rate limit: at most one dump per kind per
        ``min_dump_interval_s`` (the span store is sqlite; a
        preemption storm must not DoS it). ``dumps`` counts rate-
        limit passes, i.e. dumps TRIGGERED — the handoff queue is
        bounded and the store write fail-open, so completion is not
        guaranteed (metric semantics documented accordingly)."""
        last = self._last_dump.get(trigger)
        if last is not None and self._min_dump_s > 0 \
                and now - last < self._min_dump_s:
            return False
        self._last_dump[trigger] = now
        self.dumps += 1
        return True

    # -- export ------------------------------------------------------------
    def raw(self) -> Dict[str, Any]:
        """O(n) POINTER copy of the rings (oldest first) — the only
        part that needs the owner's lock. Records and event dicts are
        write-once after append, so sharing the references is safe;
        render with :func:`render_snapshot` OUTSIDE the lock."""
        return {
            'cap': self.steps.cap,
            'steps_total': self.steps.total,
            'programs_total': self.programs.total,
            'events_total': self.events.total,
            'dumps': self.dumps,
            'steps_raw': self.steps.snapshot(),
            'programs_raw': self.programs.snapshot(),
            'events': self.events.snapshot(),
        }


def render_snapshot(raw: Dict[str, Any]) -> Dict[str, Any]:
    """Expand a ``StepRecorder.raw()`` copy into the JSON-able
    snapshot shape, each step's program records under the step
    (``programs``, in dispatch order; a program whose step left the ring
    is dropped). Per-record dict building — thousands of dicts for a
    full ring — runs deliberately OUTSIDE any lock: a 1 Hz
    /debug/stepline poll must not stall the step loop for the build."""
    out = dict(raw)
    steps = [r.as_dict() for r in out.pop('steps_raw')]
    by_idx = {s['idx']: s for s in steps}
    for s in steps:
        s['programs'] = []
    for p in out.pop('programs_raw', ()):
        step = by_idx.get(p.step_idx)
        if step is not None:
            step['programs'].append(p.as_dict())
    out['steps'] = steps
    return out


def summarize(recs: List[StepRecord]) -> Dict[str, Any]:
    """Aggregate step-time breakdown over a snapshot of step records:
    total and fractional share per stage — the recorder-derived
    decomposition ``bench_ttft`` stamps into the TTFT json. Runs on a
    COPY, so callers can (and do) compute it outside any lock."""
    tot = {s: 0.0 for s in STAGES}
    kinds: Dict[str, int] = {}
    dur = 0.0
    for r in recs:
        tot['dispatch'] += r.dispatch_s
        tot['drain'] += r.drain_s
        tot['readback'] += r.readback_s
        tot['host'] += r.host_s()
        dur += r.dur_s
        kinds[r.kind] = kinds.get(r.kind, 0) + 1
    out: Dict[str, Any] = {
        'steps': len(recs),
        'step_kinds': kinds,
        'step_time_s': round(dur, 6),
        'step_mean_ms': (round(dur / len(recs) * 1e3, 4)
                         if recs else None),
    }
    for s in STAGES:
        out[f'{s}_s'] = round(tot[s], 6)
        out[f'{s}_share'] = (round(tot[s] / dur, 4) if dur
                             else None)
    return out


# ---- Perfetto export -----------------------------------------------------
# Stepline tracks use pids far above render.to_perfetto's hop pids
# (which start at 1), so a merged document never collides.
_PID_STEPS = 1000
_PID_REQUESTS = 1001
_STEP_TIDS = {name: i + 1 for i, name in enumerate(
    ('step',) + INTERVALS + ('programs', 'device gap'))}


def _program_events(steps: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The programs on the device and the idle gaps before them, on the
    host clock. A program starts at its start event's host time where
    the stream was empty then (it has a gap), else when the program
    before it ended; a gap ends where its program starts."""
    progs = sorted((p for s in steps for p in s.get('programs', ())),
                   key=lambda p: p['t'])
    events: List[Dict[str, Any]] = []
    prev_end = None
    for p in progs:
        gap = p['gap_before_s']
        start = p['t']
        if gap is not None and prev_end is not None:
            start = max(start, prev_end + gap)
        if gap:
            events.append({
                'name': 'device.idle', 'ph': 'X',
                'ts': (start - gap) * 1e6, 'dur': gap * 1e6,
                'pid': _PID_STEPS, 'tid': _STEP_TIDS['device gap'],
                'args': {'before_step': p['step_idx'],
                         'before': p['kind']}})
        events.append({
            'name': f"program.{p['kind']}", 'ph': 'X', 'ts': start * 1e6,
            'dur': p['device_s'] * 1e6, 'pid': _PID_STEPS,
            'tid': _STEP_TIDS['programs'],
            'args': {k: v for k, v in p.items() if k != 't'}})
        prev_end = start + p['device_s']
    return events


def stepline_events(snapshot: Dict[str, Any]
                    ) -> List[Dict[str, Any]]:
    """The snapshot as raw Chrome-trace events (including the track
    metadata), suitable for ``render.to_perfetto``'s
    ``extra_events`` — the stitch path that merges the recorder with
    a request's propagated spans."""
    events: List[Dict[str, Any]] = [
        {'name': 'process_name', 'ph': 'M', 'pid': _PID_STEPS,
         'tid': 1, 'args': {'name': 'engine-step'}},
        {'name': 'process_name', 'ph': 'M', 'pid': _PID_REQUESTS,
         'tid': 1, 'args': {'name': 'requests'}},
    ]
    for name, tid in _STEP_TIDS.items():
        events.append({'name': 'thread_name', 'ph': 'M',
                       'pid': _PID_STEPS, 'tid': tid,
                       'args': {'name': name}})
    steps = snapshot.get('steps', ())
    for rec in steps:
        args = {'step': rec['idx'], 'batch': rec['batch'],
                'chunk_tokens': rec['chunk_tokens'],
                'queue_depth': rec['queue_depth']}
        events.append({
            'name': f"step.{rec['kind']}", 'ph': 'X', 'ts': rec['t'] * 1e6,
            'dur': rec['dur_s'] * 1e6, 'pid': _PID_STEPS,
            'tid': _STEP_TIDS['step'],
            'args': dict(args, host_s=rec.get('host_s', 0.0))})
        # Each stage interval where it ran inside the step.
        for stage, off, dur in rec.get('stages', ()):
            events.append({
                'name': f"step.{rec['kind']}.{stage}", 'ph': 'X',
                'ts': (rec['t'] + off) * 1e6, 'dur': dur * 1e6,
                'pid': _PID_STEPS, 'tid': _STEP_TIDS[stage],
                'args': dict(args, stage=stage)})
    events.extend(_program_events(steps))
    # Request tracks: one tid per request_id; lifecycle phases become
    # 'X' slices bounded by the recorded events, everything else an
    # instant.
    # Lifecycle phase boundaries keyed by FIRST occurrence (each
    # fires once per request); repeatable events (preemption, resume,
    # shed, ...) are NOT folded into this map — every occurrence in
    # the ring gets its own instant below, so a request preempted
    # twice shows two instants, same as the span-store dump path.
    by_req: Dict[int, Dict[str, Any]] = {}
    for ev in snapshot.get('events', ()):
        by_req.setdefault(ev['request_id'], {}).setdefault(
            ev['event'], ev)
    for rid, evs in by_req.items():
        tid = (rid % 100000) + 1
        phases = (('queue_wait', 'submit', 'first_dispatch'),
                  ('prefill', 'first_dispatch', 'first_token'),
                  ('decode', 'first_token', 'done'))
        for name, a, b in phases:
            if a in evs and b in evs and evs[b]['t'] >= evs[a]['t']:
                events.append({
                    'name': f'req.{name}', 'ph': 'X',
                    'ts': evs[a]['t'] * 1e6,
                    'dur': (evs[b]['t'] - evs[a]['t']) * 1e6,
                    'pid': _PID_REQUESTS, 'tid': tid,
                    'args': {'request_id': rid,
                             'tenant': evs[a].get('tenant')}})
    for ev in snapshot.get('events', ()):
        if ev['event'] in ('submit', 'first_dispatch',
                           'first_token', 'done'):
            continue
        events.append({
            'name': f"req.{ev['event']}", 'ph': 'i',
            'ts': ev['t'] * 1e6, 's': 't',
            'pid': _PID_REQUESTS,
            'tid': (ev['request_id'] % 100000) + 1,
            'args': {k: v for k, v in ev.items() if k != 't'}})
    return events


def to_perfetto(snapshot: Dict[str, Any],
                spans: Optional[List[Dict[str, Any]]] = None
                ) -> Dict[str, Any]:
    """Chrome-trace JSON of a recorder snapshot; with ``spans``
    (propagated spans of the same request/replica) the two merge into
    one document, stitched on the wall clock + request_id."""
    events = stepline_events(snapshot)
    if spans:
        from skypilot_tpu_torch.observability import render
        return render.to_perfetto(spans, extra_events=events)
    return {'traceEvents': events, 'displayTimeUnit': 'ms'}


def validate_perfetto(doc: Any) -> List[str]:
    """Schema check for an exported trace (``[]`` = valid): the
    contract ui.perfetto.dev / chrome://tracing require. Shared by
    the tests."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return ['document is not an object']
    events = doc.get('traceEvents')
    if not isinstance(events, list):
        return ["missing 'traceEvents' list"]
    if not events:
        errs.append('traceEvents is empty')
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errs.append(f'event {i} is not an object')
            continue
        for key in ('name', 'ph', 'pid', 'tid'):
            if key not in ev:
                errs.append(f'event {i} missing {key!r}')
        ph = ev.get('ph')
        if ph not in ('X', 'M', 'i', 'B', 'E'):
            errs.append(f'event {i} has unknown phase {ph!r}')
        if ph == 'X':
            if not isinstance(ev.get('ts'), (int, float)):
                errs.append(f'event {i} missing numeric ts')
            if not isinstance(ev.get('dur'), (int, float)) \
                    or ev.get('dur', -1) < 0:
                errs.append(f'event {i} missing non-negative dur')
    return errs


# ---- anomaly dumps into the span store -----------------------------------

def dump_spans(trigger: str, detail: Dict[str, Any],
               snapshot: Dict[str, Any],
               trace_id: Optional[str] = None
               ) -> List[Dict[str, Any]]:
    """Encode one ring snapshot as span-store rows: a
    ``stepline.dump`` root carrying the trigger tag, a child span per
    step record, a child per request event (carrying its
    ``request_id`` so ``sky-tpu profile <request_id>`` finds the
    dump), and one ``stepline.trigger`` span for the anomaly
    itself."""
    if trace_id is None:
        trace_id = 'stepline-' + os.urandom(12).hex()
    now = time.time()
    root_id = os.urandom(8).hex()
    steps = snapshot.get('steps', [])
    events = snapshot.get('events', [])
    start = min([r['t'] for r in steps]
                + [e['t'] for e in events] + [now])
    spans: List[Dict[str, Any]] = [{
        'trace_id': trace_id, 'span_id': root_id, 'parent_id': None,
        'name': 'stepline.dump', 'hop': 'stepline',
        'start': start, 'dur_s': max(0.0, now - start),
        'status': 'ok',
        'attrs': {'trigger': trigger, 'steps': len(steps),
                  'events': len(events),
                  # Monotonic ring totals ride along so an exporter
                  # can tell how much history wrapped off the rings
                  # before the dump (no-silent-caps: a truncated
                  # incident must say so).
                  'steps_total': int(snapshot.get('steps_total')
                                     or len(steps)),
                  'events_total': int(snapshot.get('events_total')
                                      or len(events)),
                  'request_id': detail.get('request_id'), **detail},
    }, {
        'trace_id': trace_id, 'span_id': os.urandom(8).hex(),
        'parent_id': root_id,
        'name': 'stepline.trigger', 'hop': 'stepline',
        'start': detail.get('t', now), 'dur_s': 0.0,
        'status': f'anomaly:{trigger}',
        'attrs': {'trigger': trigger, **detail},
    }]
    for rec in steps:
        spans.append({
            'trace_id': trace_id, 'span_id': os.urandom(8).hex(),
            'parent_id': root_id,
            'name': f"step.{rec['kind']}", 'hop': 'stepline',
            'start': rec['t'], 'dur_s': rec['dur_s'], 'status': 'ok',
            'attrs': {k: v for k, v in rec.items()
                      if k not in ('t', 'dur_s', 'kind')
                      and v is not None},
        })
    for ev in events:
        spans.append({
            'trace_id': trace_id, 'span_id': os.urandom(8).hex(),
            'parent_id': root_id,
            'name': f"req.{ev['event']}", 'hop': 'stepline',
            'start': ev['t'], 'dur_s': 0.0, 'status': 'ok',
            'attrs': {k: v for k, v in ev.items() if k != 't'},
        })
    return spans


# Background dump writer: the trigger fires on the engine thread (or
# an HTTP submit thread) — sqlite writes must happen elsewhere, and
# never while any engine lock is held. Bounded queue, fail-open.
_dump_q: collections.deque = collections.deque(maxlen=64)
_dump_cv = threading.Condition()
_writer_started = False
_inflight_writes = 0
_store = None            # test/ops injection (SpanStore-compatible)


def set_dump_store(store: Any) -> None:
    """Inject the span store dumps land in (tests point this at a
    tmp-path store; None restores the default resolution)."""
    global _store
    _store = store


def _resolve_store():
    if _store is not None:
        return _store
    from skypilot_tpu_torch.observability import store as store_lib
    return store_lib.SpanStore()


def write_dump_sync(spans: List[Dict[str, Any]],
                    store: Any = None) -> Optional[str]:
    """Synchronous dump write (into ``store``, default the resolved
    one). Returns the dump's trace_id, or None on failure — fail-open
    like every observability write."""
    try:
        store = store or _resolve_store()
        store.add_spans(spans)
        store.gc()
        return spans[0]['trace_id'] if spans else None
    except Exception:  # noqa: BLE001 — telemetry must never throw
        return None


def enqueue_dump(spans: Any) -> None:
    """Queue a dump for the background writer: a span list, or a
    zero-arg callable producing one — the engine hands a thunk so the
    O(ring) span rendering runs on the writer thread, not the step
    loop. Drops oldest beyond the bound (an anomaly storm degrades to
    fewer dumps, never to a blocked engine). The store is resolved here,
    when the anomaly fires, not when the writer gets to it: a dump lands
    under the $SKY_TPU_HOME the engine ran with."""
    with _dump_cv:
        _dump_q.append((spans, _resolve_store()))
        _ensure_writer()
        _dump_cv.notify_all()


def _ensure_writer() -> None:
    global _writer_started
    if _writer_started:
        return
    _writer_started = True

    def loop() -> None:
        global _inflight_writes
        while True:
            with _dump_cv:
                while not _dump_q:
                    # Bounded wait (not an idle poll: the enqueue
                    # notifies; the timeout only re-arms the wait).
                    _dump_cv.wait(timeout=60.0)
                spans, store = _dump_q.popleft()
                _inflight_writes += 1
            try:
                if callable(spans):
                    try:
                        spans = spans()
                    except Exception:  # noqa: BLE001 — fail-open
                        spans = []
                write_dump_sync(spans, store)
            finally:
                with _dump_cv:
                    _inflight_writes -= 1
                    _dump_cv.notify_all()

    threading.Thread(target=loop, daemon=True,
                     name='stepline-dump-writer').start()


def flush_dumps(timeout_s: float = 5.0) -> bool:
    """Block until every queued dump has been written (tests; the
    serving path never calls this)."""
    deadline = time.monotonic() + timeout_s
    with _dump_cv:
        while _dump_q or _inflight_writes:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            _dump_cv.wait(remaining)
    return True


# ---- profile-smoke -------------------------------------------------------

_SMOKE_PAGE = 16


def _smoke_config(device):
    """The smoke's model: the tiny preset on the CPU; on the card the
    smallest preset whose head_dim, group and page the paged attention
    kernels take."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import paged_attention as paged_attn
    presets = (llama.LlamaConfig.tiny, llama.LlamaConfig.bench_350m,
               llama.LlamaConfig.bench_1b, llama.LlamaConfig.llama3_8b)
    if device.type != 'cuda':
        return presets[0]()
    for preset in presets:
        cfg = preset()
        try:
            paged_attn.check_cuda_shape(cfg.head_dim,
                                        cfg.n_heads // cfg.n_kv_heads,
                                        _SMOKE_PAGE)
        except ValueError:
            continue
        return cfg
    raise RuntimeError('no model preset fits the paged attention kernels')


def _check_tracks(snapshot: Dict[str, Any],
                  events: List[Dict[str, Any]]) -> List[str]:
    """What the export must draw of the snapshot: a slice on the
    ``programs`` track for each program record, and each stage interval
    of each step on its stage's track at the step's start plus its
    recorded offset. Returns what is missing."""
    def on(track):
        return [e for e in events if e.get('pid') == _PID_STEPS
                and e.get('tid') == _STEP_TIDS[track] and e['ph'] == 'X']
    errs = []
    progs = [p for s in snapshot['steps'] for p in s['programs']]
    if not progs or len(on('programs')) != len(progs):
        errs.append(f"{len(on('programs'))} program slices for "
                    f'{len(progs)} program records')
    starts = {(e['tid'], e['ts']) for e in events if e['ph'] == 'X'}
    for s in snapshot['steps']:
        for stage, off, _ in s['stages']:
            if (_STEP_TIDS[stage], (s['t'] + off) * 1e6) not in starts:
                errs.append(f"step {s['idx']}: no {stage} slice at "
                            f'offset {off}')
    return errs


def _smoke(argv: Optional[List[str]] = None) -> int:
    """Run a tiny in-process workload with the recorder on, force an
    anomaly dump (a zero TTFT SLO), and validate the live Perfetto export
    and the dump's round trip through the span store. Exit code 0: the
    flight recorder works end to end."""
    import argparse
    import json
    import tempfile

    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.observability import render
    from skypilot_tpu_torch.observability import store as store_lib

    parser = argparse.ArgumentParser(
        description='flight-recorder smoke: a forced dump, validated')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default; raises without a card) or "
                             "'cpu'")
    args = parser.parse_args(argv)
    device = engine_lib.resolve_device(args.device)
    cfg = _smoke_config(device)
    eng = engine_lib.InferenceEngine(
        cfg, engine_lib.init_params_sharded(cfg, 1, 0, 0, device),
        engine_lib.EngineConfig(
            n_slots=2, max_seq_len=128, prefill_buckets=(16, 32),
            prefill_chunk=32, paged=True, page_size=_SMOKE_PAGE,
            # Any TTFT breaches a zero SLO: one dump at least.
            ttft_slo_s=0.0),
        device=device)
    with tempfile.TemporaryDirectory() as tmp:
        store = store_lib.SpanStore(
            db_path=os.path.join(tmp, 'smoke-traces.db'))
        set_dump_store(store)
        try:
            eng.generate([[7, 8, 9], [11] * 40], max_new_tokens=8)
            snap = eng.stepline_snapshot()
            doc = to_perfetto(snap)
            errs = validate_perfetto(doc)
            if errs:
                print('profile-smoke: live export INVALID:', errs)
                return 1
            if not snap['steps']:
                print('profile-smoke: recorder captured no steps')
                return 1
            errs = _check_tracks(snap, doc['traceEvents'])
            if errs:
                print('profile-smoke: export misplaces records:', errs)
                return 1
            if not flush_dumps(10.0):
                print('profile-smoke: dump writer did not drain')
                return 1
            dump = next((t for t in store.list_traces()
                         if str(t.get('trace_id', ''))
                         .startswith('stepline-')), None)
            if dump is None:
                print('profile-smoke: no anomaly dump in the store')
                return 1
            spans = store.get_trace(dump['trace_id'])
            errs = validate_perfetto(render.to_perfetto(spans))
            if errs:
                print('profile-smoke: dump export INVALID:', errs)
                return 1
            if not any(s['name'] == 'stepline.trigger' for s in spans):
                print('profile-smoke: dump lacks the trigger span')
                return 1
            summ = eng.stepline_summary()
            print('profile-smoke OK:',
                  json.dumps({'device': str(device),
                              'model': {'dim': cfg.dim,
                                        'n_layers': cfg.n_layers,
                                        'head_dim': cfg.head_dim},
                              'steps': summ['steps'],
                              'programs': snap['programs_total'],
                              'step_mean_ms': summ['step_mean_ms'],
                              'dump_spans': len(spans),
                              'dump_trace': dump['trace_id']}))
            return 0
        finally:
            set_dump_store(None)


if __name__ == '__main__':
    import sys

    # `python -m` runs this file as `__main__`, a second module object:
    # delegate to the canonical import, so that set_dump_store reaches
    # the globals the engine's dump path reads.
    from skypilot_tpu_torch.observability import stepline as _canonical
    sys.exit(_canonical._smoke())
