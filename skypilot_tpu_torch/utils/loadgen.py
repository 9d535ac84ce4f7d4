"""Seeded request traces and their replay over HTTP (the part of the
reference's ``tests/load_tests/loadgen.py`` that the port's ``bench_ttft
--sweep tenants`` uses; the port imports nothing under ``tests/`` or of the
JAX package, whose ``sim/tracefmt.py`` that module builds on).

- :func:`synthesize`: a deterministic multi-tenant trace of the
  constant-rate shape (bursty arrivals, heavy-tail prompt lengths, shared
  prefix cohorts, mid-stream disconnects, deadlines): for the same seed
  and spec the reference's events, field by field. A spec key it does not
  carry (the reference's rate ``envelope``) raises.
- :func:`load_trace`: a trace file the reference's ``save_trace`` wrote
  (the versioned schema: a ``{"sky_tpu_trace": 2, "schema_version": 2,
  ...}`` header, then one record a line) or a version-less v1 file. A
  scrubbed record (lengths and a cohort hash, no token ids) raises: only
  token-carrying traces replay here.
- :func:`replay_over_http` fires each event at its offset on a worker
  thread, streams its ``/generate`` with the tenant header, and records
  the client's TTFT and time between tokens, the done line's queue wait,
  and 429 sheds; :func:`tenant_summary` rolls the records up per tenant.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import random
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

TRACE_MAGIC = 'sky_tpu_trace'
SCHEMA_VERSION = 2

# The per-tenant spec keys synthesize() carries (the reference's, without
# its rate envelope).
SPEC_KEYS = frozenset({
    'rps', 'burst', 'prompt_mean', 'prompt_max', 'max_new',
    'shared_prefix_frac', 'prefix_tokens', 'disconnect_frac', 'deadline_s',
    'start', 'until'})


@dataclasses.dataclass
class TraceEvent:
    """One request arrival; ``t`` is seconds from the trace's start."""

    t: float
    tenant: str
    tokens: List[int]        # prompt token ids
    max_new_tokens: int
    cohort: Optional[str] = None            # shared-prefix cohort label
    disconnect_after: Optional[int] = None  # hang up after N tokens
    deadline_s: Optional[float] = None      # per-request budget

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> 'TraceEvent':
        return cls(t=float(d['t']), tenant=str(d['tenant']),
                   tokens=[int(x) for x in d['tokens']],
                   max_new_tokens=int(d['max_new_tokens']),
                   cohort=d.get('cohort'),
                   disconnect_after=d.get('disconnect_after'),
                   deadline_s=d.get('deadline_s'))


def _block(rng: random.Random, n: int) -> List[int]:
    """n token ids in [2, 201], inside every model's vocabulary."""
    return [2 + rng.randrange(200) for _ in range(n)]


def synthesize(seed: int, tenants: Dict[str, Dict[str, Any]],
               duration_s: float = 2.0) -> List[TraceEvent]:
    """A deterministic trace: for each tenant (in name order, each with
    its own ``random.Random(f'{seed}/{name}')``, so adding a tenant never
    moves another's arrivals) bursts of ``burst`` requests at exponential
    gaps that keep the mean rate at ``rps``, prompts of bounded-Pareto
    length around ``prompt_mean`` (at most ``prompt_max``), ``max_new``
    tokens each, a ``shared_prefix_frac`` of them led by one of two cohort
    blocks of ``prefix_tokens``, a ``disconnect_frac`` hanging up after
    half their budget, ``deadline_s`` on every event, active in
    [``start``, ``until``). Sorted by arrival."""
    events: List[TraceEvent] = []
    for name in sorted(tenants):
        spec = tenants[name]
        unknown = set(spec) - SPEC_KEYS
        if unknown:
            raise ValueError(f'tenant {name!r}: spec keys {sorted(unknown)} '
                             f'are not carried here (have '
                             f'{sorted(SPEC_KEYS)})')
        rng = random.Random(f'{seed}/{name}')
        rps = float(spec['rps'])
        burst = max(1, int(spec.get('burst', 1)))
        prompt_mean = int(spec.get('prompt_mean', 16))
        prompt_max = int(spec.get('prompt_max', 64))
        max_new = int(spec.get('max_new', 8))
        shared_frac = float(spec.get('shared_prefix_frac', 0.0))
        prefix_tokens = int(spec.get('prefix_tokens', 32))
        disconnect_frac = float(spec.get('disconnect_frac', 0.0))
        deadline_s = spec.get('deadline_s')
        start = float(spec.get('start', 0.0))
        until = float(spec.get('until', duration_s))
        cohorts = [(f'{name}/c{i}',
                    _block(random.Random(f'{seed}/{name}/cohort{i}'),
                           prefix_tokens))
                   for i in range(2)]
        t = start
        while t < until:
            for b in range(burst):
                n = max(1, min(prompt_max,
                               int(prompt_mean
                                   * rng.paretovariate(2.0) / 2)))
                cohort = None
                prefix: List[int] = []
                if shared_frac and rng.random() < shared_frac:
                    cohort, prefix = cohorts[rng.randrange(len(cohorts))]
                tail = _block(rng, n)
                disconnect = None
                if disconnect_frac and rng.random() < disconnect_frac:
                    disconnect = max(1, max_new // 2)
                events.append(TraceEvent(
                    t=round(t + b * 1e-4, 6), tenant=name,
                    tokens=prefix + tail, max_new_tokens=max_new,
                    cohort=cohort, disconnect_after=disconnect,
                    deadline_s=deadline_s))
            t += rng.expovariate(rps / burst)
    events.sort(key=lambda e: e.t)
    return events


def load_trace(path: str) -> Tuple[List[TraceEvent], Dict[str, Any]]:
    """(events, header meta) of a token-carrying trace file; raises
    ValueError, naming the file and line, on anything else."""
    with open(path, encoding='utf-8') as f:
        try:
            header = json.loads(f.readline())
        except ValueError:
            raise ValueError(f'{path}: not a sky-tpu trace file (first line '
                             f'is not JSON)')
        if not isinstance(header, dict) or TRACE_MAGIC not in header:
            raise ValueError(f'{path}: not a sky-tpu trace file (missing '
                             f'{TRACE_MAGIC!r} header)')
        version = header[TRACE_MAGIC]
        if version not in (1, SCHEMA_VERSION):
            raise ValueError(f'{path}: trace schema version {version!r} is '
                             f'not supported (reads v1 and '
                             f'v{SCHEMA_VERSION})')
        events: List[TraceEvent] = []
        for i, line in enumerate(f, start=2):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                raise ValueError(f'{path}:{i}: malformed JSON record')
            if version == SCHEMA_VERSION:
                kind = rec.pop('type', None)
                if kind in ('fault', 'kill'):
                    continue          # a fault timeline: not replayed here
                if kind != 'request':
                    raise ValueError(f'{path}:{i}: unknown record type '
                                     f'{kind!r}')
            if 'tokens' not in rec:
                raise ValueError(f'{path}:{i}: a scrubbed record (no token '
                                 f'ids); only token-carrying traces replay')
            try:
                events.append(TraceEvent.from_json(rec))
            except (KeyError, TypeError, ValueError) as e:
                raise ValueError(f'{path}:{i}: malformed request record: '
                                 f'{e}')
    meta = {k: v for k, v in header.items()
            if k not in ('schema_version', 'kind', 'truncated')}
    return events, meta


def _http_one(gen_url: str, ev: TraceEvent, tenant_header: str,
              timeout: float) -> Dict[str, Any]:
    """One event's streamed ``/generate``: its record."""
    rec: Dict[str, Any] = {
        'tenant': ev.tenant, 'shed': False, 'ttft': None,
        'queue_wait': None, 'itls': [], 'finish_reason': None,
        'tokens': 0, 'completed': False}
    payload = {'tokens': ev.tokens, 'max_new_tokens': ev.max_new_tokens,
               'stream': True}
    req = urllib.request.Request(
        gen_url, data=json.dumps(payload).encode(),
        headers={'Content-Type': 'application/json',
                 tenant_header: ev.tenant})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            t_prev = None
            for line in iter(r.readline, b''):
                now = time.perf_counter()
                if not line.strip():
                    continue
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue
                toks = obj.get('tokens') or []
                if toks:
                    if rec['ttft'] is None:
                        rec['ttft'] = now - t0
                    elif t_prev is not None:
                        rec['itls'].extend(
                            [(now - t_prev) / len(toks)] * len(toks))
                    t_prev = now
                    rec['tokens'] += len(toks)
                if obj.get('done'):
                    rec['completed'] = True
                    rec['finish_reason'] = obj.get('finish_reason')
                    rec['queue_wait'] = obj.get('queue_wait_s')
                    break
                if (ev.disconnect_after is not None
                        and rec['tokens'] >= ev.disconnect_after):
                    rec['finish_reason'] = 'client_disconnect'
                    break   # closing the response is the hang-up
    except urllib.error.HTTPError as e:
        if e.code == 429:
            rec['shed'] = True
            rec['finish_reason'] = 'shed'
        else:
            rec['finish_reason'] = f'http_{e.code}'
    except (OSError, ValueError) as e:   # a dead stream is data here
        rec['finish_reason'] = f'error_{type(e).__name__}'
    return rec


def replay_over_http(events: List[TraceEvent], gen_url: str,
                     tenant_header: str = 'X-SkyTpu-Tenant',
                     speed: float = 1.0, timeout: float = 300.0,
                     max_workers: int = 64) -> List[Dict[str, Any]]:
    """Replay a trace against a live ``/generate``: each event fires at its
    speed-scaled offset on a worker thread and streams its answer. Returns
    one record per event, in trace order: ``tenant``, ``shed`` (a 429),
    ``ttft`` (s), ``itls`` (s a token after the first), ``queue_wait``
    (the done line's), ``finish_reason``, ``tokens`` and ``completed``."""
    t0 = time.perf_counter()

    def run(ev: TraceEvent) -> Dict[str, Any]:
        delay = ev.t / speed - (time.perf_counter() - t0)
        if delay > 0:
            time.sleep(delay)
        return _http_one(gen_url, ev, tenant_header, timeout)

    workers = min(max_workers, max(1, len(events)))
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        return list(pool.map(run, events))


def pct(vals: List[float], p: float) -> Optional[float]:
    if not vals:
        return None
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(len(vals) * p))]


def tenant_summary(records: List[Dict[str, Any]]
                   ) -> Dict[str, Dict[str, Any]]:
    """Per-tenant rollup of replay records: issued and shed counts, TTFT
    and queue-wait percentiles (s; queue wait in ms) and the time between
    tokens (ms). ``steps_waited_p50``/``p99`` are kept so that the rollup
    equals the reference's: only its in-process replay records decode
    steps waited, so over HTTP they are None."""
    out: Dict[str, Dict[str, Any]] = {}
    for tenant in sorted({r['tenant'] for r in records}):
        rs = [r for r in records if r['tenant'] == tenant]
        ttfts = [r['ttft'] for r in rs if r['ttft'] is not None]
        waits = [r['queue_wait'] for r in rs
                 if r.get('queue_wait') is not None]
        steps = [r['steps_waited'] for r in rs
                 if r.get('steps_waited') is not None]
        itls = [x for r in rs for x in r.get('itls', [])]
        shed = sum(1 for r in rs if r['shed'])
        w50, w99 = pct(waits, 0.50), pct(waits, 0.99)
        i50, i99 = pct(itls, 0.50), pct(itls, 0.99)
        out[tenant] = {
            'issued': len(rs),
            'shed': shed,
            'shed_rate': round(shed / len(rs), 4),
            'ttft_p50_s': pct(ttfts, 0.50),
            'ttft_p99_s': pct(ttfts, 0.99),
            'steps_waited_p50': pct(steps, 0.50),
            'steps_waited_p99': pct(steps, 0.99),
            'queue_wait_p50_ms': round(w50 * 1e3, 3) if waits else None,
            'queue_wait_p99_ms': round(w99 * 1e3, 3) if waits else None,
            'itl_p50_ms': round(i50 * 1e3, 3) if itls else None,
            'itl_p99_ms': round(i99 * 1e3, 3) if itls else None,
        }
    return out
