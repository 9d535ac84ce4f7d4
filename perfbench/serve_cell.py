"""A serving cell: the replica in a child process, the load from this one.

The child (``perfbench.serve_child``) builds and warms the replica. This
process sends one warm-up request over HTTP, then drives the cell's
traffic against ``/generate`` for the window, clocking every request on
its own side; with ``--trace 1`` it has the child profile a steady
sub-window at the window's end (the host-side layers are read before
it), stopping the profiler only once the traffic has ended. After the
window it reads the child's step records, peak memory and loaded
modules, stops the child, and only then runs the plain reference on the
device over a seeded sample of the finished requests.
"""
from __future__ import annotations

import collections
import dataclasses
import importlib
import json
import os
import queue
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

from perfbench import client as client_lib
from perfbench import flops
from perfbench import spec as spec_lib
from perfbench import traffic
from perfbench.weights import Dims


@dataclasses.dataclass
class ServeRun:
    """What a serving run saw; the metric readers read it."""
    cell: spec_lib.Cell
    dims: Dims
    seconds: float
    t0: float                       # the window's start (wall clock)
    records: List[client_lib.Record]
    steps: List[Dict[str, Any]]     # the flight recorder's step records
    profile: Optional[Dict[str, Any]]
    profile_span: Optional[tuple]   # (start, stop) wall clock
    setup_s: float
    drain_wait_s: float
    device_kind: str
    memory_peak_bytes: int
    replica_setup: Dict[str, Any]
    forbidden: List[str]            # modules of run.FORBIDDEN in the replica

    @property
    def t1(self) -> float:
        return self.t0 + self.seconds

    @property
    def counted(self) -> List[client_lib.Record]:
        return [r for r in self.records if r.counted]

    @property
    def host_span(self) -> tuple:
        """Where the host-side layers are read: the window up to the
        profiled sub-window (the window's end, in a traced run), so that
        the profiler's own cost on the host does not enter them."""
        return (self.t0, self.profile_span[0] if self.profile_span
                else self.t1)

    def window_steps(self, lo: Optional[float] = None,
                     hi: Optional[float] = None) -> List[Dict[str, Any]]:
        lo = self.host_span[0] if lo is None else lo
        hi = self.host_span[1] if hi is None else hi
        return [s for s in self.steps if lo <= s['t'] < hi]

    def decode_contexts(self, lo: float, hi: float) -> List[int]:
        """The context (keys seen) of every decoded token that reached
        the client in [lo, hi): token i >= 1 of a request with a
        P-token prompt was decoded at position P + i - 1 and saw P + i
        keys (token 0 comes from the prompt's last chunk)."""
        out = []
        for r in self.records:
            i = 0
            p = len(r.prompt)
            for t, n in r.arrivals:
                for _ in range(n):
                    if i >= 1 and lo <= t < hi:
                        out.append(p + i)
                    i += 1
        return out

    def prefill_chunks(self, lo: float, hi: float) -> List[tuple]:
        """(offset, true length, ends the prompt) of every prefill chunk
        reckoned to have run in [lo, hi): a request's chunks are spread
        evenly between its first dispatch (the done line's queue wait)
        and its first token. A reckoning: the port counts no chunk by
        time."""
        out = []
        for r in self.records:
            if not r.arrivals or r.done is None \
                    or r.done.get('queue_wait_s') is None:
                continue
            submitted = r.arrivals[0][0] - (r.done.get('ttft_s') or 0.0)
            start = submitted + r.done['queue_wait_s']
            end = r.arrivals[0][0]
            chunks = list(flops.prefill_chunks(len(r.prompt)))
            for k, (off, n) in enumerate(chunks):
                at = start + (k + 0.5) / len(chunks) * (end - start)
                if lo <= at < hi:
                    out.append((off, n, k == len(chunks) - 1))
        return out


class Child:
    """The replica process and its command channel."""

    def __init__(self, cell: spec_lib.Cell, seed: int, device: str,
                 engine: Dict[str, Any], config_path: str,
                 trace: bool = False) -> None:
        env = dict(os.environ)
        tmp = env.get('TMPDIR') or tempfile.gettempdir()
        env.update({
            'SKY_TPU_STEPLINE_CAP': str(cell.params.get('stepline_cap',
                                                        65536)),
            'SKY_TPU_HOME': os.path.join(tmp, 'perfbench-sky-home'),
            'TRITON_CACHE_DIR': str(spec_lib.CACHE_DIR / 'triton'),
            'TORCH_EXTENSIONS_DIR': str(spec_lib.CACHE_DIR /
                                        'torch_extensions'),
            'USE_FLAX': '0', 'USE_TF': '0',
            'PYTHONPATH': os.pathsep.join(
                [str(spec_lib.ROOT)] + ([env['PYTHONPATH']]
                                        if env.get('PYTHONPATH') else [])),
        })
        self.log = tempfile.NamedTemporaryFile(
            'w+', prefix='perfbench-replica-', suffix='.log', dir=tmp,
            delete=False)
        self.proc = subprocess.Popen(
            [sys.executable, '-m', 'perfbench.serve_child',
             '--config', config_path, '--engine', json.dumps(engine),
             '--seed', str(seed), '--device', device,
             '--build-dir', str(spec_lib.BUILD_DIR)]
            + (['--trace'] if trace else []),
            cwd=str(spec_lib.ROOT), env=env, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self.log, text=True)
        self._lock = threading.Lock()
        self._lines: queue.Queue = queue.Queue()
        threading.Thread(target=self._pump, daemon=True).start()

    def read(self, timeout_s: float) -> Dict[str, Any]:
        """The child's next message; kills it if none comes in
        ``timeout_s`` (a hung replica must not hang the run)."""
        try:
            msg = self._lines.get(timeout=timeout_s)
        except queue.Empty:
            self.proc.kill()
            raise RuntimeError(f'the replica said nothing for {timeout_s:g} '
                               f's: ' + self.log_tail()) from None
        if msg is None:
            raise RuntimeError('the replica exited: ' + self.log_tail())
        return msg

    def _pump(self) -> None:
        for line in self.proc.stdout:
            line = line.strip()
            if line.startswith('{'):
                self._lines.put(json.loads(line))
        self._lines.put(None)

    def ask(self, cmd: str, timeout_s: float = 300.0,
            **args: Any) -> Dict[str, Any]:
        with self._lock:
            self.proc.stdin.write(json.dumps(dict(args, cmd=cmd)) + '\n')
            self.proc.stdin.flush()
            return self.read(timeout_s)

    def log_tail(self, n: int = 4000) -> str:
        self.log.flush()
        with open(self.log.name) as f:
            return f.read()[-n:]

    def close(self) -> None:
        try:
            if self.proc.poll() is None:
                try:
                    self.ask('exit', 60)
                except (RuntimeError, OSError, ValueError):
                    pass
                try:
                    self.proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    self.proc.kill()
                    self.proc.wait(timeout=30)
        finally:
            self.log.close()
            os.unlink(self.log.name)


def _driver(cell: spec_lib.Cell):
    """The traffic module of the cell's mix kind
    (``perfbench/traffic/<kind>.py``)."""
    kind = cell.traffic['kind']
    return importlib.import_module(f'perfbench.traffic.{kind}')


def run(cell: spec_lib.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = 'cuda',
        engine_over: Optional[Dict[str, Any]] = None,
        config_path: Optional[str] = None) -> ServeRun:
    """Drive one serving run; the replica is stopped when it returns."""
    config_path = config_path or str(
        spec_lib.ROOT / next(c['file'] for c in spec_lib.benchmark()
                             ['configs']
                             if c['name'] == cell.entry['config']))
    with open(config_path) as f:
        dims = Dims.of(json.load(f))
    engine = dict(cell.params['engine'], **(engine_over or {}))
    params = dict(cell.traffic, **cell.params.get('traffic', {}))
    drain_wait_s = float(cell.params.get('drain_wait_s', 60))
    child = Child(cell, seed, device, engine, config_path, trace)
    try:
        # The first run in a checkout builds the kernels (nvcc).
        ready = child.read(1100)
        if not ready.get('ready'):
            raise RuntimeError(f'the replica did not start: {ready}')
        port = ready['port']
        # One request over HTTP before the window: the client's path
        # and the replica's stream path, at the mix's longest prompt.
        warm = client_lib.Record(
            idx=-1, prompt=traffic.token_ids(
                traffic.rng(seed, 7), params['prompt']['max'], dims.vocab),
            max_new=4, due=time.time())
        client_lib.stream(port, warm)
        if not warm.finished:
            raise RuntimeError(f'the warm-up request failed: {warm.error}')
        t0 = time.time() + 0.25
        setup_s = t0 - t_start
        profile: Dict[str, Any] = {}
        prof_thread = None
        if trace:
            p = float(cell.params.get('profile_s', 2.0))

            def profile_window() -> None:
                time.sleep(max(0.0, t0 + seconds - 0.5 - p - time.time()))
                child.ask('profile_start', 120)
            prof_thread = threading.Thread(target=profile_window,
                                           daemon=True)
            prof_thread.start()
        records = _driver(cell).run(port, params, seed, seconds, dims.vocab,
                                    t0, drain_wait_s)
        if prof_thread is not None:
            # The profiler stops once the traffic has ended and the
            # replica is idle (stopped under the busy engine loop, it hung
            # the replica in 2 of 8 traced runs); the trace is read over
            # its first ``profile_s`` seconds.
            prof_thread.join(timeout=120)
            time.sleep(1.0)
            child.ask('profile_stop', 120)
            profile.update(child.ask('profile_reduce', 180, seconds=p)
                           ['profile'])
        stats = child.ask('stats')
    finally:
        child.close()
    errors = collections.Counter(r.error for r in records if r.error)
    for error, n in errors.most_common(5):
        print(f'requests failed ({n}): {error}', file=sys.stderr)
    return ServeRun(cell=cell, dims=dims, seconds=seconds, t0=t0,
                    records=records, steps=stats['steps'],
                    profile=profile or None,
                    profile_span=((profile['start_wall'], profile['stop_wall'])
                                  if profile else None),
                    setup_s=setup_s, drain_wait_s=drain_wait_s,
                    device_kind=stats['device_kind'],
                    memory_peak_bytes=stats['memory_peak_bytes'],
                    replica_setup=ready['setup'],
                    forbidden=stats['forbidden'])


def label_gaps(run: ServeRun, gaps: List[list]) -> List[list]:
    """Name each idle gap by what the engine's host loop was doing at
    its middle: the step kind and the stage that took most of it."""
    out = []
    for _, length, start in gaps:
        mid = start + length / 2
        what = 'no step (engine idle)'
        for s in run.steps:
            if s['t'] <= mid < s['t'] + s['dur_s']:
                stages = {k: s[f'{k}_s'] for k in
                          ('dispatch', 'drain', 'readback', 'host')}
                what = (f"{s['kind']} step, mostly "
                        f"{max(stages, key=stages.get)}")
                break
        out.append([what, length])
    return out
