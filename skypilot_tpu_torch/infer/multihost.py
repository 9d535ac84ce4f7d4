"""The lockstep driver of a tensor-parallel replica (counterpart of
``skypilot_tpu/infer/multihost.py``).

The port's ``tp`` is ``tp`` processes, one per GPU, on one host or
several. Rank 0 serves HTTP; every other rank runs :meth:`run`, the
lockstep loop, even on one host. Every rank holds an identical engine
over its slices of the weights, and on each tick:

- rank 0's queued submissions (and the stop and warm flags) reach every
  rank as two fixed-shape broadcasts on the group's host ``gloo`` group:
  the length, then the padded payload bytes;
- every rank submits them in the same order and runs the same
  ``engine.step()``. The host decisions (slots, chunks, drafts) are
  functions of the submission order and the tokens, and every rank
  samples the same tokens from the same all-gathered logits, so the
  ranks cannot diverge;
- with more than one rank, each rank's ``output_digest`` is all-gathered
  and any mismatch raises (a diverged rank must never stream tokens).

As in the reference, the lockstep loop pins the synchronous step loop
(depth 0) and turns the wall-clock deadline and cancel sweeps off (rank
clocks differ). It does not pin speculation off: the reference does so because
its hosts' prompt-lookup indexes are host-local state, while the port's
drafter reads only the request's own tokens (``Request.draft_memo``),
which the digest holds equal on every rank; so ``--spec-k`` decodes
speculatively on a tensor-parallel replica too.

The watchdog (:meth:`MultihostEngineDriver._start_watchdog`) turns a dead
peer into a process exit with ``WATCHDOG_EXIT_CODE``: time blocked inside
the tick's host collectives past ``SKY_TPU_LOCKSTEP_TICK_DEADLINE_S``, or
a whole tick (step included) past ``SKY_TPU_LOCKSTEP_HARD_DEADLINE_S``.
A collective that raises (``gloo`` sees the peer's socket close) exits
the same way from :meth:`MultihostEngineDriver.run`.

``parallel/mesh.host_env`` reads the multi-host environment the agent
injects into every host of a slice (the reference's
``runtime/distributed_env.py`` names), for serving and training alike.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel import mesh as mesh_lib

logger = logging.getLogger(__name__)

TICK_DEADLINE_ENV = 'SKY_TPU_LOCKSTEP_TICK_DEADLINE_S'
DEFAULT_TICK_DEADLINE_S = 900.0
HARD_DEADLINE_ENV = 'SKY_TPU_LOCKSTEP_HARD_DEADLINE_S'
DEFAULT_HARD_DEADLINE_S = 7200.0
WATCHDOG_EXIT_CODE = 42


def _broadcast_bytes(data: Optional[bytes],
                     group: Optional[mesh_lib.TPGroup]) -> bytes:
    """Rank 0's bytes on every rank (``data`` is ignored elsewhere)."""
    return collectives.broadcast_bytes(data, group)


def warm_programs(engine) -> None:
    """Capture each greedy step program (every chunk bucket, decode,
    verify, mixed) of every graph-capturing tier of ``engine`` (one engine
    or an ``EnginePool``)."""
    for eng in getattr(engine, 'engines', [engine]):
        if eng.graphs_on:
            eng.warm_programs()


class MultihostEngineDriver:
    """Lockstep wrapper around an engine (or ``EnginePool``) replicated on
    every rank of ``group`` (None: a single rank)."""

    # Concurrency contract: `_pending` is shared between HTTP handler
    # threads (submit, warm) and rank 0's tick loop, always under
    # `_lock`. `_stop`, `_collective_since` and `_last_tick` are
    # GIL-atomic scalars (one writer, the watchdog reads them).
    _GUARDED_BY = {
        '_pending': '_lock',
    }

    def __init__(self, engine, group: Optional[mesh_lib.TPGroup] = None
                 ) -> None:
        self.engine = engine
        self.group = group
        if hasattr(engine, 'set_pipeline_depth'):
            # Every rank must see identical request state after each
            # tick; the overlapped loop leaves it stale by one.
            engine.set_pipeline_depth(0)
        if hasattr(engine, 'set_wallclock_cancel'):
            # Deadline and disconnect sweeps read the local wall clock.
            engine.set_wallclock_cancel(False)
        self.rank = group.rank if group is not None else 0
        self.world = group.world if group is not None else 1
        self._pending: List[Dict[str, Any]] = []   # rank 0 only
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stop = False
        self._tick_deadline = float(os.environ.get(
            TICK_DEADLINE_ENV, DEFAULT_TICK_DEADLINE_S))
        self._hard_deadline = float(os.environ.get(
            HARD_DEADLINE_ENV, DEFAULT_HARD_DEADLINE_S))
        # Set while blocked inside a tick's host collective (None
        # otherwise); the last completed tick feeds the hard backstop.
        self._collective_since: Optional[float] = None
        self._last_tick = time.monotonic()
        self._watchdog_started = False
        self.ticks = 0

    def _die(self, stalled: float, *,
             reason: str = 'stuck in the submission collective',
             deadline: Optional[float] = None) -> None:
        """Watchdog kill (isolated so tests can observe it instead).
        ``os._exit``: the main thread is wedged in a native collective and
        would never unwind a SystemExit."""
        logger.error(
            'lockstep watchdog: rank %d/%d %s %.0fs (> %.0fs); a peer rank '
            'is gone, exiting so the replica manager can relaunch the '
            'replica', self.rank, self.world, reason, stalled,
            deadline if deadline is not None else self._tick_deadline)
        os._exit(WATCHDOG_EXIT_CODE)

    def _start_watchdog(self) -> None:
        """A side thread that watches time-in-collective (never
        ``engine.step``, so a slow step on a healthy replica never trips
        it) and, as a backstop, whole-tick time. The two deadlines are
        independent; a deadline <= 0 is off."""
        if self._watchdog_started or (self._tick_deadline <= 0 and
                                      self._hard_deadline <= 0):
            return
        self._watchdog_started = True
        shortest = min(d for d in (self._tick_deadline,
                                   self._hard_deadline) if d > 0)
        interval = min(5.0, max(0.05, shortest / 4))

        def loop() -> None:
            while not self._stop:
                now = time.monotonic()
                since = self._collective_since
                if (self._tick_deadline > 0 and since is not None and
                        now - since > self._tick_deadline):
                    self._die(now - since)
                if (self._hard_deadline > 0 and
                        now - self._last_tick > self._hard_deadline):
                    self._die(now - self._last_tick,
                              reason='whole tick wedged (step included)',
                              deadline=self._hard_deadline)
                time.sleep(interval)

        threading.Thread(target=loop, daemon=True,
                         name='lockstep-watchdog').start()

    # ---- rank-0 API (HTTP handler threads) -------------------------------
    def _enqueue(self, entry: Dict[str, Any]):
        assert self.rank == 0, 'only rank 0 accepts requests'
        entry.update(event=threading.Event(), request=None, error=None)
        with self._lock:
            self._pending.append(entry)
        self._work.set()
        entry['event'].wait()
        if entry['error'] is not None:
            raise entry['error']
        return entry['request']

    def submit(self, prompt_tokens, max_new_tokens=None,
               temperature: float = 0.0, resume_tokens=None,
               spec: bool = True, tenant: Optional[str] = None):
        """Queue a submission for the next tick; block until every rank
        admitted it, then return this rank's Request (or raise the
        engine's ValueError / AdmissionError, raised alike on every
        rank). Wall-clock deadlines are not carried (rank clocks
        differ)."""
        spec_ = {'prompt_tokens': list(map(int, prompt_tokens)),
                 'max_new_tokens': max_new_tokens,
                 'temperature': float(temperature),
                 'resume_tokens': (list(map(int, resume_tokens))
                                   if resume_tokens else None),
                 'spec': bool(spec)}
        if tenant is not None:
            spec_['tenant'] = str(tenant)
        return self._enqueue({'spec': spec_})

    def warm(self) -> None:
        """Run every graph-capturing tier's ``warm_programs()`` on every
        rank in one tick (their step programs hold collectives, so the
        ranks must run them together); blocks until it ran."""
        self._enqueue({'warm': True})

    def stop(self) -> None:
        self._stop = True
        self._work.set()   # wake the idle loop to broadcast the stop

    # ---- the lockstep loop (every rank) -----------------------------------
    def _collective(self, fn, *args):
        self._collective_since = time.monotonic()
        try:
            return fn(*args)
        finally:
            self._collective_since = None

    def tick(self) -> bool:
        """One broadcast and one engine step on every rank. Returns False
        when the replica is shutting down."""
        batch: List[Dict[str, Any]] = []
        payload = None
        if self.rank == 0:
            with self._lock:
                batch, self._pending = self._pending, []
            payload = json.dumps({
                'ops': [{'warm': True} if e.get('warm') else e['spec']
                        for e in batch],
                'stop': self._stop,
            }).encode()
        data = self._collective(_broadcast_bytes, payload, self.group)
        msg = json.loads(data) if data else {'ops': [], 'stop': False}
        for i, op in enumerate(msg['ops']):
            req, err = None, None
            try:
                if op.get('warm'):
                    warm_programs(self.engine)
                else:
                    kw = {'spec': op.get('spec', True)}
                    if 'tenant' in op:
                        kw['tenant'] = op['tenant']
                    req = self.engine.submit(
                        op['prompt_tokens'],
                        max_new_tokens=op['max_new_tokens'],
                        temperature=op['temperature'],
                        resume_tokens=op.get('resume_tokens'), **kw)
            except ValueError as e:
                # The same validation on the same spec rejects it on
                # every rank (AdmissionError is a ValueError): lockstep
                # holds.
                err = e
            if self.rank == 0:
                batch[i]['request'] = req
                batch[i]['error'] = err
                batch[i]['event'].set()
        if msg.get('stop'):
            return False
        self.engine.step()
        if self.world > 1 and hasattr(self.engine, 'output_digest'):
            digests = self._collective(
                collectives.all_gather_u32,
                int(self.engine.output_digest()), self.group)
            self._check_digests(digests)
        self.ticks += 1
        self._last_tick = time.monotonic()
        return True

    def _check_digests(self, digests: List[int]) -> None:
        """Raise on any divergence between the ranks' output digests."""
        if len(set(digests)) > 1:
            raise RuntimeError(
                f'lockstep desync: rank {self.rank}/{self.world} sees '
                f'per-rank output digests {digests}; a rank diverged, '
                f'failing the replica instead of streaming diverged '
                f'tokens')

    def run(self, idle_sleep: float = 0.05) -> None:
        """Tick until stopped, under the watchdog. Rank 0 waits only when
        the engine is idle and nothing is queued (a submit wakes it at
        once); the other ranks wait inside the broadcast. Any error in the
        loop exits the process with ``WATCHDOG_EXIT_CODE``."""
        self._last_tick = time.monotonic()
        self._start_watchdog()
        try:
            while self.tick():
                if self.rank == 0 and self.engine.idle():
                    with self._lock:
                        quiet = not self._pending
                    if quiet and not self._stop:
                        self._work.wait(idle_sleep)
                        self._work.clear()
        except Exception:  # noqa: BLE001 -- any lockstep error is fatal
            logger.exception('lockstep rank %d/%d: the loop failed; '
                             'exiting for replica recovery', self.rank,
                             self.world)
            os._exit(WATCHDOG_EXIT_CODE)
        finally:
            self._stop = True


def maybe_initialize_distributed(tp: int, local_index: int = 0,
                                 device_type: str = 'cuda',
                                 address: Optional[str] = None,
                                 backend: Optional[str] = None
                                 ) -> mesh_lib.TPGroup:
    """Join this process's rank of a ``tp``-rank replica: global rank =
    host id x ranks per host + ``local_index``, on ``cuda:<local_index>``
    (or the CPU), at ``address`` (default: the coordinator the agent
    injected). ``tp`` 1: nothing is initialized."""
    if tp == 1:
        return mesh_lib.single(mesh_lib.rank_device(device_type, 0))
    n_hosts, host_id, coordinator = mesh_lib.host_env()
    per = tp // n_hosts
    rank = host_id * per + local_index
    return mesh_lib.tp_group(rank, tp, address or coordinator,
                             mesh_lib.rank_device(device_type, local_index),
                             backend)
