"""HTTP inference server: the replica a serving deployment runs
(counterpart of ``skypilot_tpu/infer/server.py``, with the same routes and
wire format for what this slice ports).

Endpoints:

- ``GET  /health``   -> 200 ``{"status": "ok"}`` once the engine is warm,
  503 ``{"status": "warming"}`` before (``"dead"`` if the loop died,
  ``"corrupt"`` once the SDC sentinel tripped, ``"draining"`` once a
  drain began).
- ``POST /generate`` -> {"tokens": [int] | "prompt": str, optional
  "max_new_tokens", "temperature", "stream", "spec", "tenant",
  "resume_from"}. The answer is one JSON object, or with ``"stream":
  true`` JSON lines: ``{"tokens", "text"}`` per token batch and a final
  ``{"done": true, ...}`` line. ``"resume_from"`` (token ids a died
  stream already delivered) continues that stream: the engine prefills
  prompt + those tokens and only new tokens are streamed (the full list
  in a plain answer, as the reference's). Once the sentinel tripped it
  answers 503 ``{"quarantined": true}``. ``"spec": false`` opts the
  request out of speculative drafting; both answers carry its
  ``accepted_len_mean`` (tokens per verify step it drafted in, None
  when it never drafted). The
  ``X-SkyTpu-Tenant`` header (or the body's ``tenant``) names the
  request's tenant for the scheduler; ``X-SkyTpu-Deadline-S`` gives it a
  wall-clock budget (504 when spent before the first token). Past the
  engine's queue bounds the answer is 429 with a computed
  ``Retry-After``; once draining, 503 with ``Retry-After: 1``.
- ``POST /drain``    -> {optional "deadline_s" (default 30)}: stop
  admitting, then answer once every in-flight request finished (or the
  deadline lapsed): ``{"status": "drained" | "draining", "inflight",
  "drain_duration_s"}``.
- ``GET  /metrics``  -> engine metrics as JSON (TTFT p50, decode tokens,
  steps, the scheduler and its per-tenant stats, the pipeline depth,
  preemptions, the KV dtype and page bytes, the speculation counters,
  the fused-step and stall counters, the recorder's and the sentinel's,
  each kernel's launch count, the prefix cache's and the KV transfers'
  counters) plus the server's drain and shed state and its ``role``;
  with the prefix cache on, ``kv_prefix_index``: the radix tree's
  chained-hash summary for the serve load balancer's fleet index,
  delta-encoded against ``?prefix_gen=N``. ``?format=prometheus`` gives
  the same as Prometheus text.
- ``GET  /debug/stepline`` -> the flight recorder's rings as JSON.
- ``POST /kv/export`` -> {"tokens": [int]}: this replica's cached KV pages
  for the prompt's prefix in the int8 wire format (``kv_wire.py``,
  ``application/octet-stream``), at most ``--kv-export-max-pages`` pages;
  404 when nothing is cached, 409 when the prefix cache is off, 503 when
  the engine failed or did not answer within ``--kv-pull-timeout-s``.

A ``/generate`` carrying ``X-SkyTpu-KV-Donor: <url>`` (the load balancer
names a replica that holds a longer cached prefix) first pulls that
donor's ``/kv/export`` of the prompt and grafts it into the local prefix
cache, so the prefill starts at the transferred boundary. Best effort end
to end: any failure (donor unreachable or stalled past the budget, a
corrupt blob, a dry pool) is counted in ``kv_transfer_failures`` and the
request recomputes; the client never sees it.

It uses the standard library's ``ThreadingHTTPServer``: one thread per
connection enqueues its request and waits on the request's condition,
while a background thread drives ``engine.step()`` (continuous batching
over every waiting request).

Without ``--checkpoint DIR`` (the params of the latest checkpoint under
DIR, as ``train.run`` writes them) the server serves random weights sized
by ``--model``, drawn from ``--seed``. ``--quantize`` serves int8 weights
(restored to the host and quantized onto the card leaf by leaf, or the
int8 form of the random draw); ``--tokenizer`` names a ``tokenizer.json``
(the optional ``tokenizers`` package) or a sentencepiece ``.model`` for
text prompts. The replica stamps its cold-start timeline into the recorder:
``coldstart.weights_loaded`` (``load_s``) once the weights exist,
``coldstart.compiled`` (``warm_s``, ``total_s``) once every tier is warm.
On the card its boot-time compile is ``nvcc``: the kernel sources the
replica launches are compiled in parallel at the start of the warm-up
(rank 0's, under ``--tp``; the other ranks of its host then load the
same libraries), so that their seconds count in ``coldstart.compiled``'s
``warm_s`` at every tp, into ``skypilot_tpu_torch/_build/`` or the
directory ``--compile-cache-dir`` names (the port's counterpart of the reference's persistent XLA cache:
libraries are named by a hash of their sources, so a relaunch on the same
directory compiles nothing). ``/metrics`` carries ``kernel_build_dir`` and
``kernel_build_s``, the seconds each compile of this boot took.

The KV cache is dense by default, as the reference's: ``max_seq_len``
rows per slot. ``--paged`` selects the paged cache (a shared page pool,
preemption under pressure; ``--prefix-cache`` and ``--kv-dtype int8``
need it). ``--long-slots N --long-seq-len L`` add a second dense tier of
N slots at L positions over the same weights (``engine.EnginePool``):
prompts that do not fit the first tier route there. The reference's usage
errors exit at once (``--paged`` with ``--long-slots``, ``--prefix-cache``
or ``--kv-dtype int8`` without ``--paged``, a long tier no longer than the
first). Run: ``python -m skypilot_tpu_torch.infer.server --port 8000
--model 8b`` (add ``--device cpu`` to run on the CPU, ``--spec-k 4`` to
decode speculatively, ``--paged --kv-dtype int8`` for int8 KV pages,
``--scheduler wfq
--tenant-weights gold=4,free=1`` for weighted fair queueing,
``--max-queue-requests N`` to shed load past N waiting requests,
``--fused-prefill`` for fused mixed steps, ``--paged --prefix-cache`` for
the shared-prefix KV cache and the KV transfer routes, ``--role prefill``
or ``decode`` for a disaggregated pair).

``--tp N`` serves the model tensor-parallel over N ranks, one process a
GPU (dense cache only): this process is rank 0 and serves HTTP, and it
starts the host's other N - 1 ranks itself (``torch.multiprocessing``,
``spawn``), which run the lockstep loop of ``multihost.py``; submissions
reach every rank through its broadcast, and the warm-up runs through it
too, so every rank has captured the same step programs before ``/health``
turns ready. Each rank draws or restores the weights leaf by leaf and
keeps its slice (with ``--quantize`` each leaf is quantized whole
first). On a multi-host replica (the agent's ``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) every host runs this command,
``--tp`` defaults to every GPU of the replica, and host ``h`` runs global
ranks ``h * per_host ..``; ranks meet at the coordinator address. SIGTERM
or SIGINT on rank 0 stops the loop on every rank, and each exits 0.
"""
from __future__ import annotations

import argparse
import http.server
import json
import logging
import os
import signal
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import List, Optional

import torch

from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.infer import multihost
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.observability import prometheus as prom_lib
from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import quant as quant_lib
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import sharding as sharding_lib

logger = logging.getLogger(__name__)

# The request headers the serve load balancer forwards (the reference's
# utils/common.py names).
DEADLINE_HEADER = 'X-SkyTpu-Deadline-S'
TENANT_HEADER = 'X-SkyTpu-Tenant'
# A replica holding a longer cached prefix of this prompt, whose pages
# the receiving replica pulls (/kv/export) before it prefills.
KV_DONOR_HEADER = 'X-SkyTpu-KV-Donor'
ROLES = ('mixed', 'prefill', 'decode')

MODELS = {
    'tiny': llama.LlamaConfig.tiny,
    '350m': llama.LlamaConfig.bench_350m,
    '1b': llama.LlamaConfig.bench_1b,
    '8b': llama.LlamaConfig.llama3_8b,
}


class Tokenizer:
    """Text<->token codec for ``/generate`` (a host copy of the
    reference's).

    A ``tokenizer.json`` (the HuggingFace ``tokenizers`` format, an
    optional import) or a sentencepiece ``.model`` (``sentencepiece``, an
    optional import); the byte-level fallback otherwise, so ``tokens``
    callers and tests need no vocab file. ``vocab_limit`` (the model's
    vocabulary) refuses a tokenizer whose ids would fall outside it.
    """

    def __init__(self, path: Optional[str] = None,
                 vocab_limit: int = 0) -> None:
        self.kind = 'bytes'
        self._tok = None
        if path:
            if path.endswith('.json'):
                try:
                    from tokenizers import Tokenizer as HFTokenizer
                except ImportError:
                    raise SystemExit(
                        "the 'tokenizers' package is not installed in "
                        'this image; install it (it ships with '
                        'transformers) or serve with token ids only')
                self._tok = HFTokenizer.from_file(path)
                self.kind = 'hf'
                size = self._tok.get_vocab_size()
            else:
                try:
                    import sentencepiece as spm
                except ImportError:
                    raise SystemExit(
                        'sentencepiece not installed; use a '
                        'tokenizer.json (tokenizers format) instead')
                self._tok = spm.SentencePieceProcessor(model_file=path)
                self.kind = 'spm'
                size = self._tok.vocab_size()
            if vocab_limit and size > vocab_limit:
                raise SystemExit(
                    f'tokenizer vocab ({size}) exceeds the model vocab '
                    f'({vocab_limit}); ids would be out of range')

    def encode(self, text: str) -> List[int]:
        if self.kind == 'hf':
            return list(self._tok.encode(text).ids)
        if self.kind == 'spm':
            return list(self._tok.encode(text))
        return list(text.encode('utf-8'))

    def decode(self, tokens: List[int]) -> str:
        if self.kind == 'hf':
            return self._tok.decode(tokens)
        if self.kind == 'spm':
            # A model vocab larger than the spm vocab can sample ids the
            # tokenizer has no piece for; spm raises where the HF path
            # skips them: filter to match.
            size = self._tok.vocab_size()
            return self._tok.decode([t for t in tokens if 0 <= t < size])
        try:
            return bytes(t for t in tokens if 0 <= t < 256).decode(
                'utf-8', errors='replace')
        except ValueError:
            return ''


class IncrementalDecoder:
    """Streaming detokenizer: the text of each new token batch, holding
    back a trailing replacement character that may still become a real
    multi-byte character (a copy of the reference's)."""

    _CONTEXT = 4
    _MAX_WINDOW = 64

    def __init__(self, tokenizer: Tokenizer) -> None:
        self._tok = tokenizer
        self._prefix = 0
        self._emitted = 0

    def feed(self, tokens: List[int], n: Optional[int] = None) -> str:
        if n is None:
            n = len(tokens)
        window = self._tok.decode(tokens[self._prefix:n])
        if (not window.endswith('\ufffd')
                or n - self._prefix >= self._MAX_WINDOW):
            delta = window[self._emitted:]
            self._prefix = max(0, n - self._CONTEXT)
            self._emitted = len(self._tok.decode(tokens[self._prefix:n]))
            return delta
        stable = len(window) - 1
        delta = window[self._emitted:stable]
        self._emitted = max(self._emitted, stable)
        return delta

    def flush(self, tokens: List[int], n: Optional[int] = None) -> str:
        if n is None:
            n = len(tokens)
        window = self._tok.decode(tokens[self._prefix:n])
        delta = window[self._emitted:]
        self._prefix = n
        self._emitted = 0
        return delta


def synthesize_wordlevel_tokenizer(vocab_size: int, path: str) -> str:
    """Write a derived ``tokenizers`` WordLevel tokenizer.json of
    ``vocab_size`` entries to ``path`` and return ``path`` (a copy of the
    reference's): the 256 byte tokens, then synthetic words, split on
    whitespace. For vocabulary-size workloads (the 128k-vocab serving
    lane), where what matters is the model's vocabulary and the width of
    the id distribution, not the words. Deterministic; JSON only, so
    loading it needs the ``tokenizers`` package."""
    vocab = {}
    for b in range(min(256, vocab_size)):
        vocab[f'<0x{b:02X}>'] = b
    i = len(vocab)
    while i < vocab_size:
        vocab[f'w{i:07d}'] = i
        i += 1
    tok = {
        'version': '1.0',
        'truncation': None,
        'padding': None,
        'added_tokens': [],
        'normalizer': None,
        'pre_tokenizer': {'type': 'Whitespace'},
        'post_processor': None,
        'decoder': None,
        'model': {
            'type': 'WordLevel',
            'vocab': vocab,
            'unk_token': '<0x00>',
        },
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f'{path}.tmp.{os.getpid()}'
    with open(tmp, 'w', encoding='utf-8') as f:
        json.dump(tok, f)
    os.replace(tmp, path)
    return path


def setup_compile_cache(cache_dir: str) -> bool:
    """Point the kernel build directory (``ops/_build.py``: the libraries
    ``nvcc`` builds, named by a hash of their sources) at ``cache_dir``, so
    a relaunched replica loads its kernels instead of compiling them: the
    port's counterpart of the reference's persistent XLA compile cache.
    Degradation, not failure, as the reference's: a directory that cannot
    be made or written, or a process that already loaded a kernel, logs a
    warning and keeps the current directory, and the replica serves."""
    try:
        os.makedirs(cache_dir, exist_ok=True)
        with tempfile.TemporaryFile(dir=cache_dir):
            pass
        before = _build.BUILD_DIR
        path = _build.set_build_dir(cache_dir)
    except (OSError, RuntimeError) as e:
        logger.warning('compile cache setup failed (%s: %s): building '
                       'kernels in %s', type(e).__name__, e,
                       _build.BUILD_DIR)
        return False
    if path != before:
        logger.info('kernel build directory (compile cache) at %s', path)
    return True


def replica_sources(args: argparse.Namespace) -> tuple:
    """The kernel sources this replica launches: paged decode and verify
    (``paged_decode``) and prefill on either cache flavor, and the
    int8-weight product with ``--quantize``."""
    return ('paged_decode', 'paged_prefill') + (
        ('qdot_int8',) if args.quantize else ())


def parse_tenant_weights(spec: Optional[str]) -> Optional[dict]:
    """``'tenantA=4,tenantB=1'`` -> ``{'tenantA': 4.0, 'tenantB': 1.0}``
    (None/empty -> None); a malformed entry exits loudly (a copy of the
    reference's)."""
    if not spec:
        return None
    out = {}
    for part in spec.split(','):
        part = part.strip()
        if not part:
            continue
        name, sep, val = part.partition('=')
        try:
            weight = float(val)
        except ValueError:
            weight = -1.0
        if not sep or not name.strip() or weight <= 0:
            raise SystemExit(
                f'bad --tenant-weights entry {part!r}: expected '
                f'name=positive_number')
        out[name.strip()] = weight
    return out or None


class InferenceServer:
    """The engine loop thread plus the HTTP front end."""

    def __init__(self, engine: engine_lib.InferenceEngine,
                 tokenizer: Optional[Tokenizer] = None,
                 boot_t0: Optional[float] = None,
                 role: str = 'mixed', kv_pull_timeout_s: float = 10.0,
                 kv_export_max_pages: int = 64,
                 driver: Optional[multihost.MultihostEngineDriver] = None,
                 kernel_sources: tuple = ()
                 ) -> None:
        self.engine = engine
        # The kernel sources the warm-up builds before it launches
        # anything (replica_sources on the card, none on the CPU).
        self.kernel_sources = kernel_sources
        self.tokenizer = tokenizer or Tokenizer()
        # A tensor-parallel replica: submissions go through the lockstep
        # driver's broadcast, and its loop is the engine loop.
        self.driver = driver
        # When the process started (main's first line): the cold-start
        # timeline's total_s counts from it.
        self.boot_t0 = boot_t0 if boot_t0 is not None else time.time()
        # Disaggregation role, advertised in /metrics for the load
        # balancer to route by; the server never refuses work by role.
        if role not in ROLES:
            raise ValueError(f'role must be mixed|prefill|decode, got '
                             f'{role!r}')
        self.role = role
        # The budget of one donor pull (fetch, then the import's wait) and
        # of serving one /kv/export, and the largest prefix an export
        # ships, in pages.
        self.kv_pull_timeout_s = kv_pull_timeout_s
        self.kv_export_max_pages = kv_export_max_pages
        # One-way flags written by the engine thread, read by handlers.
        self.ready = False
        self.dead = ''
        # In-flight /generate handlers, the drain state and the 429
        # count, under _active_lock (handler threads).
        self._active = 0
        self._active_lock = threading.Lock()
        self.draining = False
        self._drain_started: Optional[float] = None
        self.drain_duration_s: Optional[float] = None
        self._drained = threading.Event()
        self._requests_shed = 0
        self._stop = threading.Event()
        self._woken = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name='engine-loop')
        self._httpd: Optional[http.server.ThreadingHTTPServer] = None

    # ---- engine loop -----------------------------------------------------
    def _loop(self) -> None:
        if self.driver is not None:
            # The warm-up blocks on ticks, so it runs beside the loop.
            threading.Thread(
                target=self._warm_up, daemon=True, name='warm',
                args=(self.driver.warm, self.driver.submit,
                      lambda warm: [w.wait_done() for w in warm])).start()
            self.driver.run()
            return

        def finish(warm):
            while not all(w.done for w in warm):
                self.engine.step()
        if not self._warm_up(lambda: multihost.warm_programs(self.engine),
                             self.engine.submit, finish):
            return
        try:
            while not self._stop.is_set():
                if self.engine.step() == 0:
                    # Idle: wait for a submit to wake us (the timeout is
                    # a safety net, not a poll cadence).
                    self._woken.wait(timeout=0.1)
                    self._woken.clear()
        except Exception as e:  # noqa: BLE001 -- a dead loop must unready
            logger.exception('engine loop died')
            self.dead = f'{type(e).__name__}: {e}'
            self.ready = False

    def _warm_up(self, capture, submit, finish) -> bool:
        """Warm the replica, then mark it ready; False when the warm-up
        died. ``capture()`` first captures every tier's step programs on
        the card, so no live request pays a capture (on every rank,
        through the lockstep loop, with ``--tp``). Then the reference's
        warm-up requests, four tokens each, go through ``submit`` and
        ``finish(requests)`` runs them out: a pool warms every tier, since
        a prompt one past the previous tier's cap routes to the next."""
        try:
            t0 = time.time()
            if self.kernel_sources:
                secs = _build.build(self.kernel_sources)
                logger.info('kernels in %s: %s', _build.BUILD_DIR,
                            ', '.join(f'{k} {v:.1f}s'
                                      for k, v in secs.items()))
            capture()
            tiers = getattr(self.engine, 'engines', [self.engine])
            warm = [submit([1], max_new_tokens=4)]
            for prev in tiers[:-1]:
                warm.append(submit([1] * prev.ecfg.max_seq_len,
                                   max_new_tokens=4))
            finish(warm)
            logger.info('engine warm on %d rank(s) in %.1fs',
                        1 if self.driver is None else self.driver.world,
                        time.time() - t0)
            # Cold-start timeline: weights_loaded was stamped by main();
            # this is the edge at which the replica becomes serviceable.
            self.engine.note_lifecycle_event(
                'coldstart.compiled',
                warm_s=round(time.time() - t0, 3),
                total_s=round(time.time() - self.boot_t0, 3))
            self.ready = True
            return True
        except Exception as e:  # noqa: BLE001 -- a dead warm-up must unready
            logger.exception('engine warm-up died')
            self.dead = f'{type(e).__name__}: {e}'
            return False

    # ---- lifecycle -------------------------------------------------------
    def start(self, host: str, port: int) -> int:
        """Start the engine loop and the HTTP server in background
        threads; returns the bound port (``port`` 0 picks a free one)."""
        server = self

        class Handler(_Handler):
            srv = server

        self._httpd = http.server.ThreadingHTTPServer((host, port),
                                                      Handler)
        self._httpd.daemon_threads = True
        self._thread.start()
        threading.Thread(target=self._httpd.serve_forever, daemon=True,
                         name='http').start()
        return self._httpd.server_address[1]

    def shutdown(self) -> None:
        self._stop.set()
        self._woken.set()
        if self.driver is not None:
            self.driver.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        self._thread.join(timeout=30)

    def run(self, host: str, port: int) -> None:
        self.start(host, port)
        try:
            while not self._stop.wait(1.0):
                pass
        finally:
            self.shutdown()

    # ---- routes ----------------------------------------------------------
    def health(self):
        if self.dead:
            return 503, {'status': 'dead', 'error': self.dead}
        if self.engine.integrity_suspect():
            # The SDC sentinel tripped: this card produced non-finite
            # logits. 503 pulls the replica from the ready set.
            return 503, {'status': 'corrupt'}
        with self._active_lock:
            if self.draining:
                return 503, {'status': 'draining', 'inflight': self._active}
        if not self.ready:
            return 503, {'status': 'warming'}
        return 200, {'status': 'ok'}

    def metrics(self, prometheus: bool = False, since_gen: int = -1):
        """(status, the metrics dict) or, with ``prometheus``, (status,
        its Prometheus text). ``since_gen``: the caller's last-seen
        generation of the prefix index (a delta against it, or the full
        list)."""
        m = self.engine.metrics()
        with self._active_lock:
            m['server_inflight'] = self._active
            m['draining'] = self.draining
            m['requests_shed'] = self._requests_shed
            if self.drain_duration_s is not None:
                m['drain_duration_s'] = round(self.drain_duration_s, 4)
        m['role'] = self.role
        # The boot's nvcc: where the kernel libraries live and the seconds
        # each compile of this process took (none on a warm directory).
        m['kernel_build_dir'] = str(_build.BUILD_DIR)
        m['kernel_build_s'] = dict(_build.compiled)
        if self.engine.kv_index_armed():
            m['kv_prefix_index'] = self.engine.kv_index_snapshot(since_gen)
        if prometheus:
            return 200, prom_lib.render_replica(m)
        return 200, m

    def stepline(self):
        return 200, self.engine.stepline_snapshot()

    # ---- KV prefix transfer ----------------------------------------------
    def kv_export(self, body: dict):
        """(status, blob bytes or an error payload): the donor half of a
        transfer. The readback runs on the engine thread between steps;
        this handler only waits."""
        if not self.engine.kv_index_armed():
            return 409, {'error': 'prefix cache disabled'}
        try:
            tokens = [int(t) for t in body['tokens']]
        except (KeyError, TypeError, ValueError):
            return 400, {'error': 'need {"tokens": [int, ...]}'}
        cap = self.kv_export_max_pages * self.engine.kv_page_size()
        job = self.engine.request_kv_export(tokens[:cap])
        self._woken.set()
        done = job.wait(self.kv_pull_timeout_s)
        if not done or job.error is not None:
            return 503, {'error': 'export failed' if done
                         else 'export timed out'}
        if job.result is None:
            return 404, {'error': 'no cached prefix'}
        return 200, job.result

    def pull_kv(self, donor_url: str, tokens: List[int]) -> None:
        """Pull the donor's cached prefix of ``tokens`` and graft it here
        before the prefill (the decode half of a transfer). Any failure
        lands on plain recompute; a donor 404 is a clean miss, not a
        failure."""
        url = donor_url.rstrip('/') + '/kv/export'
        t0 = time.monotonic()
        req = urllib.request.Request(
            url, data=json.dumps({'tokens': tokens}).encode(),
            headers={'Content-Type': 'application/json'})
        try:
            with urllib.request.urlopen(
                    req, timeout=self.kv_pull_timeout_s) as r:
                blob = r.read()
        except urllib.error.HTTPError as e:
            if e.code != 404:
                self.engine.note_kv_transfer_failure()
            return
        except (OSError, ValueError):
            # Unreachable, reset, stalled past the budget, or a bad URL.
            self.engine.note_kv_transfer_failure()
            return
        job = self.engine.request_kv_import(blob,
                                            fetch_s=time.monotonic() - t0)
        self._woken.set()
        if not job.wait(self.kv_pull_timeout_s):
            # Import errors are counted by the engine; only a wait past
            # the budget is ours to count.
            self.engine.note_kv_transfer_failure()

    # ---- graceful drain --------------------------------------------------
    def enter_generate(self) -> bool:
        """Count a /generate handler in flight; False (and not counted)
        once draining."""
        with self._active_lock:
            if self.draining:
                return False
            self._active += 1
            return True

    def exit_generate(self) -> None:
        with self._active_lock:
            self._active -= 1
            if self.draining and self._active == 0:
                self._mark_drained()

    def _mark_drained(self) -> None:  # holds: _active_lock
        if self.drain_duration_s is None:
            self.drain_duration_s = time.time() - self._drain_started
        self._drained.set()

    def drain(self, deadline_s: float):
        """Stop admitting, then wait until every in-flight request
        finished or ``deadline_s`` lapsed (the reference's long poll)."""
        with self._active_lock:
            if not self.draining:
                self.draining = True
                self._drain_started = time.time()
                logger.info('drain: stopped admitting (%d in flight)',
                            self._active)
                if self._active == 0:
                    self._mark_drained()
        self._drained.wait(max(0.0, deadline_s))
        with self._active_lock:
            return 200, {'status': ('drained' if self._drained.is_set()
                                    else 'draining'),
                         'inflight': self._active,
                         'drain_duration_s': self.drain_duration_s}

    def admit(self, body: dict, headers=None):
        """Parse and submit one /generate body (``headers``: the
        request's, for the deadline and tenant). Returns (request, None)
        or (None, (status, error payload, extra headers))."""
        headers = headers or {}
        if self.dead:
            return None, (500, {'error': f'engine died: {self.dead}'}, {})
        corrupt = (503, {'error': 'replica corrupt', 'quarantined': True},
                   {'Retry-After': '1'})
        if self.engine.integrity_suspect():
            return None, corrupt
        with self._active_lock:
            if self.draining:
                # Drain began while the body was read: refuse at the
                # admission edge (this handler still holds the drain
                # open, so it cannot have completed).
                return None, (503, {'error': 'replica draining',
                                    'draining': True},
                              {'Retry-After': '1'})
        deadline = None
        hdr = headers.get(DEADLINE_HEADER)
        if hdr and self.driver is None:
            # Lockstep replicas ignore it: rank clocks differ.
            try:
                budget_s = float(hdr)
            except ValueError:
                return None, (400, {'error': f'bad {DEADLINE_HEADER} '
                                             f'header: {hdr!r}'}, {})
            if budget_s <= 0:
                return None, (504, {'error': 'deadline already exceeded'},
                              {})
            deadline = time.time() + budget_s
        tenant = (headers.get(TENANT_HEADER) or str(body.get('tenant') or '')
                  or 'default')
        if len(tenant) > 128:
            return None, (400, {'error': 'tenant id too long (>128 chars)'},
                          {})
        if 'tokens' in body:
            try:
                tokens = [int(t) for t in body['tokens']]
            except (TypeError, ValueError):
                return None, (400, {'error': '"tokens" must be a list of '
                                             'token ids'}, {})
        elif 'prompt' in body:
            tokens = self.tokenizer.encode(str(body['prompt']))
        else:
            return None, (400, {'error': 'need "tokens" or "prompt"'}, {})
        resume = body.get('resume_from')
        if resume is not None:
            # A died stream continued here: the engine prefills prompt +
            # these tokens and only new tokens are emitted.
            try:
                resume = [int(t) for t in resume]
            except (TypeError, ValueError):
                return None, (400, {'error': '"resume_from" must be a '
                                             'token id list'}, {})
        if self.engine.integrity_suspect():
            # The sentinel may have tripped while the body was read.
            return None, corrupt
        donor = headers.get(KV_DONOR_HEADER)
        if donor and self.driver is None and self.engine.kv_index_armed():
            # The load balancer saw a longer cached prefix on the donor:
            # pull those pages first, so the prefill below starts at the
            # transferred boundary.
            self.pull_kv(donor, tokens)
        try:
            if self.driver is not None:
                # Blocks until the next tick admitted it on every rank.
                req = self.driver.submit(
                    tokens, body.get('max_new_tokens'),
                    float(body.get('temperature', 0.0)), resume,
                    spec=bool(body.get('spec', True)), tenant=tenant)
            else:
                req = self.engine.submit(
                    tokens, max_new_tokens=body.get('max_new_tokens'),
                    temperature=float(body.get('temperature', 0.0)),
                    spec=bool(body.get('spec', True)), deadline=deadline,
                    tenant=tenant, resume_tokens=resume)
        except engine_lib.AdmissionError as e:
            # Bounded admission: shed instead of queueing unboundedly
            # (the LB tries another replica first).
            with self._active_lock:
                self._requests_shed += 1
            return None, (429, {'error': str(e)},
                          {'Retry-After':
                           str(max(1, int(round(e.retry_after_s))))})
        except (TypeError, ValueError) as e:
            return None, (400, {'error': str(e)}, {})
        self._woken.set()
        return req, None

    def cancel(self, req) -> None:
        """The client went away: free its slot now. Lockstep replicas
        skip it (request state must stay the same on every rank)."""
        if self.driver is None:
            self.engine.cancel(req)

    @staticmethod
    def _accepted_len_mean(req) -> Optional[float]:
        return (round(req.spec_emitted / req.spec_steps, 3)
                if req.spec_steps else None)

    def done_line(self, req) -> dict:
        return {'done': True, 'request_id': req.request_id,
                'finish_reason': req.finish_reason, 'ttft_s': req.ttft,
                'queue_wait_s': req.queue_wait,
                'cached_tokens': req.cached_tokens,
                'accepted_len_mean': self._accepted_len_mean(req)}

    def answer(self, req) -> dict:
        return {'request_id': req.request_id,
                'tokens': req.output_tokens,
                'text': self.tokenizer.decode(req.output_tokens),
                'finish_reason': req.finish_reason,
                'ttft_s': req.ttft,
                'queue_wait_s': req.queue_wait,
                'cached_tokens': req.cached_tokens,
                'accepted_len_mean': self._accepted_len_mean(req)}


class _Handler(http.server.BaseHTTPRequestHandler):
    srv: InferenceServer

    def log_message(self, fmt, *args) -> None:
        logger.debug('%s - ' + fmt, self.address_string(), *args)

    def _json(self, status: int, payload, headers=None) -> None:
        """Send ``payload``: a dict as JSON, a str as plain text, bytes as
        an octet stream."""
        if isinstance(payload, bytes):
            data, ctype = payload, 'application/octet-stream'
        elif isinstance(payload, str):
            data, ctype = payload.encode(), 'text/plain; charset=utf-8'
        else:
            data, ctype = json.dumps(payload).encode(), 'application/json'
        self.send_response(status)
        self.send_header('Content-Type', ctype)
        self.send_header('Content-Length', str(len(data)))
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(data)

    def _body(self) -> dict:
        """The request's JSON object; raises ValueError when it is
        not one."""
        n = int(self.headers.get('Content-Length') or 0)
        body = json.loads(self.rfile.read(n) or b'{}')
        if not isinstance(body, dict):
            raise ValueError('body is not a JSON object')
        return body

    def do_GET(self) -> None:
        path, _, query = self.path.partition('?')
        if path == '/health':
            self._json(*self.srv.health())
        elif path == '/metrics':
            qs = urllib.parse.parse_qs(query)
            try:
                since_gen = int(qs.get('prefix_gen', ['-1'])[0])
            except ValueError:
                since_gen = -1
            self._json(*self.srv.metrics(
                prometheus=qs.get('format', [''])[0] == 'prometheus',
                since_gen=since_gen))
        elif path == '/debug/stepline':
            self._json(*self.srv.stepline())
        else:
            self._json(404, {'error': f'no route {path}'})

    def do_POST(self) -> None:
        path = self.path.split('?', 1)[0]
        if path == '/drain':
            try:
                body = self._body()
            except (ValueError, UnicodeDecodeError):
                body = {}
            try:
                deadline_s = float(body.get('deadline_s', 30.0))
            except (TypeError, ValueError):
                deadline_s = 30.0
            self._json(*self.srv.drain(deadline_s))
            return
        if path == '/kv/export':
            try:
                body = self._body()
            except (ValueError, UnicodeDecodeError):
                body = {}
            self._json(*self.srv.kv_export(body))
            return
        if path != '/generate':
            self._json(404, {'error': f'no route {self.path}'})
            return
        # Counted in flight before the body is read, so a drain cannot
        # report 'drained' while this handler goes on to admit work.
        if not self.srv.enter_generate():
            self._json(503, {'error': 'replica draining', 'draining': True},
                       {'Retry-After': '1'})
            return
        try:
            self._generate()
        finally:
            self.srv.exit_generate()

    def _generate(self) -> None:
        try:
            body = self._body()
        except (ValueError, UnicodeDecodeError):
            self._json(400, {'error': 'malformed JSON'})
            return
        req, err = self.srv.admit(body, self.headers)
        if err is not None:
            self._json(*err)
            return
        if body.get('stream'):
            try:
                self._stream(req)
            except (BrokenPipeError, ConnectionResetError):
                # The client went away mid-stream: free the slot now
                # instead of generating to nobody.
                self.srv.cancel(req)
            return
        while not req.wait_done(timeout=1.0):
            if self.srv.dead:
                self._json(500, {'error': f'engine died: {self.srv.dead}'})
                return
        if (req.finish_reason == 'deadline'
                and len(req.output_tokens) <= req.resumed_from):
            # Expired before producing anything: a real timeout.
            self._json(504, {'error': 'deadline exceeded before first '
                                      'token', 'finish_reason': 'deadline'})
            return
        self._json(200, self.srv.answer(req))

    def _stream(self, req) -> None:
        """JSON lines, one per token batch as the engine emits them, then
        the done line; the connection closes at the end (HTTP/1.0)."""
        self.send_response(200)
        self.send_header('Content-Type', 'application/jsonlines')
        self.end_headers()
        decoder = IncrementalDecoder(self.srv.tokenizer)
        # A resumed stream never emits the tokens it resumed from: the
        # decoder is primed with them and their text discarded.
        sent = req.resumed_from
        if sent:
            decoder.feed(req.output_tokens, sent)

        def write(obj: dict) -> None:
            self.wfile.write(json.dumps(obj).encode() + b'\n')
            self.wfile.flush()

        while True:
            if self.srv.dead:
                write({'error': f'engine died: {self.srv.dead}'})
                return
            done = req.done             # read BEFORE the token count:
            n = len(req.output_tokens)  # done => n is final
            if n > sent:
                write({'tokens': req.output_tokens[sent:n],
                       'text': decoder.feed(req.output_tokens, n)})
                sent = n
            if done and sent == len(req.output_tokens):
                tail = decoder.flush(req.output_tokens, sent)
                if tail:
                    write({'tokens': [], 'text': tail})
                write(self.srv.done_line(req))
                return
            req.wait_progress(sent, timeout=1.0)


def build_engine(model: str, slots: int, max_seq_len: int, page_size: int,
                 n_pages: Optional[int], device: str, seed: int = 0,
                 paged: bool = False,
                 kv_dtype: str = 'bfloat16', spec_k: int = 0,
                 spec_ngram: int = 3, pipeline_depth: int = 1,
                 scheduler: str = 'fcfs', tenant_weights=None,
                 max_queue_requests: Optional[int] = None,
                 max_queue_tokens: Optional[int] = None,
                 cuda_graphs: bool = True, fused_prefill: bool = False,
                 stepline: bool = True, stepline_cap: Optional[int] = None,
                 ttft_slo_s: Optional[float] = None,
                 sdc_sentinel: bool = True,
                 prefix_cache: bool = False, quantize: bool = False,
                 params: Optional[llama.Params] = None,
                 group: Optional[mesh_lib.TPGroup] = None
                 ) -> engine_lib.InferenceEngine:
    """An engine for ``model`` on ``device`` (the dense cache, or the
    paged one with ``paged``) over ``params``, or, when None, random
    weights drawn from ``seed`` (their int8 form with ``quantize``).
    ``group``: the tensor-parallel group this engine is a rank of (its
    ``params`` then this rank's slices or the whole tree)."""
    dev = engine_lib.resolve_device(device)
    config = MODELS[model]()
    if params is None:
        params = random_params(config, seed, dev, quantize, group)
    return engine_lib.InferenceEngine(
        config, params,
        engine_lib.EngineConfig(
            n_slots=slots, max_seq_len=min(max_seq_len, config.max_seq_len),
            paged=paged, page_size=page_size, n_pages=n_pages,
            kv_dtype=kv_dtype,
            spec_k=spec_k, spec_ngram=spec_ngram,
            pipeline_depth=pipeline_depth, scheduler=scheduler,
            tenant_weights=tenant_weights,
            max_queue_requests=max_queue_requests,
            max_queue_tokens=max_queue_tokens, cuda_graphs=cuda_graphs,
            fused_prefill=fused_prefill, stepline=stepline,
            stepline_cap=stepline_cap, ttft_slo_s=ttft_slo_s,
            sdc_sentinel=sdc_sentinel, prefix_cache=prefix_cache,
            quantize=quantize),
        seed=seed, device=dev, group=group)


def random_params(config: llama.LlamaConfig, seed: int, device,
                  quantize: bool = False,
                  group: Optional[mesh_lib.TPGroup] = None) -> llama.Params:
    """Random weights drawn from ``seed`` on ``device``; with
    ``quantize`` the int8 form of the same draw. Each leaf is drawn whole,
    quantized whole with ``quantize``, and only the slice of ``group``'s
    rank kept before the next is drawn: the values of the single-rank
    draw on the same device, and the whole bf16 tree never exists."""
    tp, rank = (1, 0) if group is None else (group.world, group.rank)
    if quantize:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return quant_lib.init_params_quantized(config, gen, device, tp, rank)
    return engine_lib.init_params_sharded(config, tp, rank, seed, device)


def load_params(args: argparse.Namespace,
                config: llama.LlamaConfig) -> llama.Params:
    """The weights ``main`` serves (the reference's logic). With
    ``--checkpoint``: restored into host RAM and quantized onto the
    device leaf by leaf with ``--quantize`` (the bf16 tree never lands on
    the card whole), else moved onto the device; a bare params tree and
    a train state that nests it under ``params`` (what ``train.run``
    saves) are both accepted, and its shapes must be ``--model``'s.
    Without one: random weights from ``--seed``, their int8 form with
    ``--quantize``."""
    return load_rank_params(args, config, mesh_lib.single(
        engine_lib.resolve_device(args.device)))


def _restore(args: argparse.Namespace, config: llama.LlamaConfig):
    """The params of ``--checkpoint``'s latest checkpoint in host RAM,
    checked against ``config``'s shapes."""
    from skypilot_tpu_torch.train import checkpoint as ckpt_lib
    mgr = ckpt_lib.CheckpointManager(args.checkpoint)
    restored = mgr.restore_to_host()
    params = restored.get('params', restored) if isinstance(
        restored, dict) else restored.params
    ckpt_lib.check_like(params, llama.init_params(config, None, 'meta'))
    return params


def load_rank_params(args: argparse.Namespace, config: llama.LlamaConfig,
                     group: mesh_lib.TPGroup) -> llama.Params:
    """:func:`load_params` for one rank of ``group`` on its device: each
    leaf restored (or drawn) whole, quantized whole with ``--quantize``,
    and only this rank's slice kept."""
    dev, tp = group.device, group.world
    if args.checkpoint:
        def keep(path, leaf):
            leaf = leaf.to(dev)
            if args.quantize:
                leaf = quant_lib.quantize_leaf(path[-1], leaf)
            return sharding_lib.shard_leaf(path, leaf, group.rank, tp)
        return sharding_lib.map_tree(keep, _restore(args, config))
    logger.warning('no --checkpoint: serving random %sweights (%s, tp=%d)',
                   'int8 ' if args.quantize else '', args.model, tp)
    return random_params(config, args.seed, dev, args.quantize, group)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--host', default='0.0.0.0')
    parser.add_argument('--port', type=int, required=True)
    parser.add_argument('--model', default='tiny', choices=sorted(MODELS))
    parser.add_argument('--slots', type=int, default=8)
    parser.add_argument('--max-seq-len', type=int, default=1024)
    parser.add_argument('--long-slots', type=int, default=0,
                        help='add a second dense tier with this many slots '
                             'at --long-seq-len over the same weights: '
                             'prompts past --max-seq-len route there, so '
                             'the KV bytes are slots x max_seq_len + '
                             'long_slots x long_seq_len instead of every '
                             'slot paying the longest length')
    parser.add_argument('--long-seq-len', type=int, default=8192)
    parser.add_argument('--page-size', type=int, default=64)
    parser.add_argument('--n-pages', type=int, default=None,
                        help='KV pool pages incl. the sink page (default: '
                             'slots x max_seq_len / page_size + 1)')
    parser.add_argument('--kv-dtype', default='bfloat16',
                        choices=['bfloat16', 'int8'],
                        help='KV page value dtype: int8 pages carry one '
                             'fp32 absmax scale per row (quantized on '
                             'write, dequantized in the kernels), about '
                             'half the KV bytes per token')
    parser.add_argument('--spec-k', type=int, default=0,
                        help='speculative decoding draft width: a '
                             'prompt-lookup drafter proposes up to this '
                             'many tokens per greedy request and one '
                             'verify step scores them all (greedy output '
                             'unchanged); 0 = off')
    parser.add_argument('--spec-ngram', type=int, default=3,
                        help='longest trailing n-gram the drafter '
                             'matches')
    parser.add_argument('--pipeline-depth', type=int, default=1,
                        help='dispatch-ahead decode depth: step N+1 is '
                             'dispatched before step N is read back; 0 = '
                             'the synchronous loop')
    parser.add_argument('--scheduler', default='fcfs',
                        choices=['fcfs', 'deadline', 'wfq'],
                        help='step-loop scheduling policy: fcfs, deadline '
                             '(EDF over X-SkyTpu-Deadline-S budgets) or '
                             'wfq (per-tenant weighted fair queueing over '
                             'X-SkyTpu-Tenant)')
    parser.add_argument('--tenant-weights', default=None,
                        help="wfq weights as 'tenantA=4,tenantB=1' "
                             '(unlisted tenants weigh 1.0)')
    parser.add_argument('--max-queue-requests', type=int, default=None,
                        help='refuse new work (429 + Retry-After) once '
                             'this many requests wait; default unbounded')
    parser.add_argument('--max-queue-tokens', type=int, default=None,
                        help='cap on the prompt + generated tokens '
                             'waiting in the queue')
    parser.add_argument('--fused-prefill', action='store_true',
                        help='fused mixed steps: while slots decode, one '
                             'prefill chunk rides the decode step as one '
                             'program instead of standalone chunks '
                             'stalling the decode batch; greedy outputs '
                             'unchanged')
    parser.add_argument('--no-stepline', action='store_true',
                        help='disable the flight recorder (on by '
                             'default: per-step records and request '
                             'timelines at GET /debug/stepline, dumped '
                             'into the span store on anomalies)')
    parser.add_argument('--stepline-cap', type=int, default=None,
                        help='flight-recorder ring capacity in step '
                             'records (default: SKY_TPU_STEPLINE_CAP or '
                             '1024)')
    parser.add_argument('--ttft-slo-s', type=float, default=None,
                        help='TTFT SLO in seconds: a slower first token '
                             'triggers a flight-recorder dump (default: '
                             'no SLO trigger)')
    parser.add_argument('--no-sdc-sentinel', action='store_true',
                        help='disable the on-device SDC sentinel (on by '
                             'default: a non-finite logit marks the '
                             'replica corrupt, 503 on /health; greedy '
                             'outputs unchanged either way)')
    parser.add_argument('--prefix-cache', action='store_true',
                        help='shared-prefix KV reuse over the page pool: '
                             'repeated prompt prefixes attach cached pages '
                             'instead of re-prefilling; /metrics gains the '
                             'prefix_* counters and kv_prefix_index, answers '
                             'a cached_tokens count, and /kv/export and the '
                             'donor pull turn on')
    parser.add_argument('--role', default='mixed', choices=list(ROLES),
                        help='disaggregation role, advertised in /metrics '
                             'so the serve load balancer routes first '
                             'prefills to prefill replicas and has decode '
                             'replicas pull cached prefixes from them; '
                             'mixed (default) behaves as before')
    parser.add_argument('--kv-pull-timeout-s', type=float, default=10.0,
                        help='budget of one donor KV pull (fetch, then '
                             'import) and of serving one /kv/export; past '
                             'it the request recomputes')
    parser.add_argument('--kv-export-max-pages', type=int, default=64,
                        help='largest cached prefix one /kv/export ships, '
                             'in pages; the puller recomputes the rest')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default; raises without a card) or "
                             "'cpu'")
    parser.add_argument('--paged', action='store_true',
                        help='paged KV cache (block tables over a shared '
                             'page pool, preemption under pressure): device '
                             'memory follows the tokens in flight; default '
                             'the dense per-slot cache, as the reference\'s')
    parser.add_argument('--seed', type=int, default=0,
                        help='seed of the random weights and of sampling')
    parser.add_argument('--checkpoint', default=None,
                        help='serve the params of the latest checkpoint '
                             'under this directory (a train.run '
                             'directory, or a bare params tree), in place '
                             'of random weights')
    parser.add_argument('--quantize', action='store_true',
                        help='int8 weight-only quantization '
                             '(ops/quant.py): every dense product streams '
                             'int8 weights through the W8A16 kernel, half '
                             'the weight bytes of bf16')
    parser.add_argument('--tp', type=int, default=1,
                        help='tensor-parallel ranks, one process a GPU '
                             '(dense cache only): this process serves '
                             'HTTP as rank 0 and starts the others; on a '
                             'multi-host replica it defaults to every GPU '
                             'of the replica')
    parser.add_argument('--tokenizer', default=None,
                        help='tokenizer.json (needs the optional tokenizers '
                             'package) or sentencepiece .model for '
                             '/generate text; default: bytes')
    parser.add_argument('--compile-cache-dir', default=None,
                        help='kernel build directory, the persistent '
                             'compile cache: the nvcc-built kernel '
                             'libraries, named by a hash of their sources, '
                             'so a relaunched replica loads its kernels '
                             'instead of compiling them, cutting cold-start '
                             'time-to-ready. Survives restarts; share it '
                             'across replicas of one build. A directory '
                             'that cannot be used only warns (the default '
                             'skypilot_tpu_torch/_build/ is used)')
    args = parser.parse_args(argv)
    check_usage(args)
    return args


def check_usage(args: argparse.Namespace) -> None:
    """The reference's usage errors, each a SystemExit raised at once,
    before any weight is drawn or loaded."""
    if args.paged and args.long_slots > 0:
        raise SystemExit('--paged already serves mixed lengths from one '
                         'pool; drop --long-slots')
    if args.prefix_cache and not args.paged:
        raise SystemExit('--prefix-cache requires --paged (sharing is at '
                         'page granularity)')
    if args.kv_dtype != 'bfloat16' and not args.paged:
        raise SystemExit('--kv-dtype int8 requires --paged (quantization '
                         'is at page granularity)')
    if args.tp < 1:
        raise SystemExit(f'--tp must be >= 1, got {args.tp}')
    if args.tp > 1 and args.paged:
        raise SystemExit('paged KV is single-device for now; use the dense '
                         'cache for tp > 1 (drop --paged)')
    if args.long_slots > 0:
        model_cap = MODELS[args.model]().max_seq_len
        short_cap = min(args.max_seq_len, model_cap)
        long_cap = min(args.long_seq_len, model_cap)
        if long_cap <= short_cap:
            raise SystemExit(
                f'--long-seq-len ({args.long_seq_len}, clamped to '
                f'{long_cap} by the model) must exceed --max-seq-len '
                f'({short_cap}); equal or inverted tiers would break '
                f'routing')


def engine_from_args(args: argparse.Namespace,
                     params: Optional[llama.Params] = None,
                     group: Optional[mesh_lib.TPGroup] = None):
    """The engine ``main`` serves: one engine, or with ``--long-slots`` an
    :class:`engine_lib.EnginePool` of it and a long dense tier built on
    the same params object (the weights are on the device once;
    ``quantize=False`` there, since they already are int8 with
    ``--quantize``)."""
    common = dict(spec_k=args.spec_k, spec_ngram=args.spec_ngram,
                  pipeline_depth=args.pipeline_depth,
                  scheduler=args.scheduler,
                  tenant_weights=parse_tenant_weights(args.tenant_weights),
                  max_queue_requests=args.max_queue_requests,
                  max_queue_tokens=args.max_queue_tokens,
                  fused_prefill=args.fused_prefill,
                  stepline=not args.no_stepline,
                  stepline_cap=args.stepline_cap, ttft_slo_s=args.ttft_slo_s,
                  sdc_sentinel=not args.no_sdc_sentinel, group=group)
    device = group.device if group is not None else args.device
    engine = build_engine(args.model, args.slots, args.max_seq_len,
                          args.page_size, args.n_pages, device,
                          args.seed, paged=args.paged,
                          kv_dtype=args.kv_dtype,
                          prefix_cache=args.prefix_cache,
                          quantize=args.quantize, params=params, **common)
    if args.long_slots <= 0:
        return engine
    long_engine = build_engine(args.model, args.long_slots,
                               args.long_seq_len, args.page_size, None,
                               device, seed=1, params=engine.params,
                               **common)
    return engine_lib.EnginePool([engine, long_engine])


def server_from_args(args: argparse.Namespace,
                     boot_t0: Optional[float] = None,
                     group: Optional[mesh_lib.TPGroup] = None
                     ) -> 'InferenceServer':
    """What ``main`` serves, not yet started: the tokenizer, the weights
    (then the cold-start stamp ``coldstart.weights_loaded``), the engine
    and the server. ``boot_t0``: when the process started (default
    now). ``group``: rank 0 of a tensor-parallel replica (the server then
    submits through a lockstep driver over it)."""
    boot_t0 = time.time() if boot_t0 is None else boot_t0
    config = MODELS[args.model]()
    tokenizer = Tokenizer(args.tokenizer, vocab_limit=config.vocab_size)
    params = (load_params(args, config) if group is None
              else load_rank_params(args, config, group))
    # Cold-start timeline stamp #1: t_weights covers the checkpoint
    # restore (and quantization) or the random init; the KV pool's
    # allocation rides in the gap before the compile stamp.
    t_weights = time.time()
    engine = engine_from_args(args, params, group)
    engine.note_lifecycle_event('coldstart.weights_loaded',
                                load_s=round(t_weights - boot_t0, 3))
    driver = (multihost.MultihostEngineDriver(engine, group)
              if group is not None and group.world > 1 else None)
    return InferenceServer(engine, tokenizer, boot_t0=boot_t0,
                           role=args.role,
                           kv_pull_timeout_s=args.kv_pull_timeout_s,
                           kv_export_max_pages=args.kv_export_max_pages,
                           driver=driver,
                           kernel_sources=(replica_sources(args)
                                           if _device_type(args) == 'cuda'
                                           else ()))


def _device_type(args: argparse.Namespace) -> str:
    return torch.device(args.device).type


def tp_layout(args: argparse.Namespace, n_hosts: int) -> int:
    """The ranks this host runs for ``--tp``: the reference's layout
    rules, after a check of the host's GPU count that fails at once with
    a SystemExit naming both counts."""
    if _device_type(args) == 'cuda':
        have = torch.cuda.device_count()
        per = -(-args.tp // n_hosts)
        if per > have:
            raise SystemExit(f'--tp {args.tp} needs {per} GPUs on this host '
                             f'but it has {have}')
    else:
        have = args.tp
    try:
        return mesh_lib.check_layout(args.tp, n_hosts, have)
    except ValueError as e:
        raise SystemExit(str(e)) from e


def _rank_main(args: argparse.Namespace, local_index: int, address: str,
               boot_t0: float) -> None:
    """One rank of a tensor-parallel replica: join the group, load this
    rank's weights, build its engine; global rank 0 serves HTTP through
    the lockstep driver, every other rank runs its loop."""
    if args.compile_cache_dir:
        # A spawned rank does not inherit the parent's module globals.
        setup_compile_cache(args.compile_cache_dir)
    group = multihost.maybe_initialize_distributed(
        args.tp, local_index, _device_type(args), address)
    if group.rank == 0:
        server = server_from_args(args, boot_t0, group)
        logger.info('rank 0 of %d: weights and KV cache ready in %.1fs',
                    group.world, time.time() - boot_t0)
        # SIGTERM stops the loop on every rank (the stop rides the
        # broadcast) instead of killing rank 0 under the others.
        signal.signal(signal.SIGTERM, lambda *_: server._stop.set())
        try:
            server.run(args.host, args.port)
        except KeyboardInterrupt:
            pass
    else:
        config = MODELS[args.model]()
        engine = engine_from_args(
            args, load_rank_params(args, config, group), group)
        logger.info('rank %d/%d: entering the lockstep loop', group.rank,
                    group.world)
        multihost.MultihostEngineDriver(engine, group).run()
    mesh_lib.destroy(group)


def _follower(args: argparse.Namespace, local_index: int, address: str,
              boot_t0: float) -> None:
    """A spawned local rank. It ignores the terminal's SIGINT: rank 0's
    stop reaches it through the loop."""
    logging.basicConfig(level=logging.INFO)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    _rank_main(args, local_index, address, boot_t0)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    boot_t0 = time.time()
    if args.compile_cache_dir:
        setup_compile_cache(args.compile_cache_dir)
    n_hosts, host_id, coordinator = mesh_lib.host_env()
    if n_hosts > 1 and args.tp == 1:
        # A multi-host replica exists to shard the model: every GPU of
        # the replica (one rank a host on the CPU).
        local = (torch.cuda.device_count() if _device_type(args) == 'cuda'
                 else 1)
        args.tp = n_hosts * local
        logger.info('multi-host replica: defaulting --tp to %d', args.tp)
        check_usage(args)
    if args.tp == 1:
        server = server_from_args(args, boot_t0)
        logger.info('weights and KV pool ready in %.1fs',
                    time.time() - boot_t0)
        server.run(args.host, args.port)
        return
    per = tp_layout(args, n_hosts)
    address = coordinator or f'127.0.0.1:{mesh_lib.free_port()}'
    codes = mesh_lib.run_local_ranks(
        _rank_main, _follower, lambda i: (args, i, address, boot_t0), per,
        'tp-rank', host_id * per)
    if any(codes):
        sys.exit(1)


if __name__ == '__main__':
    main()
