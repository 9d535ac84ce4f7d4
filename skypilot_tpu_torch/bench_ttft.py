"""The port's serving sweeps on one card (counterpart of the root
``bench_ttft.py``'s eight sweeps, for a torch replica).

- ``--sweep chunked``: in-process engines (the stall under test is a
  property of the step loop, not of HTTP): victims decode on all but one
  slot while a long-prompt aggressor arrives mid-decode, ``--repeats``
  times, once with ``fused_prefill`` off and once on. It reports the
  victims' time between tokens (p50, p99) in each aggressor's window,
  from its submission to its first token, the aggressor's TTFT, the
  engine's fused-step and stall counters and the flight recorder's stage
  breakdown (``stepline_summary()``), fused vs unfused; and the kv-dtype
  axis: how many pages each page dtype keeps resident in the same bytes,
  and what that residency buys the prefix cache (the hit rate of 30
  two-page prefixes, twice over, through a pool of each dtype).
- ``--sweep concurrency``: starts the port's replica server
  (``python -m skypilot_tpu_torch.infer.server``) and streams
  ``/generate`` to it directly: one cold request (its compile and capture
  tail, reported apart), a warm pass, then each ``--concurrency`` level
  (default 1, 4, 8 in flight). It reports warm TTFT p50/p90/p99, the time
  between tokens and tokens/s per level, clocked by the client.
- ``--sweep shared-prefix``: the port's server with ``--prefix-cache``;
  at each level a cold pass (every request its own system block of
  ``--shared-prefix-tokens`` plus a 16-token tail: all misses), then a
  shared pass (one system block, unique tails: system-prompted chat, RAG
  templates), the first shared request alone to seed the tree. It
  reports the shared pass's hit rate and prefill tokens saved (from the
  server's counters around it), the TTFT improvement (cold p50 / shared
  p50) and the ratio of time between tokens, shared over cold (the
  cache must not tax decode).
- ``--sweep disagg``: two port servers on the one card, ``--role
  prefill`` and ``--role decode``, int8 pages, ``--prefix-cache``. The
  bench plays the router: at each level it sends one cohort (a shared
  system block, unique tails) to the decode server alone, which
  recomputes the block, and another cohort to the decode server after
  seeding its block on the prefill server, naming the prefill server in
  ``X-SkyTpu-KV-Donor`` while the decode server's advertised index lacks
  the block (what the serve load balancer does), so it pulls the pages.
  It reports the transfers, their bytes, ``kv_transfer_p99_s`` and the
  TTFT of each cohort.
- ``--sweep coldstart``: boots the server twice against one fresh kernel
  build directory (``--compile-cache-dir``): the first boot compiles the
  kernels it launches with ``nvcc``, the second loads them. Per boot:
  spawn to ``/health`` ready, to the first streamed token, the
  ``coldstart.*`` stamps from ``/debug/stepline``, the seconds each
  compile took (``/metrics`` ``kernel_build_s``) and the libraries the
  boot added to the directory, with every library's mtime before and
  after. On the CPU neither boot builds anything.
- ``--sweep speculative``: the server with ``--spec-k`` (default 6); at
  each level the same template-heavy prompts (a 12-token block four times
  and a unique 6-token tail) with per-request ``"spec": false``, then
  ``true``, the replica's ``spec_*`` and ``decode_*`` counters windowed
  around the second pass: ``accepted_len_mean``, ``spec_accept_rate``,
  ``tokens_per_step``, the time between tokens off over on, and a probe
  that one prompt gives the same greedy tokens both ways.
- ``--sweep tenants``: the server with ``--scheduler`` (default wfq) and
  ``--max-queue-requests`` 4 x slots; at each level a seeded 10:1
  aggressor/victim trace (``utils/loadgen.py``; ``--trace`` replays a
  file) replayed with the ``X-SkyTpu-Tenant`` header: per-tenant TTFT,
  time between tokens and shed rate, and the replica's per-tenant
  counters over the level.
- ``--sweep chaos-resume``: mid-stream failover. The bench plays the
  serve load balancer's splice, as ``disagg`` plays its router: at each
  level an uninterrupted pass, then a pass where every second stream is
  cut by the client after ``--kill-after-chunks`` lines and re-posted
  with ``resume_from`` = the tokens it delivered, the rest spliced on. It
  reports the completed-stream rate, the resumes, the p99 wall time of
  clean and of resumed streams and what a resume adds, and whether every
  spliced stream carries the tokens of the same request uninterrupted.

The servers' KV cache follows ``--paged``, as the reference bench's does:
without it the concurrency sweep measures a dense replica (the
reference server's default), with it a paged one; ``shared-prefix`` and
``disagg`` imply it (the prefix cache needs pages), and the chunked
sweep's in-process engines are always paged. The JSON records ``paged``.

``--quantize`` serves int8 weights in every sweep (the servers get
``--quantize``; the chunked sweep's engines int8 params drawn from the
same seed), recorded in the JSON as ``quantize``.

Both run on the CUDA device unless ``--device cpu`` is given, and print
one JSON document that names the card by name and power limit
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``).
Weights are random, drawn from ``--seed``.

The servers get the reference's replica flags from the bench:
``--prefix-cache``, ``--spec-k`` and ``--spec-ngram``, ``--scheduler``,
``--tenant-weights`` and ``--tokenizer``, and for the tenants sweep
``--max-queue-requests`` 4 x slots
(``128k`` derives a 128,256-entry word-level tokenizer.json under
``$SKY_TPU_HOME/cache``; loading it needs the optional ``tokenizers``
package).
``--long-prompt-tokens N`` adds a long lane to the concurrency sweep:
every 8th request a prompt of about N tokens, its TTFT reported apart.

Run: ``python -m skypilot_tpu_torch.bench_ttft --sweep chunked --model
8b`` (or ``--sweep concurrency``, ``shared-prefix``, ``disagg``,
``coldstart``, ``speculative``, ``tenants`` or ``chaos-resume``).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import pathlib
import random
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
from typing import Dict, List, Optional

import torch

from skypilot_tpu_torch.utils import loadgen

ROOT = pathlib.Path(__file__).resolve().parents[1]


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them; 'cpu'
    on the CPU."""
    if device.type != 'cuda':
        return 'cpu'
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        index = device.index or 0
        return out[index] if index < len(out) else out[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)


def _ms(v):
    return None if v is None else v * 1e3


# ---------------------------------------------------------------------------
# --sweep chunked
# ---------------------------------------------------------------------------
def _chunked_build_engine(config, params, device, *, fused: bool, slots: int,
                          max_seq_len: int, page_size: int,
                          kv_dtype: str = 'bfloat16', n_pages=None,
                          prefix_cache: bool = False):
    from skypilot_tpu_torch.infer import engine as engine_lib
    return engine_lib.InferenceEngine(
        config, params,
        engine_lib.EngineConfig(
            n_slots=slots, max_seq_len=max_seq_len,
            prefill_buckets=(64, 128), prefill_chunk=128, paged=True,
            page_size=page_size, n_pages=n_pages, kv_dtype=kv_dtype,
            fused_prefill=fused, prefix_cache=prefix_cache),
        device=device)


def _chunked_warm(eng, aggr_prompt: list) -> None:
    """Build and capture every program off the clock: standalone prefill
    (idle admission), then both chunk buckets through the mid-decode path
    the measurement runs (fused engines their mixed programs, unfused
    their standalone chunks), each at least twice (a program's first run
    is its warm-up, its second its capture)."""
    a = eng.submit([9] * 16, max_new_tokens=400)
    while not a.output_tokens:
        eng.step()
    for warm_prompt in ([8] * 8, [8] * 9, [9] * len(aggr_prompt)):
        r = eng.submit(warm_prompt, max_new_tokens=4)
        while not r.done:
            eng.step()
    eng.cancel(a)
    eng.run_until_idle()


def _chunked_victim_run(engine, conc: int, aggr_prompt: list,
                        repeats: int) -> dict:
    """Victims decode continuously; a long-prompt aggressor arrives
    mid-decode ``repeats`` times. Records every victim gap between tokens
    from each aggressor's submission to its first token (the window a
    standalone chunk stalls), and the aggressor's TTFT, on the host clock
    around the in-process step loop."""
    from skypilot_tpu_torch.ops import paged_attention as paged_attn
    from skypilot_tpu_torch.ops import quant as quant_lib

    def launched():
        return {**paged_attn.launches, **quant_lib.launches}
    launches0 = launched()
    victims = [engine.submit([3 + i] * 8, max_new_tokens=400)
               for i in range(conc)]
    while any(len(v.output_tokens) < 4 for v in victims):
        engine.step()
    itls, ttfts = [], []
    seen = {i: len(v.output_tokens) for i, v in enumerate(victims)}
    last = {i: None for i in range(len(victims))}
    for r in range(repeats):
        aggr = engine.submit(aggr_prompt, max_new_tokens=4)
        t0 = time.perf_counter()
        for i in range(len(victims)):
            last[i] = None          # a fresh window per aggressor
        while not aggr.done:
            engine.step()
            now = time.perf_counter()
            for i, v in enumerate(victims):
                n = len(v.output_tokens)
                if n > seen[i]:
                    if last[i] is not None:
                        gap = (now - last[i]) / (n - seen[i])
                        itls.extend([gap] * (n - seen[i]))
                    last[i] = now
                    seen[i] = n
            if aggr.output_tokens and len(ttfts) == r:
                ttfts.append(time.perf_counter() - t0)
    for v in victims:
        engine.cancel(v)
    engine.run_until_idle()
    m = engine.metrics()
    breakdown = engine.stepline_summary()
    breakdown.pop('enabled', None)
    itls.sort()
    ttfts.sort()
    return {
        'victim_itl_p50_ms': _ms(loadgen.pct(itls, 0.50)),
        'victim_itl_p99_ms': _ms(loadgen.pct(itls, 0.99)),
        'aggressor_ttft_p50_s': loadgen.pct(ttfts, 0.50),
        'aggressor_ttft_max_s': ttfts[-1] if ttfts else None,
        'itl_samples': len(itls),
        'fused_steps': m['fused_steps'],
        'decode_stall_steps': m['decode_stall_steps'],
        'prefill_tokens_per_step': m['prefill_tokens_per_step'],
        'step_programs': m['step_programs'],
        # This run's launches of each kernel (graph replays included).
        'kernel_launches': {k: v - launches0[k]
                            for k, v in launched().items()
                            if v != launches0[k]},
        'step_time_breakdown': breakdown,
    }


def _kv_axis(config, params, device, *, slots: int, max_seq_len: int,
             page_size: int) -> dict:
    """int8 pages at a fixed byte budget (48 bf16 pages): how many pages
    each page dtype keeps resident (the closed form of the engine's
    kv_page_bytes: K and V values at their dtype plus, on int8, one fp32
    scale per row and KV head), and what that residency buys the prefix
    cache: 30 distinct two-page prefixes (60 cached pages if all stay),
    each with a short tail, twice over through a pool of each dtype with
    the cache on. They overflow the bf16 pool and fit the int8 one, so
    the second wave's hits are what the denser pages bought."""
    per = {dt: (2 * config.n_layers * config.n_kv_heads * page_size
                * (config.head_dim * (1 if dt == 'int8' else 2)
                   + (4 if dt == 'int8' else 0)))
           for dt in ('bfloat16', 'int8')}
    budget = 48 * per['bfloat16']
    axis = {'kv_page_bytes_bf16': per['bfloat16'],
            'kv_page_bytes_int8': per['int8'],
            'hbm_budget_bytes': budget}
    cohorts = [[(7 + c) % 250] * (2 * page_size) for c in range(30)]
    for dt, key in (('bfloat16', 'bf16'), ('int8', 'int8')):
        n_pages = budget // per[dt] + 1          # + the sink page
        eng = _chunked_build_engine(
            config, params, device, fused=True, slots=slots,
            max_seq_len=max_seq_len, page_size=page_size, kv_dtype=dt,
            n_pages=int(n_pages), prefix_cache=True)
        for wave in range(2):
            for c, prefix in enumerate(cohorts):
                eng.generate([prefix + [11 + c + 100 * wave] * 8], 4)
        m = eng.metrics()
        axis[f'resident_pages_{key}'] = int(n_pages) - 1
        axis[f'prefix_hit_rate_{key}'] = m['prefix_hit_rate']
        axis[f'prefix_cached_pages_{key}'] = m['prefix_cached_pages']
        axis[f'prefix_evictions_{key}'] = m['prefix_evictions']
        del eng
        if device.type == 'cuda':
            torch.cuda.empty_cache()
    axis['resident_page_ratio'] = round(
        axis['resident_pages_int8'] / axis['resident_pages_bf16'], 4)
    axis['prefix_hit_rate_delta'] = round(
        axis['prefix_hit_rate_int8'] - axis['prefix_hit_rate_bf16'], 4)
    return axis


def run_chunked_sweep(args, device: torch.device) -> dict:
    """Fused vs unfused at each concurrency, plus the kv-dtype axis."""
    from skypilot_tpu_torch.infer import server as server_lib
    config = server_lib.MODELS[args.model]()
    if config.max_seq_len < args.max_seq_len:
        # The aggressor spans several chunks; a small preset's rotary
        # horizon widens for free.
        config = dataclasses.replace(config, max_seq_len=args.max_seq_len)
    params = server_lib.random_params(config, args.seed, device,
                                      args.quantize)
    max_seq_len = min(args.max_seq_len, config.max_seq_len)
    page_size = min(args.page_size, 64)
    aggr_prompt = [5] * min(args.aggressor_tokens, max_seq_len - 144)
    sweep = []
    for conc in args.concurrency:
        conc = min(conc, args.slots - 1)   # one slot for the aggressor
        level = {'concurrency': conc,
                 'aggressor_prompt_tokens': len(aggr_prompt),
                 'repeats': args.repeats}
        for fused in (False, True):
            eng = _chunked_build_engine(
                config, params, device, fused=fused, slots=args.slots,
                max_seq_len=max_seq_len, page_size=page_size)
            _chunked_warm(eng, aggr_prompt)
            level['fused' if fused else 'unfused'] = _chunked_victim_run(
                eng, conc, aggr_prompt, args.repeats)
            del eng
            if device.type == 'cuda':
                torch.cuda.empty_cache()
        fp, up = level['fused'], level['unfused']
        if fp['victim_itl_p99_ms'] and up['victim_itl_p99_ms']:
            level['victim_itl_p99_improvement_x'] = (
                up['victim_itl_p99_ms'] / fp['victim_itl_p99_ms'])
            level['victim_itl_p50_improvement_x'] = (
                up['victim_itl_p50_ms'] / fp['victim_itl_p50_ms'])
        level['samples'] = fp['itl_samples'] + up['itl_samples']
        sweep.append(level)
    base = sweep[0] if sweep else {}
    return {
        'metric': 'chunked_victim_itl_p99_improvement_x',
        'value': base.get('victim_itl_p99_improvement_x'),
        'unit': 'x (unfused victim itl p99 / fused victim itl p99, '
                'long-prompt aggressor arriving mid-decode)',
        'victim_itl_p50_improvement_x': base.get(
            'victim_itl_p50_improvement_x'),
        'aggressor_ttft_fused_s': (base.get('fused') or {}).get(
            'aggressor_ttft_p50_s'),
        'aggressor_ttft_unfused_s': (base.get('unfused') or {}).get(
            'aggressor_ttft_p50_s'),
        'sweep_mode': 'chunked',
        'sweep': sweep,
        'kv_dtype_axis': _kv_axis(config, params, device, slots=args.slots,
                                  max_seq_len=max_seq_len,
                                  page_size=page_size),
        'total_samples': sum(lv.get('samples', 0) for lv in sweep),
        'model': args.model,
        'slots': args.slots,
        'page_size': page_size,
        'path': 'in-process engine step loop (fused vs unfused mixed '
                'steps; host clock around each step)',
    }


# ---------------------------------------------------------------------------
# --sweep concurrency
# ---------------------------------------------------------------------------
def _streamed_request(url: str, payload, max_new_tokens: int,
                      timeout: float = 600.0, headers=None) -> tuple:
    """One streamed /generate. Returns (ttft_s, itl samples (one per
    token after the first: each line's arrival gap over the tokens it
    carried), tokens, the done line's queue wait)."""
    body = {'max_new_tokens': max_new_tokens, 'stream': True, **payload}
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json',
                                          **(headers or {})})
    t0 = time.perf_counter()
    itls: List[float] = []
    tokens = 0
    queue_wait = None
    ttft = None
    with urllib.request.urlopen(req, timeout=timeout) as r:
        t_prev = None
        for line in iter(r.readline, b''):
            now = time.perf_counter()
            if not line.strip():
                continue
            obj = json.loads(line)
            got = obj.get('tokens') or []
            if got:
                if ttft is None:
                    ttft = now - t0
                elif t_prev is not None:
                    itls.extend([(now - t_prev) / len(got)] * len(got))
                t_prev = now
                tokens += len(got)
            if obj.get('done'):
                queue_wait = obj.get('queue_wait_s')
    if ttft is None:
        raise RuntimeError('the stream carried no token')
    return ttft, itls, tokens, queue_wait


def _is_long(long_prompt_tokens: int, i: int) -> bool:
    return bool(long_prompt_tokens) and i % 8 == 7


def _sweep_level(gen_url: str, concurrency: int, n_requests: int,
                 new_tokens: int, payload_for=None, headers_for=None,
                 long_prompt_tokens: int = 0) -> dict:
    """One concurrency level: ``n_requests`` streamed requests, at most
    ``concurrency`` in flight; request i sends ``payload_for(i)`` (default
    a short distinct prompt, or with ``long_prompt_tokens`` every 8th a
    prompt of about that many byte tokens, whose TTFTs are also reported
    apart) with ``headers_for(i)`` (called as it is sent)."""
    def prompt_for(i):
        if _is_long(long_prompt_tokens, i):
            return {'prompt': f'ctx{i} ' * (long_prompt_tokens // 5)
                    + ' summarize.'}
        return {'prompt': f'request {i} hello world'}
    payload_for = payload_for or prompt_for

    def one(i):
        return i, _streamed_request(gen_url, payload_for(i), new_tokens,
                                    headers=headers_for(i) if headers_for
                                    else None)

    ttfts, itl_samples, waits, longs, shorts = [], [], [], [], []
    tokens = 0
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(concurrency) as pool:
        futs = [pool.submit(one, i) for i in range(n_requests)]
        for f in concurrent.futures.as_completed(futs):
            i, (ttft, itls, n, qwait) = f.result()
            ttfts.append(ttft)
            (longs if _is_long(long_prompt_tokens, i)
             else shorts).append(ttft)
            itl_samples.extend(itls)
            tokens += n
            if qwait is not None:
                waits.append(qwait)
    wall = time.perf_counter() - t0
    for vals in (ttfts, itl_samples, waits, longs, shorts):
        vals.sort()
    lane = ({'short_ttft_p50_s': loadgen.pct(shorts, 0.50),
             'long_ttft_p50_s': loadgen.pct(longs, 0.50),
             'long_samples': len(longs)} if longs else {})
    return {
        'concurrency': concurrency,
        'samples': len(ttfts),
        'ttft_p50_s': loadgen.pct(ttfts, 0.50),
        'ttft_p90_s': loadgen.pct(ttfts, 0.90),
        'ttft_p99_s': loadgen.pct(ttfts, 0.99),
        'ttft_mean_s': statistics.fmean(ttfts),
        'queue_wait_p50_ms': _ms(loadgen.pct(waits, 0.50)),
        'queue_wait_p99_ms': _ms(loadgen.pct(waits, 0.99)),
        'itl_p50_ms': _ms(loadgen.pct(itl_samples, 0.50)),
        'itl_p99_ms': _ms(loadgen.pct(itl_samples, 0.99)),
        'itl_samples': len(itl_samples),
        'tokens_per_sec': tokens / wall,
        'throughput_rps': n_requests / wall,
        **lane,
    }


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _get_json(url: str, timeout: float = 10.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


class _Servers:
    """Port servers in subprocesses (``python -m
    skypilot_tpu_torch.infer.server``), each started with ``flags`` after
    the common ones, waited on until healthy together and stopped on
    exit. ``bases`` are their URLs."""

    def __init__(self, args, device, flag_sets) -> None:
        self.procs, self.bases, self.logs = [], [], []
        self.ready_s = None
        # Time to ready counts from the first spawn.
        self._t0 = time.perf_counter()
        for i, flags in enumerate(flag_sets):
            port = _free_port()
            cmd = [sys.executable, '-m', 'skypilot_tpu_torch.infer.server',
                   '--host', '127.0.0.1', '--port', str(port), '--model',
                   args.model, '--slots', str(args.slots), '--max-seq-len',
                   str(args.max_seq_len), '--page-size', str(args.page_size),
                   '--device', str(device), '--seed', str(args.seed),
                   *(['--paged'] if args.paged else []),
                   *(['--quantize'] if args.quantize else []),
                   *(['--tp', str(args.tp)] if args.tp > 1 else []),
                   *replica_flags(args), *flags]
            log = (open(f'{args.server_log}.{i}' if i else args.server_log,
                        'w') if args.server_log else subprocess.DEVNULL)
            self.logs.append(log)
            self.procs.append(subprocess.Popen(cmd, cwd=ROOT, stdout=log,
                                               stderr=subprocess.STDOUT))
            self.bases.append(f'http://127.0.0.1:{port}')
        self._boot_timeout = args.boot_timeout

    def __enter__(self) -> '_Servers':
        try:
            deadline = time.time() + self._boot_timeout
            waiting = list(zip(self.procs, self.bases))
            while waiting:
                proc, base = waiting[0]
                if proc.poll() is not None:
                    raise RuntimeError(f'a server exited with '
                                       f'{proc.returncode} before it was '
                                       f'healthy')
                try:
                    if _get_json(base + '/health', 2.0).get(
                            'status') == 'ok':
                        waiting.pop(0)
                        continue
                except OSError:
                    pass
                if time.time() > deadline:
                    raise RuntimeError('a server never became healthy')
                time.sleep(0.25)
            self.ready_s = time.perf_counter() - self._t0
        except BaseException:
            self.__exit__()
            raise
        return self

    def __exit__(self, *exc) -> None:
        for proc in self.procs:
            proc.terminate()
        for proc in self.procs:
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for log in self.logs:
            if log is not subprocess.DEVNULL:
                log.close()


def replica_flags(args) -> List[str]:
    """The reference bench's replica flags, forwarded to every server."""
    flags = ['--prefix-cache'] if args.prefix_cache else []
    if args.spec_k:
        flags += ['--spec-k', str(args.spec_k), '--spec-ngram',
                  str(args.spec_ngram)]
    if args.scheduler:
        flags += ['--scheduler', args.scheduler]
    if args.tenant_weights:
        flags += ['--tenant-weights', args.tenant_weights]
    if args.sweep == 'tenants':
        # Fairness needs a finite admission bound to shed against.
        flags += ['--max-queue-requests', str(4 * args.slots)]
    if args.tokenizer:
        flags += ['--tokenizer', args.tokenizer]
    return flags


def run_concurrency_sweep(args, device: torch.device) -> dict:
    """The port's server in a subprocess, driven over HTTP."""
    flags = ['--fused-prefill'] if args.fused_prefill else []
    with _Servers(args, device, [flags]) as servers:
        base = servers.bases[0]
        gen_url = base + '/generate'
        cold_s = _streamed_request(gen_url, {'prompt': 'cold request'},
                                   args.new_tokens)[0]
        _sweep_level(gen_url, max(args.concurrency), 2 * args.slots,
                     args.new_tokens,      # warm, off the clock
                     long_prompt_tokens=args.long_prompt_tokens)
        sweep = [_sweep_level(gen_url, conc, args.requests_per_level,
                              args.new_tokens,
                              long_prompt_tokens=args.long_prompt_tokens)
                 for conc in args.concurrency]
        metrics = _get_json(base + '/metrics')
        ready_s = servers.ready_s
    first = sweep[0] if sweep else {}
    return {
        'metric': 'serve_ttft_warm_p50_s',
        'value': first.get('ttft_p50_s'),
        'unit': 'seconds',
        'ttft_warm_p99_s': first.get('ttft_p99_s'),
        'itl_p50_ms': first.get('itl_p50_ms'),
        'itl_p99_ms': first.get('itl_p99_ms'),
        'sweep_mode': 'concurrency',
        'server_ready_s': ready_s,
        'cold_first_request_s': cold_s,
        'sweep': sweep,
        'total_samples': sum(lv['samples'] for lv in sweep),
        'model': args.model,
        'slots': args.slots,
        'new_tokens': args.new_tokens,
        'fused_prefill': args.fused_prefill,
        'long_prompt_tokens': args.long_prompt_tokens,
        'tp': args.tp,
        'server_metrics': {k: metrics.get(k) for k in (
            'decode_steps', 'decode_tokens', 'tokens_per_step',
            'prefill_tokens', 'fused_steps', 'decode_stall_steps',
            'step_programs', 'stepline_steps', 'integrity', 'param_bytes',
            'kernel_launches', 'paged', 'kv_cache_bytes')},
        'path': 'client -> torch replica server (streamed; client-side '
                'send -> first token line clock)',
    }


# ---------------------------------------------------------------------------
# --sweep shared-prefix and --sweep disagg
# ---------------------------------------------------------------------------
TAIL_TOKENS = 16


def _block(seed: int, n: int) -> list:
    """A deterministic token block, ids in [2, 201] (inside every model's
    vocabulary); the seed goes through a PRNG, so distinct seeds give
    distinct leading blocks (the reference's ``_block``)."""
    rng = random.Random(seed)
    return [2 + rng.randrange(200) for _ in range(n)]


def _cohort(base: int, sys_tokens: int):
    """Request i of a cohort: one shared system block, a unique tail."""
    shared = _block(base, sys_tokens)
    return lambda i: {'tokens': shared + _block(base + 200003 + i,
                                                TAIL_TOKENS)}


def _prefix_counters(m: dict) -> dict:
    return {k: m.get(k) or 0 for k in (
        'prefix_hits', 'prefix_misses', 'prefix_tokens_saved',
        'kv_transfers_total', 'kv_transfer_bytes', 'kv_transfer_failures')}


def _window(before: dict, after: dict) -> dict:
    """Counter deltas over a pass, and its hit rate."""
    d = {k: after[k] - before[k] for k in before}
    lookups = d['prefix_hits'] + d['prefix_misses']
    d['prefix_hit_rate'] = (round(d['prefix_hits'] / lookups, 4)
                            if lookups else 0.0)
    return d


def run_shared_prefix_sweep(args, device: torch.device) -> dict:
    """The port's server with the prefix cache: cold then shared passes
    at each concurrency level."""
    sys_tokens = args.shared_prefix_tokens
    with _Servers(args, device, [[]]) as servers:
        base = servers.bases[0]
        gen_url, metrics_url = base + '/generate', base + '/metrics'
        # Cold and warm off the clock: every chunk bucket's program, and
        # the bucket a hit's tail takes.
        cold_s = _streamed_request(
            gen_url, _cohort(1, sys_tokens)(0), args.new_tokens)[0]
        _sweep_level(gen_url, max(args.concurrency), 2 * args.slots,
                     args.new_tokens, payload_for=_cohort(2, sys_tokens))
        sweep = []
        for li, conc in enumerate(args.concurrency):
            ub = (li + 1) * 1_000_000
            cold = _sweep_level(
                gen_url, conc, args.requests_per_level, args.new_tokens,
                payload_for=lambda i, ub=ub: _cohort(ub + 7 + i,
                                                     sys_tokens)(0))
            shared = _cohort(ub, sys_tokens)
            _streamed_request(gen_url, shared(0), args.new_tokens)  # seed
            m0 = _prefix_counters(_get_json(metrics_url))
            warm = _sweep_level(gen_url, conc, args.requests_per_level,
                                args.new_tokens,
                                payload_for=lambda i, f=shared: f(i + 1))
            win = _window(m0, _prefix_counters(_get_json(metrics_url)))
            sweep.append({
                'concurrency': conc,
                'samples': cold['samples'] + warm['samples'],
                'system_prompt_tokens': sys_tokens,
                'tail_tokens': TAIL_TOKENS,
                'cold': cold, 'shared': warm,
                'prefix_hit_rate': win['prefix_hit_rate'],
                'tokens_prefill_saved': win['prefix_tokens_saved'],
                'ttft_improvement_x': cold['ttft_p50_s'] / warm['ttft_p50_s'],
                # > 1: the shared pass decodes slower (reuse must not tax
                # decode).
                'itl_ratio_shared_over_cold': (warm['itl_p50_ms']
                                               / cold['itl_p50_ms'])})
        metrics = _get_json(metrics_url)
        ready_s = servers.ready_s
    first = sweep[0] if sweep else {}
    return {
        'metric': 'shared_prefix_ttft_improvement_x',
        'value': first.get('ttft_improvement_x'),
        'unit': 'x (cold ttft p50 / shared ttft p50, first level)',
        'sweep_mode': 'shared-prefix',
        'server_ready_s': ready_s,
        'cold_first_request_s': cold_s,
        'sweep': sweep,
        'total_samples': sum(lv['samples'] for lv in sweep),
        'model': args.model, 'slots': args.slots,
        'page_size': args.page_size, 'new_tokens': args.new_tokens,
        'server_metrics': {k: metrics.get(k) for k in (
            'prefix_hit_rate', 'prefix_tokens_saved', 'prefix_cached_pages',
            'prefix_evictions', 'step_programs', 'kernel_launches',
            'integrity')},
        'path': 'client -> torch replica server with --prefix-cache '
                '(streamed; client-side send -> first token line clock)',
    }


def run_disagg_sweep(args, device: torch.device) -> dict:
    """A prefill server and a decode server on the one card, int8 pages,
    the prefix cache on both; the bench routes as the serve load balancer
    would."""
    from skypilot_tpu_torch.utils import prefix_hash
    sys_tokens = args.shared_prefix_tokens
    common = ['--kv-dtype', 'int8']
    if args.n_pages:
        common += ['--n-pages', str(args.n_pages)]
    with _Servers(args, device, [common + ['--role', 'prefill'],
                                 common + ['--role', 'decode']]) as servers:
        pre, dec = servers.bases
        dec_gen, pre_gen = dec + '/generate', pre + '/generate'
        # Cold and warm both servers off the clock.
        cold_s = _streamed_request(pre_gen, _cohort(1, sys_tokens)(0),
                                   args.new_tokens)[0]
        for base in (pre, dec):
            _sweep_level(base + '/generate', max(args.concurrency),
                         2 * args.slots, args.new_tokens,
                         payload_for=_cohort(900001, sys_tokens))

        def donor_for(payload):
            """The header the load balancer would send: the prefill
            server while the decode server's advertised index lacks the
            longest chain of this prompt that the prefill server holds."""
            def headers(_i):
                chain = prefix_hash.chain_hashes(payload(_i)['tokens'],
                                                 args.page_size)
                held = {}
                for name, url in (('pre', pre), ('dec', dec)):
                    snap = _get_json(url + '/metrics')['kv_prefix_index']
                    held[name] = prefix_hash.match_depth(
                        chain, set(snap.get('full') or ()))
                return ({'X-SkyTpu-KV-Donor': pre}
                        if held['pre'] > held['dec'] else {})
            return headers

        sweep = []
        for li, conc in enumerate(args.concurrency):
            ub = (li + 1) * 1_000_000
            # Each cohort's first request goes alone: the decode server
            # recomputes the block, or pulls it; then the rest at the
            # level's concurrency.
            d0 = _prefix_counters(_get_json(dec + '/metrics'))
            rec = _cohort(ub, sys_tokens)
            rec_first = _streamed_request(dec_gen, rec(0),
                                          args.new_tokens)[0]
            recompute = _sweep_level(dec_gen, conc, args.requests_per_level,
                                     args.new_tokens,
                                     payload_for=lambda i, f=rec: f(i + 1))
            d1 = _prefix_counters(_get_json(dec + '/metrics'))
            pay = _cohort(ub + 5_000_000, sys_tokens)
            _streamed_request(pre_gen, pay(0), args.new_tokens)   # seed
            p1 = _prefix_counters(_get_json(pre + '/metrics'))
            route = donor_for(pay)
            pull_first = _streamed_request(dec_gen, pay(1), args.new_tokens,
                                           headers=route(1))[0]
            transfer = _sweep_level(
                dec_gen, conc, args.requests_per_level, args.new_tokens,
                payload_for=lambda i, f=pay: f(i + 2),
                headers_for=lambda i, r=route: r(i + 2))
            dm = _get_json(dec + '/metrics')
            d2 = _prefix_counters(dm)
            p2 = _prefix_counters(_get_json(pre + '/metrics'))
            moved = _window(d1, d2)
            sweep.append({
                'concurrency': conc,
                'samples': recompute['samples'] + transfer['samples'],
                'system_prompt_tokens': sys_tokens,
                'recompute': recompute, 'transfer': transfer,
                'recompute_hit_rate': _window(d0, d1)['prefix_hit_rate'],
                'transfer_hit_rate': moved['prefix_hit_rate'],
                'kv_transfers': moved['kv_transfers_total'],
                'kv_transfer_bytes': moved['kv_transfer_bytes'],
                'kv_transfer_failures': moved['kv_transfer_failures'],
                'donor_exports': (p2['kv_transfers_total']
                                  - p1['kv_transfers_total']),
                'kv_transfer_p99_s': dm.get('kv_transfer_p99_s'),
                'recompute_first_ttft_s': rec_first,
                'transfer_first_ttft_s': pull_first,
                'first_ttft_improvement_x': rec_first / pull_first,
                'ttft_improvement_x': (recompute['ttft_p50_s']
                                       / transfer['ttft_p50_s'])})
        metrics = {'prefill': _get_json(pre + '/metrics'),
                   'decode': _get_json(dec + '/metrics')}
        ready_s = servers.ready_s
    first = sweep[0] if sweep else {}
    return {
        'metric': 'disagg_first_ttft_improvement_x',
        'value': first.get('first_ttft_improvement_x'),
        'unit': 'x (a cohort\'s first request alone on the decode server: '
                'ttft recomputing the shared block / ttft pulling it from '
                'the prefill server, first level)',
        'kv_transfers_total': sum(lv['kv_transfers'] for lv in sweep),
        'kv_transfer_failures': sum(lv['kv_transfer_failures']
                                    for lv in sweep),
        'transfer_p99_s': metrics['decode'].get('kv_transfer_p99_s'),
        'sweep_mode': 'disagg',
        'server_ready_s': ready_s,
        'cold_first_request_s': cold_s,
        'sweep': sweep,
        'total_samples': sum(lv['samples'] for lv in sweep),
        'model': args.model, 'slots': args.slots,
        'page_size': args.page_size, 'kv_dtype': 'int8',
        'n_pages': args.n_pages, 'roles': ['prefill', 'decode'],
        'server_metrics': {role: {k: m.get(k) for k in (
            'role', 'prefix_hit_rate', 'prefix_cached_pages',
            'kv_transfers_total', 'kv_transfer_bytes',
            'kv_transfer_failures', 'kv_transfer_p99_s', 'step_programs',
            'kv_page_bytes')} for role, m in metrics.items()},
        'path': 'client (routing as the serve load balancer: '
                'X-SkyTpu-KV-Donor while the decode server lacks the '
                'prefix) -> torch decode server, pulling int8 pages from '
                'the torch prefill server over /kv/export',
    }


# ---------------------------------------------------------------------------
# --sweep coldstart
# ---------------------------------------------------------------------------
def libraries(build_dir) -> Dict[str, float]:
    """The kernel libraries in a build directory: file name -> mtime."""
    return {p.name: p.stat().st_mtime
            for p in sorted(pathlib.Path(build_dir).glob('*.so'))}


def coldstart_boot(args, device: torch.device, build_dir: str, boot: int,
                   then=None, flags=()) -> dict:
    """One whole server boot with ``--compile-cache-dir build_dir``: spawn
    -> ``/health`` ready -> the first streamed token, the server's
    ``coldstart.*`` stamps, the seconds each ``nvcc`` of the boot took,
    and the libraries the boot added to ``build_dir`` (with every
    library's mtime before and after). ``then(base_url)``, when given,
    runs against the ready server before it stops; its result is
    ``then``. ``flags``: more server flags for this boot."""
    before = libraries(build_dir)
    with _Servers(args, device,
                  [['--compile-cache-dir', build_dir, *flags]]) as servers:
        base = servers.bases[0]
        ttft = _streamed_request(base + '/generate', {'prompt': 'hello'},
                                 4)[0]
        stamps = {ev['event'].split('.', 1)[1]:
                  {k: v for k, v in ev.items() if k.endswith('_s')}
                  for ev in _get_json(base + '/debug/stepline')['events']
                  if ev['event'].startswith('coldstart.')}
        metrics = _get_json(base + '/metrics')
        extra = then(base) if then is not None else None
        ready_s = servers.ready_s
    after = libraries(build_dir)
    out = {'boot': boot,
           'time_to_ready_s': ready_s,
           'first_token_s': ready_s + ttft,
           'ttft_after_ready_s': ttft,
           'stamps': stamps,
           'kernel_build_dir': metrics['kernel_build_dir'],
           'nvcc_s': metrics['kernel_build_s'],
           'libraries_added': sorted(set(after) - set(before)),
           'library_mtimes_before': before,
           'library_mtimes_after': after}
    if then is not None:
        out['then'] = extra
    return out


def run_coldstart_sweep(args, device: torch.device) -> dict:
    """Two boots against one fresh build directory: the first compiles
    the kernels it launches, the second loads them."""
    with tempfile.TemporaryDirectory(prefix='sky-tpu-kernels-') as cache:
        boots = [coldstart_boot(args, device, cache, i) for i in range(2)]
    cold, warm = boots
    return {
        'metric': 'coldstart_ready_ratio_cold_over_warm',
        'value': cold['time_to_ready_s'] / warm['time_to_ready_s'],
        'unit': 'x (boot-1 time-to-ready, nvcc into an empty kernel build '
                'directory / boot-2 time-to-ready, the same directory)',
        'cold_time_to_ready_s': cold['time_to_ready_s'],
        'warm_time_to_ready_s': warm['time_to_ready_s'],
        'cold_first_token_s': cold['first_token_s'],
        'warm_first_token_s': warm['first_token_s'],
        'cold_nvcc_s': cold['nvcc_s'],
        'warm_nvcc_s': warm['nvcc_s'],
        'sweep_mode': 'coldstart',
        'sweep': boots,
        'model': args.model,
        'slots': args.slots,
        'path': 'whole server boot (spawn -> /health -> first streamed '
                'token), the kernel build directory shared across boots',
    }


# ---------------------------------------------------------------------------
# --sweep speculative
# ---------------------------------------------------------------------------
SPEC_COUNTERS = ('spec_steps', 'spec_slot_steps', 'spec_drafted_tokens',
                 'spec_accepted_tokens', 'spec_emitted_tokens',
                 'decode_steps', 'decode_tokens')


def speculative_level(gen_url: str, metrics_url: str, concurrency: int,
                      n_requests: int, spec_k: int, max_new: int,
                      uniq_base: int = 0) -> dict:
    """One level: the same template-heavy prompts (a shared 12-token block
    four times and a unique 6-token tail: the shape prompt-lookup drafting
    is for) with per-request speculation off (plain decode steps), then
    on, the replica's counters windowed around the second pass, and a
    probe that one prompt gives the same greedy tokens both ways."""
    template = _block(9973, 12) * 4

    def payload(i: int, spec: bool) -> dict:
        return {'tokens': template + _block(uniq_base + 31 + i, 6),
                'max_new_tokens': max_new, 'spec': spec}

    off = _sweep_level(gen_url, concurrency, n_requests, max_new,
                       payload_for=lambda i: payload(i, False))
    m0 = _get_json(metrics_url)
    on = _sweep_level(gen_url, concurrency, n_requests, max_new,
                      payload_for=lambda i: payload(i + n_requests, True))
    m1 = _get_json(metrics_url)
    d = {k: (m1.get(k) or 0) - (m0.get(k) or 0) for k in SPEC_COUNTERS}
    probe = payload(10**9, False)
    identical = (_spliced_request(gen_url, probe, max_new)['tokens']
                 == _spliced_request(gen_url, {**probe, 'spec': True},
                                     max_new)['tokens'])
    out = {
        'concurrency': concurrency,
        'samples': off['samples'] + on['samples'],
        'spec_k': spec_k,
        'spec_off': off,
        'spec_on': on,
        'counters': d,
        'accepted_len_mean': (d['spec_emitted_tokens'] / d['spec_slot_steps']
                              if d['spec_slot_steps'] else None),
        'spec_accept_rate': (d['spec_accepted_tokens']
                             / d['spec_drafted_tokens']
                             if d['spec_drafted_tokens'] else None),
        'tokens_per_step': (d['decode_tokens'] / d['decode_steps']
                            if d['decode_steps'] else None),
        'bit_identical': identical,
    }
    if on['itl_p50_ms'] and off['itl_p50_ms']:
        # > 1: speculation cut the time between tokens by that factor.
        out['itl_improvement_x'] = off['itl_p50_ms'] / on['itl_p50_ms']
    if on['ttft_p50_s'] and off['ttft_p50_s']:
        out['ttft_ratio_on_over_off'] = on['ttft_p50_s'] / off['ttft_p50_s']
    return out


def warm_speculative(gen_url: str, concurrency: int, n: int,
                     max_new: int) -> None:
    """Run decode and verify off the clock: one pass with speculation
    off, one with it on."""
    for base, spec in ((777, False), (8777, True)):
        _sweep_level(gen_url, concurrency, n, max_new,
                     payload_for=lambda i, b=base, sp=spec: {
                         'tokens': _block(b + i, 54), 'spec': sp})


def run_speculative_sweep(args, device: torch.device) -> dict:
    """The server with ``--spec-k``: speculation off vs on at each
    level."""
    with _Servers(args, device, [[]]) as servers:
        base = servers.bases[0]
        gen_url, metrics_url = base + '/generate', base + '/metrics'
        cold_s = _streamed_request(gen_url, {'prompt': 'cold request'},
                                   args.new_tokens)[0]
        warm_speculative(gen_url, max(args.concurrency), args.slots,
                         args.spec_max_new)
        sweep = [speculative_level(gen_url, metrics_url, conc,
                                   args.requests_per_level, args.spec_k,
                                   args.spec_max_new,
                                   uniq_base=(li + 1) * 1_000_000)
                 for li, conc in enumerate(args.concurrency)]
        metrics = _get_json(metrics_url)
        ready_s = servers.ready_s
    first = sweep[0] if sweep else {}
    return {
        'metric': 'speculative_itl_improvement_x',
        'value': first.get('itl_improvement_x'),
        'unit': 'x (spec-off itl p50 / spec-on itl p50, same '
                'template-heavy workload, first level)',
        'accepted_len_mean': first.get('accepted_len_mean'),
        'spec_accept_rate': first.get('spec_accept_rate'),
        'tokens_per_step': first.get('tokens_per_step'),
        'spec_on_itl_p50_ms': (first.get('spec_on') or {}).get('itl_p50_ms'),
        'spec_off_itl_p50_ms': (first.get('spec_off') or {}).get(
            'itl_p50_ms'),
        'bit_identical': all(lv['bit_identical'] for lv in sweep),
        'spec_k': args.spec_k,
        'sweep_mode': 'speculative',
        'server_ready_s': ready_s,
        'cold_first_request_s': cold_s,
        'sweep': sweep,
        'total_samples': sum(lv['samples'] for lv in sweep),
        'model': args.model, 'slots': args.slots,
        'spec_max_new': args.spec_max_new,
        'server_metrics': {k: metrics.get(k) for k in (
            'spec_steps', 'spec_accept_rate', 'accepted_len_mean',
            'step_programs', 'kernel_launches', 'integrity', 'paged')},
        'path': 'client -> torch replica server with --spec-k (streamed; '
                'client-side send -> first token line clock)',
    }


# ---------------------------------------------------------------------------
# --sweep tenants
# ---------------------------------------------------------------------------
def tenant_trace_spec(level: int) -> dict:
    """The 10:1 aggressor/victim mix at ``level``: the victim at about
    ``level`` requests/s in bursts of 2, the aggressor at 10x in bursts of
    10 with longer prompts, 8 new tokens each (the reference's)."""
    return {
        'victim': {'rps': float(level), 'burst': 2, 'prompt_mean': 16,
                   'prompt_max': 48, 'max_new': 8},
        'aggressor': {'rps': 10.0 * level, 'burst': 10, 'prompt_mean': 24,
                      'prompt_max': 96, 'max_new': 8},
    }


def tenant_level(gen_url: str, metrics_url: str, level: int, seed: int,
                 duration_s: float, trace_path: Optional[str] = None
                 ) -> dict:
    """One level: the seeded trace (or ``trace_path``) replayed with the
    tenant header; per-tenant TTFT, time between tokens and shed rate, and
    the replica's counters over the level (its 429s and each tenant's
    sheds and decode tokens, from ``/metrics``)."""
    if trace_path:
        events, _ = loadgen.load_trace(trace_path)
    else:
        events = loadgen.synthesize(seed, tenant_trace_spec(level),
                                    duration_s=duration_s)
    m0 = _get_json(metrics_url)
    records = loadgen.replay_over_http(events, gen_url)
    m1 = _get_json(metrics_url)

    def tenant_delta(key: str) -> dict:
        # The replica's per-tenant counters are cumulative: each level
        # reports its own traffic.
        t0 = m0.get('tenants') or {}
        return {t: row.get(key, 0) - (t0.get(t) or {}).get(key, 0)
                for t, row in (m1.get('tenants') or {}).items()}
    return {
        'concurrency': level,
        'samples': len(records),
        'trace_events': len(events),
        'tenants': loadgen.tenant_summary(records),
        'replica_requests_shed': (m1.get('requests_shed', 0)
                                  - m0.get('requests_shed', 0)),
        'replica_tenants_shed': tenant_delta('requests_shed'),
        'replica_tenants_decode_tokens': tenant_delta('decode_tokens'),
        'engine_queue_depth_after': m1.get('num_waiting'),
    }


def run_tenants_sweep(args, device: torch.device) -> dict:
    """The server with a scheduler and a bounded queue; the trace at each
    level."""
    with _Servers(args, device, [[]]) as servers:
        base = servers.bases[0]
        gen_url, metrics_url = base + '/generate', base + '/metrics'
        cold_s = _streamed_request(gen_url, {'prompt': 'cold request'},
                                   args.new_tokens)[0]
        _sweep_level(gen_url, max(args.concurrency), 2 * args.slots,
                     args.new_tokens)   # warm, off the clock
        sweep = [tenant_level(gen_url, metrics_url, level, args.trace_seed,
                              args.trace_duration, trace_path=args.trace)
                 for level in args.concurrency]
        metrics = _get_json(metrics_url)
        ready_s = servers.ready_s
    first = sweep[0] if sweep else {}
    vict = (first.get('tenants') or {}).get('victim') or {}
    aggr = (first.get('tenants') or {}).get('aggressor') or {}
    return {
        'metric': 'tenants_victim_ttft_p99_s',
        'value': vict.get('ttft_p99_s'),
        'unit': 'seconds (victim p99 TTFT under a 10:1 aggressor tenant, '
                'first level)',
        'victim_shed_rate': vict.get('shed_rate'),
        'aggressor_shed_rate': aggr.get('shed_rate'),
        'victim_queue_wait_p99_ms': vict.get('queue_wait_p99_ms'),
        'victim_itl_p99_ms': vict.get('itl_p99_ms'),
        'scheduler': args.scheduler,
        'trace_seed': args.trace_seed,
        'trace_duration_s': args.trace_duration,
        'max_queue_requests': 4 * args.slots,
        'sweep_mode': 'tenants',
        'server_ready_s': ready_s,
        'cold_first_request_s': cold_s,
        'sweep': sweep,
        'total_samples': sum(lv['samples'] for lv in sweep),
        'model': args.model, 'slots': args.slots,
        'server_metrics': {k: metrics.get(k) for k in (
            'scheduler', 'requests_shed', 'tenants', 'step_programs',
            'kernel_launches', 'integrity', 'paged')},
        'path': 'trace replay (X-SkyTpu-Tenant) -> torch replica server '
                '(streamed; client-side clock)',
    }


# ---------------------------------------------------------------------------
# --sweep chaos-resume
# ---------------------------------------------------------------------------
def _spliced_request(gen_url: str, payload: dict, max_new_tokens: int,
                     cut_after: Optional[int] = None,
                     timeout: float = 600.0) -> dict:
    """One streamed request. With ``cut_after``, the client hangs up after
    that many lines and re-posts the request with ``resume_from`` = the
    tokens delivered so far, splicing the new leg's tokens on: what the
    serve load balancer does when a replica's stream dies. Returns the
    wall time, the resumes, whether a done line closed the stream, the
    spliced tokens and how many of them came before the cut."""
    body = {'max_new_tokens': max_new_tokens, 'stream': True, **payload}
    t0 = time.perf_counter()
    delivered: List[int] = []
    resumes, completed, cut_at = 0, False, None
    try:
        while True:
            leg = {**body, 'resume_from': delivered} if resumes else body
            req = urllib.request.Request(
                gen_url, data=json.dumps(leg).encode(),
                headers={'Content-Type': 'application/json'})
            lines, cut = 0, False
            with urllib.request.urlopen(req, timeout=timeout) as r:
                for line in iter(r.readline, b''):
                    if not line.strip():
                        continue
                    obj = json.loads(line)
                    if 'error' in obj:
                        raise RuntimeError(obj['error'])
                    if obj.get('done'):
                        completed = True
                        break
                    delivered.extend(obj.get('tokens') or [])
                    lines += 1
                    if (cut_after is not None and not resumes
                            and lines >= cut_after):
                        cut = True     # closing the response: the cut
                        break
            if not cut:
                break
            resumes += 1
            cut_at = len(delivered)
    except (OSError, ValueError, RuntimeError):
        completed = False
    return {'duration_s': time.perf_counter() - t0, 'resumed': resumes,
            'completed': completed, 'tokens': delivered, 'cut_at': cut_at}


def _chaos_pass(gen_url: str, concurrency: int, n_requests: int,
                max_new_tokens: int, cut_after: Optional[int]) -> tuple:
    """``n_requests`` at ``concurrency`` in flight, every second one cut
    after ``cut_after`` lines (None: none cut). Returns (stats, each
    request's tokens)."""
    with concurrent.futures.ThreadPoolExecutor(concurrency) as pool:
        futs = [pool.submit(_spliced_request, gen_url,
                            {'prompt': f'chaos request {i}'}, max_new_tokens,
                            cut_after if i % 2 == 0 else None)
                for i in range(n_requests)]
        results = [f.result() for f in futs]
    clean = sorted(r['duration_s'] for r in results
                   if r['completed'] and not r['resumed'])
    resumed = sorted(r['duration_s'] for r in results
                     if r['completed'] and r['resumed'])
    completed = sum(r['completed'] for r in results)
    return {
        'concurrency': concurrency,
        'issued': n_requests,
        'completed': completed,
        'completed_rate': completed / n_requests,
        'resumes': sum(r['resumed'] for r in results),
        'resumed_streams': len(resumed),
        'clean_total_p99_s': loadgen.pct(clean, 0.99),
        'resumed_total_p99_s': loadgen.pct(resumed, 0.99),
    }, results


def chaos_resume_level(gen_url: str, concurrency: int, n_requests: int,
                       max_new_tokens: int, kill_after_chunks: int) -> dict:
    """One level: an uninterrupted pass, then the chaos pass; every
    spliced stream is held to the same request's uninterrupted tokens
    (greedy: a resume must not change them). ``spliced`` lists each
    resumed stream (its prompt, the tokens before the cut and in all),
    ``parted`` those that differ from their twin, where, and the twin's
    tokens."""
    clean, want = _chaos_pass(gen_url, concurrency, n_requests,
                              max_new_tokens, None)
    chaos, got = _chaos_pass(gen_url, concurrency, n_requests,
                             max_new_tokens, kill_after_chunks)
    spliced, parted = [], []
    for i, (g, w) in enumerate(zip(got, want)):
        if not g['resumed']:
            continue
        spliced.append({'request': i, 'prompt': f'chaos request {i}',
                        'cut_at': g['cut_at'], 'tokens': g['tokens']})
        if g['tokens'] != w['tokens']:
            at = next((j for j, (a, b) in enumerate(zip(g['tokens'],
                                                        w['tokens']))
                       if a != b), min(len(g['tokens']), len(w['tokens'])))
            parted.append({'request': i, 'at': at, 'want': w['tokens']})
    level = {'concurrency': concurrency,
             'samples': clean['issued'] + chaos['issued'],
             'uninterrupted': clean, 'chaos': chaos,
             'completed_rate': chaos['completed_rate'],
             'resumes': chaos['resumes'],
             'bit_identical': not parted, 'parted': parted,
             'spliced': spliced}
    if chaos['resumed_total_p99_s'] and clean['clean_total_p99_s']:
        # The price of a mid-stream failover: resumed p99 over untouched.
        level['resume_added_p99_s'] = (chaos['resumed_total_p99_s']
                                       - clean['clean_total_p99_s'])
    return level


def run_chaos_resume_sweep(args, device: torch.device) -> dict:
    """The server, and the bench cutting and resuming every second
    stream."""
    with _Servers(args, device, [[]]) as servers:
        base = servers.bases[0]
        gen_url = base + '/generate'
        cold_s = _streamed_request(gen_url, {'prompt': 'cold request'},
                                   args.new_tokens)[0]
        _sweep_level(gen_url, max(args.concurrency), 2 * args.slots,
                     args.new_tokens)   # warm, off the clock
        sweep = [chaos_resume_level(gen_url, conc, args.requests_per_level,
                                    args.new_tokens, args.kill_after_chunks)
                 for conc in args.concurrency]
        metrics = _get_json(base + '/metrics')
        ready_s = servers.ready_s
    first = sweep[0] if sweep else {}
    return {
        'metric': 'chaos_resume_completed_rate',
        'value': first.get('completed_rate'),
        'unit': 'completed streams / issued (every second stream cut '
                'mid-stream and resumed, first level)',
        'resumes': sum(lv['resumes'] for lv in sweep),
        'resume_added_p99_s': first.get('resume_added_p99_s'),
        'bit_identical': all(lv['bit_identical'] for lv in sweep),
        'kill_after_chunks': args.kill_after_chunks,
        'sweep_mode': 'chaos-resume',
        'server_ready_s': ready_s,
        'cold_first_request_s': cold_s,
        'sweep': sweep,
        'total_samples': sum(lv['samples'] for lv in sweep),
        'model': args.model, 'slots': args.slots,
        'new_tokens': args.new_tokens,
        'server_metrics': {k: metrics.get(k) for k in (
            'requests_cancelled', 'step_programs', 'kernel_launches',
            'integrity', 'paged')},
        'path': 'client (cutting every second stream and resuming it with '
                'resume_from, as the serve load balancer splices) -> torch '
                'replica server',
    }


_REVISION_RE = re.compile(r'^TTFT_r(\d+)\.json$')


def resolve_output(output: Optional[str], clobber: bool) -> Optional[str]:
    """``--output``: ``auto`` is the next free ``TTFT_rNN.json`` in the
    working directory (max + 1 of those there); an existing path is
    refused unless ``--clobber`` (the reference's rules)."""
    if not output:
        return output
    if output == 'auto':
        revs = [int(m.group(1)) for m in
                (_REVISION_RE.match(name) for name in os.listdir('.')) if m]
        return f'TTFT_r{(max(revs) + 1 if revs else 1):02d}.json'
    if os.path.exists(output) and not clobber:
        raise SystemExit(f'refusing to overwrite existing {output!r} (pass '
                         f'--clobber to allow, or --output auto for the next '
                         f'free revision)')
    return output


def resolve_tokenizer(spec: Optional[str]) -> Optional[str]:
    """``--tokenizer``: a path as it is; ``128k`` the derived 128,256-entry
    word-level tokenizer.json, written once under ``$SKY_TPU_HOME/cache``
    (default ``~/.sky_tpu``)."""
    if spec != '128k':
        return spec
    from skypilot_tpu_torch.infer import server as server_lib
    from skypilot_tpu_torch.observability import store
    path = os.path.join(store.base_dir(), 'cache', 'tokenizer_128k.json')
    if not os.path.exists(path):
        print(f'[bench_ttft] deriving the 128k tokenizer -> {path}',
              file=sys.stderr)
        server_lib.synthesize_wordlevel_tokenizer(128_256, path)
    return path


SWEEPS = {'chunked': run_chunked_sweep,
          'concurrency': run_concurrency_sweep,
          'shared-prefix': run_shared_prefix_sweep,
          'disagg': run_disagg_sweep,
          'coldstart': run_coldstart_sweep,
          'speculative': run_speculative_sweep,
          'tenants': run_tenants_sweep,
          'chaos-resume': run_chaos_resume_sweep}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--sweep', choices=SWEEPS, default='concurrency')
    p.add_argument('--model', default='8b',
                   choices=['tiny', '350m', '1b', '8b'])
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument('--slots', type=int, default=8)
    p.add_argument('--max-seq-len', type=int, default=2048)
    p.add_argument('--paged', action='store_true',
                   help='serve the paged KV cache (block tables over a '
                        'page pool); default the dense cache. shared-prefix '
                        'and disagg imply it')
    p.add_argument('--page-size', type=int, default=64)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--concurrency', type=int, nargs='+', default=None,
                   help='in-flight requests per level (the server sweeps, '
                        'default 1 4 8; tenants: the victim\'s requests/s, '
                        'the aggressor 10x) or victims (chunked, default '
                        'slots - 1)')
    p.add_argument('--requests-per-level', type=int, default=32)
    p.add_argument('--new-tokens', type=int, default=32,
                   help='tokens per request (the server sweeps)')
    p.add_argument('--fused-prefill', action='store_true',
                   help='serve with fused mixed steps (concurrency sweep)')
    p.add_argument('--repeats', type=int, default=4,
                   help='aggressor arrivals per engine (chunked sweep)')
    p.add_argument('--aggressor-tokens', type=int, default=768,
                   help='the aggressor prompt (chunked sweep; 6 chunks '
                        'of 128)')
    p.add_argument('--shared-prefix-tokens', type=int, default=1024,
                   help='the system block of the shared-prefix and '
                        'disagg sweeps (each request adds a 16-token '
                        'tail)')
    p.add_argument('--n-pages', type=int, default=257,
                   help='KV pool pages of each disagg server (both 8B '
                        'servers share one card)')
    p.add_argument('--quantize', action='store_true',
                   help='int8 weights: the servers it boots get '
                        '--quantize, the chunked sweep\'s engines int8 '
                        'params')
    p.add_argument('--tp', type=int, default=1,
                   help='tensor-parallel ranks of each server it boots '
                        '(one GPU a rank; the server sweeps)')
    p.add_argument('--boot-timeout', type=float, default=900.0)
    p.add_argument('--server-log', default=None,
                   help='file for the server subprocess output')
    p.add_argument('--prefix-cache', action='store_true',
                   help='the servers\' shared-prefix KV reuse (needs '
                        '--paged; shared-prefix and disagg imply both)')
    p.add_argument('--spec-k', type=int, default=0,
                   help='the servers\' speculative draft width (0 = off; '
                        'the speculative sweep defaults it to 6)')
    p.add_argument('--spec-ngram', type=int, default=3,
                   help='the drafter\'s n-gram width (forwarded)')
    p.add_argument('--spec-max-new', type=int, default=64,
                   help='speculative sweep: tokens per request')
    p.add_argument('--scheduler', default=None,
                   choices=['fcfs', 'deadline', 'wfq'],
                   help='the servers\' scheduling policy (default the '
                        'server\'s fcfs, or wfq for the tenants sweep)')
    p.add_argument('--tenant-weights', default=None,
                   help="wfq weights, e.g. 'victim=2,aggressor=1' "
                        '(forwarded)')
    p.add_argument('--trace', default=None,
                   help='tenants sweep: replay this trace file (the '
                        'loadgen JSONL format) instead of synthesizing')
    p.add_argument('--trace-seed', type=int, default=7,
                   help='tenants sweep: the trace\'s seed')
    p.add_argument('--trace-duration', type=float, default=6.0,
                   help='tenants sweep: seconds of trace a level')
    p.add_argument('--kill-after-chunks', type=int, default=6,
                   help='chaos-resume: cut every second stream after this '
                        'many lines')
    p.add_argument('--long-prompt-tokens', type=int, default=0,
                   help='concurrency sweep: every 8th request a prompt of '
                        'about this many tokens, its TTFT reported apart')
    p.add_argument('--tokenizer', default=None,
                   help='the servers\' tokenizer.json (default: bytes); '
                        "'128k' derives a 128,256-entry word-level one "
                        'under $SKY_TPU_HOME/cache (loading it needs the '
                        'tokenizers package)')
    p.add_argument('--output', default=None,
                   help="also write the JSON document here; 'auto': the "
                        'next free TTFT_rNN.json in the working directory')
    p.add_argument('--clobber', action='store_true',
                   help='let --output overwrite an existing file')
    args = p.parse_args(argv)
    args.output = resolve_output(args.output, args.clobber)
    if args.sweep in ('shared-prefix', 'disagg'):
        args.paged = True
        args.prefix_cache = True
    if args.sweep == 'tenants':
        if args.scheduler is None:
            args.scheduler = 'wfq'
    if args.sweep == 'speculative' and not args.spec_k:
        args.spec_k = 6
    if args.prefix_cache and not args.paged:
        raise SystemExit('--prefix-cache requires --paged')
    if args.concurrency is None:
        args.concurrency = ([args.slots - 1] if args.sweep == 'chunked'
                            else [1, 4, 8])
    return args


def sweep(argv: Optional[List[str]] = None) -> dict:
    """Run the sweep ``argv`` asks for; returns its JSON document."""
    args = parse_args(argv)
    from skypilot_tpu_torch.infer import engine as engine_lib
    device = engine_lib.resolve_device(args.device)
    if device.type == 'cuda':
        device = torch.device('cuda', torch.cuda.current_device()
                              if device.index is None else device.index)
    t0 = time.perf_counter()
    args.tokenizer = resolve_tokenizer(args.tokenizer)
    result = SWEEPS[args.sweep](args, device)
    result.update(device=str(device), card=card_line(device),
                  torch=torch.__version__, quantize=args.quantize,
                  paged=args.paged or args.sweep == 'chunked',
                  wall_s=time.perf_counter() - t0)
    result['args'] = vars(args)
    return result


def main(argv: Optional[List[str]] = None) -> int:
    result = sweep(argv)
    args = result['args']
    doc = json.dumps(result)
    print(doc, flush=True)
    if args['output']:
        os.makedirs(os.path.dirname(os.path.abspath(args['output'])),
                    exist_ok=True)
        with open(args['output'], 'w', encoding='utf-8') as f:
            f.write(doc + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
