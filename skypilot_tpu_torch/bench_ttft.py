"""The port's serving sweep on one card (counterpart of the root
``bench_ttft.py``'s ``--sweep chunked``, ``shared-prefix`` and ``disagg``
and of its default concurrency sweep, for a torch replica).

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

Run: ``python -m skypilot_tpu_torch.bench_ttft --sweep chunked --model
8b`` (or ``--sweep concurrency``, ``shared-prefix`` or ``disagg``).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import pathlib
import random
import socket
import statistics
import subprocess
import sys
import time
import urllib.request
from typing import List, Optional

import torch

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


def _pct(sorted_vals, p: float):
    if not sorted_vals:
        return None
    i = min(len(sorted_vals) - 1, int(len(sorted_vals) * p))
    return sorted_vals[i]


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
        'victim_itl_p50_ms': _ms(_pct(itls, 0.50)),
        'victim_itl_p99_ms': _ms(_pct(itls, 0.99)),
        'aggressor_ttft_p50_s': _pct(ttfts, 0.50),
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


def _sweep_level(gen_url: str, concurrency: int, n_requests: int,
                 new_tokens: int, payload_for=None, headers_for=None) -> dict:
    """One concurrency level: ``n_requests`` streamed requests, at most
    ``concurrency`` in flight; request i sends ``payload_for(i)`` (default
    a short distinct prompt) with ``headers_for(i)`` (called as it is
    sent)."""
    payload_for = payload_for or (
        lambda i: {'prompt': f'request {i} hello world'})

    def one(i):
        return _streamed_request(gen_url, payload_for(i), new_tokens,
                                 headers=headers_for(i) if headers_for
                                 else None)

    ttfts, itl_samples, waits = [], [], []
    tokens = 0
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(concurrency) as pool:
        futs = [pool.submit(one, i) for i in range(n_requests)]
        for f in concurrent.futures.as_completed(futs):
            ttft, itls, n, qwait = f.result()
            ttfts.append(ttft)
            itl_samples.extend(itls)
            tokens += n
            if qwait is not None:
                waits.append(qwait)
    wall = time.perf_counter() - t0
    ttfts.sort()
    itl_samples.sort()
    waits.sort()
    return {
        'concurrency': concurrency,
        'samples': len(ttfts),
        'ttft_p50_s': _pct(ttfts, 0.50),
        'ttft_p90_s': _pct(ttfts, 0.90),
        'ttft_p99_s': _pct(ttfts, 0.99),
        'ttft_mean_s': statistics.fmean(ttfts),
        'queue_wait_p50_ms': _ms(_pct(waits, 0.50)),
        'queue_wait_p99_ms': _ms(_pct(waits, 0.99)),
        'itl_p50_ms': _ms(_pct(itl_samples, 0.50)),
        'itl_p99_ms': _ms(_pct(itl_samples, 0.99)),
        'itl_samples': len(itl_samples),
        'tokens_per_sec': tokens / wall,
        'throughput_rps': n_requests / wall,
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
        for i, flags in enumerate(flag_sets):
            port = _free_port()
            cmd = [sys.executable, '-m', 'skypilot_tpu_torch.infer.server',
                   '--host', '127.0.0.1', '--port', str(port), '--model',
                   args.model, '--slots', str(args.slots), '--max-seq-len',
                   str(args.max_seq_len), '--page-size', str(args.page_size),
                   '--device', str(device), '--seed', str(args.seed),
                   *(['--paged'] if args.paged else []),
                   *(['--quantize'] if args.quantize else []),
                   *(['--tp', str(args.tp)] if args.tp > 1 else []), *flags]
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
            t_boot = time.perf_counter()
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
            self.ready_s = time.perf_counter() - t_boot
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


def run_concurrency_sweep(args, device: torch.device) -> dict:
    """The port's server in a subprocess, driven over HTTP."""
    flags = ['--fused-prefill'] if args.fused_prefill else []
    with _Servers(args, device, [flags]) as servers:
        base = servers.bases[0]
        gen_url = base + '/generate'
        cold_s = _streamed_request(gen_url, {'prompt': 'cold request'},
                                   args.new_tokens)[0]
        _sweep_level(gen_url, max(args.concurrency), 2 * args.slots,
                     args.new_tokens)   # warm, off the clock
        sweep = [_sweep_level(gen_url, conc, args.requests_per_level,
                              args.new_tokens)
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
    with _Servers(args, device, [['--prefix-cache']]) as servers:
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
    common = ['--prefix-cache', '--kv-dtype', 'int8']
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


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--sweep', choices=['chunked', 'concurrency',
                                       'shared-prefix', 'disagg'],
                   default='concurrency')
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
                   help='in-flight requests per level (concurrency '
                        'sweep, default 1 4 8) or victims (chunked, '
                        'default slots - 1)')
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
    p.add_argument('--output', default=None,
                   help='also write the JSON document here')
    args = p.parse_args(argv)
    if args.sweep in ('shared-prefix', 'disagg'):
        args.paged = True
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
    run = {'chunked': run_chunked_sweep,
           'concurrency': run_concurrency_sweep,
           'shared-prefix': run_shared_prefix_sweep,
           'disagg': run_disagg_sweep}[args.sweep]
    result = run(args, device)
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
