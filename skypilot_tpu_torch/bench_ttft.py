"""The port's serving sweep on one card (counterpart of the root
``bench_ttft.py``'s ``--sweep chunked`` and of its default concurrency
sweep, for a torch replica).

- ``--sweep chunked``: in-process engines (the stall under test is a
  property of the step loop, not of HTTP): victims decode on all but one
  slot while a long-prompt aggressor arrives mid-decode, ``--repeats``
  times, once with ``fused_prefill`` off and once on. It reports the
  victims' time between tokens (p50, p99) in each aggressor's window,
  from its submission to its first token, the aggressor's TTFT, the
  engine's fused-step and stall counters and the flight recorder's stage
  breakdown (``stepline_summary()``), fused vs unfused; and the kv-dtype
  axis: how many pages each page dtype keeps resident in the same bytes.
- ``--sweep concurrency``: starts the port's replica server
  (``python -m skypilot_tpu_torch.infer.server``) and streams
  ``/generate`` to it directly: one cold request (its compile and capture
  tail, reported apart), a warm pass, then each ``--concurrency`` level
  (default 1, 4, 8 in flight). It reports warm TTFT p50/p90/p99, the time
  between tokens and tokens/s per level, clocked by the client.

Both run on the CUDA device unless ``--device cpu`` is given, and print
one JSON document that names the card by name and power limit
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``).
Weights are random, drawn from ``--seed``.

Run: ``python -m skypilot_tpu_torch.bench_ttft --sweep chunked --model
8b`` or ``--sweep concurrency --model 8b``.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import pathlib
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
                          kv_dtype: str = 'bfloat16', n_pages=None):
    from skypilot_tpu_torch.infer import engine as engine_lib
    return engine_lib.InferenceEngine(
        config, params,
        engine_lib.EngineConfig(
            n_slots=slots, max_seq_len=max_seq_len,
            prefill_buckets=(64, 128), prefill_chunk=128,
            page_size=page_size, n_pages=n_pages, kv_dtype=kv_dtype,
            fused_prefill=fused),
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
    launches0 = dict(paged_attn.launches)
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
                            for k, v in paged_attn.launches.items()
                            if v != launches0[k]},
        'step_time_breakdown': breakdown,
    }


def _kv_axis(config, page_size: int) -> dict:
    """int8 pages at a fixed byte budget: how many pages each page dtype
    keeps resident (the closed form of the engine's kv_page_bytes: K and
    V values at their dtype plus, on int8, one fp32 scale per row and KV
    head). The prefix cache, which the reference's axis also measures,
    is not ported yet."""
    per = {dt: (2 * config.n_layers * config.n_kv_heads * page_size
                * (config.head_dim * (1 if dt == 'int8' else 2)
                   + (4 if dt == 'int8' else 0)))
           for dt in ('bfloat16', 'int8')}
    budget = 48 * per['bfloat16']
    return {'kv_page_bytes_bf16': per['bfloat16'],
            'kv_page_bytes_int8': per['int8'],
            'hbm_budget_bytes': budget,
            'resident_pages_bf16': budget // per['bfloat16'],
            'resident_pages_int8': budget // per['int8'],
            'resident_page_ratio': round(
                (budget // per['int8']) / (budget // per['bfloat16']), 4)}


def run_chunked_sweep(args, device: torch.device) -> dict:
    """Fused vs unfused at each concurrency, plus the kv-dtype axis."""
    from skypilot_tpu_torch.infer import server as server_lib
    from skypilot_tpu_torch.models import llama
    config = server_lib.MODELS[args.model]()
    if config.max_seq_len < args.max_seq_len:
        # The aggressor spans several chunks; a small preset's rotary
        # horizon widens for free.
        config = dataclasses.replace(config, max_seq_len=args.max_seq_len)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = llama.init_params(config, gen, device)
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
        'kv_dtype_axis': _kv_axis(config, page_size),
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
                      timeout: float = 600.0) -> tuple:
    """One streamed /generate. Returns (ttft_s, itl samples (one per
    token after the first: each line's arrival gap over the tokens it
    carried), tokens, the done line's queue wait)."""
    body = {'max_new_tokens': max_new_tokens, 'stream': True, **payload}
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
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
                 new_tokens: int) -> dict:
    """One concurrency level of short distinct prompts."""
    ttfts, itl_samples, waits = [], [], []
    tokens = 0
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(concurrency) as pool:
        futs = [pool.submit(_streamed_request, gen_url,
                            {'prompt': f'request {i} hello world'},
                            new_tokens) for i in range(n_requests)]
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


def run_concurrency_sweep(args, device: torch.device) -> dict:
    """The port's server in a subprocess, driven over HTTP."""
    port = _free_port()
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.infer.server',
           '--host', '127.0.0.1', '--port', str(port), '--model', args.model,
           '--slots', str(args.slots), '--max-seq-len',
           str(args.max_seq_len), '--page-size', str(args.page_size),
           '--device', str(device), '--seed', str(args.seed)]
    if args.fused_prefill:
        cmd.append('--fused-prefill')
    log = open(args.server_log, 'w') if args.server_log else \
        subprocess.DEVNULL
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=log,
                            stderr=subprocess.STDOUT)
    base = f'http://127.0.0.1:{port}'
    try:
        deadline = time.time() + args.boot_timeout
        t_boot = time.perf_counter()
        while True:
            if proc.poll() is not None:
                raise RuntimeError(f'the server exited with {proc.returncode}'
                                   f' before it was healthy')
            try:
                if _get_json(base + '/health', 2.0).get('status') == 'ok':
                    break
            except OSError:
                pass
            if time.time() > deadline:
                raise RuntimeError('the server never became healthy')
            time.sleep(0.25)
        ready_s = time.perf_counter() - t_boot
        gen_url = base + '/generate'
        cold_s = _streamed_request(gen_url, {'prompt': 'cold request'},
                                   args.new_tokens)[0]
        _sweep_level(gen_url, max(args.concurrency), 2 * args.slots,
                     args.new_tokens)   # warm, off the clock
        sweep = [_sweep_level(gen_url, conc, args.requests_per_level,
                              args.new_tokens)
                 for conc in args.concurrency]
        metrics = _get_json(base + '/metrics')
    finally:
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        if log is not subprocess.DEVNULL:
            log.close()
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
        'server_metrics': {k: metrics.get(k) for k in (
            'decode_steps', 'decode_tokens', 'tokens_per_step',
            'prefill_tokens', 'fused_steps', 'decode_stall_steps',
            'step_programs', 'stepline_steps', 'integrity')},
        'path': 'client -> torch replica server (streamed; client-side '
                'send -> first token line clock)',
    }


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--sweep', choices=['chunked', 'concurrency'],
                   default='concurrency')
    p.add_argument('--model', default='8b',
                   choices=['tiny', '350m', '1b', '8b'])
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument('--slots', type=int, default=8)
    p.add_argument('--max-seq-len', type=int, default=2048)
    p.add_argument('--page-size', type=int, default=64)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--concurrency', type=int, nargs='+', default=None,
                   help='in-flight requests per level (concurrency '
                        'sweep, default 1 4 8) or victims (chunked, '
                        'default slots - 1)')
    p.add_argument('--requests-per-level', type=int, default=32)
    p.add_argument('--new-tokens', type=int, default=32,
                   help='tokens per request (concurrency sweep)')
    p.add_argument('--fused-prefill', action='store_true',
                   help='serve with fused mixed steps (concurrency sweep)')
    p.add_argument('--repeats', type=int, default=4,
                   help='aggressor arrivals per engine (chunked sweep)')
    p.add_argument('--aggressor-tokens', type=int, default=768,
                   help='the aggressor prompt (chunked sweep; 6 chunks '
                        'of 128)')
    p.add_argument('--boot-timeout', type=float, default=900.0)
    p.add_argument('--server-log', default=None,
                   help='file for the server subprocess output')
    p.add_argument('--output', default=None,
                   help='also write the JSON document here')
    args = p.parse_args(argv)
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
    run = (run_chunked_sweep if args.sweep == 'chunked'
           else run_concurrency_sweep)
    result = run(args, device)
    result.update(device=str(device), card=card_line(device),
                  torch=torch.__version__, wall_s=time.perf_counter() - t0)
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
