#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``skypilot_tpu_torch``) on one NVIDIA GPU.

Phases, in order; any failure exits non-zero:

1. Card check: CUDA must be available; prints the card's name and power
   limit as ``nvidia-smi`` reports them.
2. Build: compiles every kernel of the serving path from
   ``skypilot_tpu_torch/ops/csrc`` with ``nvcc`` (one process per
   source, started together) and prints the seconds and the compiler's
   register/spill report.
3. Kernel vs plain: at the Llama-3-8B shapes (8 KV heads, group 4,
   head_dim 128, pages of 64 bf16 rows) each kernel is held against its
   plain PyTorch version on the same inputs, at ``ATOL``; then, on small
   inputs, at every head_dim, group and page size the kernels take.
4. Timing: each kernel, its plain version and one PyTorch library call
   computing the same function (``scaled_dot_product_attention`` over the
   gathered K/V; a yardstick the port never calls), by CUDA events, with
   the L2 cache flushed between launches; plus the least time the card
   could take for the same work (``bound_ms``).
5. End to end: starts ``python -m skypilot_tpu_torch.infer.server --model
   8b --slots 8 --max-seq-len 2048`` (full width and depth, random
   weights from a seed) in a subprocess, serves mixed-length requests
   (one streamed) twice through ``/generate``, then a burst of short
   prompts that decodes on all 8 slots; checks token counts and that a
   repeated greedy request gives the same tokens, prints TTFT, time
   between tokens and tokens/s, and reads each kernel's launches during
   those requests from ``/metrics``.

Then it prints one ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line.

Run from the root of the repository: ``python3 chip_smoke.py`` (one
card). ``--kernels-only`` stops after phase 3; ``--profile`` adds, after
phase 5, a ``torch.profiler`` breakdown of decode steps of an in-process
engine. The server's log goes to ``chiprun_out/chip_smoke_server.log``.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / 'chiprun_out'

# Kernel vs plain, both fp32 accumulations over the same bf16 inputs:
# they differ only in summation order (~1e-6 on outputs of magnitude
# ~1), so 1e-3 absolute catches any indexing or masking fault.
ATOL = 1e-3

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and
# dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# Llama-3-8B attention shapes.
HKV, GROUP, HD, PAGE = 8, 4, 128, 64
MAX_SEQ = 2048
DECODE_LENGTHS = [1, 64, 65, 2000, 512, 1023, 777, 130]
PREFILL_C, PREFILL_OFFSET, PREFILL_TRUE_LEN = 256, 192, 200
KERNELS = ('paged_decode', 'paged_prefill')
# --profile: decode steps with every slot at this context.
PROFILE_PROMPT, PROFILE_STEPS = 512, 20


def fail(msg: str) -> None:
    raise SystemExit(f'chip_smoke: FAILED: {msg}')


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def time_ms(torch, fn, reps: int, flush) -> float:
    """Median milliseconds of one call of ``fn`` by CUDA events, the L2
    cache flushed (a 64 MB write) before each timed call."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 3 + 4: kernels
# ---------------------------------------------------------------------------
def decode_case(torch, gen, lengths, hkv, group, hd, page, maxp):
    slots = len(lengths)
    need = sum(-(-n // page) for n in lengths)
    n_pages = need + 9
    dev = 'cuda'
    ids = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1)
    tables = torch.zeros((slots, maxp), dtype=torch.int32, device=dev)
    i = 0
    for b, n in enumerate(lengths):
        k = -(-n // page)
        tables[b, :k] = ids[i:i + k].to(torch.int32)
        i += k
    shape = (hkv, n_pages, page, hd)
    k_pages = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    v_pages = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((slots, hkv, group, hd), generator=gen,
                    device=dev).to(torch.bfloat16)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k_pages, v_pages, tables, lengths


def prefill_case(torch, gen, C, hkv, group, hd, page, maxp):
    n_pages = maxp + 8
    dev = 'cuda'
    row = (torch.randperm(n_pages - 1, generator=gen, device=dev)[:maxp]
           + 1).to(torch.int32)
    shape = (hkv, n_pages, page, hd)
    k_pages = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    v_pages = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((C, hkv, group, hd), generator=gen,
                    device=dev).to(torch.bfloat16)
    return q, k_pages, v_pages, row


def decode_err(torch, pa, case) -> float:
    out = pa.paged_decode_attention(*case)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all().item():
        fail('paged_decode: non-finite output')
    ref = pa.paged_decode_attention_reference(*case)
    return (out - ref).abs().max().item()


def prefill_err(torch, pa, case, offset, true_len) -> float:
    out = pa.paged_prefill_attention(*case, offset, true_len)
    torch.cuda.synchronize()
    if not torch.isfinite(out[:true_len]).all().item():
        fail('paged_prefill: non-finite output')
    ref = pa.paged_prefill_attention_reference(*case, offset, true_len)
    return (out[:true_len] - ref[:true_len]).abs().max().item()


def check_kernels(torch, pa):
    """Phase 3: each kernel against its plain version at the 8B shapes,
    then at every shape the kernels take (``pa.CUDA_HEAD_DIMS`` x
    ``CUDA_GROUPS`` x ``CUDA_PAGE_SIZES``, the shapes of the other model
    presets and page sizes among them) on small inputs. Returns {name:
    (max_abs_err at the 8B shapes, inputs)}."""
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    results = {}
    dcase = decode_case(torch, gen, DECODE_LENGTHS, HKV, GROUP, HD, PAGE,
                        MAX_SEQ // PAGE)
    err = decode_err(torch, pa, dcase)
    print(f'paged_decode vs plain: max_abs_err={err:.3e} (atol {ATOL}) '
          f'lengths={DECODE_LENGTHS}', flush=True)
    if err > ATOL:
        fail(f'paged_decode disagrees with its plain version: {err}')
    results['paged_decode'] = (err, dcase)

    tl = PREFILL_TRUE_LEN
    pcase = prefill_case(torch, gen, PREFILL_C, HKV, GROUP, HD, PAGE,
                         MAX_SEQ // PAGE)
    err = prefill_err(torch, pa, pcase, PREFILL_OFFSET, tl)
    print(f'paged_prefill vs plain: max_abs_err={err:.3e} (atol {ATOL}) '
          f'C={PREFILL_C} offset={PREFILL_OFFSET} true_len={tl}',
          flush=True)
    if err > ATOL:
        fail(f'paged_prefill disagrees with its plain version: {err}')
    results['paged_prefill'] = (err, pcase)

    # Every variant: lengths of 1, a page, a page + 1 and a few pages;
    # a 4-page chunk at a 3-page offset (page- but not chunk-aligned)
    # with true_len < C.
    worst = {'paged_decode': 0.0, 'paged_prefill': 0.0}
    n = 0
    for hd in pa.CUDA_HEAD_DIMS:
        for group in pa.CUDA_GROUPS:
            for page in pa.CUDA_PAGE_SIZES:
                shape = f'hd={hd} group={group} page={page}'
                case = decode_case(torch, gen, [1, page, page + 1,
                                                5 * page - 3],
                                   2, group, hd, page, 8)
                err = decode_err(torch, pa, case)
                if err > ATOL:
                    fail(f'paged_decode disagrees with its plain version '
                         f'at {shape}: {err}')
                worst['paged_decode'] = max(worst['paged_decode'], err)
                case = prefill_case(torch, gen, 4 * page, 2, group, hd,
                                    page, 8)
                err = prefill_err(torch, pa, case, 3 * page, 4 * page - 5)
                if err > ATOL:
                    fail(f'paged_prefill disagrees with its plain version '
                         f'at {shape}: {err}')
                worst['paged_prefill'] = max(worst['paged_prefill'], err)
                n += 1
    print(f'all {n} kernel shapes vs plain: max_abs_err decode '
          f'{worst["paged_decode"]:.3e}, prefill '
          f'{worst["paged_prefill"]:.3e} (atol {ATOL})', flush=True)
    return results


def sdpa(torch, q, k, v, mask):
    """One library call computing the same attention (GQA by
    ``enable_gqa``)."""
    F = torch.nn.functional
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          enable_gqa=True)


def time_kernels(torch, pa, checked):
    flush = torch.empty(64 << 20, dtype=torch.int8, device='cuda')
    rows = {}
    hq = HKV * GROUP

    q, kp, vp, tables, lengths = checked['paged_decode'][1]
    slots = q.shape[0]
    ms = time_ms(torch, lambda: pa.paged_decode_attention(
        q, kp, vp, tables, lengths), 50, flush)
    plain = time_ms(torch, lambda: pa.paged_decode_attention_reference(
        q, kp, vp, tables, lengths), 10, flush)
    # Library yardstick: K/V gathered per slot to the longest length.
    S = max(DECODE_LENGTHS)
    S = -(-S // PAGE) * PAGE
    idx = tables[:, :S // PAGE].long()
    kg = kp[:, idx].permute(1, 0, 2, 3, 4).reshape(slots, HKV, S, HD)
    vg = vp[:, idx].permute(1, 0, 2, 3, 4).reshape(slots, HKV, S, HD)
    qs = q.reshape(slots, hq, 1, HD)
    mask = (torch.arange(S, device='cuda')[None, :]
            < lengths[:, None].long())[:, None, None, :]
    lib = time_ms(torch, lambda: sdpa(torch, qs, kg, vg, mask), 50, flush)
    # Bytes the function needs: q in, fp32 out, each live K/V row once,
    # the owned table entries and the lengths.
    toks = sum(DECODE_LENGTHS)
    owned = sum(-(-n // PAGE) for n in DECODE_LENGTHS)
    n_bytes = (q.numel() * (2 + 4) + toks * HKV * HD * 2 * 2
               + owned * 4 + lengths.numel() * 4)
    flops = 4 * toks * hq * HD
    rows['paged_decode'] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                bound=bound(n_bytes, flops))

    q, kp, vp, row = checked['paged_prefill'][1]
    off, tl, C = PREFILL_OFFSET, PREFILL_TRUE_LEN, PREFILL_C
    ms = time_ms(torch, lambda: pa.paged_prefill_attention(
        q, kp, vp, row, off, tl), 50, flush)
    plain = time_ms(torch, lambda: pa.paged_prefill_attention_reference(
        q, kp, vp, row, off, tl), 10, flush)
    S = off + C
    idx = row[:S // PAGE].long()
    kg = kp[:, idx].reshape(1, HKV, S, HD)
    vg = vp[:, idx].reshape(1, HKV, S, HD)
    qs = q.reshape(C, hq, HD).permute(1, 0, 2)[None].contiguous()
    mask = (torch.arange(S, device='cuda')[None, :]
            <= off + torch.arange(C, device='cuda')[:, None])
    lib = time_ms(torch, lambda: sdpa(torch, qs, kg, vg, mask), 50, flush)
    # Rows past true_len are pad the caller drops: q and the fp32 output
    # count at true_len rows, K/V at every live position once, and the
    # table entries up to the last live page.
    n_bytes = (tl * HKV * GROUP * HD * (2 + 4) + (off + tl) * HKV * HD * 2 * 2
               + -(-(off + tl) // PAGE) * 4)
    flops = 4 * HD * hq * sum(off + c + 1 for c in range(tl))
    rows['paged_prefill'] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                 bound=bound(n_bytes, flops))
    for name, r in rows.items():
        print(f'{name}: {r["ms"]:.4f} ms, plain {r["plain_ms"]:.4f} ms, '
              f'library {r["library_ms"]:.4f} ms, bound '
              f'{r["bound"][0]:.4f} ms ({r["bound"][1]})', flush=True)
    return rows


# ---------------------------------------------------------------------------
# Phase 5: end to end through the server
# ---------------------------------------------------------------------------
def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def http_json(url: str, body=None, timeout: float = 600.0):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read()


def burst(base: str, prompts, new: int, vocab: int, stream_last=False):
    """Send every prompt at once (the last one streamed if
    ``stream_last``), check each answer, and return ([(tokens, ttft_s,
    latency_s)] in prompt order, wall seconds)."""
    results = [None] * len(prompts)
    errors = []

    def one(i):
        stream = stream_last and i == len(prompts) - 1
        body = {'tokens': prompts[i], 'max_new_tokens': new,
                'temperature': 0.0, 'stream': stream}
        t0 = time.perf_counter()
        try:
            status, raw = http_json(base + '/generate', body)
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(f'request {i}: {e!r}')
            return
        latency = time.perf_counter() - t0
        if stream:
            lines = [json.loads(x) for x in raw.splitlines() if x.strip()]
            if status != 200 or not lines or not lines[-1].get('done'):
                errors.append(f'stream: status {status}, last line '
                              f'{lines[-1] if lines else None}')
                return
            tokens = [t for ln in lines[:-1] for t in ln['tokens']]
            ttft = lines[-1]['ttft_s']
        else:
            answer = json.loads(raw)
            if status != 200:
                errors.append(f'request {i}: status {status}: {answer}')
                return
            tokens, ttft = answer['tokens'], answer['ttft_s']
        results[i] = (tokens, ttft, latency)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors or any(r is None for r in results):
        fail(f'requests failed: {errors}')
    for i, (tokens, _, _) in enumerate(results):
        if len(tokens) != new:
            fail(f'request {i}: {len(tokens)} tokens, expected {new}')
        if not all(0 <= t < vocab for t in tokens):
            fail(f'request {i}: token ids outside the vocabulary')
    return results, wall


def serve_and_check(base: str, vocab: int, card: str):
    """Mixed-length requests (one streamed) twice, a greedy repeat, and a
    burst of short prompts that decodes on all slots, against a warm
    server. Returns (kernel launch deltas, summary)."""
    import random
    rnd = random.Random(0)
    lengths = [17, 300, 1000, 64, 129]   # the 129-token one is streamed
    prompts = [[rnd.randrange(vocab) for _ in range(n)] for n in lengths]
    new = 32
    _, raw = http_json(base + '/metrics')
    before = json.loads(raw)['kernel_launches']

    # The first burst meets each prefill bucket's shapes for the first
    # time since the one-token warm-up; the second runs them warm.
    cold, cold_wall = burst(base, prompts, new, vocab, stream_last=True)
    warm, warm_wall = burst(base, prompts, new, vocab, stream_last=True)
    # Greedy determinism: the first request alone gives the same tokens.
    [(again, _, _)], _ = burst(base, prompts[:1], new, vocab)
    if again != cold[0][0]:
        fail('a repeated greedy request gave different tokens')
    # Decode on every slot: 8 short prompts, 64 new tokens each. The
    # time between tokens is (latency - ttft) / (new - 1) per request.
    dnew = 64
    dprompts = [[rnd.randrange(vocab) for _ in range(64)] for _ in range(8)]
    dec, dec_wall = burst(base, dprompts, dnew, vocab)
    itl_ms = [(lat - ttft) / (dnew - 1) * 1e3 for _, ttft, lat in dec]

    _, raw = http_json(base + '/metrics')
    metrics = json.loads(raw)
    after = metrics['kernel_launches']
    launches = {k: after[k] - before[k] for k in after}
    summary = {
        'card': card,
        'requests': 2 * len(prompts) + 1 + len(dprompts),
        'mixed_prompt_tokens': lengths, 'mixed_max_new_tokens': new,
        'ttft_cold_s': [r[1] for r in cold],
        'ttft_cold_p50_s': statistics.median(r[1] for r in cold),
        'mixed_cold_wall_s': cold_wall,
        'ttft_warm_s': [r[1] for r in warm],
        'ttft_warm_p50_s': statistics.median(r[1] for r in warm),
        'mixed_warm_wall_s': warm_wall,
        'decode_burst': {'requests': len(dprompts), 'prompt_tokens': 64,
                         'max_new_tokens': dnew, 'wall_s': dec_wall,
                         'tokens_per_sec': len(dprompts) * dnew / dec_wall,
                         'itl_ms': itl_ms,
                         'itl_p50_ms': statistics.median(itl_ms)},
        'decode_steps': metrics['decode_steps'],
        'decode_tokens': metrics['decode_tokens'],
        'kernel_launches': launches,
    }
    print('end to end (Llama-3-8B, random weights, 8 slots, ' + card
          + '): ' + json.dumps(summary), flush=True)
    for name in ('paged_decode_attention', 'paged_prefill_attention'):
        if launches.get(name, 0) <= 0:
            fail(f'{name} was not launched on the main path')
    return launches, summary


def run_server(card: str):
    OUT_DIR.mkdir(exist_ok=True)
    port = free_port()
    log_path = OUT_DIR / 'chip_smoke_server.log'
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.infer.server',
           '--model', '8b', '--slots', '8', '--max-seq-len', str(MAX_SEQ),
           '--host', '127.0.0.1', '--port', str(port)]
    print('starting: ' + ' '.join(cmd[1:]), flush=True)
    t0 = time.time()
    with open(log_path, 'wb') as log:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=log, stderr=log,
                                start_new_session=True)
        try:
            base = f'http://127.0.0.1:{port}'
            while True:
                if proc.poll() is not None:
                    tail = log_path.read_text(errors='replace')[-4000:]
                    fail(f'server exited {proc.returncode}:\n{tail}')
                if time.time() - t0 > 600:
                    fail('server not healthy within 600 s')
                try:
                    status, raw = http_json(base + '/health', timeout=5)
                    if status == 200 and json.loads(raw)['status'] == 'ok':
                        break
                except (urllib.error.URLError, ConnectionError, OSError):
                    pass
                time.sleep(1.0)
            print(f'server healthy after {time.time() - t0:.1f} s',
                  flush=True)
            return serve_and_check(base, 128_256, card)
        finally:
            os.killpg(proc.pid, signal.SIGTERM)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=30)


# ---------------------------------------------------------------------------
# --profile: where a decode step's time goes
# ---------------------------------------------------------------------------
def _kernel_kind(name: str) -> str:
    low = name.lower()
    if 'paged_decode' in low:
        return 'paged_decode_attention'
    if any(k in low for k in ('gemm', 'gemv', 'xmma', 'cutlass', 'cublas',
                              'nvjet')):
        return 'matmul'
    if 'memcpy' in low or 'memset' in low:
        return 'copy'
    return 'other'


def profile_decode(torch, card: str) -> None:
    """An in-process 8B engine with all 8 slots decoding at
    PROFILE_PROMPT tokens of context: the host-clock time of a step over
    PROFILE_STEPS steps, then ``torch.profiler`` over a few more: device
    time by kernel, the device's busy share of the window, and the host
    ops with the most self time."""
    import random
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from skypilot_tpu_torch.infer import server as server_lib
    eng = server_lib.build_engine('8b', 8, MAX_SEQ, PAGE, None, 'cuda')
    slots, vocab = eng.ecfg.n_slots, eng.config.vocab_size
    rnd = random.Random(2)
    for _ in range(slots):
        eng.submit([rnd.randrange(vocab) for _ in range(PROFILE_PROMPT)],
                   max_new_tokens=200)
    while eng.metrics()['prefill_tokens'] < slots * PROFILE_PROMPT:
        eng.step()
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / PROFILE_STEPS * 1e3
    n = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels, host_ops = {}, {}
    for e in prof.key_averages():
        us = getattr(e, 'self_device_time_total', 0)
        if e.device_type == DeviceType.CUDA and us > 0:
            kernels[e.key] = (us / 1e3 / n, e.count / n)
        elif e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0:
            host_ops[e.key] = (e.self_cpu_time_total / 1e3 / n, e.count / n)
    busy = sum(ms for ms, _ in kernels.values())
    kinds = {}
    for name, (ms, _) in kernels.items():
        kinds[_kernel_kind(name)] = kinds.get(_kernel_kind(name), 0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    top_host = sorted(host_ops.items(), key=lambda kv: -kv[1][0])[:15]
    print('decode step profile (Llama-3-8B, 8 slots at '
          f'{PROFILE_PROMPT} tokens, {card}): ' + json.dumps({
              'step_ms': step_ms,
              'decode_tokens_per_sec': slots / step_ms * 1e3,
              'profiled_step_ms': window_ms / n,
              'device_busy_ms_per_step': busy,
              'device_busy_share': busy * n / window_ms,
              'device_busy_share_unprofiled': busy / step_ms,
              'kernel_launches_per_step': sum(c for _, c in kernels.values()),
              'device_ms_per_step_by_kind': kinds,
              'top_kernels': [{'name': k[:100], 'ms_per_step': ms,
                               'launches_per_step': c}
                              for k, (ms, c) in top],
              # Host self time under the profiler (which inflates it).
              'top_host_ops': [{'name': k[:60], 'ms_per_step': ms,
                                'calls_per_step': c}
                               for k, (ms, c) in top_host],
              'max_memory_allocated_gb':
                  torch.cuda.max_memory_allocated() / 1e9}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--kernels-only', action='store_true',
                        help='stop after holding the kernels against '
                             'their plain versions')
    parser.add_argument('--profile', action='store_true',
                        help='after the server run, profile decode steps '
                             'of an in-process engine')
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available; this script needs an '
              'NVIDIA GPU', file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from skypilot_tpu_torch.ops import _build
    from skypilot_tpu_torch.ops import paged_attention as pa

    # Phase 1: the card.
    card = card_line()
    print(card, flush=True)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {torch.cuda.get_device_name(0)}', flush=True)

    # Phase 2: build from the checkout's sources.
    t0 = time.perf_counter()
    secs = _build.build(KERNELS)
    print(f'built {", ".join(f"{k} {v:.1f}s" for k, v in secs.items())} '
          f'({time.perf_counter() - t0:.1f} s wall)', flush=True)
    for name in KERNELS:
        for line in _build.build_log(name).splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  {name}: {line.strip()}', flush=True)

    # Phase 3: kernels vs their plain versions.
    checked = check_kernels(torch, pa)
    if args.kernels_only:
        print('kernels-only: both kernels agree with their plain versions',
              flush=True)
        return 0

    # Phase 4: timing.
    timed = time_kernels(torch, pa, checked)

    # Phase 5: the main path, end to end through the server.
    launches, _ = run_server(card)
    if args.profile:
        profile_decode(torch, card)

    replaces = {
        'paged_decode': ('paged_decode_attention',
                         'skypilot_tpu/ops/paged_attention.py:164'),
        'paged_prefill': ('paged_prefill_attention',
                          'skypilot_tpu/ops/paged_attention.py:341'),
    }
    kernels = []
    for name in KERNELS:
        wrapper, where = replaces[name]
        r = timed[name]
        kernels.append({
            'name': wrapper, 'route': 'cuda',
            'source': f'skypilot_tpu_torch/ops/csrc/{name}.cu',
            'replaces': where, 'launches': launches[wrapper],
            'max_abs_err': checked[name][0], 'ms': r['ms'],
            'plain_ms': r['plain_ms'], 'bound_ms': r['bound'][0],
            'bound_by': r['bound'][1], 'library_ms': r['library_ms']})
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
