#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``skypilot_tpu_torch``) on one NVIDIA GPU.

Phases, in order; any failure exits non-zero:

1. Card check: CUDA must be available; prints the card's name and power
   limit as ``nvidia-smi`` reports them.
2. Build: compiles every kernel source of the port from
   ``skypilot_tpu_torch/ops/csrc`` with ``nvcc`` (one process per
   source, all five started together) and prints the seconds and the
   compiler's register/spill report and warnings; then reads the
   compiled kernels back (``cuobjdump -sass``) and fails unless every
   instance of the flash forward, dQ and dK/dV kernels holds wgmma
   products (``HGMMA``), TMA tile loads (``UTMALDG``) and mbarrier
   operations (``SYNCS``), and every instance of the paged decode/verify
   and prefill kernels (bf16 and int8) ``mma.sync`` products (``HMMA``)
   and ``cp.async`` copies (``LDGSTS``).
3. Kernel vs plain: each kernel is held against its plain PyTorch
   version on the same inputs, at a stated tolerance. The paged kernels
   at the Llama-3-8B shapes (8 KV heads, group 4, head_dim 128, pages of
   64 bf16 rows), then at every head_dim, group and page size they take;
   the speculative verify kernel (5 queries per slot, one slot's run at
   the block table's coverage edge) and the int8 flavors of decode,
   prefill and verify (pages and scales from ``quantize_rows`` of random
   bf16 rows) at the same shapes, then at every head_dim, group, page
   size and (verify) query count, where each verify run's query 0 must
   also be bitwise the decode kernel's output at lengths + 1; decode and
   verify also at lengths on the edges of the kernel's page splits
   (``split_edges``), and prefill at prefixes on its own split edges
   (``prefill_split_edges``) and at the long prefix of phase 4, at the
   8B shapes and in every variant; prefill must also leave its output
   bitwise unchanged when the K/V rows past the slot's frontier hold
   NaN;
   the flash attention forward (out, lse) and backward (dq, dk, dv) at
   the bench_1b shapes (b 6, 12 heads, s 2048, d 128, causal), where the
   backward must also give the same bits on two runs, then at head_dim
   64/128 x group 1/2/4/8 x causal/not, at s 192 (an odd multiple of
   64: the forward's and dK/dV's 128-row CTAs only half fit at the
   end); the fused cross-entropy
   forward (nll, lse) at T 12288, d 1536, V 32768, then at a vocabulary
   that is not a multiple of its tile, with targets in the last tile and
   outside the vocabulary.
4. Timing: each kernel, its plain version and one PyTorch library call
   computing the same function (a yardstick the port never calls:
   ``scaled_dot_product_attention`` for attention, its backward through
   autograd, ``matmul`` + ``logsumexp`` for the cross-entropy), by CUDA
   events with the L2 cache flushed between launches and a sleep kernel
   ahead of each, so the events time the device's work and not the
   host's enqueueing; plus the least time the card could take for the
   same work (``bound_ms``). Prefill is timed twice: a 256-token chunk
   at offset 192 and the last 256-token chunk of a 2048-token prompt.
5. Serving end to end: starts ``python -m skypilot_tpu_torch.infer.server
   --model 8b --slots 8 --max-seq-len 2048 --spec-k 4`` (full width and
   depth, random weights from a seed) in a subprocess, serves
   mixed-length requests (one streamed) twice through ``/generate``, then
   a burst of short prompts that decodes on all 8 slots; checks token
   counts and that a repeated greedy request gives the same tokens,
   prints TTFT, time between tokens and tokens/s; then sends repetitive
   prompts with ``"spec": false`` and with speculation on, which must
   give the same tokens, and prints ``accepted_len_mean``; reads each
   paged kernel's launches during those requests from ``/metrics``. Then
   the same against a second server with ``--kv-dtype int8 --spec-k 4``,
   whose three int8 kernels must all launch, printed beside the bf16
   numbers with ``kv_page_bytes``.
5b. Speculation in process at full 8B width and depth (random weights,
   seed 0): speculation-off greedy tokens for 8 prompts x 64 new tokens,
   then speculation on with an oracle drafter that proposes that
   continuation (wrong at a fixed draft index for half the prompts): the
   tokens must be the same (one divergence is tolerated, only at a
   near-tie of speculation-off's top-2 logits, printed), drafts must be
   accepted, and no page may leak; the wall time of each pass is
   printed; then the int8-vs-bf16 decode-logit delta at these shapes,
   which must be > 0.
6. The training slice against its plain path: a 2-layer model at
   bench_1b width (b 1, s 2048, the same bf16 params), ``loss_fn`` with
   flash attention and the fused cross-entropy (the kernels) against
   dense attention and the dense cross-entropy (no kernel): the loss and
   every gradient leaf, by relative norm.
7. Training end to end: ``python -m skypilot_tpu_torch.bench --attn
   flash --ce fused`` (bench_1b at full width and depth) in a subprocess,
   whose JSON gives tokens/s, MFU, step time, peak memory and each
   training kernel's launches over its timed steps (counters reset just
   before them), then the same with ``--ce dense`` for comparison; then
   ``python -m skypilot_tpu_torch.train.run --model llama-350m --steps 4
   --batch 4 --seq 2048`` with a checkpoint every 2 steps, and again with
   ``--steps 6``, which must resume at step 4.

Then it prints one ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line.

Run from the root of the repository: ``python3 chip_smoke.py`` (one
card). ``--kernels-only`` stops after phase 3; ``--profile`` adds, at
the end, ``torch.profiler`` breakdowns of decode steps and of verify
steps (bf16 and int8 pages) of an in-process engine and of a bench_1b
training step. Subprocess logs go to
``chiprun_out/chip_smoke_*.log``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
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
# time_ms: the sleep ahead of each timed call, in SM clock cycles (about
# a millisecond, longer than the host takes to enqueue any timed call).
SLEEP_CYCLES = 2_000_000

# Llama-3-8B attention shapes.
HKV, GROUP, HD, PAGE = 8, 4, 128, 64
MAX_SEQ = 2048
DECODE_LENGTHS = [1, 64, 65, 2000, 512, 1023, 777, 130]
PREFILL_C, PREFILL_OFFSET, PREFILL_TRUE_LEN = 256, 192, 200
# Prefill's second case: the last chunk of a 2048-token prompt (long
# prompts, RAG contexts), where the prefix pages outweigh the chunk.
PREFILL_LONG_OFFSET, PREFILL_LONG_TRUE_LEN = MAX_SEQ - PREFILL_C, PREFILL_C
# Speculative verify: R = spec_k + 1 = 5 queries per slot over the decode
# lengths, the last slot's run at the block table's coverage edge
# (2044 + 5 > 2048: its last queries see the whole table).
VERIFY_R = 5
VERIFY_LENGTHS = DECODE_LENGTHS[:-1] + [MAX_SEQ - 4]
# Phase 5b: 8 prompts x 64 new tokens; the oracle drafter is wrong at
# this draft index for every other prompt. Speculation on and off may
# part only where speculation-off's top-2 logit margin is at most
# NEAR_TIE of the top logit (the verify step's matmuls see other shapes
# than decode's, so their sums may round differently).
SPEC_PROMPT_LENGTHS = [64, 100, 17, 300, 64, 129, 500, 200]
SPEC_NEW, ORACLE_WRONG_AT, NEAR_TIE = 64, 2, 1e-2

# bench_1b attention (b 6, 12 heads of 128, group 1, s 2048, causal) and
# its loss (T = 6 x 2048 tokens, d 1536, V 32768); the plain versions
# walk keys and the vocabulary in tiles of BLOCK (the bench's 512).
FB, FH, FS, FD = 6, 12, 2048, 128
CE_T, CE_D, CE_V = 6 * 2048, 1536, 32768
BLOCK = 512
# Kernel vs plain, training kernels. bf16 outputs (out, dq, dk, dv):
# both sides accumulate in fp32 and round once to bf16, so they may
# differ by one bf16 step (2^-7 relative) plus fp32 summation noise,
# allowed at 1e-3 of the tensor's largest magnitude; an indexing or
# masking fault is off by the size of the values themselves. fp32
# outputs (lse, nll): summation order only, 1e-5 relative plus 1e-5 of
# the largest magnitude.
BF16_RTOL, BF16_ATOL_FRAC = 2.0 ** -7, 1e-3
FP32_RTOL, FP32_ATOL_FRAC = 1e-5, 1e-5
# The slice vs its plain path (bf16 training step): the plain path
# rounds P to bf16 before P @ V and the logits to bf16 before the loss,
# the kernels keep both in fp32, and every other product rounds to bf16
# on both sides in another order: loss within 1e-2, each gradient leaf
# within 5e-2 by relative norm.
SLICE_LOSS_ATOL, SLICE_GRAD_RTOL = 1e-2, 5e-2
TRAINING_KERNELS = ('flash_attention_fwd', 'flash_attention_bwd_dq',
                    'flash_attention_bwd_dkv', 'fused_cross_entropy_fwd')
# --profile: decode steps with every slot at this context.
PROFILE_PROMPT, PROFILE_STEPS = 512, 20


# Phase 2: instructions each tensor-core kernel's compiled code must
# hold (cuobjdump -sass), by source and kernel: wgmma products, TMA tile
# loads and mbarrier waits in the flash kernels; mma.sync products and
# cp.async copies in the paged kernels.
_WGMMA_TMA = ('HGMMA', 'UTMALDG', 'SYNCS')
_MMA_CP_ASYNC = ('HMMA', 'LDGSTS')
SASS_REQUIRED = {
    'flash_fwd': (('flash_fwd_kernel', _WGMMA_TMA),),
    'flash_bwd': (('flash_bwd_dq_kernel', _WGMMA_TMA),
                  ('flash_bwd_dkv_kernel', _WGMMA_TMA)),
    'paged_decode': (('paged_attention_kernel', _MMA_CP_ASYNC),),
    'paged_prefill': (('paged_prefill_kernel', _MMA_CP_ASYNC),)}


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
    """Median milliseconds of the device's work for one call of ``fn``,
    by CUDA events, the L2 cache flushed (a 64 MB write) before each
    timed call. A sleep kernel (about a millisecond) enqueued before the
    start event keeps the device busy while the host enqueues the call,
    so the events time the device, not the wrapper's Python."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_sass(_build) -> None:
    """Phase 2: count the SASS_REQUIRED ops in each kernel (every
    instance: head_dim, page size, page type), from ``cuobjdump -sass``
    of its built library; fail if one is missing."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    for source, kernels in SASS_REQUIRED.items():
        sass = subprocess.run(
            [tool, '-sass', str(_build.library_path(source))],
            capture_output=True, text=True, check=True, timeout=300).stdout
        for kernel, ops in kernels:
            bodies = [body for body in sass.split('Function : ')[1:]
                      if kernel in body.split('\n', 1)[0]]
            if not bodies:
                fail(f'{source}: no compiled {kernel} in cuobjdump output')
            for body in bodies:
                name = body.split('\n', 1)[0]
                args = re.findall(r'Li(\d+)E', name) + (
                    ['int8'] if 'EaE' in name else [])
                label = f'{kernel}<{",".join(args) or "?"}>'
                counts = {op: len(re.findall(rf'\b{op}\b', body))
                          for op in ops}
                print(f'  {source}: {label} '
                      + ', '.join(f'{op} {n}' for op, n in counts.items()),
                      flush=True)
                if not all(counts.values()):
                    fail(f'{source}: {label} lacks one of {ops}: {counts}')


# ---------------------------------------------------------------------------
# Phase 3 + 4: kernels
# ---------------------------------------------------------------------------
def split_edges(pa, page):
    """Lengths at the decode/verify kernel's split edges (a split holds
    ``pa.PAGES_PER_SPLIT`` pages of ``page`` rows, E positions): one short
    of a split, a full split, one past it, and 2E - 1, whose decode at
    lengths + 1 fills two splits while its verify run opens a third."""
    edge = pa.PAGES_PER_SPLIT * page
    return [edge - 1, edge, edge + 1, 2 * edge - 1]


def variant_pages(pa):
    """Block-table width of the small variant cases: 8 pages, or three
    splits where a split holds more (room for split_edges' third)."""
    return max(8, 3 * pa.PAGES_PER_SPLIT)


def prefill_split_edges(pa, page):
    """Prefix lengths (page-aligned offsets) around the prefill kernel's
    first split edge (a split holds ``pa.PREFILL_PAGES_PER_SPLIT`` pages
    of ``page`` rows, E positions): one page short of it, on it, one
    page past it."""
    edge = pa.PREFILL_PAGES_PER_SPLIT * page
    return [edge - page, edge, edge + page]


def prefill_pages(pa):
    """Block-table width of the small prefill variant cases: room for a
    4-page chunk past the last of prefill_split_edges."""
    return max(8, pa.PREFILL_PAGES_PER_SPLIT + 5)


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


def verify_case(torch, gen, lengths, R, hkv, group, hd, page, maxp):
    """R queries per slot; each slot's table covers its run, up to the
    table's coverage."""
    cover = [min(n + R, maxp * page) for n in lengths]
    _, k_pages, v_pages, tables, _ = decode_case(torch, gen, cover, hkv,
                                                 group, hd, page, maxp)
    q = torch.randn((len(lengths), R, hkv, group, hd), generator=gen,
                    device='cuda').to(torch.bfloat16)
    lengths = torch.tensor(lengths, dtype=torch.int32, device='cuda')
    return q, k_pages, v_pages, tables, lengths


def quantize_case(pa, case):
    """The same case on int8 pages, values and scales from
    ``quantize_rows`` of its bf16 pages: (case, scale keywords)."""
    q, k_pages, v_pages, *rest = case
    kq, ks = pa.quantize_rows(k_pages)
    vq, vs = pa.quantize_rows(v_pages)
    return (q, kq, vq, *rest), {'k_scales': ks, 'v_scales': vs}


def decode_err(torch, pa, case, **kw) -> float:
    out = pa.paged_decode_attention(*case, **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all().item():
        fail('paged_decode: non-finite output')
    ref = pa.paged_decode_attention_reference(*case, **kw)
    return (out - ref).abs().max().item()


def prefill_err(torch, pa, case, offset, true_len, **kw) -> float:
    """Max abs error of the prefill kernel's rows below true_len; fails
    unless every row, pad rows too, is finite (the model writes pad rows
    back into the pages)."""
    out = pa.paged_prefill_attention(*case, offset, true_len, **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all().item():
        fail('paged_prefill: non-finite output')
    ref = pa.paged_prefill_attention_reference(*case, offset, true_len, **kw)
    return (out[:true_len] - ref[:true_len]).abs().max().item()


def verify_err(torch, pa, case, **kw) -> float:
    """The verify kernel against its plain version; fails unless every
    slot's query 0 is bitwise the decode kernel's output at lengths + 1
    (the exact-greedy acceptance rule rests on it)."""
    q, k_pages, v_pages, tables, lengths = case
    out = pa.paged_verify_attention(*case, **kw)
    dec = pa.paged_decode_attention(q[:, 0].contiguous(), k_pages, v_pages,
                                    tables, lengths + 1, **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all().item():
        fail('paged_verify: non-finite output')
    if not torch.equal(out[:, 0], dec):
        fail(f'paged_verify: query 0 is not bitwise the decode kernel at '
             f'lengths + 1 (max diff {(out[:, 0] - dec).abs().max().item()}'
             f', shape {tuple(q.shape)}, int8 {bool(kw)})')
    ref = pa.paged_verify_attention_reference(*case, **kw)
    return (out - ref).abs().max().item()


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
    worst = 0.0
    cases = [(off, tl) for off in prefill_split_edges(pa, PAGE)]
    for off, n in cases + [(PREFILL_LONG_OFFSET, PREFILL_LONG_TRUE_LEN)]:
        worst = max(worst, prefill_err(torch, pa, pcase, off, n))
    print(f'paged_prefill vs plain at offsets {prefill_split_edges(pa, PAGE)}'
          f' (split edges, {pa.PREFILL_PAGES_PER_SPLIT} pages a split) and '
          f'{PREFILL_LONG_OFFSET} (true_len {PREFILL_LONG_TRUE_LEN}): '
          f'max_abs_err={worst:.3e} (atol {ATOL})', flush=True)
    if worst > ATOL:
        fail(f'paged_prefill disagrees with its plain version at the split '
             f'edges or the long prefix: {worst}')
    # Pages past the frontier hold the pad rows the model writes back:
    # NaN there (the rest of the frontier's page and the page after it)
    # must not change a bit of the output.
    q, kp, vp, row = pcase
    total = PREFILL_OFFSET + tl
    clean = pa.paged_prefill_attention(*pcase, PREFILL_OFFSET, tl)
    poisoned = []
    for p in (kp, vp):
        p = p.clone()
        p[:, row[total // PAGE].long(), total % PAGE:] = float('nan')
        p[:, row[total // PAGE + 1].long()] = float('nan')
        poisoned.append(p)
    out = pa.paged_prefill_attention(q, *poisoned, row, PREFILL_OFFSET, tl)
    if not torch.equal(out, clean):
        fail('paged_prefill: NaN in K/V rows past the frontier changed the '
             'output')
    print('paged_prefill: NaN K/V past the frontier leaves the output '
          'bitwise unchanged', flush=True)

    # Every variant: lengths of 1, a page, a page + 1 and a few pages;
    # a 4-page chunk at a 3-page offset (page- but not chunk-aligned)
    # and at the prefill split edges, with true_len < C.
    worst = {'paged_decode': 0.0, 'paged_prefill': 0.0}
    n = 0
    for hd in pa.CUDA_HEAD_DIMS:
        for group in pa.CUDA_GROUPS:
            for page in pa.CUDA_PAGE_SIZES:
                shape = f'hd={hd} group={group} page={page}'
                case = decode_case(torch, gen, [1, page, page + 1,
                                                5 * page - 3]
                                   + split_edges(pa, page),
                                   2, group, hd, page, variant_pages(pa))
                err = decode_err(torch, pa, case)
                if err > ATOL:
                    fail(f'paged_decode disagrees with its plain version '
                         f'at {shape}: {err}')
                worst['paged_decode'] = max(worst['paged_decode'], err)
                case = prefill_case(torch, gen, 4 * page, 2, group, hd,
                                    page, prefill_pages(pa))
                err = max(prefill_err(torch, pa, case, off, 4 * page - 5)
                          for off in [3 * page]
                          + prefill_split_edges(pa, page))
                if err > ATOL:
                    fail(f'paged_prefill disagrees with its plain version '
                         f'at {shape}: {err}')
                worst['paged_prefill'] = max(worst['paged_prefill'], err)
                n += 1
    print(f'all {n} kernel shapes vs plain: max_abs_err decode '
          f'{worst["paged_decode"]:.3e}, prefill '
          f'{worst["paged_prefill"]:.3e} (atol {ATOL})', flush=True)
    return results


def check_spec_int8_kernels(torch, pa):
    """Phase 3 for the verify kernel and the int8 flavors: at the 8B
    shapes, then at every head_dim x group x page size (x query count for
    verify) the wrappers take, int8 pages and scales quantized from random
    bf16 rows. Returns {name: (max_abs_err at the 8B shapes, inputs, scale
    keywords)}."""
    gen = torch.Generator(device='cuda')
    gen.manual_seed(3)
    maxp = MAX_SEQ // PAGE
    vcase = verify_case(torch, gen, VERIFY_LENGTHS, VERIFY_R, HKV, GROUP, HD,
                        PAGE, maxp)
    dcase = decode_case(torch, gen, DECODE_LENGTHS, HKV, GROUP, HD, PAGE,
                        maxp)
    pcase = prefill_case(torch, gen, PREFILL_C, HKV, GROUP, HD, PAGE, maxp)
    off, tl = PREFILL_OFFSET, PREFILL_TRUE_LEN
    runs = {
        'paged_verify': lambda c, kw: verify_err(torch, pa, c, **kw),
        'paged_decode': lambda c, kw: decode_err(torch, pa, c, **kw),
        'paged_prefill': lambda c, kw: prefill_err(torch, pa, c, off, tl,
                                                   **kw),
    }
    results = {}
    for name, case in (('paged_verify', vcase), ('paged_verify_int8', vcase),
                       ('paged_decode_int8', dcase),
                       ('paged_prefill_int8', pcase)):
        kw = {}
        if name.endswith('_int8'):
            case, kw = quantize_case(pa, case)
        err = runs[name.replace('_int8', '')](case, kw)
        print(f'{name} vs plain at the 8B shapes: max_abs_err={err:.3e} '
              f'(atol {ATOL})' + (f', R={VERIFY_R} lengths={VERIFY_LENGTHS}, '
                                  f'query 0 bitwise = decode'
                                  if 'verify' in name else ''), flush=True)
        if err > ATOL:
            fail(f'{name} disagrees with its plain version: {err}')
        results[name] = (err, case, kw)

    # The split edges at the 8B shapes, decode and verify, bf16 and int8;
    # int8 prefill at the prefill split edges and the long prefix.
    worst = max(prefill_err(torch, pa, results['paged_prefill_int8'][1], off,
                            n, **results['paged_prefill_int8'][2])
                for off, n in [(e, tl) for e in prefill_split_edges(pa, PAGE)]
                + [(PREFILL_LONG_OFFSET, PREFILL_LONG_TRUE_LEN)])
    if worst > ATOL:
        fail(f'paged_prefill_int8 disagrees with its plain version at the '
             f'split edges or the long prefix: {worst}')
    print(f'paged_prefill_int8 vs plain at the split edges and the long '
          f'prefix: max_abs_err={worst:.3e} (atol {ATOL})', flush=True)
    edges = split_edges(pa, PAGE)
    worst = 0.0
    for name, case in (
            ('paged_decode', decode_case(torch, gen, edges, HKV, GROUP, HD,
                                         PAGE, maxp)),
            ('paged_verify', verify_case(torch, gen, edges, VERIFY_R, HKV,
                                         GROUP, HD, PAGE, maxp))):
        for c, kw in ((case, {}), quantize_case(pa, case)):
            err = runs[name](c, kw)
            if err > ATOL:
                fail(f'{name} disagrees with its plain version at the split '
                     f'edges {edges} (int8 {bool(kw)}): {err}')
            worst = max(worst, err)
    print(f'paged_decode and paged_verify (bf16, int8) vs plain at the split '
          f'edges {edges} (8B shapes, {pa.PAGES_PER_SPLIT} pages a split): '
          f'max_abs_err={worst:.3e} (atol {ATOL}), query 0 bitwise = decode',
          flush=True)

    # Every variant: verify at every query count from an empty slot to a
    # run at the coverage edge (maxp * page - 3 + R > maxp * page for R >=
    # 4) and at the split edges; int8 decode and prefill at the lengths
    # and chunk of check_kernels.
    worst, n = {}, 0
    maxp = variant_pages(pa)
    for hd in pa.CUDA_HEAD_DIMS:
        for group in pa.CUDA_GROUPS:
            for page in pa.CUDA_PAGE_SIZES:
                cases = [('paged_decode', decode_case(
                    torch, gen, [1, page, page + 1, 5 * page - 3]
                    + split_edges(pa, page), 2, group, hd, page, maxp)),
                    ('paged_prefill', prefill_case(
                        torch, gen, 4 * page, 2, group, hd, page,
                        prefill_pages(pa)))]
                cases += [('paged_verify', verify_case(
                    torch, gen, [0, page - 2, 5 * page - 3, maxp * page - 3]
                    + split_edges(pa, page), R, 2, group, hd, page, maxp))
                    for R in pa.CUDA_VERIFY_QUERIES
                    if R * group <= pa.CUDA_MAX_ROWS]
                for name, case in cases:
                    flavors = [('_int8', *quantize_case(pa, case))]
                    if name == 'paged_verify':
                        flavors.append(('', case, {}))
                    for suffix, c, kw in flavors:
                        if name == 'paged_prefill':
                            err = max(prefill_err(torch, pa, c, off,
                                                  4 * page - 5, **kw)
                                      for off in [3 * page]
                                      + prefill_split_edges(pa, page))
                        else:
                            err = runs[name](c, kw)
                        key = name + suffix
                        if err > ATOL:
                            fail(f'{key} disagrees with its plain version at '
                                 f'hd={hd} group={group} page={page} '
                                 f'q={tuple(c[0].shape)}: {err}')
                        worst[key] = max(worst.get(key, 0.0), err)
                        n += 1
    print(f'all {n} verify / int8 kernel variants vs plain (every verify '
          f'run\'s query 0 bitwise = decode): max_abs_err '
          + ', '.join(f'{k} {v:.3e}' for k, v in sorted(worst.items()))
          + f' (atol {ATOL})', flush=True)
    return results


def sdpa(torch, q, k, v, mask):
    """One library call computing the same attention (GQA by
    ``enable_gqa``)."""
    F = torch.nn.functional
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          enable_gqa=True)


def dequantized(torch, k_pages, v_pages, kw):
    """bf16 K/V pages as the int8 flavor's plain version sees them
    (values x row scales), or the bf16 pages as they are."""
    if not kw:
        return k_pages, v_pages
    return tuple((p.float() * s[..., None]).to(torch.bfloat16)
                 for p, s in ((k_pages, kw['k_scales']),
                              (v_pages, kw['v_scales'])))


def time_prefill(torch, pa, case, kw, off, tl, flush):
    """Phase 4, one prefill case at the 8B shapes (int8 with ``kw``'s
    scales): the kernel, its plain version, and SDPA over the gathered
    (dequantized) K/V with a boolean causal mask."""
    q, kp, vp, row = case
    C, hq = q.shape[0], HKV * GROUP
    ms = time_ms(torch, lambda: pa.paged_prefill_attention(
        *case, off, tl, **kw), 50, flush)
    plain = time_ms(torch, lambda: pa.paged_prefill_attention_reference(
        *case, off, tl, **kw), 10, flush)
    S = off + C
    kd, vd = dequantized(torch, kp, vp, kw)
    idx = row[:S // PAGE].long()
    kg = kd[:, idx].reshape(1, HKV, S, HD)
    vg = vd[:, idx].reshape(1, HKV, S, HD)
    qs = q.reshape(C, hq, HD).permute(1, 0, 2)[None].contiguous()
    mask = (torch.arange(S, device='cuda')[None, :]
            <= off + torch.arange(C, device='cuda')[:, None])
    lib = time_ms(torch, lambda: sdpa(torch, qs, kg, vg, mask), 50, flush)
    # Rows past true_len are pad the caller drops: q and the fp32 output
    # count at true_len rows, K/V at every live position once, and the
    # table entries up to the last live page.
    row_bytes = HD * 2 if not kw else HD + 4
    n_bytes = (tl * hq * HD * (2 + 4) + (off + tl) * HKV * row_bytes * 2
               + -(-(off + tl) // PAGE) * 4)
    flops = 4 * HD * hq * sum(off + c + 1 for c in range(tl))
    return dict(ms=ms, plain_ms=plain, library_ms=lib,
                bound=bound(n_bytes, flops))


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

    case = checked['paged_prefill'][1]
    rows['paged_prefill'] = time_prefill(
        torch, pa, case, {}, PREFILL_OFFSET, PREFILL_TRUE_LEN, flush)
    rows['paged_prefill_long'] = time_prefill(
        torch, pa, case, {}, PREFILL_LONG_OFFSET, PREFILL_LONG_TRUE_LEN,
        flush)
    for name, r in rows.items():
        print(f'{name}: {r["ms"]:.4f} ms, plain {r["plain_ms"]:.4f} ms, '
              f'library {r["library_ms"]:.4f} ms, bound '
              f'{r["bound"][0]:.4f} ms ({r["bound"][1]})', flush=True)
    return rows


def time_spec_int8_kernels(torch, pa, checked):
    """Phase 4 for the verify kernel and the int8 flavors at the 8B
    shapes. The library yardstick is ``scaled_dot_product_attention``
    over the gathered K/V (dequantized to bf16 beforehand for int8), with
    a boolean causal mask for verify."""
    flush = torch.empty(64 << 20, dtype=torch.int8, device='cuda')
    rows = {}
    hq = HKV * GROUP
    cov = MAX_SEQ

    def gathered(k_pages, v_pages, tables, S):
        idx = tables[:, :S // PAGE].long()
        slots = tables.shape[0]
        return tuple(p[:, idx].permute(1, 0, 2, 3, 4).reshape(
            slots, HKV, S, HD) for p in (k_pages, v_pages))

    for name in ('paged_verify', 'paged_verify_int8'):
        _, case, kw = checked[name]
        q, kp, vp, tables, lengths = case
        slots, R = q.shape[:2]
        ms = time_ms(torch, lambda: pa.paged_verify_attention(*case, **kw),
                     50, flush)
        plain = time_ms(torch, lambda: pa.paged_verify_attention_reference(
            *case, **kw), 10, flush)
        S = -(-min(max(VERIFY_LENGTHS) + R, cov) // PAGE) * PAGE
        kg, vg = gathered(*dequantized(torch, kp, vp, kw), tables, S)
        qs = q.permute(0, 2, 3, 1, 4).reshape(slots, hq, R, HD)
        horizon = (lengths.long()[:, None]
                   + torch.arange(R, device='cuda')[None, :] + 1)
        mask = (torch.arange(S, device='cuda')[None, None, :]
                < horizon[:, :, None])[:, None]
        lib = time_ms(torch, lambda: sdpa(torch, qs, kg, vg, mask), 50,
                      flush)
        # Each slot needs its rows up to its last query's horizon, once;
        # each query row pairs with the positions it sees.
        need = [min(n + R, cov) for n in VERIFY_LENGTHS]
        row_bytes = HD * 2 if not kw else HD + 4
        n_bytes = (q.numel() * (2 + 4) + sum(need) * HKV * row_bytes * 2
                   + sum(-(-n // PAGE) for n in need) * 4 + slots * 4)
        flops = 4 * hq * HD * sum(min(n + i + 1, cov)
                                  for n in VERIFY_LENGTHS for i in range(R))
        rows[name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                          bound=bound(n_bytes, flops))

    _, case, kw = checked['paged_decode_int8']
    q, kp, vp, tables, lengths = case
    slots = q.shape[0]
    ms = time_ms(torch, lambda: pa.paged_decode_attention(*case, **kw), 50,
                 flush)
    plain = time_ms(torch, lambda: pa.paged_decode_attention_reference(
        *case, **kw), 10, flush)
    S = -(-max(DECODE_LENGTHS) // PAGE) * PAGE
    kg, vg = gathered(*dequantized(torch, kp, vp, kw), tables, S)
    mask = (torch.arange(S, device='cuda')[None, :]
            < lengths[:, None].long())[:, None, None, :]
    lib = time_ms(torch, lambda: sdpa(torch, q.reshape(slots, hq, 1, HD), kg,
                                      vg, mask), 50, flush)
    toks = sum(DECODE_LENGTHS)
    n_bytes = (q.numel() * (2 + 4) + toks * HKV * (HD + 4) * 2
               + sum(-(-n // PAGE) for n in DECODE_LENGTHS) * 4 + slots * 4)
    rows['paged_decode_int8'] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                     bound=bound(n_bytes, 4 * toks * hq * HD))

    _, case, kw = checked['paged_prefill_int8']
    rows['paged_prefill_int8'] = time_prefill(
        torch, pa, case, kw, PREFILL_OFFSET, PREFILL_TRUE_LEN, flush)
    rows['paged_prefill_int8_long'] = time_prefill(
        torch, pa, case, kw, PREFILL_LONG_OFFSET, PREFILL_LONG_TRUE_LEN,
        flush)
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


def burst(base: str, prompts, new: int, vocab: int, stream_last=False,
          spec=True):
    """Send every prompt at once (the last one streamed if
    ``stream_last``; ``spec`` is the body's speculation opt-in), check
    each answer, and return ([(tokens, ttft_s, latency_s,
    accepted_len_mean)] in prompt order, wall seconds)."""
    results = [None] * len(prompts)
    errors = []

    def one(i):
        stream = stream_last and i == len(prompts) - 1
        body = {'tokens': prompts[i], 'max_new_tokens': new,
                'temperature': 0.0, 'stream': stream, 'spec': spec}
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
            answer = lines[-1]
        else:
            answer = json.loads(raw)
            if status != 200:
                errors.append(f'request {i}: status {status}: {answer}')
                return
            tokens = answer['tokens']
        results[i] = (tokens, answer['ttft_s'], latency,
                      answer['accepted_len_mean'])

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
    for i, (tokens, *_) in enumerate(results):
        if len(tokens) != new:
            fail(f'request {i}: {len(tokens)} tokens, expected {new}')
        if not all(0 <= t < vocab for t in tokens):
            fail(f'request {i}: token ids outside the vocabulary')
    return results, wall


def spec_check(base: str, vocab: int):
    """Repetitive prompts sent with speculation off and on must give the
    same tokens. Each prompt is a 4-token pattern x 16 led by its own
    greedy continuation (learnt from a first, speculation-off pass):
    once the model emits that continuation's opening again, the
    prompt-lookup drafter finds it in the prompt and drafts the rest.
    Returns a summary."""
    import random
    rnd = random.Random(1)
    new = 32
    patterns = [[rnd.randrange(vocab) for _ in range(4)] * 16
                for _ in range(8)]
    first, _ = burst(base, patterns, new, vocab, spec=False)
    prompts = [r[0][:16] + p for r, p in zip(first, patterns)]
    off, off_wall = burst(base, prompts, new, vocab, spec=False)
    on, on_wall = burst(base, prompts, new, vocab, spec=True)
    if [r[0] for r in on] != [r[0] for r in off]:
        fail('speculation changed the tokens of a greedy request')
    if any(r[3] is not None for r in off):
        fail('a request sent with "spec": false rode a verify step')
    _, raw = http_json(base + '/metrics')
    m = json.loads(raw)
    return {'requests': len(prompts), 'max_new_tokens': new,
            'accepted_len_mean_per_request': [r[3] for r in on],
            'spec_off_wall_s': off_wall, 'spec_on_wall_s': on_wall,
            **{k: m.get(k) for k in ('spec_steps', 'spec_drafted_tokens',
                                     'spec_accepted_tokens',
                                     'spec_accept_rate',
                                     'accepted_len_mean')}}


def serve_and_check(base: str, vocab: int, card: str, kernels, label: str):
    """Mixed-length requests (one streamed) twice, a greedy repeat, a
    burst of short prompts that decodes on all slots, and the
    speculation check, against a warm server. ``kernels``: the wrappers
    that must have launched. Returns (kernel launch deltas, summary)."""
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
    [(again, *_)], _ = burst(base, prompts[:1], new, vocab)
    if again != cold[0][0]:
        fail('a repeated greedy request gave different tokens')
    # Decode on every slot: 8 short prompts, 64 new tokens each. The
    # time between tokens is (latency - ttft) / (new - 1) per request.
    dnew = 64
    dprompts = [[rnd.randrange(vocab) for _ in range(64)] for _ in range(8)]
    dec, dec_wall = burst(base, dprompts, dnew, vocab)
    itl_ms = [(lat - ttft) / (dnew - 1) * 1e3 for _, ttft, lat, _ in dec]
    spec = spec_check(base, vocab)

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
        'speculation': spec,
        'decode_steps': metrics['decode_steps'],
        'decode_tokens': metrics['decode_tokens'],
        'kv_dtype': metrics['kv_dtype'],
        'kv_page_bytes': metrics['kv_page_bytes'],
        'kernel_launches': launches,
    }
    print(f'end to end (Llama-3-8B, random weights, 8 slots, {label}, '
          + card + '): ' + json.dumps(summary), flush=True)
    for name in kernels:
        if launches.get(name, 0) <= 0:
            fail(f'{name} was not launched on the main path ({label})')
    return launches, summary


def run_server(card: str, flags, log_name: str, kernels, label: str):
    OUT_DIR.mkdir(exist_ok=True)
    port = free_port()
    log_path = OUT_DIR / log_name
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.infer.server',
           '--model', '8b', '--slots', '8', '--max-seq-len', str(MAX_SEQ),
           '--host', '127.0.0.1', '--port', str(port), *flags]
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
                except urllib.error.HTTPError as e:
                    if json.loads(e.read()).get('status') == 'dead':
                        tail = log_path.read_text(errors='replace')[-4000:]
                        fail(f'the server\'s engine loop died:\n{tail}')
                except (urllib.error.URLError, ConnectionError, OSError):
                    pass
                time.sleep(1.0)
            print(f'server healthy after {time.time() - t0:.1f} s',
                  flush=True)
            return serve_and_check(base, 128_256, card, kernels, label)
        finally:
            os.killpg(proc.pid, signal.SIGTERM)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=30)


# ---------------------------------------------------------------------------
# Phase 5b: speculation in process at full 8B width and depth
# ---------------------------------------------------------------------------
class OracleDrafter:
    """Proposes each known prompt's speculation-off greedy continuation;
    for the prompts in ``wrong`` the draft's token at index ``wrong_at``
    is off by one, so those runs are accepted up to it and rejected
    there."""

    def __init__(self, prompts, outputs, wrong, wrong_at, vocab):
        self.known = [(list(p), list(o)) for p, o in zip(prompts, outputs)]
        self.wrong = {tuple(p) for p in wrong}
        self.wrong_at, self.vocab = wrong_at, vocab

    def propose(self, context, k, memo=None):
        del memo
        for prompt, out in self.known:
            if list(context[:len(prompt)]) == prompt:
                draft = out[len(context) - len(prompt):][:k]
                if tuple(prompt) in self.wrong and len(draft) > self.wrong_at:
                    draft[self.wrong_at] = (draft[self.wrong_at] + 1) % \
                        self.vocab
                return draft
        return []


def prefill_logits(torch, model_lib, pc_lib, cfg, params, rope, tokens,
                   dtype):
    """Logits after ``tokens`` through the prefill path on a fresh
    one-slot cache of ``dtype`` pages, in PREFILL_C-token chunks. Returns
    (logits [vocab], cache, table row)."""
    maxp, C = MAX_SEQ // PAGE, PREFILL_C
    cache = pc_lib.init_paged_cache(cfg.n_layers, 1, maxp + 1, PAGE,
                                    cfg.n_kv_heads, cfg.head_dim, dtype=dtype,
                                    device='cuda')
    row = torch.arange(1, maxp + 1, dtype=torch.int32, device='cuda')
    for off in range(0, len(tokens), C):
        chunk = tokens[off:off + C]
        padded = torch.zeros(C, dtype=torch.int32, device='cuda')
        padded[:len(chunk)] = torch.tensor(chunk, dtype=torch.int32)
        cache, logits = model_lib.paged_prefill_chunk(
            cfg, params, cache, 0, row, padded, off, len(chunk), rope)
    return logits, cache, row


def spec_in_process(torch, pa, card: str):
    """Phase 5b: speculation-off greedy tokens for 8 prompts x 64 new
    tokens on an 8B engine, then the same with speculation on (spec_k 4)
    and the oracle drafter; then the int8-vs-bf16 decode-logit delta."""
    import random
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import model as model_lib
    from skypilot_tpu_torch.infer import paged_cache as pc_lib
    from skypilot_tpu_torch.models import llama
    t0 = time.perf_counter()
    cfg = llama.LlamaConfig.llama3_8b()
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, 'cuda')

    def engine(**kw):
        return engine_lib.InferenceEngine(
            cfg, params, engine_lib.EngineConfig(
                n_slots=8, max_seq_len=MAX_SEQ, page_size=PAGE, **kw),
            seed=0, device='cuda')

    rnd = random.Random(4)
    prompts = [[rnd.randrange(cfg.vocab_size) for _ in range(n)]
               for n in SPEC_PROMPT_LENGTHS]
    off_engine = engine()
    t1 = time.perf_counter()
    off = [r.output_tokens for r in off_engine.generate(prompts, SPEC_NEW)]
    torch.cuda.synchronize()
    off_wall = time.perf_counter() - t1
    off_steps = off_engine.metrics()['decode_steps']
    del off_engine
    on = engine(spec_k=VERIFY_R - 1)
    on._drafter = OracleDrafter(prompts, off, prompts[1::2], ORACLE_WRONG_AT,
                                cfg.vocab_size)
    pa.reset_launches()
    t1 = time.perf_counter()
    got = [r.output_tokens for r in on.generate(prompts, SPEC_NEW)]
    torch.cuda.synchronize()
    on_wall = time.perf_counter() - t1
    launches = dict(pa.launches)
    m = on.metrics()
    al = on.allocator
    leaked = al.n_pages - 1 - al.free_pages
    refs = sum(al.refcount(pid) for pid in range(1, al.n_pages))
    rope = on._rope
    del on
    diverged = [(i, next((j for j, (a, b) in enumerate(zip(x, y)) if a != b),
                         min(len(x), len(y))))
                for i, (x, y) in enumerate(zip(off, got)) if x != y]
    summary = {
        'card': card, 'prompt_tokens': SPEC_PROMPT_LENGTHS,
        'max_new_tokens': SPEC_NEW, 'spec_k': VERIFY_R - 1,
        'oracle_wrong_at': ORACLE_WRONG_AT,
        'decode_steps_spec_off': off_steps, 'decode_steps_spec_on':
            m['decode_steps'], 'wall_s_spec_off': off_wall,
        'wall_s_spec_on': on_wall,
        **{k: m[k] for k in ('spec_steps', 'spec_drafted_tokens',
                             'spec_accepted_tokens', 'spec_accept_rate',
                             'accepted_len_mean')},
        'diverged': diverged, 'pages_leaked': leaked, 'refcounts': refs,
        'kernel_launches': launches}
    # A divergence is tolerated only at a near-tie (and only after the
    # bitwise query-0 check of phase 3 passed, which fails the run
    # otherwise): speculation-off's top-2 margin there, recomputed by
    # prefill.
    for i, j in diverged[:1]:
        logits, _, _ = prefill_logits(torch, model_lib, pc_lib, cfg, params,
                                      rope, prompts[i] + off[i][:j],
                                      torch.bfloat16)
        top2 = torch.topk(logits.float(), 2).values.tolist()
        summary['near_tie'] = {'request': i, 'step': j,
                               'margin': top2[0] - top2[1],
                               'top_logit': top2[0]}
    # int8 vs bf16 at these shapes: prefill the first prompt into each
    # kind of cache, decode one step, compare the logits.
    step = {}
    for dtype in (torch.bfloat16, torch.int8):
        logits, cache, row = prefill_logits(torch, model_lib, pc_lib, cfg,
                                            params, rope, prompts[0], dtype)
        tok = torch.argmax(logits).to(torch.int32).reshape(1)
        step[dtype], _ = model_lib.paged_decode_step(cfg, params, cache,
                                                     row[None], tok, rope)
        del cache
    delta = (step[torch.bfloat16] - step[torch.int8]).abs().max().item()
    summary['int8_vs_bf16_decode_logit_delta'] = delta
    summary['wall_s'] = time.perf_counter() - t0
    print('speculation in process (Llama-3-8B, random weights, 8 slots, '
          + card + '): ' + json.dumps(summary), flush=True)
    if len(diverged) > 1:
        fail(f'speculation on parted from speculation off in '
             f'{len(diverged)} requests: {diverged}')
    if diverged:
        tie = summary['near_tie']
        print(f'speculation on parted from off at request {tie["request"]}, '
              f'output step {tie["step"]}: speculation-off top-2 logit '
              f'margin {tie["margin"]:.4e} (top logit '
              f'{tie["top_logit"]:.4f}; tolerated at <= {NEAR_TIE} x top)',
              flush=True)
        if not tie['margin'] <= NEAR_TIE * abs(tie['top_logit']):
            fail('speculation changed greedy tokens away from a near-tie')
    if m['spec_accepted_tokens'] < 1:
        fail('the oracle run accepted no draft: the check is vacuous')
    if leaked or refs:
        fail(f'speculation leaked pages: {leaked} pages, refcounts {refs}')
    for name in ('paged_verify_attention', 'paged_decode_attention',
                 'paged_prefill_attention'):
        if launches[name] <= 0:
            fail(f'{name} was not launched in the speculation run')
    if not delta > 0:
        fail('int8 and bf16 pages gave the same decode logits: the int8 '
             'path did not run')
    del params
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# --profile: where a decode step's time goes
# ---------------------------------------------------------------------------
def _kernel_kind(name: str) -> str:
    low = name.lower()
    if 'paged_attention_kernel' in low:
        return 'paged_decode_attention'
    if any(k in low for k in ('gemm', 'gemv', 'xmma', 'cutlass', 'cublas',
                              'nvjet')):
        return 'matmul'
    if 'memcpy' in low or 'memset' in low:
        return 'copy'
    return 'other'


class RepeatDrafter:
    """Drafts k copies of the context's last token: every step with it
    is a verify step (random weights rarely accept, which does not change
    what the step launches)."""

    def propose(self, context, k, memo=None):
        del memo
        return [context[-1]] * k


def profile_decode(torch, card: str, kv_dtype: str, verify: bool) -> None:
    """An in-process 8B engine (``kv_dtype`` pages) with all 8 slots at
    PROFILE_PROMPT tokens of context, stepping decode steps or (``verify``,
    spec_k VERIFY_R - 1 with :class:`RepeatDrafter`) verify steps: the
    host-clock time of a step over PROFILE_STEPS steps (and, for bf16
    decode, over as many with the dense block one row wide instead of
    ``STEP_ROWS``: what the padding that keeps decode and verify steps
    bitwise alike costs), then the synchronizing CUDA calls of one step
    (the step's readback is one), then ``torch.profiler`` over a few
    more: device time by kernel, the paged decode/verify kernel's time
    and launches, the device's busy share of the window, and the host
    ops with the most self time."""
    import random
    import warnings
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from skypilot_tpu_torch.infer import model as model_lib
    from skypilot_tpu_torch.infer import server as server_lib
    eng = server_lib.build_engine('8b', 8, MAX_SEQ, PAGE, None, 'cuda',
                                  kv_dtype=kv_dtype,
                                  spec_k=VERIFY_R - 1 if verify else 0)
    if verify:
        eng._drafter = RepeatDrafter()
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
    narrow_ms = None
    if kv_dtype == 'bfloat16' and not verify:
        rows, model_lib.STEP_ROWS = model_lib.STEP_ROWS, 1
        try:
            eng.step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PROFILE_STEPS):
                eng.step()
            torch.cuda.synchronize()
            narrow_ms = (time.perf_counter() - t0) / PROFILE_STEPS * 1e3
        finally:
            model_lib.STEP_ROWS = rows
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            eng.step()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    n = 5
    spec_before = eng.metrics().get('spec_steps', 0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    spec_steps = eng.metrics().get('spec_steps', 0) - spec_before
    if verify and spec_steps != n:
        fail(f'the verify-step profile ran {spec_steps} verify steps of {n}')
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
    paged = [(ms, c) for name, (ms, c) in kernels.items()
             if _kernel_kind(name) == 'paged_decode_attention']
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    top_host = sorted(host_ops.items(), key=lambda kv: -kv[1][0])[:15]
    step = 'verify' if verify else 'decode'
    print(f'{step} step profile (Llama-3-8B, {kv_dtype} pages, 8 slots at '
          f'{PROFILE_PROMPT} tokens'
          + (f', spec_k {VERIFY_R - 1}' if verify else '') + f', {card}): '
          + json.dumps({
              'step_ms': step_ms,
              'step_ms_one_row_block': narrow_ms,
              'synchronizing_calls_per_step': sorted(
                  {str(w.message)[:80] for w in syncs}) + [len(syncs)],
              'decode_tokens_per_sec': slots / step_ms * 1e3,
              'profiled_step_ms': window_ms / n,
              'device_busy_ms_per_step': busy,
              'device_busy_share': busy * n / window_ms,
              'device_busy_share_unprofiled': busy / step_ms,
              'kernel_launches_per_step': sum(c for _, c in kernels.values()),
              f'paged_{step}_kernel_ms_per_step': sum(ms for ms, _ in paged),
              f'paged_{step}_kernel_launches_per_step':
                  sum(c for _, c in paged),
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
    del eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 3 + 4, training kernels
# ---------------------------------------------------------------------------
def compare(torch, got, want, rtol: float, atol_frac: float):
    """(max abs error, ok): ok when every element is within rtol of the
    plain value plus atol_frac of the plain tensor's largest
    magnitude."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all().item():
        return float('inf'), False
    err = (got - want).abs()
    limit = rtol * want.abs() + atol_frac * want.abs().max()
    return err.max().item(), bool((err <= limit).all().item())


def flash_inputs(torch, gen, b, hq, hkv, s, d):
    def randn(*shape):
        return torch.randn(shape, generator=gen,
                           device='cuda').to(torch.bfloat16)
    return randn(b, hq, s, d), randn(b, hkv, s, d), randn(b, hkv, s, d), \
        randn(b, hq, s, d)


def flash_check(torch, att, case, causal, block):
    """Every flash kernel output against its plain version on the same
    inputs; the backward takes the kernel forward's out and lse on both
    sides. Returns ({name: max abs error}, {name: ok}, (out, lse,
    delta))."""
    q, k, v, do = case
    scale = q.shape[-1] ** -0.5
    kw = dict(causal=causal, sm_scale=scale, block_k=block)
    out, lse = att._flash_forward(q, k, v, causal, scale, block)
    torch.cuda.synchronize()
    ref_out, ref_lse = att.flash_forward_reference(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)[:, :, None, :]
    dq = att._flash_backward_dq(q, k, v, do, lse, delta, causal, scale,
                                block)
    dk, dv = att._flash_backward_dkv(q, k, v, do, lse, delta, causal, scale,
                                     block)
    torch.cuda.synchronize()
    ref_dq = att.flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw)
    ref_dk, ref_dv = att.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                 **kw)
    errs, oks = {}, {}
    for name, got, want, tol in (
            ('out', out, ref_out, (BF16_RTOL, BF16_ATOL_FRAC)),
            ('lse', lse, ref_lse, (FP32_RTOL, FP32_ATOL_FRAC)),
            ('dq', dq, ref_dq, (BF16_RTOL, BF16_ATOL_FRAC)),
            ('dk', dk, ref_dk, (BF16_RTOL, BF16_ATOL_FRAC)),
            ('dv', dv, ref_dv, (BF16_RTOL, BF16_ATOL_FRAC))):
        errs[name], oks[name] = compare(torch, got, want, *tol)
    return errs, oks, (out, lse, delta)


def ce_inputs(torch, gen, T, d, V):
    x = torch.randn((T, d), generator=gen, device='cuda').to(torch.bfloat16)
    w = (torch.randn((d, V), generator=gen, device='cuda')
         * d ** -0.5).to(torch.bfloat16)
    t = torch.randint(0, V, (T,), generator=gen, device='cuda',
                      dtype=torch.int32)
    return x, w, t


def ce_check(torch, ce, case, block):
    x, w, t = case
    nll, lse = ce._fused_fwd(x, w, t, block)
    torch.cuda.synchronize()
    ref_nll, ref_lse = ce.fused_forward_reference(x, w, t, block)
    errs, oks = {}, {}
    for name, got, want in (('nll', nll, ref_nll), ('lse', lse, ref_lse)):
        errs[name], oks[name] = compare(torch, got, want, FP32_RTOL,
                                        FP32_ATOL_FRAC)
    return errs, oks


def check_training_kernels(torch, att, ce):
    """Phase 3, training kernels: at the bench_1b shapes, then at every
    variant the wrappers take on small inputs. Returns {kernel: (max abs
    error at the bench_1b shapes, inputs)}."""
    gen = torch.Generator(device='cuda')
    gen.manual_seed(1)
    case = flash_inputs(torch, gen, FB, FH, FH, FS, FD)
    errs, oks, saved = flash_check(torch, att, case, True, BLOCK)
    print(f'flash attention vs plain at b={FB} h={FH} s={FS} d={FD} causal: '
          + ', '.join(f'{k} {v:.3e}' for k, v in errs.items())
          + f' (bf16 outputs rtol 2^-7 + {BF16_ATOL_FRAC} x max, fp32 lse '
          f'rtol {FP32_RTOL} + {FP32_ATOL_FRAC} x max)', flush=True)
    bad = [k for k, ok in oks.items() if not ok]
    if bad:
        fail(f'flash kernels disagree with their plain versions at the '
             f'bench_1b shapes: {bad} {errs}')
    # No atomics anywhere: the backward gives the same bits every run.
    q, k, v, do = case
    _, lse, delta = saved
    args = (q, k, v, do, lse, delta, True, FD ** -0.5, BLOCK)
    runs = [(att._flash_backward_dq(*args), *att._flash_backward_dkv(*args))
            for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        fail('the flash backward kernels give different bits run to run')
    print('flash backward: dq, dk, dv bitwise equal over two runs',
          flush=True)
    del runs
    results = {
        'flash_attention_fwd': (max(errs['out'], errs['lse']), case, saved),
        'flash_attention_bwd_dq': (errs['dq'], case, saved),
        'flash_attention_bwd_dkv': (max(errs['dk'], errs['dv']), case, saved),
    }
    worst, n = {}, 0
    for hd in att.CUDA_HEAD_DIMS:
        for group in att.CUDA_GROUPS:
            for causal in (True, False):
                # s 192: three tiles, so not a multiple of 128.
                case = flash_inputs(torch, gen, 2, 2 * group, 2, 192, hd)
                errs, oks, _ = flash_check(torch, att, case, causal, 64)
                bad = [k for k, ok in oks.items() if not ok]
                if bad:
                    fail(f'flash kernels disagree with their plain versions '
                         f'at hd={hd} group={group} causal={causal}: {bad} '
                         f'{errs}')
                for k, v in errs.items():
                    worst[k] = max(worst.get(k, 0.0), v)
                n += 1
    print(f'all {n} flash variants vs plain: max abs error '
          + ', '.join(f'{k} {v:.3e}' for k, v in worst.items()), flush=True)

    case = ce_inputs(torch, gen, CE_T, CE_D, CE_V)
    errs, oks = ce_check(torch, ce, case, BLOCK)
    print(f'fused cross-entropy vs plain at T={CE_T} d={CE_D} V={CE_V}: '
          + ', '.join(f'{k} {v:.3e}' for k, v in errs.items())
          + f' (rtol {FP32_RTOL} + {FP32_ATOL_FRAC} x max)', flush=True)
    if not all(oks.values()):
        fail(f'ce_fwd disagrees with its plain version: {errs}')
    results['fused_cross_entropy_fwd'] = (max(errs.values()), case, None)
    # V 1000 is not a multiple of the 128-column tile; T 100 not of 64;
    # targets in the last tile, at V - 1 and outside the vocabulary.
    for T, d, V in ((100, 64, 1000), (64, 128, 256)):
        x, w, t = ce_inputs(torch, gen, T, d, V)
        t[:4] = torch.tensor([V - 1, V - 100, -1, V], dtype=torch.int32)
        errs, oks = ce_check(torch, ce, (x, w, t), 8)
        print(f'fused cross-entropy vs plain at T={T} d={d} V={V}: '
              + ', '.join(f'{k} {v:.3e}' for k, v in errs.items()),
              flush=True)
        if not all(oks.values()):
            fail(f'ce_fwd disagrees with its plain version at T={T} d={d} '
                 f'V={V}: {errs}')
    return results


def time_training_kernels(torch, att, ce, checked):
    """Phase 4, training kernels at the bench_1b shapes."""
    F = torch.nn.functional
    flush = torch.empty(64 << 20, dtype=torch.int8, device='cuda')
    rows = {}
    q, k, v, do = checked['flash_attention_fwd'][1]
    out, lse, delta = checked['flash_attention_fwd'][2]
    scale = FD ** -0.5
    kw = dict(causal=True, sm_scale=scale, block_k=BLOCK)
    pairs = FS * (FS + 1) // 2          # causal (query, key) pairs per head
    elems = FB * FH * FS * FD           # one [b, h, s, d] tensor (hkv = hq)
    rows_f32 = FB * FH * FS             # one [b, h, 1, s] fp32 tensor
    flops_1 = 2.0 * FB * FH * FD * pairs     # one s x s x d product, causal

    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 20, flush)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, (qg, kg, vg), do, retain_graph=True), 20, flush)
    rows['flash_attention_fwd'] = dict(
        ms=time_ms(torch, lambda: att._flash_forward(
            q, k, v, True, scale, BLOCK), 20, flush),
        plain_ms=time_ms(torch, lambda: att.flash_forward_reference(
            q, k, v, **kw), 5, flush),
        library_ms=lib_fwd,
        bound=bound(4 * elems * 2 + rows_f32 * 4, 2 * flops_1))
    rows['flash_attention_bwd_dq'] = dict(
        ms=time_ms(torch, lambda: att._flash_backward_dq(
            q, k, v, do, lse, delta, True, scale, BLOCK), 20, flush),
        plain_ms=time_ms(torch, lambda: att.flash_bwd_dq_reference(
            q, k, v, do, lse, delta, **kw), 5, flush),
        library_ms=lib_bwd,
        bound=bound(5 * elems * 2 + 2 * rows_f32 * 4, 3 * flops_1))
    rows['flash_attention_bwd_dkv'] = dict(
        ms=time_ms(torch, lambda: att._flash_backward_dkv(
            q, k, v, do, lse, delta, True, scale, BLOCK), 20, flush),
        plain_ms=time_ms(torch, lambda: att.flash_bwd_dkv_reference(
            q, k, v, do, lse, delta, **kw), 5, flush),
        library_ms=lib_bwd,
        bound=bound(6 * elems * 2 + 2 * rows_f32 * 4, 4 * flops_1))
    del lib_out, qg, kg, vg

    x, w, t = checked['fused_cross_entropy_fwd'][1]

    def library_ce():
        logits = torch.matmul(x, w).float()
        return torch.logsumexp(logits, -1) - logits.gather(
            1, t.long()[:, None])[:, 0]

    rows['fused_cross_entropy_fwd'] = dict(
        ms=time_ms(torch, lambda: ce._fused_fwd(x, w, t, BLOCK), 10, flush),
        plain_ms=time_ms(torch, lambda: ce.fused_forward_reference(
            x, w, t, BLOCK), 5, flush),
        library_ms=time_ms(torch, library_ce, 10, flush),
        bound=bound(x.numel() * 2 + w.numel() * 2 + CE_T * 4 * 3,
                    2.0 * CE_T * CE_D * CE_V))
    for name, r in rows.items():
        print(f'{name}: {r["ms"]:.4f} ms, plain {r["plain_ms"]:.4f} ms, '
              f'library {r["library_ms"]:.4f} ms, bound '
              f'{r["bound"][0]:.4f} ms ({r["bound"][1]})', flush=True)
    print('(library: scaled_dot_product_attention forward; its autograd '
          'backward computes dq, dk and dv together and stands beside both '
          'backward kernels; matmul + logsumexp for the cross-entropy)',
          flush=True)
    return rows


# ---------------------------------------------------------------------------
# Phase 6: the training slice against its plain path
# ---------------------------------------------------------------------------
def check_slice(torch, att, ce):
    """loss_fn and every gradient of a 2-layer bench_1b-width model, the
    kernel path (flash + fused CE) against the plain path (dense
    attention + dense CE), same bf16 params and batch."""
    from skypilot_tpu_torch.models import llama
    cfg_k = llama.LlamaConfig.bench_1b(n_layers=2, attention_impl='flash',
                                       fused_loss=True)
    cfg_p = llama.LlamaConfig.bench_1b(n_layers=2, attention_impl='dense',
                                       fused_loss=False)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(2)
    params = llama.init_params(cfg_k, gen, 'cuda')
    tokens = torch.randint(0, cfg_k.vocab_size, (1, FS + 1), generator=gen,
                           device='cuda', dtype=torch.int32)
    leaves = [(f'layers.{k}', t) for k, t in params['layers'].items()] + [
        (k, params[k]) for k in ('embed', 'final_norm', 'lm_head')]
    for _, t in leaves:
        t.requires_grad_(True)

    def run(cfg):
        att.reset_launches()
        ce.reset_launches()
        loss = llama.loss_fn(cfg, params, tokens[:, :-1], tokens[:, 1:])
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
        torch.cuda.synchronize()
        return loss.item(), grads, {**att.launches, **ce.launches}

    loss_k, grads_k, launches_k = run(cfg_k)
    loss_p, grads_p, launches_p = run(cfg_p)
    if any(launches_k[k] <= 0 for k in TRAINING_KERNELS) \
            or any(launches_p.values()):
        fail(f'the kernel path must launch every training kernel and the '
             f'plain path none: {launches_k} / {launches_p}')
    rel = {}
    for (name, _), gk, gp in zip(leaves, grads_k, grads_p):
        rel[name] = ((gk.float() - gp.float()).norm()
                     / gp.float().norm()).item()
    summary = {'loss_kernels': loss_k, 'loss_plain': loss_p,
               'loss_abs_diff': abs(loss_k - loss_p),
               'grad_rel_norm_err': rel, 'launches': launches_k}
    print('slice vs plain path (2 layers at bench_1b width, b 1, s 2048, '
          f'loss atol {SLICE_LOSS_ATOL}, grads rel-norm '
          f'{SLICE_GRAD_RTOL}): ' + json.dumps(summary), flush=True)
    if not abs(loss_k - loss_p) <= SLICE_LOSS_ATOL \
            or not all(r <= SLICE_GRAD_RTOL for r in rel.values()):
        fail('the kernel path disagrees with the plain path')
    for _, t in leaves:
        t.requires_grad_(False)
    return summary


# ---------------------------------------------------------------------------
# Phase 7: training end to end
# ---------------------------------------------------------------------------
def run_logged(cmd, log_name: str, timeout: float):
    """Run ``cmd`` from the repo root; its output goes to
    chiprun_out/<log_name>. Returns (stdout, stderr); fails on a non-zero
    exit."""
    OUT_DIR.mkdir(exist_ok=True)
    print('running: ' + ' '.join(cmd[1:]), flush=True)
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    (OUT_DIR / log_name).write_text(
        f'$ {" ".join(cmd)}\n--- stdout\n{proc.stdout}\n--- stderr\n'
        f'{proc.stderr}')
    print(f'  exit {proc.returncode} after {time.time() - t0:.1f} s',
          flush=True)
    if proc.returncode != 0:
        fail(f'{" ".join(cmd[1:])} exited {proc.returncode}:\n'
             f'{proc.stderr[-3000:]}')
    return proc.stdout, proc.stderr


def run_bench(ce_flavor: str, card: str):
    out, _ = run_logged(
        [sys.executable, '-m', 'skypilot_tpu_torch.bench', '--attn', 'flash',
         '--ce', ce_flavor], f'chip_smoke_bench_{ce_flavor}.log', 900)
    result = json.loads(out.strip().splitlines()[-1])
    print(f'bench_1b train step (--attn flash --ce {ce_flavor}, {card}): '
          + json.dumps(result), flush=True)
    if not math.isfinite(result['loss']):
        fail(f'bench loss is not finite: {result["loss"]}')
    return result


def train_and_resume(card: str):
    """llama-350m (head_dim 64, group 2: the flash kernels' other
    variant) for 4 steps with a checkpoint every 2, then to step 6 from
    the same directory, which must resume at step 4. The checkpoints
    (about 2 GB each) go to a temporary directory that is removed."""
    pat = re.compile(r'step (\d+)/(\d+) loss=(\S+) tokens/s=(\d+)')
    runs = []
    with tempfile.TemporaryDirectory(prefix='chip_smoke_ckpt_') as ckpt:
        for steps in (4, 6):
            _, err = run_logged(
                [sys.executable, '-m', 'skypilot_tpu_torch.train.run',
                 '--model', 'llama-350m', '--steps', str(steps), '--batch',
                 '4', '--seq', '2048', '--checkpoint-dir', ckpt,
                 '--checkpoint-every', '2', '--log-every', '1'],
                f'chip_smoke_train_{steps}.log', 900)
            logged = [(int(m.group(1)), float(m.group(3)), int(m.group(4)))
                      for m in pat.finditer(err)]
            resumed = re.search(r'resumed from checkpoint at step (\d+)',
                                err)
            runs.append({'steps': steps,
                         'resumed_at': int(resumed.group(1)) if resumed
                         else None,
                         'logged': logged,
                         'checkpoints': sorted(os.listdir(ckpt))})
    print(f'llama-350m train and resume ({card}): ' + json.dumps(runs),
          flush=True)
    first, second = runs
    if [s for s, _, _ in first['logged']] != [1, 2, 3, 4] \
            or first['resumed_at'] is not None:
        fail(f'the first llama-350m run did not log steps 1-4 fresh: {first}')
    if second['resumed_at'] != 4 \
            or [s for s, _, _ in second['logged']] != [5, 6]:
        fail(f'the second llama-350m run did not resume at step 4: {second}')
    if not all(math.isfinite(loss) for r in runs
               for _, loss, _ in r['logged']):
        fail('llama-350m logged a non-finite loss')
    return runs


# ---------------------------------------------------------------------------
# --profile: where a training step's time goes
# ---------------------------------------------------------------------------
def _train_kernel_kind(name: str) -> str:
    low = name.lower()
    for key in ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv', 'ce_fwd'):
        if key in low:
            return key
    return _kernel_kind(name)


def profile_train(torch, card: str) -> None:
    """bench_1b (--attn flash --ce fused) in process: host-clock step
    time over 3 steps, then ``torch.profiler`` over one more: device
    time by kernel kind and the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import trainer
    cfg = llama.LlamaConfig.bench_1b(attention_impl='flash', fused_loss=True)
    opt = trainer.make_optimizer(total_steps=1000, mu_dtype='bfloat16')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    state = trainer.init_train_state(cfg, gen, opt, 'cuda')
    step = trainer.make_train_step(cfg, opt)
    batch = trainer.synthetic_batch(cfg, 6, FS, gen, 'cuda')
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kinds, kernels = {}, {}
    for e in prof.key_averages():
        us = getattr(e, 'self_device_time_total', 0)
        if e.device_type == DeviceType.CUDA and us > 0:
            kind = _train_kernel_kind(e.key)
            kinds[kind] = kinds.get(kind, 0) + us / 1e3
            kernels[e.key] = (us / 1e3, e.count)
    busy = sum(kinds.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:20]
    print(f'train step profile (bench_1b, b 6, s {FS}, flash + fused CE, '
          f'{card}): ' + json.dumps({
              'step_ms': step_ms, 'profiled_step_ms': window_ms,
              'device_busy_ms': busy, 'device_busy_share': busy / window_ms,
              'kernel_launches': sum(c for _, c in kernels.values()),
              'device_ms_by_kind': kinds,
              'top_kernels': [{'name': k[:100], 'ms': ms, 'launches': c}
                              for k, (ms, c) in top]}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--kernels-only', action='store_true',
                        help='stop after holding the kernels against '
                             'their plain versions')
    parser.add_argument('--profile', action='store_true',
                        help='at the end, profile decode steps of an '
                             'in-process engine and a bench_1b train step')
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available; this script needs an '
              'NVIDIA GPU', file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from skypilot_tpu_torch.ops import _build
    from skypilot_tpu_torch.ops import attention as att
    from skypilot_tpu_torch.ops import cross_entropy as ce
    from skypilot_tpu_torch.ops import paged_attention as pa
    # The plain versions' fp32 products stay fp32 (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # Phase 1: the card.
    card = card_line()
    print(card, flush=True)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {torch.cuda.get_device_name(0)}', flush=True)

    # Phase 2: build from the checkout's sources.
    t0 = time.perf_counter()
    secs = _build.build()
    print(f'built {", ".join(f"{k} {v:.1f}s" for k, v in secs.items())} '
          f'({time.perf_counter() - t0:.1f} s wall)', flush=True)
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if 'registers' in line or 'spill' in line \
                    or 'Compiling entry' in line or 'arning' in line:
                print(f'  {name}: {line.strip()}', flush=True)
    check_sass(_build)

    # Phase 3: kernels vs their plain versions.
    checked = check_kernels(torch, pa)
    checked.update(check_spec_int8_kernels(torch, pa))
    checked.update(check_training_kernels(torch, att, ce))
    if args.kernels_only:
        print('kernels-only: every kernel agrees with its plain version',
              flush=True)
        return 0

    # Phase 4: timing.
    timed = time_kernels(torch, pa, checked)
    timed.update(time_spec_int8_kernels(torch, pa, checked))
    timed.update(time_training_kernels(torch, att, ce, checked))
    for key in checked:              # keep the errors, free the inputs
        checked[key] = (checked[key][0],)
    torch.cuda.empty_cache()

    # Phase 5: the serving path, end to end through the servers.
    launches, bf16 = run_server(
        card, ['--spec-k', str(VERIFY_R - 1)], 'chip_smoke_server.log',
        ('paged_decode_attention', 'paged_prefill_attention',
         'paged_verify_attention'), 'bf16 pages, spec_k 4')
    int8_launches, int8 = run_server(
        card, ['--kv-dtype', 'int8', '--spec-k', str(VERIFY_R - 1)],
        'chip_smoke_server_int8.log',
        ('paged_decode_attention_int8', 'paged_prefill_attention_int8',
         'paged_verify_attention_int8'), 'int8 pages, spec_k 4')
    launches = {k: launches[k] + int8_launches[k] for k in launches}
    print('bf16 vs int8 pages (' + card + '): ' + json.dumps({
        key: [bf16[key], int8[key]]
        for key in ('ttft_cold_p50_s', 'ttft_warm_p50_s', 'kv_page_bytes')}
        | {'itl_p50_ms': [bf16['decode_burst']['itl_p50_ms'],
                          int8['decode_burst']['itl_p50_ms']],
           'tokens_per_sec': [bf16['decode_burst']['tokens_per_sec'],
                              int8['decode_burst']['tokens_per_sec']],
           'kv_page_bytes_ratio': bf16['kv_page_bytes']
           / int8['kv_page_bytes']}), flush=True)

    # Phase 5b: speculation in process at full width and depth.
    spec_in_process(torch, pa, card)

    # Phase 6: the training slice against its plain path.
    check_slice(torch, att, ce)
    torch.cuda.empty_cache()

    # Phase 7: the training path, end to end.
    bench = run_bench('fused', card)
    per_step = bench['launches_per_step']
    if any(bench['launches'][k] <= 0 for k in TRAINING_KERNELS):
        fail(f'a training kernel was not launched on the main path: '
             f'{bench["launches"]}')
    launches.update(bench['launches'])
    print(f'bench_1b launches per step: {json.dumps(per_step)}', flush=True)
    run_bench('dense', card)
    train_and_resume(card)
    if args.profile:
        for kv_dtype in ('bfloat16', 'int8'):
            for verify in (False, True):
                profile_decode(torch, card, kv_dtype, verify)
        profile_train(torch, card)

    rows = [
        ('paged_decode_attention', 'paged_decode', 'paged_decode',
         'skypilot_tpu/ops/paged_attention.py:164'),
        ('paged_prefill_attention', 'paged_prefill', 'paged_prefill',
         'skypilot_tpu/ops/paged_attention.py:341'),
        ('paged_verify_attention', 'paged_verify', 'paged_decode',
         'skypilot_tpu/ops/paged_attention.py:545'),
        ('paged_decode_attention_int8', 'paged_decode_int8', 'paged_decode',
         'skypilot_tpu/ops/paged_attention.py:164'),
        ('paged_prefill_attention_int8', 'paged_prefill_int8',
         'paged_prefill', 'skypilot_tpu/ops/paged_attention.py:341'),
        ('paged_verify_attention_int8', 'paged_verify_int8', 'paged_decode',
         'skypilot_tpu/ops/paged_attention.py:545'),
        ('flash_attention_fwd', 'flash_attention_fwd', 'flash_fwd',
         'skypilot_tpu/ops/attention.py:63'),
        ('flash_attention_bwd_dq', 'flash_attention_bwd_dq', 'flash_bwd',
         'skypilot_tpu/ops/attention.py:169'),
        ('flash_attention_bwd_dkv', 'flash_attention_bwd_dkv', 'flash_bwd',
         'skypilot_tpu/ops/attention.py:213'),
        ('fused_cross_entropy_fwd', 'fused_cross_entropy_fwd', 'ce_fwd',
         'skypilot_tpu/ops/cross_entropy.py:131'),
    ]
    kernels = []
    for wrapper, key, source, where in rows:
        r = timed[key]
        kernels.append({
            'name': wrapper, 'route': 'cuda',
            'source': f'skypilot_tpu_torch/ops/csrc/{source}.cu',
            'replaces': where, 'launches': launches[wrapper],
            'max_abs_err': checked[key][0], 'ms': r['ms'],
            'plain_ms': r['plain_ms'], 'bound_ms': r['bound'][0],
            'bound_by': r['bound'][1], 'library_ms': r['library_ms']})
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
