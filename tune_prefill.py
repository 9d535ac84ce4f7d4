#!/usr/bin/env python3
"""Time variants of the port's paged prefill kernel (or, with
``--source ce_fwd``, of its fused cross-entropy forward, or with
``--source qdot_int8`` of its int8-weight product) on one NVIDIA GPU.

Builds ``skypilot_tpu_torch/ops/csrc/paged_prefill.cu`` once per variant,
with its tuning constants (``kWarps``: M-tiles of 16 rows a block;
``kPagesPerSplit``: pages a split; ``kStages``: the page ring's depth)
replaced, all ``nvcc`` processes started together, into a temporary
directory. Each variant is first held against the plain version at
``chip_smoke.py``'s two prefill timing cases (the 8B shapes: a 256-token
chunk at offset 192 with 200 valid rows, and the last 256-token chunk of
a 2048-token prompt), bf16 and int8 pages, at ``chip_smoke.ATOL``; then
every variant is timed at those four cases with ``chip_smoke.time_ms``
(CUDA events, L2 flushed, a sleep kernel ahead of each call), the
variants in turns, forward then backward order, over several rounds.
Prints the time of one tiny kernel by the same method (the floor of
what it can read), then one JSON line per variant (the median over
rounds of each case's milliseconds), with the card's name and power
limit.

Run from the root of the repository: ``python3 tune_prefill.py``
(about a minute of command time: the source as it is, then each
constant changed on its own), or ``--variant kWarps=8,kPagesPerSplit=4``
(repeatable) for other variants; ``--variant kWarps=4@path/to/other.cu``
builds another version of the source (with the same entry points) in
the same turns.

``--source ce_fwd`` does the same for
``skypilot_tpu_torch/ops/csrc/ce_fwd.cu`` (``kBN``: vocabulary columns
of a tile; ``kStages``: the slice ring's depth; ``kTilesPerSplit``: V
tiles a split; ``kRaster``: which CTAs are numbered together), each
variant held against ``fused_forward_reference`` at ``chip_smoke.py``'s
fp32 tolerances and timed at its bench_1b case (T 12288, d 1536,
V 32768).

``--source qdot_int8`` does the same for
``skypilot_tpu_torch/ops/csrc/qdot_int8.cu`` (``kBlocksPerSm`` with
``kRingBytes``: blocks an SM holds and the shared memory of each one's
tile ring, so its depth; ``kTargetBlocks``, ``kMaxSplits`` and
``kMinStepsPerSplit``: the K-split rule), each variant held against
``quant.qdot_reference`` at ``chip_smoke.py``'s ``QDOT_RTOL`` /
``QDOT_ATOL_FRAC`` and timed at the 8B weights at a decode step's 64
rows and a 256-token chunk's 256 (about 30 s of command time).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

import chip_smoke as cs

# The source's own constants first, then one change at a time.
DEFAULT_VARIANTS = {
    'paged_prefill': ['', 'kWarps=8', 'kPagesPerSplit=4', 'kPagesPerSplit=8',
                      'kPagesPerSplit=32', 'kStages=3'],
    'ce_fwd': ['', 'kBN=128,kStages=6', 'kStages=3', 'kTilesPerSplit=16',
               'kTilesPerSplit=64', 'kRaster=1'],
    'qdot_int8': ['', 'kBlocksPerSm=1,kRingBytes=196608',
                  'kTargetBlocks=132', 'kMaxSplits=4', 'kMinStepsPerSplit=8'],
}


def parse_variant(text: str):
    """'name=value,...[@source]' -> ({name: value}, source or None)."""
    text, _, source = text.partition('@')
    consts = {}
    for item in filter(None, text.split(',')):
        name, value = item.split('=')
        consts[name.strip()] = int(value)
    return consts, source or None


def variant_source(text: str, consts, name: str = 'paged_prefill') -> str:
    for const, value in consts.items():
        text, n = re.subn(rf'(constexpr int {const} = )\d+;',
                          rf'\g<1>{value};', text)
        if n != 1:
            cs.fail(f'{name}.cu has no single constant {const}')
    return text


def build(_build, variants, tmp, name: str = 'paged_prefill'):
    """One library per variant (by index) of ``csrc/<name>.cu``, nvcc
    processes in parallel."""
    for header in _build.SRC_DIR.glob('*.cuh'):
        shutil.copy(header, tmp)
    procs = []
    for i, (consts, source) in enumerate(variants):
        text = pathlib.Path(
            source or _build.SRC_DIR / f'{name}.cu').read_text()
        src = tmp / f'v{i}.cu'
        src.write_text(variant_source(text, consts, name))
        lib = tmp / f'v{i}.so'
        procs.append((lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, '-o', str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs = []
    for lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            cs.fail(f'nvcc failed for {lib.name}:\n{log.decode()[-3000:]}')
        spills = re.findall(rb'(\d+) bytes spill stores', log)
        libs.append((ctypes.CDLL(str(lib)),
                     max((int(s) for s in spills), default=0)))
    return libs


def prefill_calls(torch, libs, variants):
    """{case: call(variant index)} for the prefill variants, each first
    held against the plain version at every case."""
    from skypilot_tpu_torch.ops import paged_attention as pa
    fns = []
    for lib, _ in libs:
        bound = {}
        for flavor in ('bf16', 'int8'):
            fn = getattr(lib, f'paged_prefill_attention_{flavor}')
            fn.argtypes = pa._SIGNATURES[
                f'paged_prefill_attention_{flavor}'][1]
            fn.restype = ctypes.c_int
            bound[flavor] = fn
        fns.append(bound)

    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    case = cs.prefill_case(torch, gen, cs.PREFILL_C, cs.HKV, cs.GROUP,
                           cs.HD, cs.PAGE, cs.MAX_SEQ // cs.PAGE)
    qcase, kw = cs.quantize_case(pa, case)
    cases = {f'{flavor} offset {off}': (flavor, c, k, off, tl)
             for flavor, c, k in (('bf16', case, {}),
                                  ('int8', qcase, kw))
             for off, tl in ((cs.PREFILL_OFFSET, cs.PREFILL_TRUE_LEN),
                             (cs.PREFILL_LONG_OFFSET,
                              cs.PREFILL_LONG_TRUE_LEN))}
    q = case[0]
    C, hkv, group, hd = q.shape
    n_rows = C * group
    # Room for the most splits any variant takes (one page a split).
    ws = torch.empty(hkv * (cs.MAX_SEQ // cs.PAGE) * n_rows * (hd + 2),
                     dtype=torch.float32, device='cuda')
    counters = torch.zeros(hkv * n_rows // 16, dtype=torch.int32,
                           device='cuda')
    out = torch.empty(q.shape, dtype=torch.float32, device='cuda')
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, flavor, c, k, off, tl):
        qq, kp, vp, row = c
        scales = ([k['k_scales'].data_ptr(), k['v_scales'].data_ptr()]
                  if flavor == 'int8' else [])
        err = fn[flavor](qq.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                         *scales, row.data_ptr(), out.data_ptr(),
                         ws.data_ptr(), counters.data_ptr(), C, hkv,
                         group, hd, kp.shape[1], cs.PAGE, off, tl,
                         hd ** -0.5, stream)
        if err:
            cs.fail(f'launch failed with {err}')
        return out

    for i, fn in enumerate(fns):
        for name, (flavor, c, k, off, tl) in cases.items():
            got = call(fn, flavor, c, k, off, tl)[:tl].clone()
            torch.cuda.synchronize()
            ref = pa.paged_prefill_attention_reference(*c, off, tl, **k)
            err = (got - ref[:tl]).abs().max().item()
            if not err <= cs.ATOL:
                cs.fail(f'variant {variants[i]} disagrees with the plain '
                        f'version at {name}: {err}')
    return {name: (lambda i, a=a: call(fns[i], *a))
            for name, a in cases.items()}


def ce_calls(torch, libs, variants):
    """{case: call(variant index)} for the cross-entropy variants at the
    bench_1b case, each first held against the plain version at the
    fp32 tolerances."""
    from skypilot_tpu_torch.ops import cross_entropy as ce
    fns = []
    for lib, _ in libs:
        fn = lib.ce_fwd_bf16
        fn.argtypes = ce._SIGNATURE
        fn.restype = ctypes.c_int
        fns.append(fn)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(1)
    x, w, t = cs.ce_inputs(torch, gen, cs.CE_T, cs.CE_D, cs.CE_V)
    n_rt = -(-cs.CE_T // ce.CE_BLOCK_T)
    # Room for the most splits any variant takes (128-column tiles, one
    # a split).
    ws = torch.empty(n_rt * -(-cs.CE_V // 128) * 3 * ce.CE_BLOCK_T,
                     dtype=torch.float32, device='cuda')
    counters = torch.zeros(n_rt, dtype=torch.int32, device='cuda')
    nll = torch.empty(cs.CE_T, dtype=torch.float32, device='cuda')
    lse = torch.empty((cs.CE_T, 1), dtype=torch.float32, device='cuda')
    stream = torch.cuda.current_stream().cuda_stream

    def call(i):
        err = fns[i](x.data_ptr(), w.data_ptr(), t.data_ptr(),
                     nll.data_ptr(), lse.data_ptr(), ws.data_ptr(),
                     counters.data_ptr(), cs.CE_T, cs.CE_D, cs.CE_V, stream)
        if err:
            cs.fail(f'launch failed with {err}')
        return nll, lse

    ref = ce.fused_forward_reference(x, w, t, cs.BLOCK)
    for i in range(len(fns)):
        got = [a.clone() for a in call(i)]
        for name, a, b in zip(('nll', 'lse'), got, ref):
            err, ok = cs.compare(torch, a, b, cs.FP32_RTOL, cs.FP32_ATOL_FRAC)
            if not ok:
                cs.fail(f'variant {variants[i]} disagrees with the plain '
                        f'version at {name}: {err}')
    return {f'T {cs.CE_T} d {cs.CE_D} V {cs.CE_V}': call}


def qdot_calls(torch, libs, variants):
    """{case: call(variant index)} for the int8-weight product variants
    at each 8B weight and QDOT_TIMED_ROWS rows, each first held against
    the plain version."""
    from skypilot_tpu_torch.ops import quant
    fns = []
    for lib, _ in libs:
        fn = lib.qdot_int8
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns.append(fn)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream
    cases = {}
    for name in cs.QDOT_8B:
        k, n = cs.QDOT_SHAPES[name]
        x, w = cs.qdot_case(torch, quant, gen, k, n)
        for m in cs.QDOT_TIMED_ROWS:
            cases[f'{name} M {m}'] = (x[:m], w, torch.empty(
                (m, n), dtype=torch.bfloat16, device='cuda'))

    def call(i, x, w, out):
        err = fns[i](x.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(),
                     out.data_ptr(), x.shape[0], w.q.shape[0],
                     w.q.shape[1], stream)
        if err:
            cs.fail(f'launch failed with {err}')
        return out

    for i in range(len(fns)):
        for name, (x, w, out) in cases.items():
            err, ok = cs.compare(torch, call(i, x, w, out),
                                 quant.qdot_reference(x, w), cs.QDOT_RTOL,
                                 cs.QDOT_ATOL_FRAC)
            if not ok:
                cs.fail(f'variant {variants[i]} disagrees with the plain '
                        f'version at {name}: {err}')
    return {name: (lambda i, a=a: call(i, *a)) for name, a in cases.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--source', choices=sorted(DEFAULT_VARIANTS),
                        default='paged_prefill',
                        help='the kernel source whose variants are timed')
    parser.add_argument('--variant', action='append',
                        help='constants of one variant, e.g. '
                             'kWarps=4,kPagesPerSplit=8 (repeatable)')
    parser.add_argument('--rounds', type=int, default=4)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('tune_prefill: CUDA is not available; this script needs an '
              'NVIDIA GPU', file=sys.stderr)
        return 1
    from skypilot_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    variants = [parse_variant(v)
                for v in args.variant or DEFAULT_VARIANTS[args.source]]
    with tempfile.TemporaryDirectory(prefix='tune_prefill_') as tmp:
        libs = build(_build, variants, pathlib.Path(tmp), args.source)
        setup = {'paged_prefill': prefill_calls, 'ce_fwd': ce_calls,
                 'qdot_int8': qdot_calls}[args.source]
        calls = setup(torch, libs, variants)
        reps = 50 if args.source == 'paged_prefill' else 20

        flush = torch.empty(64 << 20, dtype=torch.int8, device='cuda')
        times = [{name: [] for name in calls} for _ in variants]
        for r in range(args.rounds):
            order = list(range(len(variants)))
            if r % 2:
                order.reverse()
            for i in order:
                for name, call in calls.items():
                    times[i][name].append(cs.time_ms(
                        torch, lambda: call(i), reps, flush))
        tiny = torch.empty(1, device='cuda')
        print(json.dumps({'one_tiny_kernel_ms': cs.time_ms(
            torch, tiny.zero_, 50, flush), 'card': card}), flush=True)
        for i, (consts, source) in enumerate(variants):
            print(json.dumps({
                'variant': consts, 'source': source,
                'spill_bytes': libs[i][1],
                'ms': {name: statistics.median(t)
                       for name, t in times[i].items()},
                'spread': {name: (max(t) - min(t)) / min(t)
                           for name, t in times[i].items()},
                'card': card}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
