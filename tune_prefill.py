#!/usr/bin/env python3
"""Time variants of the port's paged prefill kernel on one NVIDIA GPU.

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
DEFAULT_VARIANTS = ['', 'kWarps=8', 'kPagesPerSplit=4', 'kPagesPerSplit=8',
                    'kPagesPerSplit=32', 'kStages=3']


def parse_variant(text: str):
    """'name=value,...[@source]' -> ({name: value}, source or None)."""
    text, _, source = text.partition('@')
    consts = {}
    for item in filter(None, text.split(',')):
        name, value = item.split('=')
        consts[name.strip()] = int(value)
    return consts, source or None


def variant_source(text: str, consts) -> str:
    for name, value in consts.items():
        text, n = re.subn(rf'(constexpr int {name} = )\d+;',
                          rf'\g<1>{value};', text)
        if n != 1:
            cs.fail(f'paged_prefill.cu has no single constant {name}')
    return text


def build(_build, variants, tmp):
    """One library per variant (by index), nvcc processes in parallel."""
    for header in _build.SRC_DIR.glob('*.cuh'):
        shutil.copy(header, tmp)
    procs = []
    for i, (consts, source) in enumerate(variants):
        text = pathlib.Path(
            source or _build.SRC_DIR / 'paged_prefill.cu').read_text()
        src = tmp / f'v{i}.cu'
        src.write_text(variant_source(text, consts))
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
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
    from skypilot_tpu_torch.ops import paged_attention as pa
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    variants = [parse_variant(v) for v in args.variant or DEFAULT_VARIANTS]
    with tempfile.TemporaryDirectory(prefix='tune_prefill_') as tmp:
        libs = build(_build, variants, pathlib.Path(tmp))
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

        flush = torch.empty(64 << 20, dtype=torch.int8, device='cuda')
        times = [{name: [] for name in cases} for _ in fns]
        for r in range(args.rounds):
            order = list(range(len(fns)))
            if r % 2:
                order.reverse()
            for i in order:
                for name, (flavor, c, k, off, tl) in cases.items():
                    times[i][name].append(cs.time_ms(
                        torch, lambda: call(fns[i], flavor, c, k, off, tl),
                        50, flush))
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
