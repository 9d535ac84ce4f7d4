"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Needs as many CUDA devices as the cell asks for (else it exits 2 and
prints no result). The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (with ``--trace 0``
the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
number the correctness check compared, with its limit. The same numbers
end standard error. It exits 1 without a result if ``jax``, ``jaxlib``,
``flax`` or the JAX package was loaded, in this process or in a serving
cell's replica process, once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Any, Dict, List, Optional, Tuple  # noqa: E402

from perfbench import spec as spec_lib  # noqa: E402

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'skypilot_tpu')


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN (compared
    whole: ``skypilot_tpu_torch`` is not ``skypilot_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split('.', 1)[0] in FORBIDDEN)


class ForbiddenModules(RuntimeError):
    """A process of the run loaded one of FORBIDDEN."""


def _judge(numbers: Dict[str, float], limits: Dict[str, Dict[str, float]]
           ) -> Tuple[bool, Dict[str, Any]]:
    """Each compared number against its limit ({"max": x} or
    {"min": x}); a number without a limit fails."""
    out, ok = {}, True
    for name, value in numbers.items():
        lim = limits.get(name)
        if lim is None:
            out[name] = {'value': value}
            continue
        if 'max' in lim:
            good = value <= lim['max']
            out[name] = {'value': value, 'max': lim['max']}
        else:
            good = value >= lim['min']
            out[name] = {'value': value, 'min': lim['min']}
        ok = ok and good
    missing = [k for k in limits if k not in numbers]
    for k in missing:
        out[k] = {'value': None, **limits[k]}
        ok = False
    return ok, out


def execute(cell: spec_lib.Cell, seed: int, seconds: float, trace: bool,
            device: str = 'cuda', config_path: Optional[str] = None,
            t_start: Optional[float] = None,
            engine_over: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Run ``cell`` once on ``device`` and return its result object.
    Raises ForbiddenModules if this process, or the replica's, holds one
    of FORBIDDEN once the window has closed. ``engine_over`` changes the
    replica's engine settings (the serving control's int8 weights); a
    benchmark run never passes it."""
    t_start = T_START if t_start is None else t_start
    driver = cell.params['driver']
    elsewhere: List[str] = []
    if driver == 'serve':
        from perfbench import check_serve, serve_cell
        run = serve_cell.run(cell, seed, seconds, trace, t_start,
                             device=device, config_path=config_path,
                             engine_over=engine_over)
        elsewhere = [f'{m} (replica process)' for m in run.forbidden]
        t_ref = time.time()
        numbers = check_serve.check(run, seed, device,
                                    cell.params['check']['sample_requests'])
        timing = dict(run.replica_setup, reference_s=time.time() - t_ref)
        attempted = len(run.counted)
        failed = numbers['failed']
        gaps = (serve_cell.label_gaps(run, run.profile['idle_gaps'])
                if run.profile else [])
    elif driver == 'train':
        from perfbench import check_train, train_cell
        run, prog = train_cell.run(cell, seed, seconds, trace, t_start,
                                   device=device, config_path=config_path)
        t_ref = time.time()
        ref = check_train.reference_readings(cell, run.dims, seed, device)
        numbers = check_train.compare(prog, ref)
        timing = dict(run.timing, reference_s=time.time() - t_ref)
        attempted, failed = train_cell.FIRST_STEPS + run.steps, 0
        gaps = [g[:2] for g in run.profile['idle_gaps']] \
            if run.profile else []
    else:
        raise ValueError(f'unknown driver {driver!r}')
    bad = forbidden_modules() + elsewhere
    if bad:
        raise ForbiddenModules(', '.join(bad))
    correct, check = _judge(numbers, cell.params['check']['limits'])
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec_lib.reader(m['name'])(run)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    dev = {'platform': 'gpu' if device == 'cuda' else device,
           'kind': run.device_kind, 'count': cell.chips,
           'memory_peak_bytes': run.memory_peak_bytes}
    result: Dict[str, Any] = {'correct': correct, 'attempted': attempted,
                              'failed': failed, 'metrics': metrics,
                              'device': dev}
    if trace and run.profile:
        dev['busy_s'] = run.profile['busy_s']
        dev['window_s'] = run.profile['window_s']
        result['breakdown'] = {'device_ops': run.profile['device_ops'][:10],
                               'idle_gaps': gaps[:10]}
    result['check'] = check
    print(f'timing {json.dumps(timing)}', file=sys.stderr)
    if run.profile:
        print(f"trace events {run.profile['events']} clock offset "
              f"{run.profile['clock_offset_ns']} ns", file=sys.stderr)
    return result


def _power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return 'nvidia-smi not available'


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    os.environ.setdefault('USE_FLAX', '0')
    os.environ.setdefault('USE_TF', '0')
    os.environ.setdefault('TRITON_CACHE_DIR',
                          str(spec_lib.CACHE_DIR / 'triton'))
    os.environ.setdefault('TORCH_EXTENSIONS_DIR',
                          str(spec_lib.CACHE_DIR / 'torch_extensions'))
    cell = spec_lib.load_cell(args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f'{args.workload} needs {cell.chips} CUDA device(s); this '
              f'machine has {have}', file=sys.stderr)
        return 2
    print(f'card: {_power_limit()}', file=sys.stderr)
    try:
        result = execute(cell, args.seed, args.seconds, bool(args.trace))
    except ForbiddenModules as e:
        print(f'forbidden modules loaded: {e}', file=sys.stderr)
        return 1
    for name, c in result['check'].items():
        lim = (f"<= {c['max']}" if 'max' in c else
               f">= {c['min']}" if 'min' in c else '(no limit)')
        print(f'check {name} {c["value"]} {lim}', file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
