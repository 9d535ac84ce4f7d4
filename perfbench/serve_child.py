"""The replica under test, in a process of its own.

``python3 -m perfbench.serve_child --config <file> --engine <json>
--seed <n> [--device cuda|cpu]`` makes the weights from the seed on the
device, builds the port's engine over them
(``engine.InferenceEngine(config, params, EngineConfig(...))``), wraps it
in ``server.InferenceServer`` as the replica serves, starts it on a free
local port and waits until it is warm. It then says so on standard
output as one JSON line and answers commands, one JSON object a line on
standard input, with one JSON line each:

- ``{"cmd": "profile_start"}`` / ``{"cmd": "profile_stop"}``: a
  ``torch.profiler`` trace of the replica between the two;
  ``{"cmd": "profile_reduce", "seconds": s}``: that trace's first ``s``
  seconds reduced by ``perfbench.trace`` (busy time, kernels by name,
  idle gaps);
- ``{"cmd": "stats"}``: the flight recorder's step records, the peak
  device memory, the card, and the loaded modules whose top-level name
  a run forbids (``perfbench.run.FORBIDDEN``);
- ``{"cmd": "exit"}``: stop the server and exit.

It exits when its standard input closes, and the kernel ends it with
the parent (``PR_SET_PDEATHSIG``), so it never outlives the run.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import logging
import signal
import sys
import time


def _die_with_parent() -> None:
    try:
        libc = ctypes.CDLL('libc.so.6', use_errno=True)
        libc.prctl(1, signal.SIGKILL)     # PR_SET_PDEATHSIG
    except OSError:
        pass


def _say(obj) -> None:
    sys.stdout.write(json.dumps(obj) + '\n')
    sys.stdout.flush()


def main(argv=None) -> int:
    t_start = time.time()
    _die_with_parent()
    parser = argparse.ArgumentParser()
    parser.add_argument('--config', required=True)
    parser.add_argument('--engine', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--build-dir')
    parser.add_argument('--trace', action='store_true',
                        help='start and stop the profiler once in set-up, '
                             'so the traced window does not pay its start')
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)

    import torch
    from perfbench import model as model_lib
    from perfbench import run as run_lib
    from perfbench import trace as trace_lib
    from perfbench import weights as weights_lib
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import server as server_lib
    from skypilot_tpu_torch.ops import _build

    if args.build_dir:
        _build.set_build_dir(args.build_dir)
    with open(args.config) as f:
        config_file = json.load(f)
    engine_kw = json.loads(args.engine)
    device = torch.device(args.device)
    on_cuda = device.type == 'cuda'
    dims = weights_lib.Dims.of(config_file)
    config = model_lib.llama_config(config_file)
    t0 = time.time()
    params = weights_lib.make(dims, args.seed, device)
    if on_cuda:
        torch.cuda.synchronize()
    t_weights = time.time()
    engine = engine_lib.InferenceEngine(
        config, params, engine_lib.EngineConfig(**engine_kw),
        seed=args.seed, device=device)
    server = server_lib.InferenceServer(
        engine, kernel_sources=(server_lib.replica_sources(
            argparse.Namespace(quantize=engine_kw.get('quantize', False)))
            if on_cuda else ()))
    port = server.start('127.0.0.1', 0)
    while not server.ready:
        if server.dead:
            _say({'error': f'replica died warming up: {server.dead}'})
            return 1
        time.sleep(0.02)
    if args.trace:
        warm = trace_lib.Profile()
        warm.start()
        time.sleep(0.1)
        warm.stop()
        del warm
    t_ready = time.time()
    _say({'ready': True, 'port': port,
          'setup': {'import_s': t0 - t_start, 'weights_s': t_weights - t0,
                    'engine_and_warm_s': t_ready - t_weights,
                    'kernel_build_s': dict(_build.compiled)}})

    prof = None
    for line in sys.stdin:
        msg = json.loads(line)
        cmd = msg.get('cmd')
        if cmd == 'profile_start':
            prof = trace_lib.Profile()
            prof.start()
            _say({'ok': True, 'wall': prof.start_wall})
        elif cmd == 'profile_stop':
            prof.stop()
            _say({'ok': True})
        elif cmd == 'profile_reduce':
            # Asked once the window has closed: reading the trace holds
            # the interpreter for seconds, which would stall the engine.
            _say({'profile': prof.reduce(top=10, gaps=50,
                                         seconds=msg.get('seconds'))})
            prof = None
        elif cmd == 'stats':
            snap = engine.stepline_snapshot()
            _say({'steps': snap.get('steps', []),
                  'memory_peak_bytes': (torch.cuda.max_memory_allocated(
                      device) if on_cuda else 0),
                  'device_kind': (torch.cuda.get_device_name(device)
                                  if on_cuda else 'cpu'),
                  'metrics': {k: v for k, v in engine.metrics().items()
                              if isinstance(v, (int, float, str))},
                  'forbidden': run_lib.forbidden_modules()})
        elif cmd == 'exit':
            break
    server.shutdown()
    _say({'bye': True})
    return 0


if __name__ == '__main__':
    sys.exit(main())
