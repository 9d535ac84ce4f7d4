"""The readings that a cell's correctness limits are set from.

    python3 -m perfbench.controls --workload serve-chat --seeds 12 \\
        --control-seeds 3 --seconds 10 [--fault-seeds 3] [--out FILE]

On the card, at the cell's own size and load: the program's compared
numbers on ``--seeds`` seeds (short windows; a training cell needs
none), then the control's on ``--control-seeds`` more. The control is
what a sound run must not be mistaken for: for a serving cell the
port's own int8-weight path (``EngineConfig(quantize=True)``, the
precision below the bf16 the configuration states), for a training cell
the plain reference with every product in float8 (``Lin(fp8=True)``) in
the program's place. With ``--fault-seeds`` a training cell also reads the
program with half of every batch masked out (the mean over the rest),
and a serving cell the replica with a token of every request altered
where it is produced.
Each reading prints as one JSON line. Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

from perfbench import spec as spec_lib


# The step-3 fault of a serving cell: the replica's process alters the
# fourth token of every request where the engine produces it.
ALTERED_TOKEN = '''
from skypilot_tpu_torch.infer import engine


class _Altered(list):
    def append(self, token):
        super().append(token ^ 1 if len(self) == 3 else token)


_init = engine.Request.__init__


def _patched(self, *a, **k):
    _init(self, *a, **k)
    self.output_tokens = _Altered(self.output_tokens)


engine.Request.__init__ = _patched
'''


def altered_token_env(directory: str) -> None:
    """Make every replica started from here on alter tokens
    (``sitecustomize`` in ``directory``, put on PYTHONPATH)."""
    import os
    with open(os.path.join(directory, 'sitecustomize.py'), 'w') as f:
        f.write(ALTERED_TOKEN)
    os.environ['PYTHONPATH'] = directory


def serve_readings(cell, seed: int, seconds: float, control: bool,
                   sample: int = 0):
    """The check's numbers of one serving run (``sample``: how many
    finished requests to check, the cell's own count when 0; with a
    larger one every checked token's gap comes back too)."""
    from perfbench import check_serve, serve_cell
    run = serve_cell.run(cell, seed, seconds, False, time.time(),
                         engine_over={'quantize': True} if control
                         else None)
    detail = {} if sample else None
    nums = check_serve.check(run, seed, 'cuda', sample or
                             cell.params['check']['sample_requests'],
                             detail)
    return dict(nums, **(detail or {}))


def train_readings(cell, seed: int, kind: str):
    import torch
    from perfbench import check_train, train_cell
    if kind == 'control':
        dims = _dims(cell)
        ref = check_train.reference_readings(cell, dims, seed, 'cuda')
        low = check_train.reference_readings(cell, dims, seed, 'cuda',
                                             fp8=True)
        return dict(check_train.compare(low, ref),
                    leaves=check_train.leaf_gaps(low, ref))
    from skypilot_tpu_torch.train import trainer
    real = trainer.make_train_step
    if kind == 'half_batch':
        trainer.make_train_step = _mask_half_batch(real)
    try:
        run, prog = train_cell.run(cell, seed, 0.0, False, time.time())
    finally:
        trainer.make_train_step = real
    ref = check_train.reference_readings(cell, run.dims, seed, 'cuda')
    torch.cuda.empty_cache()
    return dict(check_train.compare(prog, ref),
                leaves=check_train.leaf_gaps(prog, ref))


def _dims(cell):
    from perfbench.weights import Dims
    with open(spec_lib.ROOT / next(
            c['file'] for c in spec_lib.benchmark()['configs']
            if c['name'] == cell.entry['config'])) as f:
        return Dims.of(json.load(f))


def _mask_half_batch(real):
    """A train-step factory like ``real`` whose steps see a mask that
    keeps the first half of each batch's tokens: the loss is the mean
    over the rest."""
    import torch

    def factory(config, opt, mesh=None):
        step = real(config, opt, mesh)

        def broken(state, batch):
            tokens = batch['tokens']
            keep = (torch.arange(tokens.numel(), device=tokens.device)
                    < tokens.numel() // 2).reshape(tokens.shape)
            return step(state, dict(batch, mask=keep.float()))
        return broken
    return factory


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=int, default=12)
    parser.add_argument('--control-seeds', type=int, default=3)
    parser.add_argument('--first-seed', type=int, default=3_000_000_001)
    parser.add_argument('--control-first-seed', type=int,
                        help='default: --first-seed + 1000')
    parser.add_argument('--seconds', type=float, default=10.0)
    parser.add_argument('--fault-seeds', type=int, default=0,
                        help='seeds of the faults (training: half of each '
                             'batch masked; serving: a token altered)')
    parser.add_argument('--sample', type=int, default=0,
                        help='serving: check this many finished requests '
                             'and keep every token\'s gap')
    parser.add_argument('--out')
    args = parser.parse_args(argv)
    cell = spec_lib.load_cell(args.workload)
    serve = cell.params['driver'] == 'serve'
    plan = [('program', args.first_seed + i) for i in range(args.seeds)]
    first_control = (args.first_seed + 1000 if args.control_first_seed
                     is None else args.control_first_seed)
    plan += [('control', first_control + i)
             for i in range(args.control_seeds)]
    plan += [('half_batch' if not serve else 'altered_token',
              args.first_seed + 2000 + i) for i in range(args.fault_seeds)]
    out = []
    fault_dir = tempfile.mkdtemp(prefix='perfbench-fault-')
    for kind, seed in plan:
        t = time.time()
        if kind == 'altered_token':
            altered_token_env(fault_dir)
        if serve:
            nums = serve_readings(cell, seed, args.seconds,
                                  kind == 'control', args.sample)
        else:
            nums = train_readings(cell, seed, kind)
        line = {'kind': kind, 'seed': seed, 'seconds': time.time() - t,
                **nums}
        print(json.dumps({k: v for k, v in line.items()
                          if k not in ('gaps', 'leaves')}), flush=True)
        out.append(line)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
