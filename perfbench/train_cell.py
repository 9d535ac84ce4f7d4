"""A training cell: the port's train step, in this process.

Set-up makes the weights from the seed on the device, builds one train
state around them (``trainer.TrainState`` with ``AdamW.init``) and the
step (``trainer.make_train_step``), and drives that same state through
its first steps on their own batches: what the check compares is read
there (each step's loss, the first gradient as the optimizer got it,
from its first moment, and the change of every leaf after those
steps). The window then runs further steps of the same state on new
batches until its time is up, and ends in a ``synchronize()``. With
``--trace 1`` one step in the window's middle (the first to start in
its second half) runs under ``torch.profiler``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Any, Dict, Optional

from perfbench import spec as spec_lib
from perfbench.weights import Dims

# Elements of each leaf of the first gradient that the check compares
# one by one (drawn from the seed).
SAMPLE = 1 << 20
# Steps before the window, through the window's own call and feed, that
# the check reads and the reference follows: two, not three, so that the
# float32 reference's steps take less time than the window.
FIRST_STEPS = 2


@dataclasses.dataclass
class TrainRun:
    cell: spec_lib.Cell
    dims: Dims
    batch: int
    seq: int
    seconds: float          # the window's length as run
    steps: int              # steps completed in the window
    setup_s: float
    profile: Optional[Dict[str, Any]]
    device_kind: str
    memory_peak_bytes: int
    timing: Dict[str, float]


def norm32(t) -> float:
    """The float32 norm of ``t``, one slice of its first axis at a time
    (a stacked leaf is never widened whole)."""
    import torch
    if t.dim() < 3:
        return float(torch.linalg.vector_norm(t.float()))
    return math.sqrt(sum(float(torch.linalg.vector_norm(s.float())) ** 2
                         for s in t))


def change32(p, p0) -> float:
    """The float32 norm of ``p - p0``, a slice at a time."""
    import torch
    if p.dim() < 3:
        return float(torch.linalg.vector_norm(p.float() - p0.float()))
    return math.sqrt(sum(
        float(torch.linalg.vector_norm(a.float() - b.float())) ** 2
        for a, b in zip(p, p0)))


def run(cell: spec_lib.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = 'cuda',
        config_path: Optional[str] = None):
    """One training run. Returns (TrainRun, the program's readings)."""
    import torch
    from perfbench import model as model_lib
    from perfbench import trace as trace_lib
    from perfbench import weights as weights_lib
    from perfbench.traffic import steps as steps_lib
    from skypilot_tpu_torch.ops import _build
    from skypilot_tpu_torch.train import trainer

    _build.set_build_dir(spec_lib.BUILD_DIR)
    config_path = config_path or str(spec_lib.ROOT / next(
        c['file'] for c in spec_lib.benchmark()['configs']
        if c['name'] == cell.entry['config']))
    with open(config_path) as f:
        config_file = json.load(f)
    dims = Dims.of(config_file)
    mix = dict(cell.traffic, **cell.params.get('traffic', {}))
    dev = torch.device(device)
    config = model_lib.llama_config(config_file, max_seq_len=mix['seq'],
                                    **cell.params['model'])
    opt = trainer.make_optimizer(**cell.params['optimizer'])
    t_w = time.time()
    params = weights_lib.make(dims, seed, dev)
    state = trainer.TrainState(step=torch.zeros((), dtype=torch.int32),
                               params=params, opt_state=opt.init(params))
    step_fn = trainer.make_train_step(config, opt)
    n_batches = FIRST_STEPS + 2 + math.ceil(
        seconds / float(cell.params.get('min_step_s', 0.2)))
    batches = steps_lib.batches(mix, seed, n_batches, dims.vocab, dev)
    t_steps = time.time()

    readings: Dict[str, Any] = {'loss': [], 'grad_leaf': {},
                                'change_leaf': {}}
    step_s = []
    for i in range(FIRST_STEPS):
        t = time.time()
        state, m = step_fn(state, batches[i])
        readings['loss'].append(float(m['loss']))
        step_s.append(time.time() - t)
        if i == 0:
            readings['grad_norm'] = float(m['grad_norm'])
            readings['grad_sample'] = {}
            for n, (path, mu) in enumerate(
                    weights_lib.leaves(state.opt_state['mu'])):
                key = '.'.join(path)
                readings['grad_leaf'][key] = norm32(mu) / (1.0 - opt.b1)
                idx = weights_lib.sample_index(mu.numel(), seed, n,
                                               SAMPLE, dev)
                readings['grad_sample'][key] = (
                    mu.reshape(-1)[idx].float() / (1.0 - opt.b1)).cpu()
    for path, p in weights_lib.leaves(state.params):
        p0 = weights_lib.make_leaf(dims, path, seed, dev)
        readings['change_leaf']['.'.join(path)] = change32(p, p0)
        del p0
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)

    prof = None
    t0 = time.time()
    setup_s = t0 - t_start
    # The traced step: the first to start in the window's second half.
    prof_from = t0 + seconds / 2 if trace else math.inf
    done = 0
    while time.time() - t0 < seconds:
        traced = prof is None and time.time() >= prof_from
        if traced:
            prof = trace_lib.Profile()
            prof.start()
        if FIRST_STEPS + done >= len(batches):
            raise RuntimeError('the window outran its batches: raise the '
                               "cell's min_step_s")
        state, _ = step_fn(state, batches[FIRST_STEPS + done])
        done += 1
        if traced:
            prof.stop()
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    t1 = time.time()
    profile = prof.reduce(cpu_labels=True) if prof is not None else None
    on_cuda = dev.type == 'cuda'
    run_rec = TrainRun(
        cell=cell, dims=dims, batch=mix['batch'], seq=mix['seq'],
        seconds=t1 - t0, steps=done, setup_s=setup_s, profile=profile,
        device_kind=torch.cuda.get_device_name(dev) if on_cuda else 'cpu',
        memory_peak_bytes=(torch.cuda.max_memory_allocated(dev)
                           if on_cuda else 0),
        timing={'start_s': t_w - t_start, 'state_s': t_steps - t_w,
                'first_steps_s': step_s, 'readings_s': t0 - t_steps
                - sum(step_s)})
    del state, step_fn, batches, params, prof
    if on_cuda:
        torch.cuda.empty_cache()
    return run_rec, readings
