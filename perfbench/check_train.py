"""Whether the train step is right: its first steps
(``train_cell.FIRST_STEPS``) against the plain reference's.

The reference (``reference/llama.py``) starts from the same seeded
weights, made again, takes the same batches, and computes each step's
loss and float32 gradients layer by layer, then optax's clipped AdamW
with the moments and parameters kept in bf16, as the configuration
states. Compared, each as a gap between the program's number and the
reference's, over the reference's:

- ``loss_gap``: the worst of the steps' losses;
- ``grad_norm_gap``: the first step's gradient norm before clipping;
- ``grad_leaf_gap``: the first gradient as the optimizer got it (from
  its first moment after one step), by the worst leaf: the gap of the
  leaf's norms over the larger of the reference leaf's norm and the
  median leaf's;
- ``change_leaf_gap``: each leaf's change after those steps, by the
  worst leaf in the same way. A leaf whose reference gradient is under a
  thousandth of the median leaf's moves under Adam by rounding alone and
  is left out of this one;
- ``grad_sample_gap``: the first gradient element by element, on 2^20
  elements of each leaf drawn from the seed: the norm of the difference
  over the larger of the reference sample's norm and the median leaf's,
  for the median leaf. Norms of whole leaves, like losses, are blind to
  noise of either sign (a float8 step reads under the bf16 program on
  all four numbers above); the difference is not, so this is the number
  that holds the precision. It takes the median leaf and not the worst:
  the worst is ``final_norm``'s, 4,096 elements that read 5-6% in the
  bf16 program on every seed (2.6% in float8), which would hide what the
  other leaves say.
"""
from __future__ import annotations

import statistics
from typing import Any, Dict

from perfbench import weights as weights_lib
from perfbench.train_cell import FIRST_STEPS, SAMPLE, change32, norm32


def reference_readings(cell, dims, seed: int, device, fp8: bool = False
                       ) -> Dict[str, Any]:
    """The reference's readings (float32, or with ``fp8`` the control:
    every product's operands rounded to float8)."""
    import torch
    from perfbench.reference import llama as ref
    from perfbench.traffic import steps as steps_lib
    ref.exact()
    dev = torch.device(device)
    mix = dict(cell.traffic, **cell.params.get('traffic', {}))
    opt = cell.params['optimizer']
    tree = weights_lib.make(dims, seed, dev)
    zeros = lambda t: torch.zeros_like(t)  # noqa: E731
    state = {'mu': {'layers': {}}, 'nu': {'layers': {}}}
    for key in ('mu', 'nu'):
        for path, leaf in weights_lib.leaves(tree):
            if path[0] == 'layers':
                state[key]['layers'][path[1]] = zeros(leaf)
            else:
                state[key][path[0]] = zeros(leaf)
    batches = steps_lib.batches(mix, seed, FIRST_STEPS, dims.vocab, dev)
    lin = ref.Lin(fp8=fp8)
    out: Dict[str, Any] = {'loss': [], 'grad_leaf': {}, 'change_leaf': {}}
    for i, b in enumerate(batches):
        loss, grads = ref.loss_and_grads(dims, tree, b['tokens'],
                                         b['targets'], lin)
        out['loss'].append(loss)
        lr = ref.warmup_cosine(i, opt['learning_rate'],
                               opt.get('warmup_steps', 100),
                               opt.get('total_steps', 10_000))
        norm = ref.adamw_step(tree, grads, state, i, lr,
                              weight_decay=opt.get('weight_decay', 0.1),
                              clip=opt.get('grad_clip', 1.0))
        if i == 0:
            out['grad_norm'] = norm
            clip = opt.get('grad_clip', 1.0)
            factor = clip / norm if norm >= clip else 1.0
            out['grad_sample'] = {}
            for n, (path, g) in enumerate(weights_lib.leaves(grads)):
                key = '.'.join(path)
                out['grad_leaf'][key] = norm32(g) * factor
                idx = weights_lib.sample_index(g.numel(), seed, n, SAMPLE,
                                               dev)
                out['grad_sample'][key] = (g.reshape(-1)[idx]
                                           * factor).cpu()
        del grads
    for path, p in weights_lib.leaves(tree):
        p0 = weights_lib.make_leaf(dims, path, seed, dev)
        out['change_leaf']['.'.join(path)] = change32(p, p0)
        del p0
    return out


def _worst(prog: Dict[str, float], ref: Dict[str, float], keys) -> float:
    floor = statistics.median(ref[k] for k in ref)
    return max(abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30)
               for k in keys)


def leaf_gaps(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, Any]:
    """Every leaf's gaps, for looking into a reading (not compared)."""
    out = {}
    for key in ('grad_leaf', 'change_leaf'):
        floor = statistics.median(ref[key].values())
        out[key] = {k: abs(prog[key][k] - r) / max(r, floor, 1e-30)
                    for k, r in ref[key].items()}
    out['loss'] = [(p, r) for p, r in zip(prog['loss'], ref['loss'])]
    out['grad_sample'] = sample_gap(prog, ref)
    return out


def sample_gap(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """Each leaf's ``grad_sample_gap``: the norm of the difference of the
    sampled elements over the larger of the reference sample's norm and
    the median leaf's."""
    norms = {k: float(v.norm()) for k, v in ref['grad_sample'].items()}
    floor = statistics.median(norms.values())
    return {k: float((prog['grad_sample'][k] - v).norm())
            / max(norms[k], floor, 1e-30)
            for k, v in ref['grad_sample'].items()}


def compare(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """The five gaps (see the module's docstring)."""
    gmed = statistics.median(ref['grad_leaf'].values())
    moved = [k for k, g in ref['grad_leaf'].items() if g >= 1e-3 * gmed]
    return {
        'grad_sample_gap': statistics.median(
            sample_gap(prog, ref).values()),
        'loss_gap': max(abs(p - r) / abs(r)
                        for p, r in zip(prog['loss'], ref['loss'])),
        'grad_norm_gap': abs(prog['grad_norm'] - ref['grad_norm'])
        / ref['grad_norm'],
        'grad_leaf_gap': _worst(prog['grad_leaf'], ref['grad_leaf'],
                                ref['grad_leaf']),
        'change_leaf_gap': _worst(prog['change_leaf'], ref['change_leaf'],
                                  moved),
    }
