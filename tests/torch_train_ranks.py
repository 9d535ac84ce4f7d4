"""Rank programs of the port's multi-process training tests
(``test_torch_train_mesh.py``, ``test_torch_resnet.py``): each rank is a
process started by ``torch.multiprocessing`` with the ``spawn`` method,
which imports this module, so nothing here imports JAX. The ranks join a
``gloo`` world on the CPU at a free localhost port (``torch_tp_ranks``'
``spawn``)."""
from __future__ import annotations

import json
import pathlib

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.train import checkpoint as ckpt_lib
from skypilot_tpu_torch.train import run_vision
from skypilot_tpu_torch.train import trainer
from torch_tp_ranks import load_params

CFG = llama.LlamaConfig.tiny()
# The reference's mesh test's schedule (warmup 1: the second step moves
# the params by about lr), at lr 1e-4. The tiny model's gradient norm
# (1.39) is above the clip, so the global norm scales every update.
# Adam's update g / (|g| + eps) magnifies fp32 summation order in a
# gradient element near eps: lm_head holds one at -3.3e-10, whose update
# parts by 4 % between any two reduction orders (the reference's own mesh
# and one-device steps part there by 2.6e-6 at lr 3e-4, the port's mesh
# by 1.1e-5), so lr 1e-4 keeps that one element's 4 % under PARAM_ATOL
# while every other element's update (about lr) is 10x the tolerance.
OPT = dict(learning_rate=1e-4, warmup_steps=1, total_steps=10)
STEPS = 2


class Allocations(TorchDispatchMode):
    """While on: the largest storage (bytes) that any operator's fresh
    output holds (an output that aliases none of its inputs), and how
    many tensors ``torch.from_file`` mapped (rank 0's file-backed whole
    leaves, which are not counted as allocations)."""

    def __init__(self):
        super().__init__()
        self.largest = 0
        self.mapped = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.from_file.default:
            self.mapped += 1
            return out
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for ret, t in zip(func._schema.returns, outs):
            if isinstance(t, torch.Tensor) and ret.alias_info is None:
                self.largest = max(self.largest,
                                   t.untyped_storage().nbytes())
        return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def mesh_steps(rank, world, address, shape, data_path, out_dir):
    """``STEPS`` steps of the tiny config on the mesh ``shape`` (dp, fsdp,
    tp) from the whole params and global batch in ``data_path`` (an npz
    of '/'-joined param keys, 'tokens', 'targets', 'mask'), without and
    with the mask, each from a fresh state and saved after the last step
    by ``checkpoint.save_mesh`` in pieces of one block row (into
    ``<out_dir>/plain`` and ``<out_dir>/masked``). Rank 0 writes each
    run's losses and grad norms to ``<out_dir>/metrics.json``; every rank
    writes to ``<out_dir>/save<rank>.json`` what its save allocated
    (:class:`Allocations`), its largest block row and the largest whole
    leaf, in bytes."""
    torch.set_num_threads(1)
    # Pieces of one block row, so that the tiny blocks cross in pieces.
    sharding.PIECE_BYTES = 1
    mesh = mesh_lib.train_mesh(mesh_lib.MeshShape(*shape), rank, address,
                               'cpu')
    whole = load_params(data_path)
    batch = {k: whole.pop(k) for k in ('tokens', 'targets', 'mask')}
    opt = trainer.make_optimizer(**OPT)
    step = trainer.make_train_step(CFG, opt, mesh)
    result, saves = {}, {}
    for masked in (False, True):
        fresh = sharding.map_tree(lambda _, t: t.clone(), whole)
        state = trainer.shard_train_state(
            trainer.TrainState(step=torch.zeros((), dtype=torch.int32),
                               params=fresh, opt_state=opt.init(fresh)),
            mesh)
        rows = sharding.batch_rows(
            {k: v for k, v in batch.items() if masked or k != 'mask'}, mesh)
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, rows)
            metrics.append({'loss': float(m['loss']),
                            'grad_norm': float(m['grad_norm'])})
        name = 'masked' if masked else 'plain'
        result[name] = metrics
        blocks = [state.params, state.opt_state['mu'],
                  state.opt_state['nu']]
        mgr = ckpt_lib.CheckpointManager(str(pathlib.Path(out_dir) / name))
        with Allocations() as seen:
            ckpt_lib.save_mesh(mgr, STEPS, state, mesh)
        saves[name] = {
            'largest_allocation': seen.largest, 'mapped': seen.mapped,
            'leaves': sum(1 for tree in blocks for _ in _leaves(tree)),
            'block_row': max(t[0].nbytes for tree in blocks
                             for t in _leaves(tree)),
            'whole_leaf': max(t.nbytes for t in _leaves(whole))}
    (pathlib.Path(out_dir) / f'save{rank}.json').write_text(
        json.dumps(saves))
    if rank == 0:
        (pathlib.Path(out_dir) / 'metrics.json').write_text(
            json.dumps(result))
    mesh_lib.destroy_mesh(mesh)


def vision_rank(rank, world, address, argv, out_path):
    """``run_vision``'s rank program over ``world`` ranks with the flags
    ``argv``; rank 0 writes the logged losses and the final params."""
    args = run_vision.parse_args(argv)
    out = run_vision.run_rank(args, world, rank, address, 'cpu')
    if rank == 0:
        np.savez(out_path, losses=np.array([r['loss'] for r in
                                            out['logged']]),
                 **{f'p{i}': p.numpy() for i, p in
                    enumerate(out['params'])})
