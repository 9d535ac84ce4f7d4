"""Rank programs of the port's sequence, pipeline and expert parallelism
tests (``test_torch_ring_attention.py``, ``test_torch_pp.py``,
``test_torch_moe.py``): each rank is a process started by
``torch.multiprocessing`` with the ``spawn`` method, which imports this
module, so nothing here imports JAX. The ranks join a ``gloo`` world on
the CPU at a free localhost port (``torch_tp_ranks.start``); inputs come
in an npz and results go out in one, per rank."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import moe
from skypilot_tpu_torch.ops import attention
from skypilot_tpu_torch.ops import ring_attention as ring
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import pipeline
from skypilot_tpu_torch.parallel import sharding
from torch_tp_ranks import load_params

RING_CASES = [(causal, hq, hkv) for causal in (True, False)
              for hq, hkv in ((4, 4), (4, 2))]
RING_IMPLS = {'reference': ring.ring_attention_reference,
              'flash': ring.ring_attention}
PP_CFG = llama.LlamaConfig.tiny(n_layers=4)
PP_MICROBATCHES = 2
MOE_CFG = moe.MoEConfig.tiny()
# The reference's test_moe_trains: plain SGD at this rate.
MOE_LR = 0.05
MOE_STEPS = 5


def _grad_arrays(tree) -> Dict[str, np.ndarray]:
    """A gradient tree as npz entries ``grad/<'/'-joined path>``."""
    return {'grad/' + '/'.join(path): g.detach().numpy()
            for path, g in sharding.tree_leaves(tree).items()}


def _shard(x: np.ndarray, i: int, n: int, axis: int) -> torch.Tensor:
    size = x.shape[axis] // n
    return torch.from_numpy(np.take(x, range(i * size, (i + 1) * size),
                                    axis=axis).copy())


def ring_rank(rank, world, address, data_path, out_path):
    """Every ring case of :data:`RING_CASES` with both implementations on
    this rank's sequence shard: the output shard and the gradients of
    ``sum(out * cotangent)`` for its q, k and v shards, and the flash
    operators' calls in the flash runs of each case."""
    torch.set_num_threads(1)
    group = mesh_lib.axes_mesh(mesh_lib.AxesShape(mesh_lib.SP_AXES,
                                                  (world,)),
                               rank, address).group('sp')
    data = np.load(data_path)
    out = {}
    for causal, hq, hkv in RING_CASES:
        case = f'{int(causal)}_{hq}_{hkv}'
        q, k, v, ct = (_shard(data[f'{name}_{case}'], rank, world, 2)
                       for name in ('q', 'k', 'v', 'ct'))
        for impl, fn in RING_IMPLS.items():
            attention.reset_launches()
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            o = fn(*leaves, group, causal=causal)
            dq, dk, dv = torch.autograd.grad((o * ct).sum(), leaves)
            key = f'{impl}_{case}'
            for name, t in (('out', o), ('dq', dq), ('dk', dk), ('dv', dv)):
                out[f'{name}_{key}'] = t.detach().numpy()
            out[f'calls_{key}'] = np.array(
                [attention.op_calls[k] for k in
                 ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv')])
    np.savez(out_path.format(rank=rank), **out)
    mesh_lib.destroy(group)


def pp_rank(rank, world, address, dp, data_path, out_path):
    """The tiny model's pipelined loss and gradients at ``dp`` x
    ``world / dp`` (``('dp', 'pp')``) from the whole params and batch in
    ``data_path``: this stage's layers, this dp rank's rows; the
    gradients finished by ``pipeline.reduce_grads``."""
    torch.set_num_threads(1)
    pp = world // dp
    mesh = mesh_lib.axes_mesh(mesh_lib.AxesShape(mesh_lib.PP_AXES, (dp, pp)),
                              rank, address)
    whole = load_params(data_path)
    tokens, targets = whole.pop('tokens'), whole.pop('targets')
    stage = mesh.coord('pp')
    params = pipeline.stage_params(whole, stage, pp)
    leaves = sharding.tree_leaves(params)
    for t in leaves.values():
        t.requires_grad_()
    d = mesh.coord('dp')
    rows = tokens.shape[0] // dp
    fn = pipeline.llama_pp_loss_fn(PP_CFG, mesh.group('pp'),
                                   PP_MICROBATCHES, mesh.group('dp'))
    loss = fn(params, tokens[d * rows:(d + 1) * rows].long(),
              targets[d * rows:(d + 1) * rows].long())
    grads = torch.autograd.grad(loss, list(leaves.values()))
    by_path = dict(zip(leaves, grads))
    tree = pipeline.reduce_grads(
        sharding.map_tree(lambda path, _: by_path[path], params),
        mesh.group('pp'), mesh.group('dp'))
    np.savez(out_path.format(rank=rank), loss=loss.detach().numpy(),
             **_grad_arrays(tree))
    mesh_lib.destroy_mesh(mesh)


def moe_rank(rank, world, address, sizes, data_path, out_path):
    """The tiny MoE at ``sizes`` (fsdp, tp, ep) from the whole params and
    batch in ``data_path``: this rank's blocks and rows; the loss, its aux
    terms and the finished gradients, then :data:`MOE_STEPS` SGD steps at
    :data:`MOE_LR` on the blocks (the losses before each)."""
    torch.set_num_threads(1)
    mesh = mesh_lib.axes_mesh(mesh_lib.AxesShape(mesh_lib.EP_AXES, sizes),
                              rank, address, combined=(('fsdp', 'ep'),))
    moe.check_divisible(MOE_CFG, mesh)
    shard = moe.MeshOps(mesh)
    whole = load_params(data_path)
    tokens, targets = whole.pop('tokens'), whole.pop('targets')
    rows = tokens.shape[0] // shard.data.world
    r0 = shard.data.rank * rows
    tokens = tokens[r0:r0 + rows].long()
    targets = targets[r0:r0 + rows].long()
    params = moe.shard_params(whole, mesh)

    def loss_and_grads(p):
        tree = sharding.map_tree(lambda _, t: t.detach().requires_grad_(), p)
        leaves = sharding.tree_leaves(tree)
        total, aux = moe.loss_fn(MOE_CFG, tree, tokens, targets,
                                 shard=shard)
        grads = dict(zip(leaves, torch.autograd.grad(total,
                                                     list(leaves.values()))))
        return total, aux, moe.reduce_grads(
            sharding.map_tree(lambda path, _: grads[path], tree), mesh)

    total, aux, grads = loss_and_grads(params)
    out = {'loss': total.detach().numpy(),
           **{k: v.detach().numpy() for k, v in aux.items()},
           **_grad_arrays(grads)}
    losses = [float(total)]
    for _ in range(MOE_STEPS):
        flat = sharding.tree_leaves(grads)
        params = sharding.map_tree(
            lambda path, w: w - MOE_LR * flat[path], params)
        total, _, grads = loss_and_grads(params)
        losses.append(float(total))
    out['losses'] = np.array(losses)
    np.savez(out_path.format(rank=rank), **out)
    mesh_lib.destroy_mesh(mesh)

