"""Vision DDP entrypoint: ``python -m skypilot_tpu_torch.train.run_vision``
(counterpart of ``python -m skypilot_tpu.train.run_vision``).

Pure data parallel: params replicated, the batch's rows split over every
rank (dp-major, as the reference's ``P('dp')``), the gradients summed
over the ranks (each rank's loss is its rows' share of the global
mean). The optimizer is the reference's ``optax.sgd(cosine_decay_schedule
(lr, steps), momentum=0.9, nesterov=True)`` written out (:class:`SGD`).

One process per GPU, started by the command itself on each host as
``train.run`` does: ``--dp`` ranks in all (default every GPU of every
host, as the reference uses every device), split evenly over the hosts;
``--device cpu`` runs ``--dp`` ``gloo`` ranks on the CPU. If any rank
exits non-zero, the command does.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class SGD:
    """``optax.sgd(optax.cosine_decay_schedule(lr, decay_steps),
    momentum, nesterov=True)``: trace ``t = g + momentum * t``, update
    ``g + momentum * t``, scaled by ``-schedule(count)`` with the count
    before its increment; the trace keeps the params' dtype."""
    learning_rate: float
    decay_steps: int
    momentum: float = 0.9

    def schedule(self, count: int) -> float:
        """optax's cosine decay (alpha 0, exponent 1) at ``count``, in
        float32 operation by operation as optax computes it."""
        f32 = np.float32
        c = f32(min(count, self.decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c
                                             / f32(self.decay_steps)))
        return float(f32(self.learning_rate) * cosine)

    def init(self, params) -> Dict:
        return {'count': 0,
                'trace': [torch.zeros_like(p) for p in _leaves(params)]}

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict,
               params) -> None:
        """One step on ``params`` (in place) from the leaves' gradients."""
        step = -self.schedule(state['count'])
        for g, t, p in zip(grads, state['trace'], _leaves(params)):
            t.copy_(g + self.momentum * t)
            u = g + self.momentum * t
            p.copy_(p + torch.tensor(step, dtype=u.dtype) * u)
        state['count'] += 1


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', default='resnet18',
                        choices=['tiny', 'resnet18', 'resnet50'])
    parser.add_argument('--steps', type=int, default=100)
    parser.add_argument('--batch', type=int, default=256,
                        help='Global batch size.')
    parser.add_argument('--image-size', type=int, default=224)
    parser.add_argument('--lr', type=float, default=0.1)
    parser.add_argument('--log-every', type=int, default=10)
    parser.add_argument('--dp', type=int, default=0,
                        help='ranks over all hosts; 0 = every GPU (one '
                             'rank a host on the CPU)')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    return parser.parse_args(argv)


def run_rank(args: argparse.Namespace, world: int, rank: int = 0,
             address: Optional[str] = None, device='cpu',
             backend: Optional[str] = None) -> Dict:
    """One rank of the DDP run over ``world`` ranks: join, train, leave.
    Rank 0 logs. Returns the logged steps' losses and the final params
    (on the CPU)."""
    from skypilot_tpu_torch.train.run import cpu_share
    device = torch.device(device)
    with cpu_share(device, world):
        return _train(args, world, rank, address, device, backend)


def _train(args, world, rank, address, device, backend) -> Dict:
    from skypilot_tpu_torch.models import resnet
    from skypilot_tpu_torch.parallel import collectives
    from skypilot_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.train_mesh(mesh_lib.MeshShape(dp=world), rank, address,
                               device, backend)
    group = mesh.group('dp')
    lead = mesh.rank == 0
    config = getattr(resnet.ResNetConfig, args.model)()
    if args.batch % world:
        raise ValueError(f'batch {args.batch} does not split over {world} '
                         f'ranks')
    if lead:
        logger.info('DDP over %d devices, model=%s, device=%s', world,
                    args.model, device)
    params = resnet.init_params(
        config, torch.Generator(device=device).manual_seed(0), device)
    leaves = _leaves(params)
    opt = SGD(args.lr, args.steps)
    opt_state = opt.init(params)

    gen = torch.Generator(device=device).manual_seed(1)
    s = args.image_size
    images = torch.randn((args.batch, s, s, 3), generator=gen,
                         device=device)
    labels = torch.randint(0, config.num_classes, (args.batch,),
                           generator=gen, device=device)
    rows = args.batch // world
    images = images[rank * rows:(rank + 1) * rows]
    labels = labels[rank * rows:(rank + 1) * rows]

    t_last, logged, out = time.perf_counter(), 0, []
    for step in range(args.steps):
        for p in leaves:
            p.requires_grad_(True)
        try:
            # This rank's share of the global mean.
            local = resnet.loss_fn(config, params, images, labels) / world
            grads = torch.autograd.grad(local, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = [collectives.all_reduce_sum(g, group) for g in grads]
        loss = collectives.all_reduce_sum(local.detach(), group)
        opt.update(grads, opt_state, params)
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            dt = time.perf_counter() - t_last
            ips = args.batch * (step + 1 - logged) / dt
            t_last, logged = time.perf_counter(), step + 1
            out.append({'step': step + 1, 'loss': float(loss),
                        'images_per_s': ips})
            if lead:
                logger.info('step %d/%d loss=%.4f images/s=%.0f', step + 1,
                            args.steps, float(loss), ips)
    if lead:
        logger.info('done')
    mesh_lib.destroy_mesh(mesh)
    return {'logged': out, 'params': [p.cpu() for p in leaves]}


def _follower(args, world, rank, address, device) -> None:
    logging.basicConfig(
        level=logging.INFO,
        format='%(asctime)s %(levelname)s %(name)s: %(message)s')
    run_rank(args, world, rank, address, device)


def main(argv=None) -> None:
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format='%(asctime)s %(levelname)s %(name)s: %(message)s')
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.train.run import resolve_device
    device = resolve_device(args.device)
    n_hosts, host_id, coordinator = mesh_lib.host_env()
    world = args.dp or n_hosts * (torch.cuda.device_count()
                                  if device.type == 'cuda' else 1)
    if world % n_hosts:
        raise SystemExit(f'--dp {world} must be a multiple of the '
                         f'{n_hosts} hosts')
    per_host = world // n_hosts
    if world == 1:
        run_rank(args, 1, 0, None, device)
        return
    address = coordinator or f'127.0.0.1:{mesh_lib.free_port()}'
    first = host_id * per_host
    codes = mesh_lib.run_local_ranks(
        run_rank, _follower,
        lambda i: (args, world, first + i, address,
                   mesh_lib.rank_device(device.type, i)),
        per_host, 'vision-rank', first)
    if any(codes):
        sys.exit(1)


if __name__ == '__main__':
    main()
