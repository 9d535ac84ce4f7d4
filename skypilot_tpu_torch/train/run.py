"""Training entrypoint: ``python -m skypilot_tpu_torch.train.run``
(counterpart of ``python -m skypilot_tpu.train.run``).

Synthetic data and the checkpoint/resume convention of the managed jobs:
with ``--checkpoint-dir`` a run restores the latest checkpoint there and
goes on from its step.

    python -m skypilot_tpu_torch.train.run --model llama-8b --steps 1000 \\
        --batch 16 --seq 4096 --fsdp 8 --tp 1 --checkpoint-dir /ckpt

The mesh is the reference's: ``--dp``, ``--fsdp`` (0 = every device the
other two leave) and ``--tp`` over every GPU of the job, ``fsdp = fsdp or
devices // (dp * tp)``, ranked as ``parallel/mesh.py`` says. The port runs
one process per GPU: on each host the command starts one rank per local
GPU itself (this process is the host's first), so a recipe's single
``run:`` line needs no launcher; across hosts it reads the agent's
environment (``parallel/mesh.host_env``), and the coordinator's address
is rank 0's rendezvous. With ``--device cpu`` it runs ``dp * fsdp * tp``
``gloo`` ranks on the CPU (``--fsdp 0``: one). A single device runs in
this process. If any rank exits non-zero, the command does.
"""
from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys
import time
from typing import Dict, List, Optional

import torch

logger = logging.getLogger(__name__)

PHASES = ('forward', 'backward', 'grad_sync', 'optimizer')

MODELS = {
    'llama-tiny': ('llama', 'tiny'),
    'llama-350m': ('llama', 'bench_350m'),
    'llama-8b': ('llama', 'llama3_8b'),
    'llama-70b': ('llama', 'llama3_70b'),
    'moe-tiny': ('moe', 'tiny'),
    'moe-8x7b': ('moe', 'mixtral_8x7b'),
}


def resolve_device(name: str) -> torch.device:
    """The device a run asks for; 'cuda' without a card raises."""
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda: CUDA is not available (pass '
                           '--device cpu to train on the CPU)')
    return device


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', default='llama-350m',
                        choices=sorted(MODELS))
    parser.add_argument('--steps', type=int, default=100)
    parser.add_argument('--batch', type=int, default=8,
                        help='Global batch size.')
    parser.add_argument('--seq', type=int, default=2048)
    parser.add_argument('--lr', type=float, default=3e-4)
    parser.add_argument('--dp', type=int, default=1)
    parser.add_argument('--fsdp', type=int, default=0,
                        help='0 = all remaining devices.')
    parser.add_argument('--tp', type=int, default=1)
    parser.add_argument('--checkpoint-dir', default=os.environ.get(
        'SKY_TPU_CHECKPOINT_DIR'))
    parser.add_argument('--checkpoint-every', type=int, default=50)
    parser.add_argument('--log-every', type=int, default=10)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    return parser.parse_args(argv)


@contextlib.contextmanager
def cpu_share(device: torch.device, ranks: int):
    """On the CPU with more than one rank: each rank's intra-op threads a
    share of the host's cores, not all of them (restored after)."""
    if device.type != 'cpu' or ranks == 1:
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // ranks))
    try:
        yield
    finally:
        torch.set_num_threads(before)


def run_rank(args: argparse.Namespace, shape, rank: int = 0,
             address: Optional[str] = None, device='cpu',
             backend: Optional[str] = None) -> List[Dict[str, float]]:
    """One rank of a run over the mesh ``shape`` (a ``MeshShape``): join
    it, restore or initialize, train, checkpoint, leave. Rank 0 logs.
    Returns the logged steps' metrics."""
    device = torch.device(device)
    with cpu_share(device, shape.size):
        return _train(args, shape, rank, address, device, backend)


def phase_means_ms(records: List[Dict], n: int) -> Dict[str, Optional[float]]:
    """The mean ms of each train-step phase over the last ``n`` records
    (``trainer.make_train_step``'s ``records()``); None for a phase the
    steps did not run (``grad_sync`` off a mesh)."""
    recent = records[-n:] if n > 0 else []
    out = {}
    for phase in PHASES:
        vals = [r[phase] for r in recent if r[phase] is not None]
        out[f'{phase}_ms'] = (sum(vals) / len(vals) * 1e3 if vals
                              else None)
    return out


def _train(args, shape, rank, address, device, backend):
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel import sharding
    from skypilot_tpu_torch.train import checkpoint as ckpt_lib
    from skypilot_tpu_torch.train import trainer

    mesh = mesh_lib.train_mesh(shape, rank, address, device, backend)
    lead = mesh.rank == 0
    _, preset = MODELS[args.model]
    config = getattr(llama.LlamaConfig, preset)(max_seq_len=args.seq)
    if lead:
        logger.info('devices=%d mesh dp=%d fsdp=%d tp=%d model=%s (%.0fM) '
                    'device=%s', shape.size, shape.dp, shape.fsdp, shape.tp,
                    args.model, config.num_params / 1e6, device)

    opt = trainer.make_optimizer(learning_rate=args.lr,
                                 total_steps=args.steps)
    step_fn = trainer.make_train_step(config, opt, mesh)

    def init():
        gen = torch.Generator(device=device).manual_seed(0)
        return trainer.init_train_state(config, gen, opt, device, mesh)

    start_step = 0
    mgr = None
    if args.checkpoint_dir:
        mgr = ckpt_lib.CheckpointManager(
            args.checkpoint_dir, save_interval_steps=args.checkpoint_every)
        if mesh.size == 1:
            state, restored = ckpt_lib.restore_or_init(args.checkpoint_dir,
                                                       init)
        else:
            whole = trainer.init_train_state(config, None, opt, 'meta')
            state, restored = ckpt_lib.restore_or_init_mesh(
                args.checkpoint_dir, init, mesh, whole, device)
        if restored:
            start_step = int(state.step)
            if lead:
                logger.info('resumed from checkpoint at step %d',
                            start_step)
    else:
        state = init()

    batch = trainer.synthetic_batch(
        config, args.batch, args.seq,
        torch.Generator(device=device).manual_seed(1), device)
    if mesh.size > 1:
        batch = sharding.batch_rows(batch, mesh)

    tokens_per_step = args.batch * args.seq
    t_last, logged = time.perf_counter(), start_step
    out = []
    for step in range(start_step, args.steps):
        state, metrics = step_fn(state, batch)
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            loss = float(metrics['loss'])
            dt = time.perf_counter() - t_last
            tps = tokens_per_step * (step + 1 - logged) / dt
            # The loss's read waited for the step: reading the records
            # waits no more.
            phases = phase_means_ms(step_fn.records(), step + 1 - logged)
            t_last, logged = time.perf_counter(), step + 1
            out.append({'step': step + 1, 'loss': loss,
                        'grad_norm': float(metrics['grad_norm']),
                        'tokens_per_s': tps, **phases})
            if lead:
                logger.info('step %d/%d loss=%.4f tokens/s=%.0f %s',
                            step + 1, args.steps, loss, tps,
                            ' '.join(f'{k}={v:.1f}'
                                     for k, v in phases.items()
                                     if v is not None))
            if not torch.isfinite(metrics['loss']):
                logger.error('non-finite loss; aborting')
                sys.exit(1)
        if mgr is not None:
            ckpt_lib.save_mesh(mgr, step + 1, state, mesh)
    if mgr is not None:
        mgr.wait()
        mgr.close()
    if lead:
        logger.info('done: %d steps', args.steps)
    mesh_lib.destroy_mesh(mesh)
    return out


def _follower(args: argparse.Namespace, shape, rank: int, address: str,
              device: torch.device) -> None:
    """A spawned local rank."""
    logging.basicConfig(
        level=logging.INFO,
        format='%(asctime)s %(levelname)s %(name)s: %(message)s')
    run_rank(args, shape, rank, address, device)


def main(argv=None) -> None:
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format='%(asctime)s %(levelname)s %(name)s: %(message)s')
    from skypilot_tpu_torch.parallel import mesh as mesh_lib

    family, _ = MODELS[args.model]
    if family != 'llama':
        raise SystemExit(f'--model {args.model}: the MoE trainer entry '
                         f'lands with the MoE train-step factory; use '
                         f'llama-* presets here for now')
    device = resolve_device(args.device)
    n_hosts, host_id, coordinator = mesh_lib.host_env()
    # This host's ranks: its GPUs, or on the CPU the ranks the flags ask
    # for (--fsdp 0 counting one).
    per_host = (torch.cuda.device_count() if device.type == 'cuda'
                else args.dp * (args.fsdp or 1) * args.tp)
    n = n_hosts * per_host
    shape = mesh_lib.make_mesh(dp=args.dp,
                               fsdp=args.fsdp or n // (args.dp * args.tp),
                               tp=args.tp, n_devices=n)
    if shape.size == 1:
        run_rank(args, shape, 0, None, device)
        return
    address = coordinator or f'127.0.0.1:{mesh_lib.free_port()}'
    first = host_id * per_host
    codes = mesh_lib.run_local_ranks(
        run_rank, _follower,
        lambda i: (args, shape, first + i, address,
                   mesh_lib.rank_device(device.type, i)),
        per_host, 'train-rank', first)
    if any(codes):
        sys.exit(1)


if __name__ == '__main__':
    main()
