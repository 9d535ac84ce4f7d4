"""Training entrypoint: ``python -m skypilot_tpu_torch.train.run``
(counterpart of ``python -m skypilot_tpu.train.run``).

One device (an NVIDIA GPU unless ``--device cpu``), synthetic data,
and the checkpoint/resume convention of the managed jobs: with
``--checkpoint-dir`` a run restores the latest checkpoint there and
goes on from its step.

    python -m skypilot_tpu_torch.train.run --model llama-350m --steps 100 \\
        --batch 8 --seq 2048 --checkpoint-dir /mnt/ckpt

The mesh flags of the reference (``--dp --fsdp --tp``) are accepted;
anything but one device raises until sharding is ported (ROADMAP.md
queue 1 item 15).
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import torch

logger = logging.getLogger(__name__)

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


def main(argv=None) -> None:
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
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format='%(asctime)s %(levelname)s %(name)s: %(message)s')

    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import trainer

    family, preset = MODELS[args.model]
    if family != 'llama':
        raise SystemExit(f'--model {args.model}: the MoE trainer entry '
                         f'lands with the MoE train-step factory; use '
                         f'llama-* presets here for now')
    n = 1
    fsdp = args.fsdp or n // (args.dp * args.tp)
    if args.dp * fsdp * args.tp != n:
        raise SystemExit(f'mesh dp={args.dp} fsdp={fsdp} tp={args.tp}: the '
                         f'port trains on one device; sharding is '
                         f'ROADMAP.md queue 1 item 15')
    device = resolve_device(args.device)
    config = getattr(llama.LlamaConfig, preset)(max_seq_len=args.seq)
    logger.info('device=%s mesh dp=%d fsdp=%d tp=%d model=%s (%.0fM)',
                device, args.dp, fsdp, args.tp, args.model,
                config.num_params / 1e6)

    opt = trainer.make_optimizer(learning_rate=args.lr,
                                 total_steps=args.steps)
    step_fn = trainer.make_train_step(config, opt)

    def init():
        gen = torch.Generator(device=device).manual_seed(0)
        return trainer.init_train_state(config, gen, opt, device)

    start_step = 0
    if args.checkpoint_dir:
        from skypilot_tpu_torch.train import checkpoint as ckpt_lib
        mgr = ckpt_lib.CheckpointManager(
            args.checkpoint_dir, save_interval_steps=args.checkpoint_every)
        state, restored = ckpt_lib.restore_or_init(args.checkpoint_dir, init)
        if restored:
            start_step = int(state.step)
            logger.info('resumed from checkpoint at step %d', start_step)
    else:
        mgr = None
        state = init()

    batch = trainer.synthetic_batch(
        config, args.batch, args.seq,
        torch.Generator(device=device).manual_seed(1), device)

    tokens_per_step = args.batch * args.seq
    t_last, logged = time.perf_counter(), start_step
    for step in range(start_step, args.steps):
        state, metrics = step_fn(state, batch)
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            loss = float(metrics['loss'])
            dt = time.perf_counter() - t_last
            tps = tokens_per_step * (step + 1 - logged) / dt
            t_last, logged = time.perf_counter(), step + 1
            logger.info('step %d/%d loss=%.4f tokens/s=%.0f',
                        step + 1, args.steps, loss, tps)
            if not torch.isfinite(metrics['loss']):
                logger.error('non-finite loss; aborting')
                sys.exit(1)
        if mgr is not None:
            mgr.save(step + 1, state)
    if mgr is not None:
        mgr.wait()
        mgr.close()
    logger.info('done: %d steps', args.steps)


if __name__ == '__main__':
    main()
