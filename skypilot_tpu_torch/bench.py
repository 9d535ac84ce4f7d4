"""Benchmark: Llama train-step throughput on one NVIDIA GPU
(``python -m skypilot_tpu_torch.bench``; counterpart of the root
``bench.py``).

Prints ONE JSON line last:
    {"metric": "train_tokens_per_sec_per_chip", "value": N,
     "unit": "tokens/s/chip", "mfu": x, "vs_baseline": M, ...}

The workload is the reference's: ``LlamaConfig.bench_1b`` (~1B params,
bf16, full per-layer remat), AdamW with a bf16 first moment
(``make_optimizer(total_steps=1000, mu_dtype='bfloat16')``), batch 6 at
seq 2048, 2 warm-up steps then 5 timed steps on one synthetic batch.
MFU is tokens/s x ``flops_per_token`` over the card's dense bf16 peak;
``vs_baseline`` divides it by the 43% MFU the Llama-3 report gives for
H100 bf16 pretraining, as the reference does. Before the JSON line it
prints the step time, the peak of ``torch.cuda.max_memory_allocated``
and each kernel's launches per timed step, from the wrappers' counters.

It needs a CUDA card and refuses to run without one.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict

import torch

BATCH = 6
SEQ = 2048
WARMUP = 2
STEPS = 5
# Llama-3 report (Meta 2024, sec 3.3.2): 38-43% MFU, H100 BF16
# pretraining. Upper bound used: conservative against this port.
EXTERNAL_BASELINE_MFU = 0.43

# Dense bf16 tensor-core peak by card name (NVIDIA's data sheet, SXM).
PEAK_BF16_TFLOPS = {'H100': 989.0}


def peak_tflops(device_name: str) -> float:
    for key, val in PEAK_BF16_TFLOPS.items():
        if key in device_name:
            return val
    raise ValueError(f'no bf16 peak known for {device_name!r}; add it to '
                     f'PEAK_BF16_TFLOPS')


def kernel_launches() -> Dict[str, int]:
    from skypilot_tpu_torch.ops import attention, cross_entropy
    return {**attention.launches, **cross_entropy.launches}


def reset_launches() -> None:
    from skypilot_tpu_torch.ops import attention, cross_entropy
    attention.reset_launches()
    cross_entropy.reset_launches()


def measure(config, batch: int, seq: int, device, steps: int = STEPS,
            warmup: int = WARMUP) -> dict:
    """Train ``warmup`` then ``steps`` steps of ``config`` on ``device``
    (bf16 Adam first moment) and return the timed steps' numbers: host
    seconds, final loss, peak device memory and kernel launches per
    step (counters reset just before the timed steps)."""
    from skypilot_tpu_torch.train import trainer
    opt = trainer.make_optimizer(total_steps=1000, mu_dtype='bfloat16')
    gen = torch.Generator(device=device).manual_seed(0)
    state = trainer.init_train_state(config, gen, opt, device)
    step = trainer.make_train_step(config, opt)
    data = trainer.synthetic_batch(
        config, batch, seq, torch.Generator(device=device).manual_seed(1),
        device)
    cuda = torch.device(device).type == 'cuda'

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(warmup):
        state, metrics = step(state, data)
    float(metrics['loss'])
    warmup_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step(state, data)
    final_loss = float(metrics['loss'])
    sync()
    seconds = time.perf_counter() - t0
    return {
        'seconds': seconds, 'steps': steps, 'warmup_s': warmup_s,
        'loss': final_loss,
        'peak_memory_gb': (torch.cuda.max_memory_allocated() / 1e9
                           if cuda else None),
        'launches_per_step': {k: v / steps
                              for k, v in kernel_launches().items()},
        'launches': dict(kernel_launches()),
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('--seq', type=int, default=SEQ,
                        help='sequence length (batch drops to 1 above '
                             '2048)')
    parser.add_argument('--batch', type=int, default=None)
    parser.add_argument('--remat-policy', default=None,
                        choices=['full', 'dots', 'save_attn'])
    parser.add_argument('--attn', default=None,
                        choices=['flash', 'dense'])
    parser.add_argument('--block-q', type=int, default=None)
    parser.add_argument('--block-k', type=int, default=None)
    parser.add_argument('--fused-ce', action='store_true',
                        help='fused cross-entropy forward kernel '
                             '(ops/cross_entropy.py fused_cross_entropy)')
    parser.add_argument('--vocab', type=int, default=None,
                        help='override vocab size (e.g. 128256 = '
                             'Llama-3)')
    parser.add_argument('--ce', default=None,
                        choices=['dense', 'chunked', 'fused'],
                        help='CE path: dense fp32 log-softmax, vocab-'
                             'chunked custom backward, or the fused '
                             'forward kernel (equivalent to --fused-ce)')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError('skypilot_tpu_torch.bench measures a CUDA card '
                           'and CUDA is not available')
    from skypilot_tpu_torch.models import llama

    seq = args.seq
    batch = args.batch or (BATCH if seq <= 2048 else 1)
    kw = {'attention_impl': args.attn or 'auto'}
    if args.remat_policy:
        kw['remat_policy'] = args.remat_policy
    if args.block_q:
        kw['attn_block_q'] = args.block_q
    if args.block_k:
        kw['attn_block_k'] = args.block_k
    if args.fused_ce or args.ce == 'fused':
        kw['fused_loss'] = True
    elif args.ce == 'chunked':
        kw['loss_vocab_chunks'] = 16
    elif args.ce == 'dense':
        kw['loss_vocab_chunks'] = None
    if args.vocab:
        kw['vocab_size'] = args.vocab
    config = llama.LlamaConfig.bench_1b(max_seq_len=seq, **kw)
    name = torch.cuda.get_device_name(0)
    peak = peak_tflops(name)
    print(f'[bench] device={name} params={config.num_params/1e6:.0f}M '
          f'batch={batch} seq={seq} attn={kw["attention_impl"]} '
          f'fused_loss={config.fused_loss} '
          f'loss_vocab_chunks={config.loss_vocab_chunks}', flush=True)

    r = measure(config, batch, seq, 'cuda')
    tok_per_sec = batch * seq * r['steps'] / r['seconds']
    mfu = tok_per_sec * llama.flops_per_token(config) / (peak * 1e12)
    step_ms = r['seconds'] / r['steps'] * 1e3
    print(f'[bench] warmup: {r["warmup_s"]:.1f}s', flush=True)
    print(f'[bench] {tok_per_sec:.0f} tok/s  step={step_ms:.1f}ms  '
          f'loss={r["loss"]:.3f}  MFU={mfu:.4f}  '
          f'peak_memory={r["peak_memory_gb"]:.2f}GB', flush=True)
    print('[bench] launches per step: '
          + json.dumps(r['launches_per_step']), flush=True)
    print(json.dumps({
        'metric': 'train_tokens_per_sec_per_chip',
        'value': tok_per_sec,
        'unit': 'tokens/s/chip',
        'vs_baseline': mfu / EXTERNAL_BASELINE_MFU,
        'baseline_source': 'Llama-3 report 2024 sec3.3.2: 43% MFU H100 BF16',
        'mfu': mfu,
        'model_params_m': round(config.num_params / 1e6),
        'batch': batch, 'seq': seq,
        'device': name,
        'step_ms': step_ms,
        'loss': r['loss'],
        'peak_memory_gb': r['peak_memory_gb'],
        'launches': r['launches'],
        'launches_per_step': r['launches_per_step'],
    }), flush=True)


if __name__ == '__main__':
    sys.exit(main())
