"""The port's training entry points on the CPU:
``python -m skypilot_tpu_torch.train.run`` on ``llama-tiny`` with a
checkpoint directory, then a resume that must land where an
uninterrupted run lands (bit for bit: the checkpoint holds params,
moments and counts); the refusals (a mesh, the MoE presets, CUDA
without a card); and ``skypilot_tpu_torch.bench``, which refuses to run
without a card while its measuring loop runs here on the tiny config.
"""
import json
import logging
import re

import pytest
import torch

from skypilot_tpu_torch import bench
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.train import run

ARGS = ['--model', 'llama-tiny', '--device', 'cpu', '--batch', '2',
        '--seq', '32', '--log-every', '1']


def _losses(caplog):
    out = {}
    for rec in caplog.records:
        m = re.match(r'step (\d+)/(\d+) loss=([\d.]+) tokens/s=\d+',
                     rec.getMessage())
        if m:
            out[int(m.group(1))] = float(m.group(3))
    return out


def test_train_resume_lands_where_an_uninterrupted_run_does(tmp_path,
                                                            caplog):
    caplog.set_level(logging.INFO)
    run.main(ARGS + ['--steps', '5'])
    straight = _losses(caplog)
    assert sorted(straight) == [1, 2, 3, 4, 5]
    caplog.clear()

    ckpt = str(tmp_path / 'ckpt')
    run.main(ARGS + ['--steps', '3', '--checkpoint-dir', ckpt,
                     '--checkpoint-every', '2'])
    first = _losses(caplog)
    assert first == {k: straight[k] for k in (1, 2, 3)}
    assert sorted(p.name for p in (tmp_path / 'ckpt').iterdir()) == \
        ['1', '2']
    caplog.clear()

    run.main(ARGS + ['--steps', '5', '--checkpoint-dir', ckpt,
                     '--checkpoint-every', '2'])
    messages = [r.getMessage() for r in caplog.records]
    assert 'resumed from checkpoint at step 2' in messages
    assert _losses(caplog) == {k: straight[k] for k in (3, 4, 5)}
    assert sorted(p.name for p in (tmp_path / 'ckpt').iterdir()) == \
        ['1', '2', '4']


@pytest.mark.parametrize('extra, match', [
    (['--tp', '2'], 'one device'),
    (['--dp', '2', '--fsdp', '1'], 'one device'),
    (['--model', 'moe-tiny'], 'MoE'),
])
def test_run_refuses_what_is_not_ported(extra, match):
    with pytest.raises(SystemExit, match=match):
        run.main(ARGS + ['--steps', '1'] + extra)


def test_run_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='--device cpu'):
        run.main(['--model', 'llama-tiny', '--steps', '1'])


def test_bench_refuses_without_cuda_and_knows_its_peak(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        bench.main([])
    assert bench.peak_tflops('NVIDIA H100 80GB HBM3') == 989.0
    with pytest.raises(ValueError, match='no bf16 peak'):
        bench.peak_tflops('Some Other Card')


def test_bench_measure_runs_the_training_path():
    """The measuring loop on the CPU: plain versions, so every kernel
    counter stays at 0; finite loss; the counters are per timed step."""
    cfg = llama.LlamaConfig.tiny(attention_impl='flash', fused_loss=True,
                                 max_seq_len=32)
    r = bench.measure(cfg, 2, 32, 'cpu', steps=2, warmup=1)
    assert r['steps'] == 2 and r['seconds'] > 0
    assert torch.isfinite(torch.tensor(r['loss']))
    assert set(r['launches_per_step']) == {
        'flash_attention_fwd', 'flash_attention_bwd_dq',
        'flash_attention_bwd_dkv', 'fused_cross_entropy_fwd'}
    assert all(v == 0 for v in r['launches'].values())
    json.dumps(r)
