"""The port's training entry points on the CPU:
``python -m skypilot_tpu_torch.train.run`` on ``llama-tiny`` with a
checkpoint directory, then a resume that must land where an
uninterrupted run lands (bit for bit: the checkpoint holds params,
moments and counts); two-rank meshes started by the command; the
refusals (the MoE presets, CUDA without a card); and
``skypilot_tpu_torch.bench``, which refuses to run without a card while
its measuring loop runs here on the tiny config, and its chip lock.
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
    (['--tp', '2'], None),
    (['--dp', '2', '--fsdp', '1'], None),
    (['--model', 'moe-tiny'], 'MoE'),
])
def test_run_refuses_what_is_not_ported(extra, match, caplog):
    """The MoE presets exit, as in the reference; a mesh is ported: the
    command starts the other CPU rank itself and both exit 0."""
    if match is not None:
        with pytest.raises(SystemExit, match=match):
            run.main(ARGS + ['--steps', '1'] + extra)
        return
    caplog.set_level(logging.INFO)
    run.main(ARGS + ['--steps', '1'] + extra)
    messages = [r.getMessage() for r in caplog.records]
    assert 'done: 1 steps' in messages
    assert 'train-rank-1 exited 0' in messages
    assert sorted(_losses(caplog)) == [1]


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
        'flash_attention_bwd_dkv', 'fused_cross_entropy_fwd',
        'adamw_update'}
    assert all(v == 0 for v in r['launches'].values())
    json.dumps(r)


def test_chip_lock_second_holder_waits(tmp_path, monkeypatch):
    """The bench's chip lock at the reference's path and env: while
    another process holds it a second holder times out, then gets it once
    the first lets go."""
    import subprocess
    import sys

    import filelock

    from skypilot_tpu_torch.utils import locks
    path = str(tmp_path / 'chip.lock')
    monkeypatch.setenv(locks.CHIP_LOCK_ENV, path)
    assert locks.chip_lock_path() == path
    holder = subprocess.Popen(
        [sys.executable, '-c',
         'import sys, filelock; l = filelock.FileLock(sys.argv[1]); '
         'l.acquire(); print("held", flush=True); sys.stdin.readline()',
         path], stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        assert holder.stdout.readline().strip() == 'held'
        with pytest.raises(filelock.Timeout):
            locks.acquire_chip_lock('test', timeout=0.3)
    finally:
        holder.communicate('\n', timeout=30)
    lock = locks.acquire_chip_lock('test', timeout=30)
    assert lock.is_locked
    lock.release()
