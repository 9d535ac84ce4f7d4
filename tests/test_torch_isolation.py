"""The port stands alone: importing every module of ``skypilot_tpu_torch``
(the observability copies, the serving sweep, the dense cache and the
prefix cache's copies of ``prefix_hash``, ``kv_wire`` and ``prefix_cache``,
the tensor-parallel ``parallel/`` and the lockstep ``infer/multihost``,
the ResNet DDP path, the chip lock, the trace generator ``utils.loadgen``,
ring attention, the GPipe pipeline and the MoE included) and
``chip_smoke.py``, which drives it on the card, loads neither JAX nor any
module of the JAX package. Checked in a fresh interpreter, since
this test process has both loaded."""
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

PROBE = r'''
import importlib, pkgutil, sys
import skypilot_tpu_torch
names = ['skypilot_tpu_torch'] + [
    m.name for m in pkgutil.walk_packages(skypilot_tpu_torch.__path__,
                                          'skypilot_tpu_torch.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))
             or m == 'skypilot_tpu' or m.startswith('skypilot_tpu.'))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 50, names
assert {'skypilot_tpu_torch.infer.sched.' + m
        for m in ('base', 'deadline', 'wfq')} <= set(names), names
assert ({'skypilot_tpu_torch.observability.' + m
         for m in ('prometheus', 'render', 'stepline', 'store')}
        | {'skypilot_tpu_torch.bench_ttft'}) <= set(names), names
assert {'skypilot_tpu_torch.utils.prefix_hash',
        'skypilot_tpu_torch.infer.kv_wire',
        'skypilot_tpu_torch.infer.prefix_cache',
        'skypilot_tpu_torch.infer.cache'} <= set(names), names
assert {'skypilot_tpu_torch.ops.quant',
        'skypilot_tpu_torch.train.checkpoint'} <= set(names), names
assert {'skypilot_tpu_torch.parallel.' + m
        for m in ('mesh', 'sharding', 'collectives')} \
    | {'skypilot_tpu_torch.infer.multihost'} <= set(names), names
assert {'skypilot_tpu_torch.models.resnet',
        'skypilot_tpu_torch.train.run_vision',
        'skypilot_tpu_torch.utils.locks',
        'skypilot_tpu_torch.utils.loadgen'} <= set(names), names
assert {'skypilot_tpu_torch.ops.ring_attention',
        'skypilot_tpu_torch.parallel.pipeline',
        'skypilot_tpu_torch.models.moe'} <= set(names), names
'''


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    out = subprocess.run([sys.executable, '-c', PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith('[]')
