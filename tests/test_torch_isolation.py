"""The port stands alone: importing every module of ``skypilot_tpu_torch``
(and ``chip_smoke.py``, which drives it on the card) loads neither JAX
nor any module of the JAX package. Checked in a fresh interpreter, since
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
assert len(names) >= 14, names
'''


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    out = subprocess.run([sys.executable, '-c', PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith('[]')
