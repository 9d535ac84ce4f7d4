"""What a chip run loads holds no JAX and no JAX package (top-level names
compared whole), and the plain reference loads nothing of the port."""
from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys

from perfbench import run as run_lib

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def _loaded(code: str):
    out = subprocess.run([sys.executable, '-c', code + (
        '\nimport sys, json\nprint(json.dumps(sorted(sys.modules)))')],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300,
        env={'PATH': '/usr/bin:/bin', 'PYTHONPATH': str(ROOT),
             'USE_FLAX': '0'})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_chip_run_loads_no_jax():
    mods = _loaded(
        'import perfbench.run, perfbench.serve_cell, perfbench.train_cell, '
        'perfbench.check_serve, perfbench.check_train, perfbench.knee, '
        'perfbench.trace, perfbench.model, perfbench.reference.llama\n'
        'from perfbench import serve_child\n'
        'from skypilot_tpu_torch.infer import engine, server\n'
        'from skypilot_tpu_torch.train import trainer\n'
        'from skypilot_tpu_torch.ops import _build')
    assert 'skypilot_tpu_torch.infer.server' in mods
    bad = [m for m in mods if m.split('.', 1)[0] in run_lib.FORBIDDEN]
    assert bad == []


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'skypilot_tpu_torch_extra', object())
    assert run_lib.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'skypilot_tpu.fake', object())
    assert run_lib.forbidden_modules() == ['skypilot_tpu.fake']


def test_the_reference_loads_nothing_of_the_port():
    mods = _loaded('import perfbench.reference.llama, perfbench.weights')
    assert not [m for m in mods
                if m.split('.', 1)[0] in ('skypilot_tpu_torch',
                                          'skypilot_tpu', 'jax')]
    for path in (HERE / 'reference').glob('*.py'):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split('.', 1)[0] not in (
                    'skypilot_tpu_torch', 'skypilot_tpu', 'jax'), path
