"""The port's kernel build (``skypilot_tpu_torch/ops/_build.py``) on the CPU.

There is no ``nvcc`` here, so a stand-in compiler script records its
command line and writes the output file: each source is compiled once,
for ``sm_90a`` with the flags the build names, into a library whose name
changes with the source; an unchanged source is not compiled again; a
failing compile raises ``BuildError`` with the compiler's output and
leaves no library behind.
"""
import os
import stat

import pytest

from skypilot_tpu_torch.ops import _build

FAKE_NVCC = '''#!/bin/sh
echo "$@" >> "{log}"
if [ -n "{fail}" ]; then echo "error: stand-in compile failure"; exit 2; fi
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; echo built > "$1"; fi
  shift
done
echo "ptxas info    : Used 42 registers"
'''


def _fake_nvcc(tmp_path, fail=False):
    log = tmp_path / 'nvcc.log'
    script = tmp_path / ('nvcc_fail' if fail else 'nvcc')
    script.write_text(FAKE_NVCC.format(log=log, fail='1' if fail else ''))
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script), log


@pytest.fixture
def build_env(tmp_path, monkeypatch):
    src = tmp_path / 'csrc'
    src.mkdir()
    for name in ('k1', 'k2'):
        (src / f'{name}.cu').write_text(f'// kernel {name}\n')
    monkeypatch.setattr(_build, 'SRC_DIR', src)
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'out')
    return tmp_path


def test_builds_each_source_once_for_sm90a_and_caches(build_env,
                                                      monkeypatch):
    nvcc, log = _fake_nvcc(build_env)
    monkeypatch.setattr(_build, '_nvcc', lambda: nvcc)
    first = _build.build(['k1', 'k2'])
    assert set(first) == {'k1', 'k2'}
    calls = log.read_text().splitlines()
    assert len(calls) == 2
    for line in calls:
        assert 'arch=compute_90a,code=sm_90a' in line
        assert '-O3' in line and '-shared' in line and '-fPIC' in line
    for name in ('k1', 'k2'):
        lib = _build._target(name)
        assert lib.read_text() == 'built\n'
        assert 'Used 42 registers' in _build.build_log(name)
    # Unchanged sources are not compiled again.
    assert _build.build(['k1', 'k2']) == {'k1': 0.0, 'k2': 0.0}
    assert len(log.read_text().splitlines()) == 2
    # An edited source gets a new library name and one new compile.
    old = _build._target('k1')
    (_build.SRC_DIR / 'k1.cu').write_text('// kernel k1, edited\n')
    assert _build._target('k1') != old
    _build.build(['k1'])
    assert len(log.read_text().splitlines()) == 3


def test_failed_compile_raises_with_output_and_leaves_no_library(
        build_env, monkeypatch):
    nvcc, _ = _fake_nvcc(build_env, fail=True)
    monkeypatch.setattr(_build, '_nvcc', lambda: nvcc)
    with pytest.raises(_build.BuildError, match='stand-in compile failure'):
        _build.build(['k1'])
    assert not _build._target('k1').exists()
    assert not [p for p in os.listdir(_build.BUILD_DIR)
                if p.endswith(('.so', '.tmp'))]


def test_missing_nvcc_is_a_build_error(monkeypatch):
    monkeypatch.setattr(_build.shutil, 'which', lambda name: None)
    monkeypatch.setattr(_build.os.path, 'exists', lambda path: False)
    with pytest.raises(_build.BuildError, match='nvcc not found'):
        _build._nvcc()
