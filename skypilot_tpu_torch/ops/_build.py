"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``. Builds happen at first use (or all together, in parallel,
through :func:`build`) into ``skypilot_tpu_torch/_build/``, which
``.gitignore`` lists. A library's file name carries a hash of its source
and flags, so an edited kernel is rebuilt and an unchanged one is loaded
as it is; the compiler's ``-Xptxas -v`` report (registers, shared
memory, spills) lands beside it as ``<name>-<hash>.log``.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List

SRC_DIR = pathlib.Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class BuildError(RuntimeError):
    pass


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise BuildError('nvcc not found (on PATH or /usr/local/cuda/bin); '
                         'the CUDA kernels build only where the CUDA '
                         'toolkit is installed')
    return path


def _target(name: str) -> pathlib.Path:
    src = (SRC_DIR / f'{name}.cu').read_bytes()
    digest = hashlib.sha1(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'{name}-{digest[:12]}.so'


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named kernel source that has no current library,
    one ``nvcc`` process per source, all started together. Returns the
    wall seconds each compile took (0.0 for one already built). Raises
    :class:`BuildError` with the compiler's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    seconds: Dict[str, float] = {}
    for name in names:
        out = _target(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        # Compile to a private name and rename: a concurrent process
        # loading the library never sees a half-written file.
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
               str(SRC_DIR / f'{name}.cu')]
        procs.append((name, out, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)))
    errors: List[str] = []
    for name, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix('.log').write_bytes(log)
        if proc.returncode != 0:
            errors.append(f'{name}: nvcc exited {proc.returncode}\n'
                          f'{log.decode(errors="replace")}')
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    if errors:
        raise BuildError('\n'.join(errors))
    return seconds


def build_log(name: str) -> str:
    """The compiler's report for the current build of ``name``."""
    path = _target(name).with_suffix('.log')
    return path.read_text(errors='replace') if path.exists() else ''


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib
