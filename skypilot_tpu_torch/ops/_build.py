"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``. Builds happen at first use (or all together, in parallel,
through :func:`build`) into ``skypilot_tpu_torch/_build/``, which
``.gitignore`` lists, or into the directory :func:`set_build_dir` names
(the replica's ``--compile-cache-dir``: a relaunched replica finds its
libraries there and runs no ``nvcc``). A library's file name carries a
hash of its source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited kernel or
header is rebuilt and an unchanged one is loaded as it is; the
compiler's ``-Xptxas -v`` report (registers, shared memory, spills)
lands beside it as ``<name>-<hash>.log``. The flash kernels' TMA tensor
maps come from the driver through ``cudaGetDriverEntryPoint`` at run
time, so no library links ``-lcuda``.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine without ``nvcc``.
"""
from __future__ import annotations

import concurrent.futures
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

# Every kernel source of the port (csrc/<name>.cu): the paged attention
# and the int8-weight product of the serving path, then the flash
# attention forward/backward, the fused cross-entropy forward and the
# AdamW update of the training path.
SOURCES = ('paged_decode', 'paged_prefill', 'qdot_int8', 'flash_fwd',
           'flash_bwd', 'ce_fwd', 'adamw')

_libs: Dict[str, ctypes.CDLL] = {}
# Wall seconds of each compile this process ran, by source name: what a
# cold replica boot spent in nvcc (0 sources on a warm boot).
compiled: Dict[str, float] = {}
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


def set_build_dir(path) -> pathlib.Path:
    """Build into and load from ``path`` instead of the default
    ``_build/``. Refuses (RuntimeError) once a library is loaded: a
    process serves one build directory. Returns the resolved path."""
    global BUILD_DIR
    path = pathlib.Path(path).expanduser().resolve()
    with _lock:
        if _libs and path != BUILD_DIR:
            raise RuntimeError(
                f'kernel libraries are already loaded from {BUILD_DIR} '
                f'({", ".join(sorted(_libs))}); the build directory can '
                f'only move before the first kernel launch')
        BUILD_DIR = path
    return path


def library_path(name: str) -> pathlib.Path:
    """Where the current build of ``csrc/<name>.cu`` lies (or will): its
    name hashes the source, every shared header (``csrc/*.cuh``, which
    any source may include) and the flags."""
    digest = hashlib.sha1((SRC_DIR / f'{name}.cu').read_bytes())
    for header in sorted(SRC_DIR.glob('*.cuh')):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'{name}-{digest.hexdigest()[:12]}.so'


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named kernel source (default: all of them) that
    has no current library, one ``nvcc`` process per source, all
    started together. Returns the
    wall seconds each compile took (0.0 for one already built). Raises
    :class:`BuildError` with the compiler's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    seconds: Dict[str, float] = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        # Compile to a private name and rename: a concurrent process
        # loading the library never sees a half-written file.
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
               str(SRC_DIR / f'{name}.cu')]
        procs.append((name, out, tmp,
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)))

    def finish(proc):
        """The compiler's output and its own wall seconds (each compile
        is drained on its own thread: waiting in turn would time a quick
        one by the slow one before it)."""
        log, _ = proc.communicate()
        return log, time.perf_counter() - t0
    with concurrent.futures.ThreadPoolExecutor(max(1, len(procs))) as pool:
        done = list(pool.map(finish, [p[-1] for p in procs]))
    errors: List[str] = []
    for (name, out, tmp, proc), (log, secs) in zip(procs, done):
        seconds[name] = compiled[name] = secs
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
    path = library_path(name).with_suffix('.log')
    return path.read_text(errors='replace') if path.exists() else ''


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
