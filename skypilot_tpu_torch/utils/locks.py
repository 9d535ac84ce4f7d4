"""The machine-wide chip lock (counterpart of ``chip_lock`` and
``acquire_chip_lock`` in ``skypilot_tpu/utils/locks.py``).

Benches hold it for their measured section, so two never measure the one
card at once, and the test session try-acquires it at startup so that a
bench launched mid-suite waits instead of measuring noise. The path and
its environment override are the reference's, so the port's benches and
the reference's contend for one lock. It lives at a fixed machine-wide
path, not under ``SKY_TPU_HOME``: benches and the tests run with other
homes. ``filelock`` (a dependency of torch) backs it with ``flock``, so a
crashed holder's lock dies with its process.
"""
from __future__ import annotations

import os
import sys
import tempfile

import filelock

CHIP_LOCK_ENV = 'SKY_TPU_CHIP_LOCK'


def chip_lock_path() -> str:
    return (os.environ.get(CHIP_LOCK_ENV) or
            os.path.join(tempfile.gettempdir(), 'sky_tpu_chip0.lock'))


def chip_lock(timeout: float = -1) -> filelock.FileLock:
    """The lock; ``timeout`` as ``filelock.FileLock``'s (-1 waits for
    ever, 0 tries once)."""
    return filelock.FileLock(chip_lock_path(), timeout=timeout)


def acquire_chip_lock(tag: str, timeout: float = 3600.0
                      ) -> filelock.FileLock:
    """Blocking acquisition for a bench: logs the wait on stderr and
    holds until the process exits (or the returned lock is released)."""
    lock = chip_lock(timeout=timeout)
    print(f'[{tag}] acquiring chip lock {chip_lock_path()}',
          file=sys.stderr)
    lock.acquire()
    return lock
