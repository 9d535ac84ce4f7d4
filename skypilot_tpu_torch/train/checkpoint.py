"""Checkpointing for the managed-jobs checkpoint/resume convention
(counterpart of ``skypilot_tpu/train/checkpoint.py``).

The reference writes Orbax checkpoints into a directory (typically a
mounted bucket) and ``restore_or_init`` is what recovered jobs call on
startup. Here a checkpoint is ``torch.save`` of the state into
``<dir>/<step>/state.pt``, written under a temporary name and renamed,
so a reader never sees a half-written step. Orbax's on-disk format is
not carried across: the port reads only its own checkpoints. Saves are
synchronous, so ``wait`` and ``close`` have nothing left to do.

``save`` keeps Orbax's decision rule: a step at or below the latest
saved one is skipped, a step on the ``save_interval_steps`` grid is
saved, and so is the first save of a manager with no checkpoints;
``force`` saves regardless (an existing step raises). Beyond
``max_to_keep`` the oldest steps are deleted.

``restore_to_host`` (the int8 serving path's restore) waits for the
port of that path (ROADMAP.md queue 1 item 10).
"""
from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, List, Optional

import torch

DEFAULT_CHECKPOINT_DIR_ENV = 'SKY_TPU_CHECKPOINT_DIR'
_FILE = 'state.pt'


def _to(tree, fn):
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _to(getattr(tree, f.name), fn)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    return fn(tree)


def _onto(saved, target):
    """``saved`` with every tensor moved to the device of the matching
    leaf of ``target``; shapes and dtypes must agree."""
    if dataclasses.is_dataclass(target) and not isinstance(target, type):
        return dataclasses.replace(target, **{
            f.name: _onto(getattr(saved, f.name), getattr(target, f.name))
            for f in dataclasses.fields(target)})
    if isinstance(target, dict):
        if set(saved) != set(target):
            raise ValueError(f'checkpoint keys {sorted(saved)} do not match '
                             f'the target {sorted(target)}')
        return {k: _onto(saved[k], target[k]) for k in target}
    if isinstance(target, torch.Tensor):
        if saved.shape != target.shape or saved.dtype != target.dtype:
            raise ValueError(f'checkpoint leaf {tuple(saved.shape)} '
                             f'{saved.dtype} does not match the target '
                             f'{tuple(target.shape)} {target.dtype}')
        return saved.to(target.device)
    return saved


class CheckpointManager:
    """Synchronous ``torch.save`` checkpoints, one directory per step."""

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        self.directory = os.path.abspath(os.path.expanduser(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps

    def all_steps(self) -> List[int]:
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.exists(
                          os.path.join(self.directory, name, _FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        steps = self.all_steps()
        if steps and steps[-1] >= step:
            return False
        return step % self.save_interval_steps == 0 or not steps

    def save(self, step: int, state: Any, *, force: bool = False) -> bool:
        if not force and not self.should_save(step):
            return False
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final):
            raise ValueError(f'Checkpoint for step {step} already exists.')
        tmp = os.path.join(self.directory, f'.{step}.tmp-{os.getpid()}')
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        host = _to(state, lambda t: t.detach().cpu()
                   if isinstance(t, torch.Tensor) else t)
        torch.save(host, os.path.join(tmp, _FILE))
        os.replace(tmp, final)
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def restore(self, step: Optional[int] = None,
                target: Optional[Any] = None) -> Any:
        """The state saved at ``step`` (default the latest): on the CPU,
        or, given ``target``, on the devices of its leaves (whose shapes
        and dtypes must match)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(
                f'No checkpoint under {self.directory}')
        saved = torch.load(os.path.join(self.directory, str(step), _FILE),
                           map_location='cpu', weights_only=False)
        return saved if target is None else _onto(saved, target)

    def wait(self) -> None:
        """Saves are synchronous: nothing is pending."""

    def close(self) -> None:
        """Nothing to release."""


def restore_or_init(directory: str, init_fn, *,
                    target: Optional[Any] = None) -> tuple:
    """The resume convention: restore the latest checkpoint if one exists,
    else initialize fresh. Returns (state, restored: bool)."""
    mgr = CheckpointManager(directory)
    step = mgr.latest_step()
    if step is None:
        return init_fn(), False
    state = mgr.restore(step, target=target if target is not None
                        else init_fn())
    return state, True
