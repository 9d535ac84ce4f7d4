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

``restore_to_host`` is the int8 serving path's restore: the saved tree on
the host, whatever device it was saved from, for
``ops/quant.quantize_params(params, device)`` to quantize onto the card
leaf by leaf.

A mesh run saves what the reference saves, ``jax.device_get(state)``:
the whole tree. In :func:`save_mesh` the ranks send their blocks to
rank 0 a piece at a time and rank 0 writes today's format;
:func:`restore_or_init_mesh` has every rank read the whole tree
(memory-mapped, so the ranks of a host share its pages) and keep its
blocks. A checkpoint therefore moves freely
between meshes, to one device, and to the serving ``--checkpoint`` path.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os
import shutil
from typing import Any, List, Optional

import torch
import torch.distributed as dist

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
    leaf of ``target`` (whose tree :func:`check_like` held it to)."""
    if dataclasses.is_dataclass(target) and not isinstance(target, type):
        return dataclasses.replace(target, **{
            f.name: _onto(getattr(saved, f.name), getattr(target, f.name))
            for f in dataclasses.fields(target)})
    if isinstance(target, dict):
        return {k: _onto(saved[k], target[k]) for k in target}
    if isinstance(target, torch.Tensor):
        return saved.to(target.device)
    return saved


def check_like(saved, target) -> None:
    """Raise ValueError unless ``saved`` has ``target``'s tree (dict keys
    and dataclass fields) and every tensor leaf its shape and dtype; the
    target's leaves may lie on any device, ``'meta'`` included."""
    if dataclasses.is_dataclass(target) and not isinstance(target, type):
        for f in dataclasses.fields(target):
            check_like(getattr(saved, f.name), getattr(target, f.name))
    elif isinstance(target, dict):
        keys = sorted(saved) if isinstance(saved, dict) else saved
        if keys != sorted(target):
            raise ValueError(f'checkpoint keys {keys} do not match the '
                             f'target {sorted(target)}')
        for k in target:
            check_like(saved[k], target[k])
    elif isinstance(target, torch.Tensor):
        if not isinstance(saved, torch.Tensor) \
                or saved.shape != target.shape or saved.dtype != target.dtype:
            got = (f'{tuple(saved.shape)} {saved.dtype}'
                   if isinstance(saved, torch.Tensor) else repr(saved))
            raise ValueError(f'checkpoint leaf {got} does not match the '
                             f'target {tuple(target.shape)} {target.dtype}')


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
        if target is None:
            return saved
        check_like(saved, target)
        return _onto(saved, target)

    def restore_to_host(self, target: Optional[Any] = None,
                        step: Optional[int] = None) -> Any:
        """The state saved at ``step`` (default the latest) on the CPU,
        whatever device it was saved from, never on the card: an 8B bf16
        checkpoint (16 GB) must not land whole on the card it is being
        quantized for. ``target`` (a tree of tensors on any device,
        ``'meta'`` included) checks the saved tree's structure, shapes
        and dtypes without moving anything."""
        saved = self.restore(step)
        if target is not None:
            check_like(saved, target)
        return saved

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


def _broadcast_int(value: int, mesh) -> int:
    """Rank 0's ``value`` on every rank of the mesh's world."""
    t = torch.tensor([value], dtype=torch.int64)
    dist.broadcast(t, src=0, group=mesh.host_pg)
    return int(t[0])


def _file_backed(directory: str):
    """An ``alloc`` for ``trainer.gather_train_state`` whose every whole
    leaf is a shared mapping of its own file under ``directory``: the
    host holds page cache the kernel can write back and drop, not the
    whole state in anonymous memory."""
    names = itertools.count()

    def alloc(shape, dtype):
        path = os.path.join(directory, f'{next(names)}.bin')
        return torch.from_file(path, shared=True, size=math.prod(shape),
                               dtype=dtype).view(shape)
    return alloc


def save_mesh(mgr: CheckpointManager, step: int, state: Any,
              mesh) -> bool:
    """A mesh run's save; every rank calls it. Rank 0's ``should_save``
    decides for all. Then the ranks at dp 0 send their blocks to rank 0 a
    piece at a time (``trainer.gather_train_state``), which copies each
    into whole leaves mapped from files beside the step's directory,
    writes them in the one-device format and deletes the files: the
    state crosses the disk twice, and no rank holds a whole leaf in
    memory. One rank: :meth:`CheckpointManager.save`."""
    if mesh.size == 1:
        return mgr.save(step, state)
    from skypilot_tpu_torch.train import trainer
    go = mgr.should_save(step) if mesh.rank == 0 else False
    if not _broadcast_int(int(go), mesh):
        return False
    parts = None
    if mesh.rank == 0:
        parts = os.path.join(mgr.directory, f'.{step}.parts-{os.getpid()}')
        shutil.rmtree(parts, ignore_errors=True)
        os.makedirs(parts)
    try:
        whole = trainer.gather_train_state(
            state, mesh, _file_backed(parts) if parts else None)
        if mesh.rank == 0:
            mgr.save(step, whole, force=True)
            del whole
    finally:
        if parts:
            shutil.rmtree(parts, ignore_errors=True)
    dist.barrier(group=mesh.host_pg)
    return True


def restore_or_init_mesh(directory: str, init_fn, mesh, target: Any,
                         device) -> tuple:
    """The resume convention on a mesh rank: with a checkpoint (rank 0's
    latest step, for all), the whole saved state checked against
    ``target`` (the whole state's tree, ``'meta'`` leaves allowed) and
    this rank's blocks of it on ``device``; else ``init_fn()``. Returns
    (state, restored: bool)."""
    from skypilot_tpu_torch.train import trainer
    mgr = CheckpointManager(directory)
    latest = mgr.latest_step() if mesh.rank == 0 else None
    step = _broadcast_int(-1 if latest is None else latest, mesh)
    if step < 0:
        return init_fn(), False
    saved = torch.load(os.path.join(mgr.directory, str(step), _FILE),
                       map_location='cpu', weights_only=False, mmap=True)
    check_like(saved, target)
    state = trainer.shard_train_state(saved, mesh)
    opt = dict(state.opt_state)
    for k in ('mu', 'nu'):
        opt[k] = _to(opt[k], lambda t: t.to(device))
    return trainer.TrainState(step=state.step,
                              params=_to(state.params,
                                         lambda t: t.to(device)),
                              opt_state=opt), True
