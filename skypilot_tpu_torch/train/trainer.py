"""Training loop pieces on one device (counterpart of
``skypilot_tpu/train/trainer.py``): ``TrainState``, the optimizer, the
train step factory and a synthetic batch.

The optimizer is the reference's optax chain written out as plain
functions on tensors, computing what optax computes:
``clip_by_global_norm(grad_clip)`` then ``adamw(b1=0.9, b2=0.95,
eps=1e-8, weight_decay, mu_dtype)`` under
``warmup_cosine_decay_schedule(0.0, lr, warmup, max(total, warmup+1))``.

- The schedule is read at the update count before it is incremented, so
  the first update uses lr 0 and leaves the params unchanged.
- Weight decay applies to every leaf (optax's ``mask=None``), norms and
  embeddings included.
- ``mu`` takes ``mu_dtype``; ``nu`` keeps the parameter dtype, as
  optax's ``tree.zeros_like(params)`` does (bf16 for bf16 params).
- The ``grad_norm`` metric is the norm before clipping.
- Params and moments are updated in place: the reference donates the
  state's buffers to its jitted step, which is the same thing. Each
  leaf's update is ``ops/adamw.py``'s: one kernel a leaf on CUDA tensors
  (the same bits as the eager chain), the eager chain on the CPU.

On a mesh (``parallel/mesh.py``'s ``TrainMesh`` of more than one rank)
each rank holds its blocks of the params and of their moments (ZeRO-3:
``parallel/sharding.py``) and steps on its rows of the batch. The step
computes what the reference's mesh step computes: the loss is the global
mean (masked: ``sum(nll * mask) / max(sum(mask), 1)`` over the global
batch); gradients of fsdp-split leaves are reduce-scattered over fsdp and
summed over dp, the others summed over dp x fsdp; the global norm, for
clipping and for ``grad_norm``, counts each element once; AdamW updates
the rank's blocks with that norm.

Each step records its phases (``step_fn.records()``: forward, backward,
the mesh's gradient sync, the optimizer) between CUDA events that are
read only once a wait the step makes anyway has passed them, so the
records add no host sync; on the CPU the phases are host intervals.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.observability import stepline as stepline_lib
from skypilot_tpu_torch.ops import adamw as adamw_lib
from skypilot_tpu_torch.parallel import sharding as sharding_lib
from skypilot_tpu_torch.parallel.mesh import TrainMesh


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor        # int32 scalar
    params: Any
    opt_state: Any


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k])]
    return [tree]


def _map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax's ``chain(clip_by_global_norm, adamw)`` under a warmup +
    cosine schedule. ``init`` builds the state; ``update`` applies one
    step to the params in place and returns the pre-clip gradient
    norm."""
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0
    mu_dtype: Optional[str] = None
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8

    def schedule(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(0, lr, warmup,
        max(total, warmup + 1)) at ``count``, in float32 operation by
        operation as optax computes it (the warmup's ``-lr * frac + lr``
        cancels, so the rounding shows)."""
        f32 = np.float32
        lr, warmup = self.learning_rate, self.warmup_steps
        if count < warmup:
            frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
            return float(f32(0.0 - lr) * frac + f32(lr))
        decay = f32(max(self.total_steps, warmup + 1) - warmup)
        c = min(f32(count - warmup), decay)
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / decay))
        return float(f32(lr) * cosine)

    def init(self, params) -> Dict[str, Any]:
        mu_dtype = llama.torch_dtype(self.mu_dtype) if self.mu_dtype \
            else None
        return {
            # One count serves Adam's bias correction and the schedule:
            # optax keeps two, always equal.
            'count': torch.zeros((), dtype=torch.int32),
            'mu': _map(lambda p: torch.zeros_like(p, dtype=mu_dtype),
                       params),
            'nu': _map(torch.zeros_like, params),
        }

    @torch.no_grad()
    def update(self, grads, opt_state, params,
               g_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``g_norm``: the whole gradient's norm where ``grads`` are a
        mesh rank's blocks (``sharding.global_norm``); computed from
        ``grads`` when None."""
        leaves = _leaves(grads)
        if g_norm is None:
            # optax.global_norm: sqrt of the sum of the squares of all
            # leaves.
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in leaves))
        clip = not bool(g_norm < self.grad_clip)
        count = int(opt_state['count'])
        count_inc = count + 1
        # Bias corrections in fp32 (optax: 1 - decay**count), then cast
        # to each moment's dtype for the division.
        f32 = torch.float32
        bc1 = 1 - torch.tensor(self.b1, dtype=f32) ** count_inc
        bc2 = 1 - torch.tensor(self.b2, dtype=f32) ** count_inc
        step_size = torch.tensor(-self.schedule(count), dtype=f32)
        for g, mu, nu, p in zip(leaves, _leaves(opt_state['mu']),
                                _leaves(opt_state['nu']), _leaves(params)):
            adamw_lib.adamw_update(
                g, mu, nu, p, g_norm, clip, bc1, bc2, step_size,
                b1=self.b1, b2=self.b2, eps=self.eps,
                weight_decay=self.weight_decay, grad_clip=self.grad_clip)
        opt_state['count'] = torch.tensor(count_inc, dtype=torch.int32)
        return g_norm


def make_optimizer(learning_rate: float = 3e-4,
                   weight_decay: float = 0.1,
                   warmup_steps: int = 100,
                   total_steps: int = 10_000,
                   grad_clip: float = 1.0,
                   mu_dtype: Optional[str] = None) -> AdamW:
    """AdamW + cosine schedule. ``mu_dtype='bfloat16'`` halves the
    first-moment memory; ``nu`` stays in the parameter dtype."""
    return AdamW(learning_rate=learning_rate, weight_decay=weight_decay,
                 warmup_steps=warmup_steps, total_steps=total_steps,
                 grad_clip=grad_clip, mu_dtype=mu_dtype)


def init_train_state(config: llama.LlamaConfig, generator: torch.Generator,
                     optimizer: AdamW, device='cpu',
                     mesh: Optional[TrainMesh] = None) -> TrainState:
    """The fresh state. On a mesh of more than one rank each leaf is
    drawn whole with the one-device generator sequence and the rank keeps
    its block, so a mesh run starts from the one-device run's params."""
    keep = None
    if mesh is not None and mesh.size > 1:
        def keep(path, leaf):
            return sharding_lib.shard_for(path, leaf, mesh)
    params = llama.init_params(config, generator, device, keep=keep)
    return TrainState(step=torch.zeros((), dtype=torch.int32),
                      params=params, opt_state=optimizer.init(params))


def _paths(tree, prefix=()) -> list:
    if isinstance(tree, dict):
        return [p for k in tree for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


def shard_train_state(state: TrainState, mesh: TrainMesh) -> TrainState:
    """This rank's blocks of a whole state: params and moments alike
    (ZeRO-3); the counts stay whole."""
    if mesh.size == 1:
        return state
    opt = dict(state.opt_state)
    for k in ('mu', 'nu'):
        opt[k] = sharding_lib.shard_train_tree(opt[k], mesh)
    return TrainState(step=state.step,
                      params=sharding_lib.shard_train_tree(state.params,
                                                           mesh),
                      opt_state=opt)


def gather_train_state(state: TrainState, mesh: TrainMesh,
                       alloc: Callable) -> Optional[TrainState]:
    """The whole state from every rank's blocks on rank 0's host, each
    whole leaf from ``alloc(shape, dtype)``; None on the other ranks (a
    collective: every rank calls it). The blocks reach rank 0 a piece at
    a time (``sharding.gather_to_first``); the counts stay as they
    are."""
    def whole(tree):
        return sharding_lib.gather_to_first(tree, mesh, alloc)
    params = whole(state.params)
    opt = dict(state.opt_state)
    for k in ('mu', 'nu'):
        opt[k] = whole(opt[k])
    if mesh.rank != 0:
        return None
    return TrainState(step=state.step, params=params, opt_state=opt)


def make_train_step(config: llama.LlamaConfig, optimizer: AdamW,
                    mesh: Optional[TrainMesh] = None):
    """Returns ``step(state, batch) -> (state, metrics)``.

    batch: {'tokens': [b, s] int, 'targets': [b, s] int,
            'mask': optional [b, s]}. The state's params and moments
    are updated in place and the same state comes back with its step
    advanced. On a mesh of more than one rank the state holds the rank's
    blocks (:func:`init_train_state` or :func:`shard_train_state`) and
    the batch is the rank's rows (``sharding.batch_rows``); the metrics
    are the global ones, the same on every rank.

    ``step.records()`` returns a ``stepline.TrainStepRecord`` dict a
    step, oldest first (the ring keeps the last ``stepline.default_cap()``
    steps). A step's record is appended once its events are read: after
    the next step's optimizer has read the gradient norm on the host, or
    by ``records()``, which waits for the last step's optimizer to end
    where it has not."""
    if mesh is not None and mesh.size > 1:
        sharding_lib.check_divisible(config, mesh.shape.tp, mesh.shape.fsdp)
        shard = sharding_lib.RankOps(mesh)
    else:
        mesh = shard = None
    ring = stepline_lib.Ring(stepline_lib.default_cap())
    # The last step's (idx, t, dur_s, marks), its optimizer end unread.
    pending: List[tuple] = []

    def mark(cuda: bool):
        if not cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def append_pending() -> None:
        idx, t, dur, marks = pending.pop()
        if isinstance(marks[0], float):
            secs = [b - a for a, b in zip(marks, marks[1:])]
        else:
            secs = [a.elapsed_time(b) / 1e3 for a, b in zip(marks,
                                                            marks[1:])]
        forward, backward, *sync, opt = secs
        ring.append(stepline_lib.TrainStepRecord(
            idx=idx, t=t, dur_s=dur, forward=forward, backward=backward,
            grad_sync=sync[0] if sync else None, optimizer=opt))

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]
                ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        t_wall, t0 = time.time(), time.perf_counter()
        leaves = _leaves(state.params)
        cuda = leaves[0].is_cuda
        marks = [mark(cuda)]
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = llama.loss_fn(config, state.params, batch['tokens'],
                                 batch['targets'], batch.get('mask'),
                                 shard=shard)
            marks.append(mark(cuda))
            grads = list(torch.autograd.grad(loss, leaves))
            marks.append(mark(cuda))
        finally:
            for p in leaves:
                p.requires_grad_(False)
        g_norm = None
        loss = loss.detach()
        if mesh is not None:
            paths = _paths(state.params)
            grads = [sharding_lib.reduce_grad(path, g, mesh)
                     for path, g in zip(paths, grads)]
            g_norm = sharding_lib.global_norm(paths, grads, mesh)
            loss = shard.data_sum(loss)
            marks.append(mark(cuda))
        grad_tree = _unflatten(state.params, grads)
        g_norm = optimizer.update(grad_tree, state.opt_state, state.params,
                                  g_norm)
        marks.append(mark(cuda))
        # The update read the norm on the host: every event recorded
        # before it, the last step's optimizer end included, is complete.
        if pending:
            append_pending()
        state.step = state.step + 1
        pending.append((ring.total, t_wall, time.perf_counter() - t0,
                        marks))
        if not cuda:
            append_pending()
        metrics = {'loss': loss, 'grad_norm': g_norm, 'step': state.step}
        return state, metrics

    def records() -> List[Dict[str, Any]]:
        if pending:
            end = pending[0][3][-1]
            if not end.query():
                end.synchronize()
            append_pending()
        return [r.as_dict() for r in ring.snapshot()]

    step_fn.records = records
    return step_fn


def _unflatten(like, leaves: list):
    it = iter(leaves)
    return _map(lambda _: next(it), like)


def synthetic_batch(config: llama.LlamaConfig, batch_size: int,
                    seq_len: int, generator: torch.Generator,
                    device='cpu') -> Dict[str, torch.Tensor]:
    """Uniform random tokens (from ``generator``, which lives on
    ``device``); targets are the tokens shifted by one."""
    tokens = torch.randint(0, config.vocab_size, (batch_size, seq_len + 1),
                           generator=generator, dtype=torch.int32,
                           device=device)
    return {'tokens': tokens[:, :-1], 'targets': tokens[:, 1:]}
