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
  state's buffers to its jitted step, which is the same thing.

Sharding (a mesh of more than one device) is a later slice of the port
(ROADMAP.md queue 1, item 15).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.models import llama


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
    def update(self, grads, opt_state, params) -> torch.Tensor:
        leaves = _leaves(grads)
        # optax.global_norm: sqrt of the sum of the squares of all leaves.
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
            if clip:
                g = (g / g_norm.to(g.dtype)) * self.grad_clip
            mu_new = (1 - self.b1) * g + self.b1 * mu
            nu.copy_((1 - self.b2) * g ** 2 + self.b2 * nu)
            mu_hat = mu_new / bc1.to(mu_new.dtype)
            nu_hat = nu / bc2.to(nu.dtype)
            u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            u = u + self.weight_decay * p
            u = step_size.to(u.dtype) * u
            mu.copy_(mu_new)
            p.copy_(p + u)
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
                     optimizer: AdamW, device='cpu') -> TrainState:
    params = llama.init_params(config, generator, device)
    return TrainState(step=torch.zeros((), dtype=torch.int32),
                      params=params, opt_state=optimizer.init(params))


def make_train_step(config: llama.LlamaConfig, optimizer: AdamW,
                    mesh=None):
    """Returns ``step(state, batch) -> (state, metrics)`` on one device.

    batch: {'tokens': [b, s] int, 'targets': [b, s] int,
            'mask': optional [b, s]}. The state's params and moments
    are updated in place and the same state comes back with its step
    advanced. A mesh of more than one device raises."""
    if mesh is not None and getattr(mesh, 'size', 1) != 1:
        raise NotImplementedError(
            'the port trains on one device; sharding over a mesh is '
            'ROADMAP.md queue 1 item 15')

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]
                ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        leaves = _leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = llama.loss_fn(config, state.params, batch['tokens'],
                                 batch['targets'], batch.get('mask'))
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grad_tree = _unflatten(state.params, list(grads))
        g_norm = optimizer.update(grad_tree, state.opt_state, state.params)
        state.step = state.step + 1
        metrics = {'loss': loss.detach(), 'grad_norm': g_norm,
                   'step': state.step}
        return state, metrics

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
