"""AdamW's update of one leaf (``train/trainer.py``'s ``AdamW.update``).

The reference's update is optax's ``chain(clip_by_global_norm, adamw)``
under XLA, which fuses it; no Pallas kernel. Eagerly it is a chain of
some 21 elementwise ops a leaf, each reading and writing whole leaves.

- :func:`adamw_update_reference`: that chain in plain torch, updating
  ``mu``, ``nu`` and ``p`` in place.
- :func:`adamw_update`: the plain version on CPU tensors; on CUDA tensors
  it launches ``csrc/adamw.cu``, which reads g, mu, nu and p once and
  writes mu, nu and p once, with the same bits as the chain on the card
  (every intermediate rounded to the dtype the eager op gives, in the
  eager order). It takes params of fp32 or bf16 with g and nu of the
  params' dtype and mu of fp32 or bf16, all contiguous, else raises.

The wrapper adds one to ``launches['adamw_update']`` where it launches
its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

launches: Dict[str, int] = {'adamw_update': 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# The kernel's dtype codes.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def adamw_update_reference(g: torch.Tensor, mu: torch.Tensor,
                           nu: torch.Tensor, p: torch.Tensor,
                           g_norm: Optional[torch.Tensor], clip: bool,
                           bc1: torch.Tensor, bc2: torch.Tensor,
                           step_size: torch.Tensor, *, b1: float, b2: float,
                           eps: float, weight_decay: float,
                           grad_clip: float) -> None:
    """One leaf's clipped AdamW step in place (mu, nu, p). ``bc1``,
    ``bc2``: the fp32 bias corrections ``1 - b**count``; ``step_size``:
    minus the learning rate, fp32; all three 0-d CPU tensors."""
    if clip:
        g = (g / g_norm.to(g.dtype)) * grad_clip
    mu_new = (1 - b1) * g + b1 * mu
    nu.copy_((1 - b2) * g ** 2 + b2 * nu)
    mu_hat = mu_new / bc1.to(mu_new.dtype)
    nu_hat = nu / bc2.to(nu.dtype)
    u = mu_hat / (torch.sqrt(nu_hat) + eps)
    u = u + weight_decay * p
    u = step_size.to(u.dtype) * u
    mu.copy_(mu_new)
    p.copy_(p + u)


# p and mu dtype codes; g, mu, nu, p, g_norm; n; clip; grad_clip,
# 1 - b1, b1, 1 - b2, b2, bc1, bc2, eps, weight_decay, step_size; the
# stream.
_SIGNATURE = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
              + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_float] * 10
              + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, its library built and bound on first use."""
    from skypilot_tpu_torch.ops import _build
    fn = _build.library('adamw').adamw_update
    fn.argtypes = _SIGNATURE
    fn.restype = ctypes.c_int
    return fn


def _check_args(g, mu, nu, p) -> None:
    """Raise unless g, mu, nu and p are one leaf's: one shape and one
    device, g and nu of p's dtype."""
    if not (g.shape == mu.shape == nu.shape == p.shape):
        raise ValueError(f'adamw_update: g, mu, nu and p must share one '
                         f'shape, got {tuple(g.shape)}, {tuple(mu.shape)}, '
                         f'{tuple(nu.shape)}, {tuple(p.shape)}')
    if not (g.device == mu.device == nu.device == p.device):
        raise ValueError('adamw_update: g, mu, nu and p must share one '
                         'device')
    if g.dtype != p.dtype or nu.dtype != p.dtype:
        raise TypeError(f'adamw_update: g and nu must take the params\' '
                        f'dtype {p.dtype}, got {g.dtype}, {nu.dtype}')


def adamw_update(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                 p: torch.Tensor, g_norm: Optional[torch.Tensor],
                 clip: bool, bc1: torch.Tensor, bc2: torch.Tensor,
                 step_size: torch.Tensor, *, b1: float, b2: float,
                 eps: float, weight_decay: float, grad_clip: float) -> None:
    """:func:`adamw_update_reference`: the plain version on CPU tensors,
    the ``adamw`` kernel on CUDA tensors (``g_norm`` on the same card
    where ``clip``)."""
    _check_args(g, mu, nu, p)
    hyper = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                 grad_clip=grad_clip)
    if p.device.type == 'cpu':
        adamw_update_reference(g, mu, nu, p, g_norm, clip, bc1, bc2,
                               step_size, **hyper)
        return
    name = 'adamw_update'
    if p.device.type != 'cuda':
        raise ValueError(f'{name}: tensors on {p.device}, not CPU or CUDA')
    if p.dtype not in _DTYPES or mu.dtype not in _DTYPES:
        raise TypeError(f'{name}: the CUDA kernel takes fp32 or bf16 params '
                        f'and mu, got {p.dtype}, {mu.dtype}')
    if not all(t.is_contiguous() for t in (g, mu, nu, p)):
        raise ValueError(f'{name}: g, mu, nu and p must be contiguous')
    if clip and g_norm.device != p.device:
        raise ValueError(f'{name}: g_norm must lie on {p.device}, got '
                         f'{g_norm.device}')
    # The chain's dtypes: mu_new and the update take the promotion of the
    # params' and mu's dtypes, nu the params'.
    u_dtype = torch.promote_types(p.dtype, mu.dtype)
    norm = g_norm.to(p.dtype) if clip else p
    stream = torch.cuda.current_stream(p.device).cuda_stream
    err = _kernel()(
        _DTYPES[p.dtype], _DTYPES[mu.dtype], g.data_ptr(), mu.data_ptr(),
        nu.data_ptr(), p.data_ptr(), norm.data_ptr(), p.numel(), int(clip),
        grad_clip, 1 - b1, b1, 1 - b2, b2, float(bc1.to(u_dtype)),
        float(bc2.to(p.dtype)), eps, weight_decay,
        float(step_size.to(u_dtype)), stream)
    if err:
        raise RuntimeError(f'{name}: kernel launch failed with CUDA error '
                           f'{err}')
    launches[name] += 1
