"""Cross-entropy over a large vocabulary (counterpart of
``skypilot_tpu/ops/cross_entropy.py``).

Two ``torch.autograd.Function``s with the reference's numerics:

- ``chunked_cross_entropy``: plain torch, as the reference is plain XLA.
  The forward streams the vocabulary in chunks with an online
  logsumexp; the backward recomputes each chunk's logits and feeds the
  dX/dW products autodiff would run.
- ``fused_cross_entropy``: the forward is the reference's Pallas kernel
  (each ``[bt, bv]`` logits tile computed, folded into an online
  logsumexp and a target pick, and dropped); on CUDA tensors it launches
  ``csrc/ce_fwd.cu``, on CPU tensors it runs the plain version
  :func:`fused_forward_reference`. The backward is plain torch with one
  logits recompute, exactly the reference's ``_fused_bwd_rule``: one
  fp32 ``[T, V]`` recompute up to ``ONE_SHOT_BWD_MAX_VOCAB``, the chunked
  backward above it. Those products are outside any kernel in the
  reference too, so they are ``torch.matmul``.

The fused wrapper adds one to ``launches['fused_cross_entropy_fwd']``
where it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

# Vocab size above which the fused backward switches from the one-shot
# fp32 recompute to the chunked backward (fp32 [T, V] logits alone
# exceed 6 GB at Llama-3's 128k vocab). Module-level so tests can lower
# it.
ONE_SHOT_BWD_MAX_VOCAB = 65536

launches: Dict[str, int] = {'fused_cross_entropy_fwd': 0}

# The CUDA kernel's constraints: d a multiple of its 64-deep slice, V a
# multiple of 8 (16-byte rows); any T.
CUDA_DIM_MULTIPLE = 64
CUDA_VOCAB_MULTIPLE = 8


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# Chunked cross-entropy (plain torch, custom backward)
# ---------------------------------------------------------------------------
def _ce_fwd_impl(x, w, targets, num_chunks):
    t = x.shape[0]
    v = w.shape[1]
    assert v % num_chunks == 0, (v, num_chunks)
    c = v // num_chunks
    m = torch.full((t,), -math.inf, dtype=torch.float32, device=x.device)
    l = torch.zeros((t,), dtype=torch.float32, device=x.device)
    tl = torch.zeros((t,), dtype=torch.float32, device=x.device)
    for i in range(num_chunks):
        logits = (x @ w[:, i * c:(i + 1) * c]).float()          # [T, C]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=-1)
        m = m_new
        in_chunk = (targets >= i * c) & (targets < (i + 1) * c)
        idx = torch.clamp(targets - i * c, 0, c - 1).long()
        picked = logits.gather(1, idx[:, None])[:, 0]
        tl = tl + torch.where(in_chunk, picked, torch.zeros_like(picked))
    lse = m + torch.log(l)
    return lse - tl, lse


def _ce_bwd(num_chunks, x, w, targets, lse, g):
    """dX, dW of the per-token NLL, one chunk of the vocabulary at a
    time (lse: [T])."""
    v = w.shape[1]
    c = v // num_chunks
    g32 = g.float()
    dx = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    dws = []
    for i in range(num_chunks):
        wc = w[:, i * c:(i + 1) * c]
        logits = (x @ wc).float()                                # [T, C]
        p = torch.exp(logits - lse[:, None])
        in_chunk = (targets >= i * c) & (targets < (i + 1) * c)
        idx = torch.clamp(targets - i * c, 0, c - 1).long()
        onehot = torch.zeros_like(p).scatter_(1, idx[:, None], 1.0) \
            * in_chunk[:, None].float()
        dlogits = ((p - onehot) * g32[:, None]).to(x.dtype)
        dx = dx + dlogits @ wc.T                                 # [T, d]
        dws.append(x.T @ dlogits)                                # [d, C]
    return dx.to(x.dtype), torch.cat(dws, dim=1).to(w.dtype)


class _ChunkedCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, targets, num_chunks):
        nll, lse = _ce_fwd_impl(x, w, targets, num_chunks)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.num_chunks = num_chunks
        return nll

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        dx, dw = _ce_bwd(ctx.num_chunks, x, w, targets, lse, g)
        return dx, dw, None, None


def chunked_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                          targets: torch.Tensor,
                          num_chunks: int = 8) -> torch.Tensor:
    """Per-token NLL of ``softmax(x @ w)`` at ``targets``.

    x: [T, d] (compute dtype); w: [d, V]; targets: [T] int.
    Returns [T] fp32. V must divide by num_chunks.
    """
    return _ChunkedCrossEntropy.apply(x, w, targets, num_chunks)


# ---------------------------------------------------------------------------
# Fused cross-entropy: forward kernel + one-recompute backward
# ---------------------------------------------------------------------------
def fused_forward_reference(x: torch.Tensor, w: torch.Tensor,
                            targets: torch.Tensor, block_v: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused forward as the reference kernel computes it, one
    ``block_v`` vocab tile at a time: fp32 logits of the tile (products
    of the inputs accumulated in fp32, never rounded to the input
    dtype), running max from ``-1e30``, running sum, target pick by
    column; lse = m + log(max(l, 1e-30)). A target that no column
    matches picks 0. Returns (nll [T], lse [T, 1]), fp32."""
    t = x.shape[0]
    v = w.shape[1]
    x32 = x.float()
    tgt = targets.long()[:, None]
    m = torch.full((t, 1), -1e30, dtype=torch.float32, device=x.device)
    l = torch.zeros((t, 1), dtype=torch.float32, device=x.device)
    tl = torch.zeros((t, 1), dtype=torch.float32, device=x.device)
    for v0 in range(0, v, block_v):
        logits = x32 @ w[:, v0:v0 + block_v].float()            # [T, bv]
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(logits - m_new).sum(
            dim=-1, keepdim=True)
        m = m_new
        cols = v0 + torch.arange(logits.shape[1], device=x.device)
        tl = tl + torch.where(cols[None, :] == tgt, logits,
                              torch.zeros_like(logits)).sum(
                                  dim=-1, keepdim=True)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return (lse - tl)[:, 0], lse


_SIGNATURE = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _kernel():
    from skypilot_tpu_torch.ops import _build
    fn = _build.library('ce_fwd').ce_fwd_bf16
    fn.argtypes = _SIGNATURE
    fn.restype = ctypes.c_int
    return fn


def check_cuda_shape(x_shape, w_shape) -> None:
    """Raise ValueError unless the CUDA kernel takes x [T, d] and
    w [d, V]: d a multiple of CUDA_DIM_MULTIPLE, V of
    CUDA_VOCAB_MULTIPLE."""
    t, d = x_shape
    if len(w_shape) != 2 or w_shape[0] != d or t < 1 \
            or d % CUDA_DIM_MULTIPLE or d == 0 \
            or w_shape[1] % CUDA_VOCAB_MULTIPLE or w_shape[1] == 0:
        raise ValueError(
            f'the CUDA cross-entropy kernel takes x [T, d] and w [d, V] '
            f'with d a multiple of {CUDA_DIM_MULTIPLE} and V of '
            f'{CUDA_VOCAB_MULTIPLE}; got x {tuple(x_shape)}, w '
            f'{tuple(w_shape)}')


def _fused_fwd(x, w, targets, block_v: int):
    """(nll [T], lse [T, 1]): the plain version on CPU tensors, the
    ``ce_fwd`` kernel on CUDA tensors (bf16 x and w, int32 targets)."""
    devices = {x.device.type, w.device.type, targets.device.type}
    if devices == {'cpu'}:
        return fused_forward_reference(x, w, targets, block_v)
    name = 'fused_cross_entropy_fwd'
    if devices != {'cuda'} or x.device != w.device \
            or x.device != targets.device:
        raise ValueError(f'{name}: x, w and targets must share one device')
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f'{name}: the CUDA kernel takes bf16 x and w, got '
                        f'{x.dtype}, {w.dtype}')
    if targets.dtype != torch.int32:
        raise TypeError(f'{name}: targets must be int32, got '
                        f'{targets.dtype}')
    if not (x.is_contiguous() and w.is_contiguous()
            and targets.is_contiguous()):
        raise ValueError(f'{name}: inputs must be contiguous')
    check_cuda_shape(tuple(x.shape), tuple(w.shape))
    t, d = x.shape
    v = w.shape[1]
    if targets.numel() != t:
        raise ValueError(f'{name}: {targets.numel()} targets for {t} rows')
    nll = torch.empty((t,), dtype=torch.float32, device=x.device)
    lse = torch.empty((t, 1), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(x.data_ptr(), w.data_ptr(), targets.data_ptr(),
                    nll.data_ptr(), lse.data_ptr(), t, d, v, stream)
    if err == -1:
        raise ValueError(f'{name}: the CUDA kernel does not take x '
                         f'{tuple(x.shape)}, w {tuple(w.shape)}')
    if err:
        raise RuntimeError(f'{name}: kernel launch failed with CUDA error '
                           f'{err}')
    launches[name] += 1
    return nll, lse


def _auto_block(n: int, want: int, floor: int = 8) -> int:
    """Largest power-of-two-ish tile <= want that divides n (Llama-3's
    128256 vocab divides 256, not 512)."""
    b = want
    while b > floor and n % b:
        b //= 2
    if n % b:
        b = math.gcd(b, n)
    return max(b, 1)


def _fused_bwd(x, w, targets, lse, g):
    """Backward in plain torch, recomputing the logits ONCE (the
    reference's ``_fused_bwd_rule``): the [T, V] logits in x's dtype,
    P = exp(logits - lse) in fp32 minus the one-hot, times g, cast to
    x's dtype, then the dX and dW products. Above
    ONE_SHOT_BWD_MAX_VOCAB the chunked backward instead."""
    t = x.shape[0]
    v = w.shape[1]
    if v <= ONE_SHOT_BWD_MAX_VOCAB:
        logits = (x @ w).float()
        p = torch.exp(logits - lse)                      # lse: [T, 1]
        rows = torch.arange(t, device=x.device)
        p[rows, targets.long()] -= 1.0
        p = (p * g.float()[:, None]).to(x.dtype)
        dx = p @ w.T
        dw = x.T @ p
        return dx.to(x.dtype), dw.to(w.dtype)
    c = _auto_block(v, 8192, floor=128)
    return _ce_bwd(v // c, x, w, targets, lse[:, 0], g)


class _FusedCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, targets, block_v):
        nll, lse = _fused_fwd(x, w, targets, block_v)
        ctx.save_for_backward(x, w, targets, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        dx, dw = _fused_bwd(x, w, targets, lse, g)
        return dx, dw, None, None


def fused_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                        targets: torch.Tensor,
                        block_t: Optional[int] = None,
                        block_v: Optional[int] = None) -> torch.Tensor:
    """Per-token NLL of ``softmax(x @ w)`` at ``targets``: fused forward
    (logits tiles never leave the kernel) + single-recompute backward.

    x: [T, d]; w: [d, V]; targets: [T] int -> [T] fp32. Tile sizes
    default to the largest divisors of T / V up to 512, as in the
    reference, and T / V must divide by them; the plain version walks
    the vocabulary in ``block_v`` tiles, while the CUDA kernel picks its
    own tiles (64 rows by 128 vocab columns) and masks the edges.
    """
    t, v = x.shape[0], w.shape[1]
    bt = block_t or _auto_block(t, 512)
    bv = block_v or _auto_block(v, 512, floor=128)
    assert t % bt == 0, (t, bt)
    assert v % bv == 0, (v, bv)
    targets = targets.to(torch.int32).contiguous()
    return _FusedCrossEntropy.apply(x.contiguous(), w.contiguous(),
                                    targets, bv)
