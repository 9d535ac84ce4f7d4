"""Ring attention: exact attention over sequence-sharded inputs
(counterpart of ``skypilot_tpu/ops/ring_attention.py``).

Each rank of the ``sp`` group holds the sequence shard ``i`` of Q, K and V
(rows ``i * s_local`` onward, ``[b, h, s_local, d]``, GQA by fewer KV
heads); K/V blocks travel the ring (``collectives.ppermute``, rank ``i``
to ``i + 1``) while each rank accumulates its queries' exact softmax over
every block. Two implementations with one contract:

- :func:`ring_attention_reference`: the reference's loop line for line
  (fp32 logits, the ``-1e30`` mask, the guarded ``exp``, ``acc``/``m``/
  ``l``); autograd differentiates it through ``ppermute``.
- :func:`ring_attention`: a ``torch.autograd.Function`` on the flash
  operators (``attention.flash_fwd_op``, ``flash_bwd_dq_op``,
  ``flash_bwd_dkv_op``): the ported flash kernels on CUDA tensors, their
  plain blockwise versions on CPU tensors. At ring step ``i`` the rank
  holds the block of rank ``src = (me - i) % n``: causal, the diagonal
  block (``src == me``) runs the causal kernel, a block below it
  (``src < me``) the full one, and a block above it launches nothing (it
  is fully masked; the reference adds exactly 0 there). The forward
  merges the blocks' ``(out, lse)`` by their logsumexp in fp32; the
  backward is FlashAttention-2's from the merged (global) lse and
  ``delta = rowsum(dO * O)``: dQ accumulates on the rank, dK/dV in an
  fp32 buffer that travels the ring with its block and is back at its
  owner after the last step.

Shards are contiguous (no zigzag or striped reordering), so under the
causal mask rank ``r`` computes ``r + 1`` of the ``n`` blocks.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from skypilot_tpu_torch.ops import attention as attention_lib
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel.mesh import TPGroup

_NEG_INF = -1e30


def _ring(group: Optional[TPGroup]) -> Tuple[int, int, List]:
    """(ring size, this rank's index, the rotation ``i -> i + 1``)."""
    n = group.world if group is not None else 1
    me = group.rank if group is not None else 0
    return n, me, [(i, (i + 1) % n) for i in range(n)]


def ring_attention_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, group: Optional[TPGroup], *,
                             causal: bool = True,
                             sm_scale: Optional[float] = None
                             ) -> torch.Tensor:
    """q/k/v: this rank's shards [b, h, s_local, d] on the ring of
    ``group``; the plain version (autograd through ``ppermute``)."""
    b, hq, s_local, d = q.shape
    hkv = k.shape[1]
    if hkv != hq:
        rep = hq // hkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    if sm_scale is None:
        sm_scale = d ** -0.5
    n, me, perm = _ring(group)
    f32 = torch.float32
    q32 = q.float() * sm_scale
    q_pos = me * s_local + torch.arange(s_local, device=q.device)
    acc = torch.zeros((b, hq, s_local, d), dtype=f32, device=q.device)
    m = torch.full((b, hq, s_local, 1), _NEG_INF, dtype=f32,
                   device=q.device)
    l = torch.zeros((b, hq, s_local, 1), dtype=f32, device=q.device)
    kv = torch.stack([k, v])
    for i in range(n):
        # The block held at ring step i came from rank (me - i).
        src = (me - i) % n
        k_pos = src * s_local + torch.arange(s_local, device=q.device)
        s = q32 @ kv[0].float().transpose(-1, -2)
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]
            s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # Fully-masked rows keep m = -inf; guard the exp.
        m_safe = torch.where(torch.isfinite(m_new) | (m_new > _NEG_INF / 2),
                             m_new, torch.zeros_like(m_new))
        p = torch.exp(s - m_safe)
        p = torch.where(s <= _NEG_INF / 2, torch.zeros_like(p), p)
        alpha = torch.where(m > _NEG_INF / 2, torch.exp(m - m_safe),
                            torch.zeros_like(m))
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ kv[1].float()
        m = m_new
        if i < n - 1:
            # The reference also rotates after the last step; that block
            # is never read.
            kv = collectives.ppermute(kv, group, perm)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def _block_causal(causal: bool, src: int, me: int) -> Optional[bool]:
    """The flash kernels' ``causal`` flag for the block from rank ``src``
    on rank ``me``; None for a block the mask hides whole."""
    if not causal:
        return False
    if src > me:
        return None
    return src == me


def _block_k(s_local: int) -> int:
    """The plain CPU versions' key block (the CUDA kernels tile by
    themselves)."""
    return attention_lib._fit_block(attention_lib.DEFAULT_BLOCK_K, s_local)


class _RingFlash(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, causal, sm_scale):
        if q.is_cuda:
            # Raise before any rank sends: every rank holds these shapes.
            attention_lib.check_cuda_shape(tuple(q.shape), tuple(k.shape))
        q = q.contiguous()
        kv = torch.stack([k, v])
        n, me, perm = _ring(group)
        block_k = _block_k(q.shape[2])
        outs, lses = [], []
        for i in range(n):
            flag = _block_causal(causal, (me - i) % n, me)
            if flag is not None:
                out, lse = attention_lib.flash_fwd_op(
                    q, kv[0], kv[1], flag, sm_scale, block_k)
                outs.append(out)
                lses.append(lse)
            if i < n - 1:
                kv = collectives.send_recv(kv, group, perm)
        # Merge the blocks by their logsumexp, in fp32.
        lse_i = torch.stack(lses)                       # [N, b, h, 1, s]
        lse = torch.logsumexp(lse_i, dim=0)
        w = torch.exp(lse_i - lse).transpose(-1, -2)    # [N, b, h, s, 1]
        out = sum(wi * o.float() for wi, o in zip(w, outs)).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, causal, sm_scale, block_k)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, sm_scale, block_k = ctx.args
        do = g.contiguous()
        delta = (do.float() * out.float()).sum(dim=-1)[:, :, None, :]
        n, me, perm = _ring(group)
        kv = torch.stack([k, v])
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        for i in range(n):
            flag = _block_causal(causal, (me - i) % n, me)
            if flag is not None:
                args = (q, kv[0], kv[1], do, lse, delta, flag, sm_scale,
                        block_k)
                dq += attention_lib.flash_bwd_dq_op(*args).float()
                dk, dv = attention_lib.flash_bwd_dkv_op(*args)
                dkv[0] += dk.float()
                dkv[1] += dv.float()
            if i < n - 1:
                kv = collectives.send_recv(kv, group, perm)
            # The gradient travels with its block; the n-th rotation
            # brings it home.
            dkv = collectives.send_recv(dkv, group, perm)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: Optional[TPGroup], *, causal: bool = True,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v: this rank's shards [b, h, s_local, d] on the ring of
    ``group`` (k/v with fewer heads for GQA); exact attention over the
    whole sequence through the flash operators. CUDA tensors must take
    the kernels' shapes (``attention.check_cuda_shape``: head_dim 64 or
    128, group 1/2/4/8, ``s_local`` a multiple of 64) and be bf16, else
    this raises."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _RingFlash.apply(q, k, v, group, causal, float(sm_scale))
