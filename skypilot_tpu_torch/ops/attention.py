"""Training attention (counterpart of ``skypilot_tpu/ops/attention.py``).

Inputs are ``[batch, heads, seq, head_dim]`` as in the reference, GQA by
fewer KV heads (query head ``h`` reads KV head ``h // group``). Two
implementations with one contract:

- ``dense_attention``: fp32 logits, ``-1e30`` causal mask, probabilities
  cast to ``v.dtype`` before the value product, exactly the reference's
  XLA path; autograd differentiates it.
- ``flash_attention``: a ``torch.autograd.Function``. Its forward runs
  the flash forward (online softmax over KV blocks, causal block skip,
  fp32 accumulators, per-row logsumexp saved); its backward is the
  FlashAttention-2 decomposition from the saved logsumexp, with
  ``delta = rowsum(dO * O)`` in fp32 between the dQ and the dK/dV
  passes, as the reference computes it in XLA.

On CUDA tensors the three passes launch ``csrc/flash_fwd.cu`` (forward)
and ``csrc/flash_bwd.cu`` (dQ, then dK/dV; all three run wgmma
products on TMA-loaded tiles); on CPU tensors they run the
plain blockwise versions below, which the CPU tests hold to the JAX
kernels and ``chip_smoke.py`` holds the CUDA kernels to. Each wrapper
adds one to its entry of :data:`launches` where it launches its kernel,
and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_K = 256
_NEG_INF = -1e30

# Kernel launches per wrapper since the process started (or the last
# reset_launches()).
launches: Dict[str, int] = {'flash_attention_fwd': 0,
                            'flash_attention_bwd_dq': 0,
                            'flash_attention_bwd_dkv': 0}

# The shapes the CUDA kernels take; ``chip_smoke.py`` holds every
# combination (causal and not) against the plain versions on the card.
# The kernels tile the sequence by 64 rows and keys (the forward's and
# dK/dV's 128-row blocks idle their second half past the end).
CUDA_HEAD_DIMS = (64, 128)
CUDA_GROUPS = (1, 2, 4, 8)
CUDA_SEQ_MULTIPLE = 64


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Reference attention. q: [b, hq, s, d]; k/v: [b, hkv, s, d]."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if sm_scale is None:
        sm_scale = d ** -0.5
    if hkv != hq:
        assert hq % hkv == 0
        rep = hq // hkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    logits = (q.float() @ k.float().transpose(-1, -2)) * sm_scale
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool,
                          device=q.device).tril()
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return probs @ v


# ---------------------------------------------------------------------------
# Plain versions (ground truth in tests; the CPU path of the wrappers)
# ---------------------------------------------------------------------------
def _kv_for_q_heads(t: torch.Tensor, group: int) -> torch.Tensor:
    """[b, hkv, n, d] -> [b, hkv*group, n, d] in fp32 (head h reads KV
    head h // group)."""
    t = t.float()
    return t.repeat_interleave(group, dim=1) if group > 1 else t


def _causal_keep(q0: int, nq: int, k0: int, nk: int,
                 device) -> torch.Tensor:
    q_pos = q0 + torch.arange(nq, device=device)[:, None]
    k_pos = k0 + torch.arange(nk, device=device)[None, :]
    return q_pos >= k_pos


def flash_forward_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool,
                            sm_scale: float, block_k: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flash forward computed blockwise over ``block_k`` keys with
    an online softmax, as the reference kernel does: q is scaled before
    the product, masked logits are ``-1e30``, ``l`` is clamped at
    ``1e-30``. Returns (out in q.dtype, lse [b, hq, 1, s] fp32)."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    qs = q.float() * sm_scale
    acc = torch.zeros((b, hq, s, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, hq, s, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hq, s, 1), dtype=torch.float32, device=q.device)
    for k0 in range(0, s, block_k):
        kb = _kv_for_q_heads(k[:, :, k0:k0 + block_k], group)
        vb = _kv_for_q_heads(v[:, :, k0:k0 + block_k], group)
        sc = qs @ kb.transpose(-1, -2)                    # [b, hq, s, bk]
        if causal:
            keep = _causal_keep(0, s, k0, kb.shape[2], q.device)
            sc = torch.where(keep, sc, torch.full_like(sc, _NEG_INF))
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ vb
        m = m_new
    l = torch.clamp(l, min=1e-30)
    out = (acc / l).to(q.dtype)
    lse = (m + torch.log(l))[..., 0][:, :, None, :]
    return out, lse


def _bwd_blocks(q, k, v, do, lse, delta, causal: bool, sm_scale: float,
                block_k: int):
    """Yield (kb, q32, do32, p, ds) per ``block_k`` keys: the
    rebuilt P = exp(S - lse) and dS = P * (dO V^T - delta), with S the
    scaled product (the reference's backward scales the product, not
    q); kb is the block's keys repeated to the query heads, fp32."""
    s = q.shape[2]
    group = q.shape[1] // k.shape[1]
    q32, do32 = q.float(), do.float()
    lse_c = lse[:, :, 0, :, None]
    delta_c = delta[:, :, 0, :, None]
    for k0 in range(0, s, block_k):
        kb = _kv_for_q_heads(k[:, :, k0:k0 + block_k], group)
        vb = _kv_for_q_heads(v[:, :, k0:k0 + block_k], group)
        sc = (q32 @ kb.transpose(-1, -2)) * sm_scale
        if causal:
            keep = _causal_keep(0, s, k0, kb.shape[2], q.device)
            sc = torch.where(keep, sc, torch.full_like(sc, _NEG_INF))
        p = torch.exp(sc - lse_c)
        ds = p * (do32 @ vb.transpose(-1, -2) - delta_c)
        yield kb, q32, do32, p, ds


def flash_bwd_dq_reference(q, k, v, do, lse, delta, *, causal: bool,
                           sm_scale: float, block_k: int) -> torch.Tensor:
    """dQ of the FlashAttention-2 backward, blockwise over ``block_k``
    keys from the saved statistics (lse, delta: [b, hq, 1, s]):
    dQ = sum_j dS_j K_j * sm_scale, in q.dtype."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for kb, _, _, _, ds in _bwd_blocks(q, k, v, do, lse, delta, causal,
                                       sm_scale, block_k):
        dq = dq + ds @ kb
    return (dq * sm_scale).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, *, causal: bool,
                            sm_scale: float, block_k: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK, dV of the FlashAttention-2 backward, blockwise over
    ``block_k`` keys: dK = dS^T Q * sm_scale, dV = P^T dO, summed over
    each KV head's group of query heads in fp32 and rounded once to
    k.dtype / v.dtype."""
    b, hq, _, d = q.shape
    hkv = k.shape[1]
    dks, dvs = [], []
    for _, q32, do32, p, ds in _bwd_blocks(q, k, v, do, lse, delta, causal,
                                           sm_scale, block_k):
        dk_q = ds.transpose(-1, -2) @ q32                  # [b, hq, bk, d]
        dv_q = p.transpose(-1, -2) @ do32
        dks.append(dk_q.reshape(b, hkv, hq // hkv, -1, d).sum(dim=2))
        dvs.append(dv_q.reshape(b, hkv, hq // hkv, -1, d).sum(dim=2))
    dk = torch.cat(dks, dim=2) * sm_scale
    return dk.to(k.dtype), torch.cat(dvs, dim=2).to(v.dtype)


def flash_backward_reference(q, k, v, do, lse, delta, *, causal: bool,
                             sm_scale: float, block_k: int
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv): both halves of the plain backward."""
    kw = dict(causal=causal, sm_scale=sm_scale, block_k=block_k)
    dq = flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw)
    return (dq, *flash_bwd_dkv_reference(q, k, v, do, lse, delta, **kw))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    'flash_fwd_bf16': ('flash_fwd', [_P, _P, _P, _P, _P] + [_I] * 6
                       + [_F, _P]),
    'flash_bwd_dq_bf16': ('flash_bwd', [_P] * 7 + [_I] * 6 + [_F, _P]),
    'flash_bwd_dkv_bf16': ('flash_bwd', [_P] * 8 + [_I] * 6 + [_F, _P]),
}


@functools.lru_cache(maxsize=None)
def _kernel(symbol: str):
    """The C entry point ``symbol``, its library built and bound on first
    use."""
    from skypilot_tpu_torch.ops import _build
    lib_name, argtypes = _SIGNATURES[symbol]
    fn = getattr(_build.library(lib_name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devices = {t.device.type for t in tensors}
    if devices == {'cpu'}:
        return True
    if devices != {'cuda'}:
        raise ValueError(f'tensors must all lie on the CPU or all on one '
                         f'CUDA device, got {sorted(devices)}')
    return False


def check_cuda_shape(q_shape, kv_shape) -> None:
    """Raise ValueError unless the CUDA flash kernels take these shapes:
    q [b, hq, s, d], k/v [b, hkv, s, d] with d in CUDA_HEAD_DIMS,
    hq // hkv in CUDA_GROUPS and s a multiple of CUDA_SEQ_MULTIPLE."""
    b, hq, s, d = q_shape
    if len(kv_shape) != 4 or kv_shape[0] != b or kv_shape[2:] != (s, d) \
            or hq % kv_shape[1]:
        raise ValueError(f'q {tuple(q_shape)} and k/v {tuple(kv_shape)} do '
                         f'not form a (GQA) attention problem')
    group = hq // kv_shape[1]
    if d not in CUDA_HEAD_DIMS or group not in CUDA_GROUPS \
            or s % CUDA_SEQ_MULTIPLE or s == 0:
        raise ValueError(
            f'the CUDA flash kernels take head_dim in {CUDA_HEAD_DIMS}, '
            f'group in {CUDA_GROUPS} and seq a multiple of '
            f'{CUDA_SEQ_MULTIPLE}; got head_dim {d}, group {group}, '
            f'seq {s}')


def _launch(symbol: str, name: str, bf16, fp32, outs, causal: bool,
            sm_scale: float) -> None:
    """Check the inputs (``bf16``: q, k, v[, dO]; ``fp32``: lse and
    delta, if any), launch ``symbol`` on their pointers and those of
    ``outs``, raise on a refused shape or a failed launch, and count
    the launch."""
    q, k, v = bf16[:3]
    for t in bf16:
        if t.dtype != torch.bfloat16:
            raise TypeError(f'{name}: the CUDA kernel takes bf16 q, k, v '
                            f'and dO, got {t.dtype}')
    for t in fp32:
        if t.dtype != torch.float32:
            raise TypeError(f'{name}: lse and delta must be fp32, got '
                            f'{t.dtype}')
    for t in (*bf16, *fp32):
        if not t.is_contiguous():
            raise ValueError(f'{name}: inputs must be contiguous')
        if t.device != q.device:
            raise ValueError(f'{name}: inputs must share one device')
    check_cuda_shape(tuple(q.shape), tuple(k.shape))
    b, hq, s, d = q.shape
    if v.shape != k.shape or any(t.shape != q.shape for t in bf16[3:]) \
            or any(tuple(t.shape) != (b, hq, 1, s) for t in fp32):
        raise ValueError(f'{name}: v, dO, lse or delta do not match q '
                         f'{tuple(q.shape)} and k {tuple(k.shape)}')
    err = _kernel(symbol)(
        *(t.data_ptr() for t in (*bf16, *fp32, *outs)), b, hq, k.shape[1],
        s, d, int(causal), float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err == -1:
        raise ValueError(f'{name}: the CUDA kernel does not take q '
                         f'{tuple(q.shape)}, k {tuple(k.shape)}')
    if err:
        raise RuntimeError(f'{name}: kernel launch failed with CUDA error '
                           f'{err}')
    launches[name] += 1


def _flash_forward(q, k, v, causal: bool, sm_scale: float, block_k: int):
    """(out, lse [b, hq, 1, s]): the plain version on CPU tensors, the
    ``flash_fwd`` kernel on CUDA tensors."""
    if _on_cpu(q, k, v):
        return flash_forward_reference(q, k, v, causal=causal,
                                       sm_scale=sm_scale, block_k=block_k)
    b, hq, s, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, 1, s), dtype=torch.float32, device=q.device)
    _launch('flash_fwd_bf16', 'flash_attention_fwd', (q, k, v), (),
            (out, lse), causal, sm_scale)
    return out, lse


def _flash_backward_dq(q, k, v, do, lse, delta, causal: bool,
                       sm_scale: float, block_k: int) -> torch.Tensor:
    """dQ: the plain version on CPU tensors, the ``flash_bwd_dq`` kernel
    on CUDA tensors."""
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                      causal=causal, sm_scale=sm_scale,
                                      block_k=block_k)
    dq = torch.empty_like(q)
    _launch('flash_bwd_dq_bf16', 'flash_attention_bwd_dq', (q, k, v, do),
            (lse, delta), (dq,), causal, sm_scale)
    return dq


def _flash_backward_dkv(q, k, v, do, lse, delta, causal: bool,
                        sm_scale: float, block_k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV): the plain version on CPU tensors, the ``flash_bwd_dkv``
    kernel on CUDA tensors."""
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                       causal=causal, sm_scale=sm_scale,
                                       block_k=block_k)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch('flash_bwd_dkv_bf16', 'flash_attention_bwd_dkv', (q, k, v, do),
            (lse, delta), (dk, dv), causal, sm_scale)
    return dk, dv


def _flash_backward(q, k, v, out, lse, do, causal: bool, sm_scale: float,
                    block_k: int):
    """(dq, dk, dv): delta = rowsum(dO * O) in fp32 (the reference's XLA
    step between its kernels), then the dQ pass and the dK/dV pass."""
    delta = (do.float() * out.float()).sum(dim=-1)[:, :, None, :]
    args = (q, k, v, do, lse, delta, causal, sm_scale, block_k)
    return (_flash_backward_dq(*args), *_flash_backward_dkv(*args))


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, block_k):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _flash_forward(q, k, v, causal, sm_scale, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, sm_scale, block_k)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, out, lse, g.contiguous(),
                                     *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sm_scale: Optional[float] = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """Flash attention. q: [b, hq, s, d]; k/v: [b, hkv, s, d] (GQA).

    ``block_q``/``block_k`` are the reference's tile sizes: seq must
    divide by both (clamped to seq), and the plain CPU version walks
    keys in ``block_k`` blocks. The CUDA kernels pick their own tiles:
    the forward 128 q rows per block against 64-key tiles, dK/dV 128 keys
    per block against 64-row q tiles (both on the tensor cores), dQ 64
    rows by 64 keys. They take bf16 inputs with the shapes of
    :func:`check_cuda_shape`; anything else raises."""
    s = q.shape[2]
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    block_q = min(block_q, s)
    block_k = min(block_k, s)
    assert s % block_q == 0 and s % block_k == 0, (
        f'seq_len {s} must be a multiple of block sizes '
        f'({block_q}, {block_k})')
    return _FlashAttention.apply(q, k, v, causal, float(sm_scale), block_k)


def _fit_block(want: int, seq_len: int) -> int:
    """Largest tile <= `want` that DIVIDES seq_len (the kernels require
    it), preferring lane-aligned multiples of 128. seq 768 with a 512
    request fits 384; non-multiple-of-128 seqs fall back to the gcd."""
    b = min(want, seq_len)
    while b > 128 and seq_len % b:
        b -= 128
    if seq_len % b:
        b = math.gcd(b, seq_len)
    return max(b, 1)


def attention(q, k, v, *, causal: bool = True,
              sm_scale: Optional[float] = None,
              impl: str = 'auto',
              block_q: Optional[int] = None,
              block_k: Optional[int] = None) -> torch.Tensor:
    """Dispatch: 'dense', 'flash', or 'auto' (flash on CUDA tensors when
    seq is a multiple of 128 and at least 256, else dense).
    block_q/block_k override the flash tile sizes (clamped to seq; None
    -> defaults)."""
    if impl == 'dense':
        return dense_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    s = q.shape[2]
    bq = _fit_block(block_q or DEFAULT_BLOCK_Q, s)
    bk = _fit_block(block_k or DEFAULT_BLOCK_K, s)
    if impl == 'flash':
        if min(bq, bk) < 128 and s >= 128:
            # The gcd fallback would hand the kernel sub-lane tiles;
            # explicit flash on such a seq is a user error, not
            # something to quietly degrade.
            raise ValueError(
                f'flash attention needs seq_len divisible by a >=128 '
                f'tile; got seq_len={s} (fitted tiles {bq}x{bk}). Pad '
                f'the sequence or use impl="dense"/"auto".')
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                               block_q=bq, block_k=bk)
    if q.is_cuda and s % 128 == 0 and s >= 256:
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                               block_q=bq, block_k=bk)
    return dense_attention(q, k, v, causal=causal, sm_scale=sm_scale)
