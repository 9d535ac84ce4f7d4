"""The arithmetic of the tensor-core flash kernels, emulated on the CPU.

``csrc/flash_fwd.cu`` and the dK/dV kernel of ``csrc/flash_bwd.cu`` run
their products as bf16 ``wgmma`` instructions with fp32 accumulation,
while the reference (``skypilot_tpu/ops/attention.py``) and the port's
plain versions keep P and dS in fp32. The kernels therefore:

- form S = q kᵀ (and dP = dO vᵀ) from the bf16 operands, exact per
  product, and scale S in fp32 after the product (the reference scales q
  first: a relative change of about 1e-7);
- split each fp32 operand x of P @ V, Pᵀ dO and dSᵀ Q into
  ``hi = bf16(x)`` and ``lo = bf16(x - hi)`` and run both halves against
  the same bf16 tile into one fp32 accumulator (relative error about
  2^-16).

This file emulates exactly that in torch, over the kernels' 64-key and
64-row tiles, and holds the result to ``flash_forward_reference`` /
``flash_bwd_dkv_reference`` at ``chip_smoke.py``'s tolerances. It also
shows that the split matters: with a single bf16 P (and dS) the fp32
results are measurably further from the plain versions.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from skypilot_tpu_torch.ops import attention as tatt

TILE = 64        # the kernels' key tile (forward) and q tile (dK/dV)
NEG_INF = -1e30
# The single-bf16 variant must be at least this many times further from
# the plain version (in fp32, before the output is rounded) than the
# split: the split leaves fp32 summation noise, a bf16 P about 2^-9.
SPLIT_GAIN = 8.0


def _bf16_inputs(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 .to(torch.bfloat16)
                 for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d),
                               (b, hq, s, d)))


def _split_product(x, b, split: bool):
    """x @ b with x fp32 and b holding bf16 values: the kernels' two
    bf16 products (hi and lo) into one fp32 sum, or one (hi only)."""
    hi = x.to(torch.bfloat16).float()
    out = hi @ b
    if split:
        out = out + (x - hi).to(torch.bfloat16).float() @ b
    return out


def _keep(q0, nq, k0, nk):
    return (q0 + torch.arange(nq)[:, None]) >= (k0 + torch.arange(nk)[None])


def emulate_forward(q, k, v, causal, sm_scale, split=True):
    """(out fp32, lse fp32 [b, hq, 1, s]) as the forward kernel computes
    them: 64-key tiles, online softmax, S scaled after the product."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    acc = torch.zeros((b, hq, s, d))
    m = torch.full((b, hq, s, 1), NEG_INF)
    l = torch.zeros((b, hq, s, 1))
    for k0 in range(0, s, TILE):
        sc = (qf @ kf[:, :, k0:k0 + TILE].transpose(-1, -2)) * sm_scale
        if causal:
            sc = torch.where(_keep(0, s, k0, TILE), sc,
                             torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _split_product(p, vf[:, :, k0:k0 + TILE], split)
        m = m_new
    l = torch.clamp(l, min=1e-30)
    return acc / l, (m + torch.log(l))[..., 0][:, :, None, :]


def emulate_dkv(q, k, v, do, lse, delta, causal, sm_scale, split=True):
    """(dK fp32, dV fp32) as the dK/dV kernel computes them: per KV head,
    the transposed products Sᵀ = K Qᵀ and dPᵀ = V dOᵀ over 64-row q
    tiles, Pᵀ and dSᵀ in fp32, then dV += Pᵀ dO and dK += dSᵀ Q with the
    fp32 operand split into bf16 halves; dK scaled once at the end."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dk = torch.zeros((b, hkv, s, d))
    dv = torch.zeros((b, hkv, s, d))
    for h in range(hq):
        kvh = h // group
        for r0 in range(0, s, TILE):
            rows = slice(r0, r0 + TILE)
            st = kf[:, kvh] @ qf[:, h, rows].transpose(-1, -2) * sm_scale
            if causal:
                st = torch.where(_keep(r0, TILE, 0, s).T, st,
                                 torch.full_like(st, NEG_INF))
            pt = torch.exp(st - lse[:, h, 0, None, rows])
            dpt = vf[:, kvh] @ dof[:, h, rows].transpose(-1, -2)
            dst = pt * (dpt - delta[:, h, 0, None, rows])
            dv[:, kvh] += _split_product(pt, dof[:, h, rows], split)
            dk[:, kvh] += _split_product(dst, qf[:, h, rows], split)
    return dk * sm_scale, dv


def _within(got, want, rtol, atol_frac, name):
    err, ok = chip_smoke.compare(torch, got, want, rtol, atol_frac)
    assert ok, f'{name}: max abs error {err:.3e} outside the tolerance'
    return err


def _max_err(got, want):
    return (got - want).abs().max().item()


CASES = [(hd, group, s, causal) for hd in (64, 128) for group in (1, 4)
         for s in (192, 256) for causal in (True, False)]


@pytest.mark.parametrize('hd,group,s,causal', CASES)
def test_forward_arithmetic_meets_the_chip_tolerances(hd, group, s, causal):
    q, k, v, _ = _bf16_inputs(hd + s + group, 1, 2 * group, 2, s, hd)
    scale = hd ** -0.5
    ref_out, ref_lse = tatt.flash_forward_reference(
        q, k, v, causal=causal, sm_scale=scale, block_k=TILE)
    out, lse = emulate_forward(q, k, v, causal, scale)
    _within(out.to(torch.bfloat16), ref_out, chip_smoke.BF16_RTOL,
            chip_smoke.BF16_ATOL_FRAC, 'out')
    _within(lse, ref_lse, chip_smoke.FP32_RTOL, chip_smoke.FP32_ATOL_FRAC,
            'lse')
    # Before the bf16 rounding of out: a single bf16 P is further away.
    want, _ = tatt.flash_forward_reference(q.float(), k.float(), v.float(),
                                           causal=causal, sm_scale=scale,
                                           block_k=TILE)
    err_split = _max_err(out, want)
    err_single = _max_err(emulate_forward(q, k, v, causal, scale,
                                          split=False)[0], want)
    assert err_single > SPLIT_GAIN * err_split, (err_single, err_split)


@pytest.mark.parametrize('hd,group,s,causal', CASES)
def test_dkv_arithmetic_meets_the_chip_tolerances(hd, group, s, causal):
    q, k, v, do = _bf16_inputs(2 * hd + s + group, 1, 2 * group, 2, s, hd)
    scale = hd ** -0.5
    out, lse = tatt.flash_forward_reference(q, k, v, causal=causal,
                                            sm_scale=scale, block_k=TILE)
    delta = (do.float() * out.float()).sum(-1)[:, :, None, :]
    kw = dict(causal=causal, sm_scale=scale, block_k=TILE)
    ref_dk, ref_dv = tatt.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                  **kw)
    dk, dv = emulate_dkv(q, k, v, do, lse, delta, causal, scale)
    _within(dk.to(torch.bfloat16), ref_dk, chip_smoke.BF16_RTOL,
            chip_smoke.BF16_ATOL_FRAC, 'dk')
    _within(dv.to(torch.bfloat16), ref_dv, chip_smoke.BF16_RTOL,
            chip_smoke.BF16_ATOL_FRAC, 'dv')
    want_dk, want_dv = tatt.flash_bwd_dkv_reference(
        q.float(), k.float(), v.float(), do.float(), lse, delta, **kw)
    single_dk, single_dv = emulate_dkv(q, k, v, do, lse, delta, causal,
                                       scale, split=False)
    for name, got, single, want in (('dk', dk, single_dk, want_dk),
                                    ('dv', dv, single_dv, want_dv)):
        err_split, err_single = _max_err(got, want), _max_err(single, want)
        assert err_single > SPLIT_GAIN * err_split, (name, err_single,
                                                     err_split)
