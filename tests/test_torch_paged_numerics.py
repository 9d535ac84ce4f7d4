"""The arithmetic of the paged decode/verify kernel, emulated on the CPU.

``csrc/paged_decode.cu`` splits a slot's pages across blocks and runs
its products on the tensor cores, while the reference
(``skypilot_tpu/ops/paged_attention.py``) takes one softmax over the
whole table with q scaled first. The kernel therefore:

- walks pages in splits of ``PAGES_PER_SPLIT`` (by page index alone),
  each split's 16-key chunks dealt to 4 key groups (chunk % 4), each key
  group an online softmax over its chunks in order;
- forms S = q kᵀ from the unscaled bf16 q and the bf16 (or int8, exact
  in bf16) k, exact per product with fp32 sums, then scales S in fp32:
  the int8 K row scale first, then sm_scale;
- gives a masked key p = 0 exactly, folds the int8 V row scale into P,
  and runs P @ V as ``hi = bf16(P)`` and ``lo = bf16(P - hi)`` against
  the same V into one fp32 accumulator;
- merges the key groups' partials (m, l, acc) in key-group order, then
  the splits' in split order, and divides once: acc / max(l, 1e-30).

This file emulates exactly that in torch, row by row so that a row's
numbers cannot depend on how many rows the call holds (products of bf16
values are summed in fp64, where they are exact, then rounded once to
fp32), and holds it to the JAX reference at ``chip_smoke.ATOL``, at
lengths on the split edges. It checks that query 0 of a verify run at
lengths L is bitwise the decode emulation at L + 1, also where the run's
extra page opens a split of its own, and that a single bf16 P is
measurably further from the reference than the hi/lo split.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import chip_smoke
from skypilot_tpu.ops import paged_attention as jpa
from skypilot_tpu_torch.ops import paged_attention as tpa

jax.config.update('jax_default_matmul_precision', 'highest')

PPS = tpa.PAGES_PER_SPLIT
CHUNK = 16         # keys per chunk: one k step of the P @ V product
KEY_GROUPS = 4     # warps that deal a split's chunks among them
NEG_INF = -1e30
HKV, HD, R = 2, 64, 5
MAXP = max(8, 3 * PPS)   # pages a table holds: room for three splits
# The single-bf16 variant must be at least this many times further from
# the reference (before anything is rounded) than the split: the split
# leaves fp32 summation noise, a bf16 P about 2^-9.
SPLIT_GAIN = 8.0


def _exact(a, b):
    """a @ b for fp32 tensors holding bf16 (or int8) values: every product
    is exact and their sum is exact in fp64, rounded once to fp32."""
    return (a.double() @ b.double()).float()


def _merge(parts):
    """Merge partials (m, l, acc) in list order: the kernel's one merge
    path, for key groups and for splits alike."""
    big_m = parts[0][0]
    for m, _, _ in parts[1:]:
        big_m = torch.maximum(big_m, m)
    big_l = torch.zeros_like(parts[0][1])
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        w = torch.exp(m - big_m)
        big_l = big_l + l * w
        acc = acc + a * w[..., None]
    return big_m, big_l, acc


def emulate(q, k_pages, v_pages, tables, lengths, offset, split=True,
            k_scales=None, v_scales=None):
    """out fp32 [slots, R, hkv, group, hd] as the kernel computes it; q
    [slots, R, hkv, group, hd] holds bf16 values (decode: R = 1), pages
    bf16 values or int8 with fp32 scales [hkv, P, page]. Row r = (query
    r // group, head r % group) sees positions < lengths + offset + r //
    group (offset 0 for decode at the bumped length, 1 for verify)."""
    slots, n_q, hkv, group, hd = q.shape
    page = k_pages.shape[2]
    maxp = tables.shape[1]
    scale = hd ** -0.5
    quantized = k_scales is not None
    idx = tables.long()
    # [slots, hkv, maxp * page, hd] (every table page: past a slot's
    # live pages every key is masked, an exact no-op, as the kernel's
    # skipped pages and splits are).
    k = k_pages.float()[:, idx].permute(1, 0, 2, 3, 4).reshape(
        slots, hkv, maxp * page, hd)
    v = v_pages.float()[:, idx].permute(1, 0, 2, 3, 4).reshape(
        slots, hkv, maxp * page, hd)
    if quantized:
        ks = k_scales[:, idx].permute(1, 0, 2, 3).reshape(slots, hkv, -1)
        vs = v_scales[:, idx].permute(1, 0, 2, 3).reshape(slots, hkv, -1)
    out = torch.empty(q.shape, dtype=torch.float32)
    split_keys = PPS * page
    n_splits = -(-maxp // PPS)
    for r in range(n_q * group):
        qi, head = divmod(r, group)
        qr = q[:, qi, :, head][:, :, None, :]      # [slots, hkv, 1, hd]
        horizon = (lengths.long() + offset + qi)[:, None, None]
        splits = []
        for s in range(n_splits):
            groups = []
            for kg in range(KEY_GROUPS):
                m = torch.full((slots, hkv), NEG_INF)
                l = torch.zeros((slots, hkv))
                acc = torch.zeros((slots, hkv, hd))
                n_keys = min(split_keys, maxp * page - s * split_keys)
                for c in range(kg, n_keys // CHUNK, KEY_GROUPS):
                    keys = slice(s * split_keys + c * CHUNK,
                                 s * split_keys + (c + 1) * CHUNK)
                    sc = _exact(qr, k[:, :, keys].transpose(-1, -2))[:, :, 0]
                    if quantized:
                        sc = sc * ks[:, :, keys]
                    sc = sc * scale
                    pos = torch.arange(keys.start, keys.stop)[None, None, :]
                    live = pos < horizon
                    sc = torch.where(live, sc, torch.full_like(sc, NEG_INF))
                    m_new = torch.maximum(m, sc.amax(-1))
                    p = torch.where(live, torch.exp(sc - m_new[..., None]),
                                    torch.zeros_like(sc))
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(-1)
                    if quantized:
                        p = p * vs[:, :, keys]
                    hi = p.to(torch.bfloat16).float()
                    acc = acc * alpha[..., None]
                    acc = acc + _exact(hi[:, :, None, :], v[:, :, keys])[
                        :, :, 0]
                    if split:
                        lo = (p - hi).to(torch.bfloat16).float()
                        acc = acc + _exact(lo[:, :, None, :],
                                           v[:, :, keys])[:, :, 0]
                    m = m_new
                groups.append((m, l, acc))
            splits.append(_merge(groups))
        _, big_l, acc = _merge(splits)
        out[:, qi, :, head] = acc / torch.clamp(big_l, min=1e-30)[..., None]
    return out


def _inputs(seed, lengths, group, page, quantized):
    """q [slots, R, hkv, group, hd] and bf16-valued pages from a numpy
    seed, each slot's table covering its verify run (up to the table's
    coverage); int8 pages and scales by ``quantize_rows`` of the same
    rows. Returns (q, k, v, k_scales, v_scales, tables, lengths) as
    torch tensors (fp32 values, int8 pages when quantized)."""
    rng = np.random.default_rng(seed)
    slots = len(lengths)
    cover = [min(n + R, MAXP * page) for n in lengths]
    need = [-(-n // page) for n in cover]
    n_pages = sum(need) + 3
    ids = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((slots, MAXP), np.int32)
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = ids[at:at + n]
        at += n

    def bf16(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(torch.bfloat16).float()

    q = bf16((slots, R, HKV, group, HD))
    k, v = bf16((HKV, n_pages, page, HD)), bf16((HKV, n_pages, page, HD))
    ks = vs = None
    if quantized:
        k, ks = tpa.quantize_rows(k)
        v, vs = tpa.quantize_rows(v)
    return (q, k, v, ks, vs, torch.from_numpy(tables),
            torch.tensor(lengths, dtype=torch.int32))


def _lengths(page):
    """1, a page, one split's edges (E - 1, E, E + 1) and 2E - 1, whose
    verify run opens a split that decode at lengths + 1 does not have;
    the last slot's run crosses the table's coverage."""
    edge = PPS * page
    return [1, page, edge - 1, edge, edge + 1, 2 * edge - 1,
            MAXP * page - 3]


def _jax(fn, q, k, v, ks, vs, tables, lengths):
    kw = {} if ks is None else {'k_scales': jnp.asarray(ks.numpy()),
                                'v_scales': jnp.asarray(vs.numpy())}
    return torch.from_numpy(np.array(fn(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), jnp.asarray(tables.numpy()),
        jnp.asarray(lengths.numpy()), **kw)))


CASES = [(group, page, quantized) for group in (1, 4) for page in (16, 32)
         for quantized in (False, True)]


@pytest.mark.parametrize('group,page,quantized', CASES)
def test_decode_arithmetic_meets_the_chip_tolerance(group, page, quantized):
    q, k, v, ks, vs, tables, lengths = _inputs(
        group + page, _lengths(page), group, page, quantized)
    q0 = q[:, :1]
    got = emulate(q0, k, v, tables, lengths, 0, k_scales=ks, v_scales=vs)
    want = _jax(jpa.paged_decode_attention_reference, q0[:, 0], k, v, ks, vs,
                tables, lengths)
    err = (got[:, 0] - want).abs().max().item()
    assert err <= chip_smoke.ATOL, err


@pytest.mark.parametrize('group,page,quantized', CASES)
def test_verify_arithmetic_meets_the_chip_tolerance(group, page, quantized):
    q, k, v, ks, vs, tables, lengths = _inputs(
        2 * group + page, _lengths(page), group, page, quantized)
    got = emulate(q, k, v, tables, lengths, 1, k_scales=ks, v_scales=vs)
    want = _jax(jpa.paged_verify_attention_reference, q, k, v, ks, vs,
                tables, lengths)
    err = (got - want).abs().max().item()
    assert err <= chip_smoke.ATOL, err


@pytest.mark.parametrize('group,page,quantized', CASES)
def test_verify_query0_is_bitwise_decode_at_lengths_plus_one(group, page,
                                                             quantized):
    """Verify's extra pages and splits past query 0's horizon are exact
    no-ops for it: the 2E - 1 slot opens a third split only in verify."""
    q, k, v, ks, vs, tables, lengths = _inputs(
        3 * group + page, _lengths(page), group, page, quantized)
    ver = emulate(q, k, v, tables, lengths, 1, k_scales=ks, v_scales=vs)
    dec = emulate(q[:, :1], k, v, tables, lengths + 1, 0, k_scales=ks,
                  v_scales=vs)
    assert torch.equal(ver[:, 0], dec[:, 0])
    edge = PPS * page
    assert -(-(2 * edge - 1 + R) // edge) == 3 and -(-(2 * edge) // edge) \
        == 2


@pytest.mark.parametrize('page,quantized', [(16, False), (32, False),
                                            (16, True), (32, True)])
def test_hi_lo_split_of_p_is_needed(page, quantized):
    """Before the output meets any tolerance: a single bf16 P is at least
    SPLIT_GAIN times further from the reference than the hi/lo split."""
    q, k, v, ks, vs, tables, lengths = _inputs(
        7 + page, _lengths(page), 4, page, quantized)
    want = _jax(jpa.paged_verify_attention_reference, q, k, v, ks, vs,
                tables, lengths)
    errs = [(emulate(q, k, v, tables, lengths, 1, split=split, k_scales=ks,
                     v_scales=vs) - want).abs().max().item()
            for split in (True, False)]
    assert errs[1] > SPLIT_GAIN * errs[0], errs


def test_wrapper_scratch_matches_the_kernel_split(monkeypatch):
    """The workspace holds one partial of rows x (hd + 2) fp32 per slot,
    KV head and split; it and the counters (slots x hkv int32, zero) are
    kept per device and grown when a launch needs more; a library whose
    split constant differs from the wrapper's is refused."""
    built = {'pps': PPS}
    monkeypatch.setattr(tpa, '_kernel', lambda symbol: lambda: built['pps'])
    monkeypatch.setattr(tpa, '_split_buffers', {})
    tpa._checked_pages_per_split.cache_clear()
    try:
        q = torch.zeros(1)
        ws, counters = tpa._split_scratch(q, 8, 8, 20, 128, 32)
        assert ws.dtype == torch.float32
        assert ws.numel() == 8 * 8 * -(-32 // PPS) * 20 * 130
        assert counters.dtype == torch.int32 and counters.numel() == 64
        assert not counters.any()
        small = tpa._split_scratch(q, 2, 8, 4, 64, 5)
        assert small[0] is ws and small[1] is counters
        grown = tpa._split_scratch(q, 16, 8, 4, 64, 5)
        assert grown[0] is ws and grown[1].numel() == 128
        built['pps'] = PPS + 1
        tpa._checked_pages_per_split.cache_clear()
        with pytest.raises(RuntimeError, match='splits every'):
            tpa._split_scratch(q, 8, 8, 20, 128, 32)
    finally:
        tpa._checked_pages_per_split.cache_clear()
