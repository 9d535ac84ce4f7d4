"""The arithmetic of the paged prefill kernel, emulated on the CPU.

``csrc/paged_prefill.cu`` splits a chunk's prefix pages across blocks
and runs its products on the tensor cores, while the reference
(``skypilot_tpu/ops/paged_attention.py``) takes one softmax over the
whole table with q scaled first. The kernel therefore:

- walks pages in splits of ``PREFILL_PAGES_PER_SPLIT`` (by page index
  alone), each split an online softmax over its pages in order, one page
  at a time;
- forms S = q kᵀ from the unscaled bf16 q and the bf16 (or int8, exact
  in bf16) k, exact per product with fp32 sums, then scales S in fp32:
  the int8 K row scale first, then sm_scale times log2(e), and keeps
  its softmax in the log2 domain (exp2);
- masks per row in global positions (row r = query r // group sees
  positions <= offset + r // group, and none at or past the slot's
  frontier offset + true_len, whose K/V rows it stages as zeros), gives
  a masked key p = 0 exactly, folds the int8 V row scale into P, and
  runs P @ V as ``hi = bf16(P)`` and ``lo = bf16(P - hi)`` against the
  same V into one fp32 accumulator;
- merges the splits' partials (m, l, acc) in split order and divides
  once: acc / max(l, 1e-30);
- from its device-scalar entry (offset and true_len read on the device),
  launches a grid of splits over the table row's whole length (max_pages)
  in which the splits past the frontier exit before loading a page and
  the merge waits for the live splits only: the same walk, and the same
  bits, as the host-scalar grid sized to the live pages.

This file emulates exactly that in torch (products of bf16 values summed
in fp64, where they are exact, then rounded once to fp32) and holds it to
the JAX kernel (``paged_prefill_attention`` in interpret mode) and to the
JAX reference at ``chip_smoke.ATOL``, bf16 and int8, at offsets whose
prefix ends one page short of a split edge, on it and one page past it,
with a chunk whose true_len < C; and the device-scalar grid's walk at
frontiers one page short of, on and one page past a split edge, which
must give the host-scalar grid's bits. It shows that a single bf16 P is
measurably further from the reference than the hi/lo split, and that
the wrapper's workspace follows the split constant.
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

PPS = tpa.PREFILL_PAGES_PER_SPLIT
NEG_INF = -1e30
LOG2E = 1.4426950408889634
HKV, HD = 2, 64
# The single-bf16 variant must be at least this many times further from
# the reference (before anything is rounded) than the split.
SPLIT_GAIN = 8.0


def _exact(a, b):
    """a @ b for fp32 tensors holding bf16 (or int8) values: every product
    is exact and their sum is exact in fp64, rounded once to fp32."""
    return (a.double() @ b.double()).float()


def _merge(parts):
    """Merge partials (m, l, acc) in list order, as the kernel does."""
    big_m = parts[0][0]
    for m, _, _ in parts[1:]:
        big_m = torch.maximum(big_m, m)
    big_l = torch.zeros_like(parts[0][1])
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        w = torch.exp2(m - big_m)
        big_l = big_l + l * w
        acc = acc + a * w[..., None]
    return big_m, big_l, acc


def emulate(q, k_pages, v_pages, table_row, offset, true_len, split=True,
            k_scales=None, v_scales=None, grid_pages=None, exits=None):
    """out fp32 [C, hkv, group, hd] as the kernel computes it (rows past
    true_len included: finite, and dropped by the caller). The grid's
    splits cover the live pages (the host-scalar entry) or
    ``grid_pages`` pages (the device-scalar entry: the table row's
    length); a split past the frontier exits and, when ``exits`` is a
    list, is appended to it."""
    C, hkv, group, hd = q.shape
    page = k_pages.shape[2]
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32) * LOG2E
    total = offset + true_len
    n_live = -(-total // page)
    idx = table_row.long()[:n_live]
    k = k_pages.float()[:, idx].reshape(hkv, n_live * page, hd)
    v = v_pages.float()[:, idx].reshape(hkv, n_live * page, hd)
    k[:, total:] = 0.0       # staged as zeros past the frontier
    v[:, total:] = 0.0
    quantized = k_scales is not None
    if quantized:
        ks = k_scales[:, idx].reshape(hkv, -1)
        vs = v_scales[:, idx].reshape(hkv, -1)
    # [hkv, rows, hd], rows = C x group (group fastest).
    qr = q.float().permute(1, 0, 2, 3).reshape(hkv, C * group, hd)
    qpos = offset + torch.arange(C * group) // group
    horizon = torch.clamp(qpos + 1, max=total)[None, :, None]
    splits = []
    n_splits = -(-n_live // PPS)
    for s in range(-(-(grid_pages or n_live) // PPS)):
        if s >= n_splits:       # past the frontier: exits at once
            if exits is not None:
                exits.append(s)
            continue
        m = torch.full((hkv, C * group), NEG_INF)
        l = torch.zeros((hkv, C * group))
        acc = torch.zeros((hkv, C * group, hd))
        for p in range(s * PPS, min((s + 1) * PPS, n_live)):
            keys = slice(p * page, (p + 1) * page)
            sc = _exact(qr, k[:, keys].transpose(-1, -2))
            if quantized:
                sc = sc * ks[:, None, keys]
            live = torch.arange(keys.start, keys.stop)[None, None, :] \
                < horizon
            sc = torch.where(live, sc * scale, torch.full_like(sc, NEG_INF))
            m_new = torch.maximum(m, sc.amax(-1))
            pr = torch.where(live, torch.exp2(sc - m_new[..., None]),
                             torch.zeros_like(sc))
            alpha = torch.exp2(m - m_new)
            l = l * alpha + pr.sum(-1)
            if quantized:
                pr = torch.where(live, pr * vs[:, None, keys],
                                 torch.zeros_like(pr))
            hi = pr.to(torch.bfloat16).float()
            acc = acc * alpha[..., None] + _exact(hi, v[:, keys])
            if split:
                lo = (pr - hi).to(torch.bfloat16).float()
                acc = acc + _exact(lo, v[:, keys])
            m = m_new
        splits.append((m, l, acc))
    _, big_l, acc = _merge(splits)
    out = acc / torch.clamp(big_l, min=1e-30)[..., None]
    return out.reshape(hkv, C, group, hd).permute(1, 0, 2, 3)


def _inputs(seed, group, page, quantized):
    """A 4-page chunk (q [C, hkv, group, hd], bf16 values) over a table
    with room for the last split-edge offset plus the chunk; bf16-valued
    pages, or int8 pages and scales by ``quantize_rows`` of the same
    rows. Returns (q, k, v, k_scales, v_scales, table_row)."""
    rng = np.random.default_rng(seed)
    C = 4 * page
    maxp = PPS + 5
    n_pages = maxp + 3
    row = rng.permutation(np.arange(1, n_pages))[:maxp].astype(np.int32)

    def bf16(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(torch.bfloat16).float()

    q = bf16((C, HKV, group, HD))
    k, v = bf16((HKV, n_pages, page, HD)), bf16((HKV, n_pages, page, HD))
    ks = vs = None
    if quantized:
        k, ks = tpa.quantize_rows(k)
        v, vs = tpa.quantize_rows(v)
    return q, k, v, ks, vs, torch.from_numpy(row)


def _offsets(page):
    """Prefix lengths one page short of the first split edge, on it, and
    one page past it."""
    edge = PPS * page
    return [edge - page, edge, edge + page]


def _jax(fn, q, k, v, ks, vs, row, offset, true_len):
    kw = {} if ks is None else {'k_scales': jnp.asarray(ks.numpy()),
                                'v_scales': jnp.asarray(vs.numpy())}
    return torch.from_numpy(np.array(fn(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), jnp.asarray(row.numpy()), offset, true_len,
        **kw)))


CASES = [(group, page, quantized) for group in (1, 4) for page in (16, 32)
         for quantized in (False, True)]


@pytest.mark.parametrize('group,page,quantized', CASES)
def test_prefill_arithmetic_meets_the_chip_tolerance(group, page,
                                                     quantized):
    q, k, v, ks, vs, row = _inputs(group + page, group, page, quantized)
    true_len = q.shape[0] - 5
    for offset in _offsets(page):
        got = emulate(q, k, v, row, offset, true_len, k_scales=ks,
                      v_scales=vs)
        assert torch.isfinite(got).all()
        for fn in (jpa.paged_prefill_attention,
                   jpa.paged_prefill_attention_reference):
            want = _jax(fn, q, k, v, ks, vs, row, offset, true_len)
            err = (got[:true_len] - want[:true_len]).abs().max().item()
            assert err <= chip_smoke.ATOL, (fn.__name__, offset, err)
    # The offsets straddle the edge: one split, then two.
    lives = [-(-(off + true_len) // page) for off in _offsets(page)]
    assert lives[0] > PPS and all(-(-n // PPS) == 2 for n in lives)


@pytest.mark.parametrize('group,page,quantized', CASES)
def test_device_scalar_grid_walk_equals_the_host_grid(group, page,
                                                      quantized):
    """Under the device-scalar entry's grid (splits over the whole table
    row, max_pages = PPS + 5 here: two splits), frontiers one page short
    of the split edge and on it leave the second split to exit, one page
    past it runs both; every case gives the host-scalar grid's output
    bitwise (which test_prefill_arithmetic_meets_the_chip_tolerance holds
    to JAX), for a full chunk and one 5 rows short, and the case on the
    edge meets the JAX kernel at chip_smoke.ATOL."""
    q, k, v, ks, vs, row = _inputs(3 * group + page, group, page, quantized)
    maxp, C, edge = row.shape[0], q.shape[0], PPS * page
    for true_len in (C, C - 5):
        for frontier_page, want_exits in ((PPS - 1, [1]), (PPS, [1]),
                                          (PPS + 1, [])):
            # The largest page-aligned offset whose frontier ends in
            # page frontier_page - 1.
            offset = (frontier_page * page - true_len) // page * page
            assert -(-(offset + true_len) // page) == frontier_page
            exits = []
            dev = emulate(q, k, v, row, offset, true_len, k_scales=ks,
                          v_scales=vs, grid_pages=maxp, exits=exits)
            host = emulate(q, k, v, row, offset, true_len, k_scales=ks,
                           v_scales=vs)
            assert exits == want_exits, (offset, true_len, exits)
            assert torch.equal(dev, host)
            if true_len < C and frontier_page == PPS:
                # On the edge, with a split that exits: the JAX kernel.
                want = _jax(jpa.paged_prefill_attention, q, k, v, ks, vs,
                            row, offset, true_len)
                err = (dev[:true_len] - want[:true_len]).abs().max().item()
                assert err <= chip_smoke.ATOL, (offset, true_len, err)
    assert -(-maxp // PPS) == 2 and edge == PPS * page


@pytest.mark.parametrize('page,quantized', [(16, False), (32, False),
                                            (16, True), (32, True)])
def test_hi_lo_split_of_p_is_needed(page, quantized):
    """Before the output meets any tolerance: a single bf16 P is at least
    SPLIT_GAIN times further from the reference than the hi/lo split."""
    q, k, v, ks, vs, row = _inputs(7 + page, 4, page, quantized)
    offset, true_len = PPS * page, q.shape[0] - 5
    want = _jax(jpa.paged_prefill_attention_reference, q, k, v, ks, vs, row,
                offset, true_len)[:true_len]
    errs = [(emulate(q, k, v, row, offset, true_len, split=split,
                     k_scales=ks, v_scales=vs)[:true_len]
             - want).abs().max().item() for split in (True, False)]
    assert errs[1] > SPLIT_GAIN * errs[0], errs


def test_wrapper_scratch_follows_the_prefill_split(monkeypatch):
    """The prefill workspace holds one partial of the chunk's rows x (hd +
    2) fp32 per KV head and split of the live pages; the counters one
    int32 per KV head and 16-row tile; both are kept per device apart from
    the decode kernel's and grown when a launch needs more; a library
    whose split constant differs from the wrapper's is refused."""
    built = {'paged_pages_per_split': tpa.PAGES_PER_SPLIT,
             'paged_prefill_pages_per_split': PPS}
    monkeypatch.setattr(tpa, '_kernel', lambda symbol: lambda: built[symbol])
    monkeypatch.setattr(tpa, '_split_buffers', {})
    tpa._checked_pages_per_split.cache_clear()
    try:
        q = torch.zeros(1)
        ws, counters = tpa._prefill_scratch(q, 8, 1024, 128, 32)
        assert ws.dtype == torch.float32
        assert ws.numel() == 8 * -(-32 // PPS) * 1024 * 130
        assert counters.dtype == torch.int32
        assert counters.numel() == 8 * 1024 // 16 and not counters.any()
        small = tpa._prefill_scratch(q, 8, 256, 128, 7)
        assert small[0] is ws and small[1] is counters
        dws, _ = tpa._split_scratch(q, 8, 8, 4, 128, 32)
        assert dws is not ws
        built['paged_prefill_pages_per_split'] = PPS + 1
        tpa._checked_pages_per_split.cache_clear()
        with pytest.raises(RuntimeError, match='paged_prefill.cu splits'):
            tpa._prefill_scratch(q, 8, 1024, 128, 32)
    finally:
        tpa._checked_pages_per_split.cache_clear()
