"""The arithmetic of the fused cross-entropy forward kernel, emulated on
the CPU.

``csrc/ce_fwd.cu`` splits the vocabulary across CTAs and folds each
logits tile into running statistics in registers, while the reference
(``skypilot_tpu/ops/cross_entropy.py`` ``_ce_fwd_kernel``) walks every
vocab tile of a row block in one sequential grid axis. The kernel:

- cuts T into ``CE_BLOCK_T``-row tiles (rows past T are TMA's zero rows:
  computed, then dropped) and V into ``CE_BLOCK_V``-column tiles,
  ``CE_TILES_PER_SPLIT`` consecutive tiles to a split;
- forms each tile's logits from bf16 x and w, every product exact and
  summed in fp32;
- sets columns >= V (TMA's zero fill) to -1e30 before the max and the
  sum, and keeps each split's running max m (natural units, from -1e30),
  sum l of exp2(logit * log2 e - m * log2 e) and target logit tl, the
  target picked only in the tile that holds its column;
- merges the splits' (m, l, tl) in split order: m = max m_i,
  l = sum l_i exp2((m_i - m) log2 e), tl = sum tl_i, then
  lse = m + log(max(l, 1e-30)) and nll = lse - tl.

This file emulates exactly that in torch (products of bf16 values summed
in fp64, where they are exact, then rounded once to fp32) and holds it to
the JAX kernel (``_fused_fwd`` in interpret mode) and to the port's plain
``fused_forward_reference`` at ``chip_smoke.py``'s fp32 tolerances, at
vocabularies one tile short of, on and one tile past a split edge, at a
vocabulary and a T that are not multiples of the tiles, and with targets
at -1, V, V - 1 and on a split boundary. It shows that the column mask
is needed, that a split with no valid column weighs exactly 0, and that
the wrapper's tiles and workspace follow the source's constants.
"""
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import chip_smoke
from skypilot_tpu.ops import cross_entropy as jce
from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import cross_entropy as tce

jax.config.update('jax_default_matmul_precision', 'highest')

BT, BV, TPS = tce.CE_BLOCK_T, tce.CE_BLOCK_V, tce.CE_TILES_PER_SPLIT
EDGE = BV * TPS          # vocabulary columns of one split
NEG_INF = -1e30
LOG2E = 1.4426950408889634


def _merge(parts):
    """(lse [T], tl [T]) of split partials (m, l, tl), in list order."""
    big_m = parts[0][0]
    for m, _, _ in parts[1:]:
        big_m = torch.maximum(big_m, m)
    big_l = torch.zeros_like(big_m)
    big_tl = torch.zeros_like(big_m)
    for m, l, tl in parts:
        big_l = big_l + l * torch.exp2((m - big_m) * LOG2E)
        big_tl = big_tl + tl
    return big_m + torch.log(torch.clamp(big_l, min=1e-30)), big_tl


def split_partials(x, w, targets, mask=True):
    """Each split's (m, l, tl) over the rows of x padded to whole row
    tiles, as the kernel's CTAs compute them."""
    t, _ = x.shape
    v = w.shape[1]
    rows = -(-t // BT) * BT
    xp = torch.zeros((rows, x.shape[1]), dtype=torch.float32)
    xp[:t] = x.float()
    tgt = torch.full((rows,), -1, dtype=torch.long)
    tgt[:t] = targets.long()
    tgt = torch.where((tgt >= 0) & (tgt < v), tgt, torch.full_like(tgt, -1))
    n_vt = -(-v // BV)
    parts = []
    for s in range(-(-n_vt // TPS)):
        m = torch.full((rows,), NEG_INF)
        l = torch.zeros(rows)
        tl = torch.zeros(rows)
        for vt in range(s * TPS, min((s + 1) * TPS, n_vt)):
            v0 = vt * BV
            wt = torch.zeros((w.shape[0], BV), dtype=torch.float32)
            wt[:, :min(BV, v - v0)] = w[:, v0:v0 + BV].float()  # zero fill
            logits = (xp.double() @ wt.double()).float()
            cols = v0 + torch.arange(BV)
            if mask:
                logits = torch.where(cols[None, :] < v, logits,
                                     torch.full_like(logits, NEG_INF))
            m_new = torch.maximum(m, logits.amax(-1))
            l = l * torch.exp2((m - m_new) * LOG2E) + torch.exp2(
                logits * LOG2E - (m_new * LOG2E)[:, None]).sum(-1)
            m = m_new
            hit = cols[None, :] == tgt[:, None]
            tl = tl + torch.where(hit, logits, torch.zeros_like(logits)).sum(-1)
        parts.append((m, l, tl))
    return parts


def emulate(x, w, targets, mask=True):
    """(nll [T], lse [T, 1]) fp32 as the kernel computes them."""
    t = x.shape[0]
    lse, tl = _merge(split_partials(x, w, targets, mask))
    return (lse - tl)[:t], lse[:t, None]


def _inputs(seed, T, d, V):
    """bf16-valued x [T, d], w [d, V] (scaled by d^-1/2, so logits are
    O(1)) and targets with -1, V, V - 1 and the first column of the
    second split (where V has one) up front."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, d)).astype(np.float32)
    w = (rng.normal(size=(d, V)) * d ** -0.5).astype(np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    w = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
    tgt = rng.integers(0, V, size=(T,)).astype(np.int32)
    tgt[:4] = [-1, V, V - 1, EDGE % V]
    if V > EDGE:
        tgt[4] = EDGE - 1
    return x, w, tgt


def _jax_fused_fwd(x, w, tgt):
    """The JAX kernel in interpret mode, with the largest row block up to
    128 and vocab block up to 512 that divide T and V."""
    t, v = x.shape[0], w.shape[1]
    nll, lse = jce._fused_fwd(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(tgt), jce._auto_block(t, 128),
                              jce._auto_block(v, 512), True)
    return torch.from_numpy(np.array(nll)), torch.from_numpy(np.array(lse))


def _assert_close(got, want, name):
    err, ok = chip_smoke.compare(torch, got, want, chip_smoke.FP32_RTOL,
                                 chip_smoke.FP32_ATOL_FRAC)
    assert ok, (name, err)


# (T, d, V): V one tile short of the split edge, on it and one tile
# past it; V 1000 (not a multiple of 64 or of the tile); T 100 (not a
# multiple of the row tile).
CASES = [(64, 64, EDGE - BV), (64, 64, EDGE), (64, 64, EDGE + BV),
         (100, 64, 1000), (136, 128, 256)]


@pytest.mark.parametrize('T,d,V', CASES)
def test_ce_arithmetic_meets_the_chip_tolerance(T, d, V):
    x, w, tgt = _inputs(T + V, T, d, V)
    tx, tw, tt = (torch.from_numpy(a) for a in (x, w, tgt))
    nll, lse = emulate(tx, tw, tt)
    assert nll.shape == (T,) and lse.shape == (T, 1)
    assert torch.isfinite(nll).all() and torch.isfinite(lse).all()
    j_nll, j_lse = _jax_fused_fwd(x, w, tgt)
    r_nll, r_lse = tce.fused_forward_reference(tx, tw, tt, 8)
    for name, got, want in (('nll vs jax', nll, j_nll),
                            ('lse vs jax', lse, j_lse),
                            ('nll vs plain', nll, r_nll),
                            ('lse vs plain', lse, r_lse)):
        _assert_close(got, want, name)
    # Targets outside [0, V) pick nothing: the NLL is the logsumexp.
    assert nll[0] == lse[0, 0] and nll[1] == lse[1, 0]


def test_split_edge_cases_straddle_the_edge():
    """The edge cases give one split, one full split, then two."""
    splits = [-(-(-(-V // BV)) // TPS) for _, _, V in CASES[:3]]
    assert splits == [1, 1, 2]
    assert -(-(EDGE - BV) // BV) == TPS - 1


def test_target_on_a_split_boundary_is_picked_once():
    """A target on the first column of the second split (and the last of
    the first) is picked by that split alone."""
    x, w, tgt = _inputs(5, 64, 64, EDGE + BV)
    tx, tw, tt = (torch.from_numpy(a) for a in (x, w, tgt))
    parts = split_partials(tx, tw, tt)
    logits = (tx.double() @ tw.double()).float()
    for row, col in ((3, EDGE), (4, EDGE - 1)):
        owner = col // EDGE
        assert parts[owner][2][row] == logits[row, col]
        assert parts[1 - owner][2][row] == 0.0


def test_column_mask_is_needed():
    """Without the mask, the zero columns past V of the last tile are
    logits of 0, each adding exp(-m) to l: the result leaves the
    tolerance."""
    x, w, tgt = _inputs(9, 100, 64, 1000)
    tx, tw, tt = (torch.from_numpy(a) for a in (x, w, tgt))
    want, _ = tce.fused_forward_reference(tx, tw, tt, 8)
    got, _ = emulate(tx, tw, tt, mask=False)
    _, ok = chip_smoke.compare(torch, got, want, chip_smoke.FP32_RTOL,
                               chip_smoke.FP32_ATOL_FRAC)
    assert not ok


def test_a_split_without_valid_columns_weighs_zero():
    """A partial (m = -1e30, l = 0, tl = 0) changes no bit of the merge,
    wherever it stands in the order."""
    x, w, tgt = _inputs(11, 64, 64, EDGE + BV)
    tx, tw, tt = (torch.from_numpy(a) for a in (x, w, tgt))
    parts = split_partials(tx, tw, tt)
    empty = (torch.full_like(parts[0][0], NEG_INF),
             torch.zeros_like(parts[0][1]), torch.zeros_like(parts[0][2]))
    want = _merge(parts)
    for order in ([empty] + parts, parts[:1] + [empty] + parts[1:],
                  parts + [empty]):
        got = _merge(order)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _source_constant(name):
    text = (_build.SRC_DIR / 'ce_fwd.cu').read_text()
    found = re.findall(rf'constexpr int {name} = (\d+);', text)
    assert len(found) == 1, name
    return int(found[0])


def test_wrapper_tiles_match_the_source():
    assert tce.CE_TILES_PER_SPLIT == _source_constant('kTilesPerSplit')
    assert tce.CE_BLOCK_V == _source_constant('kBN')
    assert tce.CE_BLOCK_T == _source_constant('kBT')


def test_wrapper_scratch_follows_the_split(monkeypatch):
    """The workspace holds one (m, l, tl) partial of 128 rows per row tile
    and split, the counters one int32 per row tile; both are kept per
    device and grown when a launch needs more; a library whose tiles
    differ from the wrapper's is refused at the first launch."""
    from skypilot_tpu_torch.ops import paged_attention as tpa
    monkeypatch.setattr(tpa, '_split_buffers', {})
    device = torch.device('cpu')
    ws, counters = tce._scratch(device, 12288, 32768)
    n_splits = -(-(32768 // BV) // TPS)
    assert ws.dtype == torch.float32 and counters.dtype == torch.int32
    assert ws.numel() == 96 * n_splits * 3 * BT
    assert counters.numel() == 96 and not counters.any()
    small = tce._scratch(device, 100, 1000)
    assert small[0] is ws and small[1] is counters
    # Llama-3's head at T 512 fits in the same buffers; twice the rows
    # grow them.
    head = tce._scratch(device, 512, 128256)
    assert head[0] is ws and 4 * -(-(-(-128256 // BV)) // TPS) * 3 * BT \
        <= ws.numel()
    grown, more = tce._scratch(device, 2 * 12288, 32768)
    assert grown.numel() == 2 * ws.numel() and more.numel() == 192

    class Lib:
        ce_fwd_bf16 = staticmethod(lambda *args: 0)

        @staticmethod
        def ce_fwd_block_v():
            return BV

        @staticmethod
        def ce_fwd_tiles_per_split():
            return TPS + 1

    monkeypatch.setattr(_build, 'library', lambda name: Lib)
    tce._kernel.cache_clear()
    try:
        with pytest.raises(RuntimeError, match='ce_fwd_tiles_per_split'):
            tce._kernel()
    finally:
        tce._kernel.cache_clear()
