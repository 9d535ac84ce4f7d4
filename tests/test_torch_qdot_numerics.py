"""The layout and arithmetic of the W8A16 product kernel, emulated on the
CPU.

``csrc/qdot_int8.cu`` computes y = bf16(bf16(x @ q) * scale) as y^T =
q^T x^T: a block's consumer warpgroup holds 128 output columns as the A
side of two wgmma products per 16-deep step, A from registers. It:

- receives each 64 x 128 int8 weight box by TMA under the 128-byte
  swizzle (16-byte chunk j of row r at chunk j ^ (r % 8));
- has thread (warp w, g = lane / 4, t = lane % 4) read one 32-bit word of
  staged rows 2t, 2t + 1, 2t + 8 and 2t + 9 of each 16-deep step, at the
  4 columns 32w + 4g .. + 3, and turn each byte into a bf16 exactly
  (byte_perm under the exponent of 2^23, minus 2^23 + 128), pairing
  K-neighbours in one register (the lower K in the lower half);
- so A row 16w + g (+ 8) of product p carries column 32w + 4g + 2p (+ 1);
- sums each K-split's 16-deep products in order in fp32, hands the sums
  of 8-row group j to block j % S of the cluster (local row (j / S) * 8 +
  r % 8, split sp at [lr][sp]), which adds the splits in order, rounds
  to bf16, multiplies by the column's bf16 scale and rounds again.

This file emulates each of those steps in numpy and torch: the fragment
reads from the swizzled box give every A register the weight value the
column mapping promises, the convert is exact for all 256 bytes, the
exchange sends every row to one merging block and back to its own
index within the receive tiles the source sizes, and the emulated
product agrees with the JAX ``qdot`` and the port's plain version at
``chip_smoke.py``'s ``QDOT_RTOL`` / ``QDOT_ATOL_FRAC`` at the 350m
model's smallest weight and an N off the 128-column tile.
"""
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import chip_smoke
from skypilot_tpu.ops import quant as jquant
from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import quant as tquant

SRC = (_build.SRC_DIR / 'qdot_int8.cu').read_text()


def _const(name: str) -> int:
    return int(re.search(rf'constexpr int {name} = (\d+);', SRC).group(1))


BK, BN = _const('kBK'), _const('kBN')
MAX_SPLITS, RING = _const('kMaxSplits'), _const('kRingBytes')
PART_ROW = BN + 4  # kPartRow


def swizzled(box: np.ndarray) -> np.ndarray:
    """A [64, 128] int8 box as TMA lays it into shared memory under the
    128-byte swizzle, as a flat byte array."""
    rows = box.shape[0]
    out = np.zeros(rows * 128, dtype=np.uint8)
    for r in range(rows):
        for j in range(8):
            dst = r * 128 + ((j ^ (r % 8)) << 4)
            out[dst:dst + 16] = box[r, 16 * j:16 * j + 16].view(np.uint8)
    return out


def word(smem: np.ndarray, offset: int) -> int:
    return int(smem[offset:offset + 4].view('<u4')[0])


def byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm: byte i of the result is byte (s >> 4i) & 7 of
    the 8 bytes of (x, y)."""
    pool = x.to_bytes(4, 'little') + y.to_bytes(4, 'little')
    return int.from_bytes(
        bytes(pool[(s >> (4 * i)) & 7] for i in range(4)), 'little')


def f32_bits(v: float) -> int:
    return int(np.array(v, dtype=np.float32).view(np.uint32))


def bits_f32(b: int) -> float:
    return float(np.array(b, dtype=np.uint32).view(np.float32))


def b_pairs(lo: int, hi: int):
    """The kernel's b_pairs: 4 registers, each the bf16 pair (lo's byte
    j, hi's byte j), the lower K in the lower half."""
    lo ^= 0x80808080
    hi ^= 0x80808080

    def as_f32(w, e):
        return f32_bits(np.float32(bits_f32(byte_perm(w, 0x4B000000, 0x7540 | e)))
                        - np.float32(8388736.0))

    return [byte_perm(as_f32(lo, j), as_f32(hi, j), 0x7632)
            for j in range(4)]


def bf16_value(half: int) -> float:
    return bits_f32(half << 16)


def fragments(box: np.ndarray):
    """A[p][row][k] of both products over a 64-deep step, read from the
    swizzled box as the kernel's 128 threads read and convert it."""
    smem = swizzled(box)
    a = np.full((2, 64, BK), np.nan)
    for tid in range(128):
        warp, lane = tid // 32, tid % 32
        g, t = lane // 4, lane % 4
        chunk, wd = 2 * warp + (g >> 2), 4 * (g & 3)
        even = 2 * t * 128 + ((chunk ^ (2 * t)) << 4) + wd
        odd = (2 * t + 1) * 128 + ((chunk ^ (2 * t + 1)) << 4) + wd
        for kk in range(BK // 16):
            base = kk * 16 * 128
            lo = b_pairs(word(smem, base + even), word(smem, base + odd))
            hi = b_pairs(word(smem, base + even + 1024),
                         word(smem, base + odd + 1024))
            for p in range(2):
                regs = (lo[2 * p], lo[2 * p + 1], hi[2 * p], hi[2 * p + 1])
                # m64k16 A fragment: reg 0 (row g, k 2t..2t+1), reg 1
                # (row g + 8), reg 2 (row g, k + 8), reg 3 (row g + 8, k + 8).
                for i, reg in enumerate(regs):
                    row = 16 * warp + g + 8 * (i & 1)
                    k = 16 * kk + 2 * t + 8 * (i >> 1)
                    a[p, row, k] = bf16_value(reg & 0xFFFF)
                    a[p, row, k + 1] = bf16_value(reg >> 16)
    return a


def test_convert_is_exact_for_every_byte():
    every = np.arange(-128, 128, dtype=np.int8).reshape(64, 4)
    for lo_row, hi_row in zip(every[0::2], every[1::2]):
        regs = b_pairs(int(lo_row.view('<u4')[0]), int(hi_row.view('<u4')[0]))
        for j, reg in enumerate(regs):
            assert bf16_value(reg & 0xFFFF) == float(lo_row[j])
            assert bf16_value(reg >> 16) == float(hi_row[j])


@pytest.mark.parametrize('seed', [0, 1])
def test_fragments_carry_the_promised_columns(seed):
    """Every A register value is the weight at (k, column) for the
    column its fragment row carries: A row 16w + g + 8h of product p is
    column 32w + 4g + 2p + h."""
    box = np.random.default_rng(seed).integers(
        -127, 128, size=(BK, 128)).astype(np.int8)
    a = fragments(box)
    assert not np.isnan(a).any()
    for p in range(2):
        for row in range(64):
            w, rest = divmod(row, 16)
            g, h = rest % 8, rest // 8
            col = 32 * w + 4 * g + 2 * p + h
            np.testing.assert_array_equal(a[p, row], box[:, col])


def recv_rows(tt: int) -> int:
    """The source's recv_rows: receive tile rows at the worst split."""
    return max(-(-8 * tt // s) * 8 * s for s in range(1, MAX_SPLITS + 1))


@pytest.mark.parametrize('tt', [1, 2])
@pytest.mark.parametrize('splits', range(1, MAX_SPLITS + 1))
def test_exchange_sends_every_row_once_and_back(tt, splits):
    """Row r (8-row group j) goes to block j % S at receive row (lr * S +
    split); the merging block's loop over its local rows lr = tid / 16 +
    8i maps each back to r, and every index lies inside the receive
    tiles, which fit over the ring."""
    rows = 64 * tt
    sent = {}
    for r in range(rows):
        j = r // 8
        owner, lr = j % splits, (j // splits) * 8 + r % 8
        for split in range(splits):
            slot = lr * splits + split
            assert slot < recv_rows(tt)
            assert (owner, slot) not in sent
            sent[(owner, slot)] = r
    merged = []
    for rank in range(splits):
        for tid in range(128):
            lr = tid // (BN // 8)
            while True:
                r = (lr // 8 * splits + rank) * 8 + lr % 8
                if r >= rows:
                    break
                assert all(sent[(rank, lr * splits + sp)] == r
                           for sp in range(splits))
                if tid % (BN // 8) == 0:
                    merged.append(r)
                lr += 128 // (BN // 8)
    assert sorted(merged) == list(range(rows))
    stage = (1 + tt) * 8192
    assert recv_rows(tt) * PART_ROW * 4 <= RING // stage * stage


def emulated(x: torch.Tensor, w, splits: int) -> torch.Tensor:
    """The kernel's arithmetic: each split's fp32 sum of exact bf16
    products (fp64, rounded once a 64-deep step), the splits added in
    order in fp32, then the two bf16 roundings."""
    k = w.q.shape[0]
    steps = k // BK
    xd = x.double()
    qd = w.q.double()
    total = None
    for sp in range(splits):
        s0, s1 = sp * steps // splits, (sp + 1) * steps // splits
        part = torch.zeros((x.shape[0], w.q.shape[1]), dtype=torch.float32)
        for i in range(s0, s1):
            sl = slice(i * BK, (i + 1) * BK)
            part = (part.double() + xd[:, sl] @ qd[sl]).float()
        total = part if total is None else total + part
    return (total.to(torch.bfloat16).float()
            * w.scale.float()).to(torch.bfloat16)


@pytest.mark.parametrize('shape,splits', [((1024, 512), 4), ((1024, 1040), 8)])
def test_emulated_product_matches_the_references(shape, splits):
    k, n = shape
    rng = np.random.default_rng(7)
    w_np = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    x_np = rng.standard_normal((17, k)).astype(np.float32)
    wt = tquant.quantize_weight(torch.from_numpy(w_np).to(torch.bfloat16))
    x = torch.from_numpy(x_np).to(torch.bfloat16)
    got = emulated(x, wt, splits).float()
    wj = jquant.quantize_weight(jnp.asarray(w_np).astype(jnp.bfloat16))
    want = torch.from_numpy(np.asarray(
        jquant.qdot(jnp.asarray(x_np).astype(jnp.bfloat16), wj),
        dtype=np.float32))
    for ref in (want, tquant.qdot_reference(x, wt).float()):
        err, ok = chip_smoke.compare(torch, got, ref, chip_smoke.QDOT_RTOL,
                                     chip_smoke.QDOT_ATOL_FRAC)
        assert ok, err
    # Rows are independent of M: the first row alone gives its bits.
    assert torch.equal(emulated(x[:1], wt, splits), got[:1].to(torch.bfloat16))
