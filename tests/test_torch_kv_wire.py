"""The port's copy of the KV prefix wire format
(``skypilot_tpu_torch/infer/kv_wire.py``) against the JAX package's
(``skypilot_tpu/infer/kv_wire.py``), on the same seeded pages: ``pack``
gives byte-identical blobs (CRCs and header JSON included), each side
unpacks the other's blob to the same arrays, every malformed blob of the
reference's own tests raises the port's ``WireError``, and
``quantize_rows_np`` is bitwise the port's ``quantize_rows`` (the int8
pages' write path) on the same rows."""
import json
import struct
import zlib

import numpy as np
import pytest
import torch

from skypilot_tpu.infer import kv_wire as jwire
from skypilot_tpu_torch.infer import kv_wire as twire
from skypilot_tpu_torch.ops import paged_attention as tpa

pytestmark = pytest.mark.jax

PAGE, L, HKV, HD = 16, 2, 2, 8


def _pages(rng, n):
    k = rng.integers(-127, 128, size=(L, HKV, n, PAGE, HD)).astype(np.int8)
    v = rng.integers(-127, 128, size=(L, HKV, n, PAGE, HD)).astype(np.int8)
    ks = rng.random((L, HKV, n, PAGE), dtype=np.float32) + 0.5
    vs = rng.random((L, HKV, n, PAGE), dtype=np.float32) + 0.5
    return k, v, ks, vs


def _good_blob(n=2, seed=3):
    rng = np.random.default_rng(seed)
    return twire.pack(list(range(n * PAGE)), PAGE, *_pages(rng, n))


@pytest.mark.parametrize('n', [1, 3])
def test_pack_byte_identical_and_cross_unpack(n):
    rng = np.random.default_rng(n)
    arrays = _pages(rng, n)
    toks = [int(t) for t in rng.integers(0, 128256, size=n * PAGE - 3)]
    blob = twire.pack(toks, PAGE, *arrays)
    assert blob == jwire.pack(toks, PAGE, *arrays)
    assert twire.MAGIC == jwire.MAGIC
    assert (len(blob) - len(twire.MAGIC) - 4
            - struct.unpack_from('<I', blob, len(twire.MAGIC))[0]
            == n * twire.page_wire_bytes(L, HKV, PAGE, HD))
    assert (twire.page_wire_bytes(32, 8, 64, 128)
            == jwire.page_wire_bytes(32, 8, 64, 128))
    for blk in (twire.unpack(blob), jwire.unpack(blob)):
        assert blk.tokens == toks and blk.page_size == PAGE
        assert blk.n_pages == n
        for got, want in zip((blk.k, blk.v, blk.k_scales, blk.v_scales),
                             arrays):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype


@pytest.mark.parametrize('mutate, what', [
    (lambda b: b'XXYKV1\n' + b[7:], 'bad magic'),
    (lambda b: b[:9], 'truncated header length'),
    (lambda b: b[:20], 'truncated header'),
    (lambda b: b[:-5], 'payload size mismatch'),
    (lambda b: b + b'\x00' * 8, 'payload size mismatch'),
], ids=['magic', 'hdr-len', 'hdr', 'short-payload', 'long-payload'])
def test_unpack_rejects_malformed(mutate, what):
    bad = mutate(_good_blob())
    with pytest.raises(twire.WireError, match=what):
        twire.unpack(bad)
    with pytest.raises(jwire.WireError, match=what):
        jwire.unpack(bad)


def test_unpack_rejects_flipped_byte_and_token_overflow():
    blob = bytearray(_good_blob())
    blob[-1] ^= 0x40
    with pytest.raises(twire.WireError, match='CRC'):
        twire.unpack(bytes(blob))
    k, v, ks, vs = _pages(np.random.default_rng(2), 1)
    with pytest.raises(twire.WireError):
        twire.pack(list(range(PAGE + 1)), PAGE, k, v, ks, vs)


def test_unpack_rejects_doctored_header():
    blob = _good_blob()
    off = len(twire.MAGIC)
    (hlen,) = struct.unpack_from('<I', blob, off)
    hdr = json.loads(blob[off + 4:off + 4 + hlen].decode())
    assert zlib.crc32(b'') not in hdr['page_crc32']
    hdr['n_pages'], hdr['page_crc32'] = 1, hdr['page_crc32'][:1]
    hdr['tokens'] = hdr['tokens'][:PAGE]
    hdr['page_size'] = 2 * PAGE
    doctored = json.dumps(hdr, sort_keys=True).encode()
    blob2 = (twire.MAGIC + struct.pack('<I', len(doctored)) + doctored
             + blob[off + 4 + hlen:])
    with pytest.raises(twire.WireError):
        twire.unpack(blob2)
    for bad_hdr in (b'{not json', json.dumps({'tokens': []}).encode()):
        with pytest.raises(twire.WireError, match='bad header'):
            twire.unpack(twire.MAGIC + struct.pack('<I', len(bad_hdr))
                         + bad_hdr)


@pytest.mark.parametrize('scale', [3.0, 1e-3, 400.0])
def test_quantize_rows_np_is_bitwise_the_port_quantizer(scale):
    """bf16 rows (what a bf16 pool holds) and fp32 rows, an all-zero row
    and rows whose values land on .5 of a step: the numpy mirror, the JAX
    package's mirror and the port's write-path quantizer agree bit for
    bit."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.normal(size=(3, 5, 7, HD)) * scale)
                         .astype(np.float32))
    x[1, 2, 3] = 0.0
    x[0, 0, 0] = torch.arange(HD, dtype=torch.float32) - 3.5
    for rows in (x, x.to(torch.bfloat16)):
        qt, st = tpa.quantize_rows(rows)
        qn, sn = twire.quantize_rows_np(rows.float().numpy())
        qj, sj = jwire.quantize_rows_np(rows.float().numpy())
        np.testing.assert_array_equal(qn, qt.numpy())
        np.testing.assert_array_equal(sn.view(np.int32),
                                      st.numpy().view(np.int32))
        np.testing.assert_array_equal(qn, qj)
        np.testing.assert_array_equal(sn, sj)
        np.testing.assert_array_equal(
            twire.dequantize_rows_np(qn, sn),
            jwire.dequantize_rows_np(qn, sn))
    assert float(sn[1, 2, 3]) == 1.0 and not qn[1, 2, 3].any()
