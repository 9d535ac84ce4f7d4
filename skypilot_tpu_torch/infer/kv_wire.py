"""On-wire format for streamed KV prefix pages (fleet disaggregation).

A donor replica exports a cached prefix's pages; the puller imports
them into its own PageAllocator + radix tree and prefills only from the
boundary. The wire dtype is ALWAYS int8 + fp32 row scales — the int8 KV
page format, half the bytes of bf16 — so:

- int8 pool -> int8 pool round-trips BYTE-EXACT (the bit-identity gate
  rides on this),
- bf16 pools quantize on export with the exact quantize_rows scheme the
  int8 cache uses on write (deterministic round-to-nearest, absmax/127,
  zero rows get scale 1.0), so a bf16 puller lands within the int8
  pages' pinned tolerance of a local recompute.

Layout (little-endian lengths, network-order-free by construction):

    MAGIC 'SKYKV1\\n'
    u32 header_len | header JSON (utf-8)
    per page: k int8 [L,hkv,page,hd] | v int8 | k_scales f32 [L,hkv,page]
              | v_scales f32

The header carries geometry, the prefix token ids, and one CRC32 per
page over that page's payload slice. Any mismatch — magic, geometry,
CRC — raises WireError; callers degrade to plain recompute, never an
error surface.

Host-side numpy only: export/import are control-plane moves (once per
routed miss), not step-loop work. A copy of
``skypilot_tpu/infer/kv_wire.py`` (the port imports nothing of the JAX
package): the bytes on the wire are identical, CRCs and header JSON
included, so a JAX replica imports a torch replica's blob and the
reverse.
"""
from __future__ import annotations

import dataclasses
import json
import struct
import zlib
from typing import List, Sequence

import numpy as np

MAGIC = b'SKYKV1\n'

# Wire bytes of one page across every layer and KV head: int8 K + int8
# V values plus one f32 scale per row each.
def page_wire_bytes(n_layers: int, n_kv_heads: int, page: int,
                    head_dim: int) -> int:
    values = n_layers * n_kv_heads * page * head_dim      # int8, x2 (K+V)
    scales = n_layers * n_kv_heads * page * 4             # f32, x2
    return 2 * values + 2 * scales


class WireError(ValueError):
    """Malformed/corrupt KV blob — the import path treats this as a
    cache miss (recompute), never a request failure."""


@dataclasses.dataclass
class KVWireBlock:
    """A decoded prefix transfer: ``n`` pages covering ``tokens``."""
    tokens: List[int]
    page_size: int
    k: np.ndarray          # int8 [L, hkv, n, page, hd]
    v: np.ndarray          # int8 [L, hkv, n, page, hd]
    k_scales: np.ndarray   # f32  [L, hkv, n, page]
    v_scales: np.ndarray   # f32  [L, hkv, n, page]

    @property
    def n_pages(self) -> int:
        return self.k.shape[2]


def quantize_rows_np(x: np.ndarray):
    """Numpy mirror of ``ops.paged_attention.quantize_rows``: it MUST
    stay bit-compatible (same absmax/127, same round-half-to-even, same
    all-zero-row scale of 1.0) or bf16 exports drift from what the
    donor's own int8 cache would have held."""
    xf = np.asarray(x, np.float32)
    absmax = np.max(np.abs(xf), axis=-1)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(xf / scale[..., None]), -127, 127)
    return q.astype(np.int8), scale


def dequantize_rows_np(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    return np.asarray(q, np.float32) * np.asarray(
        scales, np.float32)[..., None]


def _page_slices(k, v, ks, vs, i):
    """The four per-page payload arrays, C-contiguous."""
    return (np.ascontiguousarray(k[:, :, i]),
            np.ascontiguousarray(v[:, :, i]),
            np.ascontiguousarray(ks[:, :, i]),
            np.ascontiguousarray(vs[:, :, i]))


def pack(tokens: Sequence[int], page_size: int,
         k: np.ndarray, v: np.ndarray,
         k_scales: np.ndarray, v_scales: np.ndarray) -> bytes:
    """Serialize gathered pages (already int8 + scales, page axis 2,
    shape [L, hkv, n, page, hd]) into one blob."""
    k = np.asarray(k, np.int8)
    v = np.asarray(v, np.int8)
    ks = np.asarray(k_scales, np.float32)
    vs = np.asarray(v_scales, np.float32)
    n = k.shape[2]
    if len(tokens) > n * page_size:
        raise WireError(f'{len(tokens)} tokens exceed {n} pages '
                        f'of {page_size}')
    payload = bytearray()
    crcs: List[int] = []
    for i in range(n):
        start = len(payload)
        for arr in _page_slices(k, v, ks, vs, i):
            payload += arr.tobytes()
        crcs.append(zlib.crc32(bytes(payload[start:])))
    header = json.dumps({
        'tokens': [int(t) for t in tokens],
        'page_size': int(page_size),
        'n_pages': int(n),
        'n_layers': int(k.shape[0]),
        'n_kv_heads': int(k.shape[1]),
        'head_dim': int(k.shape[4]),
        'page_crc32': crcs,
    }, sort_keys=True).encode()
    return (MAGIC + struct.pack('<I', len(header)) + header
            + bytes(payload))


def unpack(blob: bytes) -> KVWireBlock:
    """Decode and CRC-verify a blob. Raises WireError on anything
    short, malformed, or corrupt."""
    if not blob.startswith(MAGIC):
        raise WireError('bad magic')
    off = len(MAGIC)
    if len(blob) < off + 4:
        raise WireError('truncated header length')
    (hlen,) = struct.unpack_from('<I', blob, off)
    off += 4
    if len(blob) < off + hlen:
        raise WireError('truncated header')
    try:
        hdr = json.loads(blob[off:off + hlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise WireError(f'bad header: {exc}') from exc
    off += hlen
    try:
        tokens = [int(t) for t in hdr['tokens']]
        page, n = int(hdr['page_size']), int(hdr['n_pages'])
        layers, hkv = int(hdr['n_layers']), int(hdr['n_kv_heads'])
        hd = int(hdr['head_dim'])
        crcs = [int(c) for c in hdr['page_crc32']]
    except (KeyError, TypeError, ValueError) as exc:
        raise WireError(f'bad header fields: {exc}') from exc
    if n <= 0 or len(crcs) != n or len(tokens) > n * page:
        raise WireError('inconsistent geometry')
    vals_sz = layers * hkv * page * hd
    scl_sz = layers * hkv * page * 4
    per_page = 2 * vals_sz + 2 * scl_sz
    if len(blob) - off != n * per_page:
        raise WireError('payload size mismatch')
    kp = np.empty((layers, hkv, n, page, hd), np.int8)
    vp = np.empty((layers, hkv, n, page, hd), np.int8)
    ks = np.empty((layers, hkv, n, page), np.float32)
    vs = np.empty((layers, hkv, n, page), np.float32)
    for i in range(n):
        start = off + i * per_page
        if zlib.crc32(blob[start:start + per_page]) != crcs[i]:
            raise WireError(f'page {i} CRC mismatch')
        o = start
        kp[:, :, i] = np.frombuffer(blob, np.int8, vals_sz, o).reshape(
            layers, hkv, page, hd)
        o += vals_sz
        vp[:, :, i] = np.frombuffer(blob, np.int8, vals_sz, o).reshape(
            layers, hkv, page, hd)
        o += vals_sz
        ks[:, :, i] = np.frombuffer(blob, np.float32,
                                    layers * hkv * page, o).reshape(
            layers, hkv, page)
        o += scl_sz
        vs[:, :, i] = np.frombuffer(blob, np.float32,
                                    layers * hkv * page, o).reshape(
            layers, hkv, page)
    return KVWireBlock(tokens=tokens, page_size=page, k=kp, v=vp,
                       k_scales=ks, v_scales=vs)
