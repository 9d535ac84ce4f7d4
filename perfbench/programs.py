"""The port's step-program records, as a serving run's step records
carry them (``steps[i]['programs']``: the flight recorder's
``ProgramRecord`` of each program the engine dispatched, with its rows,
prefill chunks (request id, offset, true length), KV tokens read, device
seconds and the device's idle gap before it). A port without them gives
no records, and the readers of these metrics then give None."""
from __future__ import annotations

from typing import Any, Dict, List, Set, Tuple

from perfbench import flops, weights
from perfbench.weights import Dims


def records(run, lo: float, hi: float) -> List[Dict[str, Any]]:
    """The program records whose start event was recorded in [lo, hi),
    in dispatch order."""
    return [p for s in run.steps for p in s.get('programs', ())
            if lo <= p['t'] < hi]


def last_chunks(run) -> Set[Tuple[int, int]]:
    """(request id, offset) of every chunk of the run that ends its
    prompt: no chunk of the same request starts where it ends."""
    chunks = [c for s in run.steps for p in s.get('programs', ())
              for c in p['chunks']]
    starts = {(rid, off) for rid, off, _ in chunks}
    return {(rid, off) for rid, off, n in chunks
            if (rid, off + n) not in starts}


def kv_bytes_per_token(dims: Dims) -> float:
    """The K and V bytes of one token over every layer (bf16)."""
    return dims.layers * 2 * dims.hkv * dims.hd * flops.BF16


def decode_bytes(dims: Dims, rows: int, kv_tokens: int) -> float:
    """The least bytes a decode program moves: every weight that enters a
    product streamed once (bf16; the embedding is a lookup), the keys and
    values of the ``kv_tokens`` it reads, and the new key and value row
    of each of its ``rows``."""
    return (weights.matmul_params(dims) * flops.BF16
            + (kv_tokens + rows) * kv_bytes_per_token(dims))
