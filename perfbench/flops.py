"""Operations and bytes of the model's steps and of each kernel,
computed from shapes.

The rules: a product of m x k by k x n is 2 m k n operations; causal
attention counts the keys the mask keeps (a query at position p sees
p + 1 keys), QK^T and PV each 2 hd operations a key a head; each input
byte is read once and each output byte written once, whatever a kernel
reads again; recompute (a rematerialized forward, the backward's second
QK^T) is not model work. The embedding is a lookup and is not counted.
Elements are bf16 (2 bytes) and the log-sum-exp rows fp32.
"""
from __future__ import annotations

from typing import Iterable, Tuple

from perfbench.weights import Dims, matmul_params

BF16 = 2
FP32 = 4


def _causal_keys(off: int, n: int) -> int:
    """Keys that ``n`` queries at positions off..off+n-1 see in all."""
    return n * off + n * (n + 1) // 2


# ---- the model --------------------------------------------------------
def layer_matmul_flops_per_token(dims: Dims) -> float:
    return 2.0 * (matmul_params(dims) - dims.d * dims.vocab)


def head_flops(dims: Dims) -> float:
    return 2.0 * dims.d * dims.vocab


def attention_flops(dims: Dims, keys: float) -> float:
    """Forward attention over ``keys`` (query, key) pairs, every layer."""
    return 4.0 * dims.hq * dims.hd * dims.layers * keys


def prefill_chunk_flops(dims: Dims, off: int, n: int, last: bool) -> float:
    """One prefill chunk of ``n`` true tokens at offset ``off``: every
    token's products, causal attention, and the head for the chunk's
    last row only where it ends the prompt (the first token's logits)."""
    return (n * layer_matmul_flops_per_token(dims)
            + attention_flops(dims, _causal_keys(off, n))
            + (head_flops(dims) if last else 0.0))


def decode_token_flops(dims: Dims, context: int) -> float:
    """One decoded token whose query sees ``context`` keys."""
    return (layer_matmul_flops_per_token(dims) + head_flops(dims)
            + attention_flops(dims, context))


def train_step_flops(dims: Dims, batch: int, seq: int) -> float:
    """Model operations of one training step: 3 x the forward (forward,
    then the backward's two products per forward product), products and
    causal attention, no recompute."""
    forward = (batch * seq * (layer_matmul_flops_per_token(dims)
                              + head_flops(dims))
               + batch * attention_flops(dims, _causal_keys(0, seq)))
    return 3.0 * forward


# ---- kernels (one launch = one layer) -----------------------------------
def paged_prefill_work(dims: Dims, off: int, n: int) -> Tuple[float, float]:
    """(operations, bytes) of ``paged_prefill.cu`` for one chunk of ``n``
    true queries at offset ``off``: Q read and O written for the chunk,
    K and V read for the prefix and the chunk."""
    flops = 4.0 * dims.hq * dims.hd * _causal_keys(off, n)
    nbytes = (2 * n * dims.hq * dims.hd * BF16
              + 2 * (off + n) * dims.hkv * dims.hd * BF16)
    return flops, nbytes


def paged_decode_work(dims: Dims, contexts: Iterable[int]
                      ) -> Tuple[float, float]:
    """(operations, bytes) of ``paged_decode.cu`` for one decode launch
    over slots whose queries see ``contexts`` keys."""
    flops = nbytes = 0.0
    for c in contexts:
        flops += 4.0 * dims.hq * dims.hd * c
        nbytes += (2 * dims.hq * dims.hd * BF16
                   + 2 * c * dims.hkv * dims.hd * BF16)
    return flops, nbytes


def flash_fwd_work(dims: Dims, batch: int, seq: int) -> Tuple[float, float]:
    """(operations, bytes) of one ``flash_fwd`` launch, causal: Q, K, V
    read, O and the log-sum-exp rows written."""
    flops = 4.0 * batch * dims.hq * dims.hd * _causal_keys(0, seq)
    nbytes = (batch * seq * dims.hd * BF16 * (2 * dims.hq + 2 * dims.hkv)
              + batch * dims.hq * seq * FP32)
    return flops, nbytes


def flash_bwd_work(dims: Dims, batch: int, seq: int) -> Tuple[float, float]:
    """(operations, bytes) of one backward, ``flash_bwd_dq`` and
    ``flash_bwd_dkv`` together: dP = dO V^T, dQ = dS K, dK = dS^T Q,
    dV = P^T dO (QK^T again is recompute); Q, K, V, O, dO and the
    log-sum-exp rows read, dQ, dK, dV written."""
    flops = 8.0 * batch * dims.hq * dims.hd * _causal_keys(0, seq)
    nbytes = (batch * seq * dims.hd * BF16 * (4 * dims.hq + 4 * dims.hkv)
              + batch * dims.hq * seq * FP32)
    return flops, nbytes


def prefill_chunks(prompt: int, cap: int = 256) -> Iterable[Tuple[int, int]]:
    """(offset, true length) of the chunks the engine splits a prompt
    into: ``cap``-token chunks from offset 0, then the remainder."""
    off = 0
    while off < prompt:
        n = min(cap, prompt - off)
        yield off, n
        off += n
