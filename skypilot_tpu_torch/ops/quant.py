"""Int8 weight-only quantization for inference (counterpart of
``skypilot_tpu/ops/quant.py``).

Per-output-channel symmetric int8 weights with bf16 scales, consumed by
the same prefill, decode, verify and mixed steps as bf16 weights. The
scales commute with the product, ``x @ (q * s_col) == (x @ q) * s_col``,
so the contraction runs on the int8 weight converted to the activation
dtype and one [out]-vector multiply finishes it. Decode streams the
weights on every step, so int8 weights halve its bytes.

``qdot``/``qembed`` are transparent: plain tensors pass through, so the
shared model code serves bf16 and quantized params alike.

The reference leaves the int8 -> bf16 convert to XLA, which fuses it into
the dot's operand read: the weight stays int8 in device memory. Eager
torch would build a bf16 copy of every weight on every call, reading 8
GB and writing and reading 16 GB a decode step at 8B, which is slower
than the bf16 weights themselves. So on CUDA tensors ``qdot`` on a
:class:`QuantArray` launches ``csrc/qdot_int8.cu``, a W8A16 product that
loads int8 weight tiles into shared memory by TMA, converts them to bf16
on their way into the warpgroup products' register operands and applies
the scale to the result. On CPU
tensors it runs the plain version, :func:`qdot_reference`, the
reference's formula. The wrapper adds one to ``launches['qdot_int8']``
where it launches the kernel, and nowhere else; a launch recorded into a
CUDA graph counts in :data:`captured` instead, and whoever replays the
graph adds the capture's counts once per replay (:func:`count_replay`),
as the paged attention wrappers count.

Every division by a constant divides by a tensor: CUDA divides a tensor by
a Python scalar as a product with its reciprocal, which can miss the
quotient by one ulp, and the card's quantizer must give the CPU's bits.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any, Dict

import torch

Params = Any

# Kernel launches since the process started (or the last
# reset_launches()), and launches recorded into CUDA graphs under
# capture.
launches: Dict[str, int] = {'qdot_int8': 0}
captured: Dict[str, int] = dict.fromkeys(launches, 0)

# The products csrc/qdot_int8.cu takes: K a multiple of its 64-deep
# tile, N a multiple of 16 (a TMA row stride is a multiple of 16 bytes).
CUDA_K_MULTIPLE = 64
CUDA_N_MULTIPLE = 16


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def count_replay(per_replay: Dict[str, int]) -> None:
    """Add one replay of a graph whose capture recorded ``per_replay``
    launches (a delta of :data:`captured`) to :data:`launches`."""
    for name, n in per_replay.items():
        launches[name] += n


@dataclasses.dataclass
class QuantArray:
    """int8 weight + per-output-channel scale.

    Matmul weights [..., in, out]: scale [..., out] (reduce over in).
    Embedding tables [vocab, d]: scale [vocab] (per row: rows are
    gathered one by one, so each row's own range is what matters).
    Indexing takes a slice of both (a layer of a stacked leaf)."""
    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.scale.dtype

    def __getitem__(self, index) -> 'QuantArray':
        return QuantArray(q=self.q[index], scale=self.scale[index])


def _quantize(w: torch.Tensor, axis: int, scale_dtype) -> QuantArray:
    """Symmetric int8 over ``axis``: scale = max(absmax / 127, 1e-8) in
    fp32, q = round-half-even(w / scale) clipped to +-127, and the scale
    stored in ``scale_dtype`` after q was computed from its fp32 value."""
    wf = w.float()
    absmax = wf.abs().amax(dim=axis)
    scale = torch.maximum(absmax / torch.full_like(absmax, 127.0),
                          torch.full_like(absmax, 1e-8))
    q = torch.round(wf / scale.unsqueeze(axis))
    q = torch.clamp(q, -127, 127).to(torch.int8)
    return QuantArray(q=q, scale=scale.to(scale_dtype))


def quantize_weight(w: torch.Tensor,
                    scale_dtype=torch.bfloat16) -> QuantArray:
    """Symmetric per-output-channel int8 over the contraction axis
    (axis -2 of [..., in, out]). A stacked [L, in, out] leaf is
    quantized one layer at a time (the channels of one layer never mix
    with another's), so the fp32 temporaries stay one layer large."""
    if w.dim() <= 2:
        return _quantize(w, -2, scale_dtype)
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty(w.shape[:-2] + w.shape[-1:], dtype=scale_dtype,
                        device=w.device)
    for i in range(w.shape[0]):
        part = quantize_weight(w[i], scale_dtype)
        q[i], scale[i] = part.q, part.scale
    return QuantArray(q=q, scale=scale)


def quantize_embed(w: torch.Tensor,
                   scale_dtype=torch.bfloat16) -> QuantArray:
    """Per-row int8 for embedding tables [vocab, d]: scale [vocab]."""
    return _quantize(w, -1, scale_dtype)


def qdot_reference(x: torch.Tensor, w: QuantArray) -> torch.Tensor:
    """The plain version, the reference's formula: the product on the
    weight converted to ``x.dtype``, rounded to it, then times the scale
    in ``x.dtype`` (two roundings, not one fused multiply)."""
    return (x @ w.q.to(x.dtype)) * w.scale.to(x.dtype)


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for plain weight tensors; the dequantizing product for a
    :class:`QuantArray`: the plain version on CPU tensors, the kernel on
    CUDA tensors (bf16 ``x``, contiguous operands) or a ValueError."""
    if not isinstance(w, QuantArray):
        return x @ w
    devices = {x.device.type, w.q.device.type, w.scale.device.type}
    if devices == {'cpu'}:
        return qdot_reference(x, w)
    if devices != {'cuda'}:
        raise ValueError(f'qdot: x and the weight must all lie on the CPU '
                         f'or all on one CUDA device, got {sorted(devices)}')
    return _qdot_cuda(x, w)


@functools.lru_cache(maxsize=None)
def _kernel(symbol: str):
    """The C entry point ``symbol`` of csrc/qdot_int8.cu, its library
    built and bound on first use."""
    from skypilot_tpu_torch.ops import _build
    fn = getattr(_build.library('qdot_int8'), symbol)
    if symbol == 'qdot_int8':
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return fn


def cuda_splits(k: int, n: int) -> int:
    """How many K-splits the kernel runs for a [k, n] weight (fixed by
    (k, n) and the card, never by the row count). Needs the built
    library and a CUDA device."""
    return _kernel('qdot_int8_splits')(k, n)


def _qdot_cuda(x: torch.Tensor, w: QuantArray) -> torch.Tensor:
    """Launch ``qdot_int8`` on the current stream: bf16 ``x`` [..., K]
    with its leading dims as the rows, int8 ``w.q`` [K, N], bf16
    ``w.scale`` [N], all contiguous on one device; bf16 [..., N] out."""
    q, scale = w.q, w.scale
    if x.dtype != torch.bfloat16 or q.dtype != torch.int8 \
            or scale.dtype != torch.bfloat16:
        raise ValueError(f'qdot: the CUDA kernel takes bf16 x, an int8 '
                         f'weight and bf16 scales, got {x.dtype}, '
                         f'{q.dtype}, {scale.dtype}')
    if q.dim() != 2 or scale.shape != q.shape[1:] \
            or x.shape[-1] != q.shape[0]:
        raise ValueError(f'qdot: x {tuple(x.shape)} does not match a '
                         f'[K, N] weight {tuple(q.shape)} with scale '
                         f'{tuple(scale.shape)}')
    k, n = q.shape
    if k % CUDA_K_MULTIPLE or n % CUDA_N_MULTIPLE:
        raise ValueError(f'qdot: the CUDA kernel takes K a multiple of '
                         f'{CUDA_K_MULTIPLE} and N of {CUDA_N_MULTIPLE}, '
                         f'got [{k}, {n}]')
    for t in (x, q, scale):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError('qdot: the CUDA kernel takes contiguous, '
                             '16-byte aligned operands')
        if t.device != x.device:
            raise ValueError('qdot: operands must share one device')
    out = torch.empty(x.shape[:-1] + (n,), dtype=torch.bfloat16,
                      device=x.device)
    m = x.numel() // k
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel('qdot_int8')(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                               out.data_ptr(), m, k, n, stream)
    if err == -1:
        raise ValueError(f'qdot: the CUDA kernel does not take M {m}, '
                         f'K {k}, N {n}')
    if err:
        raise RuntimeError(f'qdot: kernel launch failed with CUDA error '
                           f'{err}')
    counts = captured if torch.cuda.is_current_stream_capturing() \
        else launches
    counts['qdot_int8'] += 1
    return out


def qembed(embed, tokens: torch.Tensor) -> torch.Tensor:
    """Row gather for plain or quantized embedding tables. Quantized rows
    come back in the scale's dtype (bf16), whatever the model computes
    in, as the reference's do."""
    if isinstance(embed, QuantArray):
        rows = embed.q[tokens]
        scale = embed.scale[tokens]
        return rows.to(scale.dtype) * scale[..., None]
    return embed[tokens]


_MATMUL_KEYS = frozenset({'wq', 'wk', 'wv', 'wo',
                          'w_gate', 'w_up', 'w_down', 'lm_head'})


def quantize_params(params: Params, device=None) -> Params:
    """Quantize a Llama param tree: matmul weights per output channel,
    the embedding per row; norms stay in their compute dtype (tiny).

    Leaf by leaf, each stacked weight one layer at a time: the new tree
    holds no bf16 weight, so each bf16 source is freed as its int8 form
    appears once nothing else holds it (the reference donates its
    buffers; here the caller's tree is left as it was). With ``device``
    each leaf first moves there and quantizes there, so a tree on the
    host (``CheckpointManager.restore_to_host``) lands on the card as
    its int8 form plus one bf16 leaf at most."""
    from skypilot_tpu_torch.parallel import sharding

    def moved(leaf):
        return leaf if device is None else leaf.to(device)

    return sharding.map_tree(
        lambda path, leaf: quantize_leaf(path[-1], moved(leaf)), params)


def init_params_quantized(config, generator, device='cpu', tp: int = 1,
                          rank: int = 0) -> Params:
    """Random init straight into int8 (the reference's
    ``init_params_quantized``): each leaf is drawn whole in the compute
    dtype (``models.llama.init_params``' draws, in its order), quantized
    whole, and dropped before the next is drawn, so the tree's bf16 form
    never exists at once. The values equal
    ``quantize_params(init_params(config, generator, device))``.

    ``tp > 1``: rank ``rank`` keeps only its slice of each quantized leaf
    (``parallel/sharding.py``), so it holds 1/tp of the weights plus one
    whole leaf at a time. A row-parallel weight's per-column scale covers
    the whole contraction axis, which is why the leaf is quantized before
    it is sliced, never per shard."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import sharding

    def keep(path, leaf):
        return sharding.shard_leaf(path, quantize_leaf(path[-1], leaf),
                                   rank, tp)

    return llama.init_params(config, generator, device, keep=keep)


def quantize_leaf(name: str, leaf):
    """The int8 form of the leaf ``name``: a matmul weight per output
    channel, the embedding per row, a norm unchanged."""
    if name in _MATMUL_KEYS:
        return quantize_weight(leaf)
    if name == 'embed':
        return quantize_embed(leaf)
    return leaf


def _leaves(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    else:
        yield tree


def is_quantized(params: Params) -> bool:
    return any(isinstance(leaf, QuantArray) for leaf in _leaves(params))


def param_bytes(params: Params) -> int:
    """Device bytes of a (possibly quantized) param tree."""
    total = 0
    for leaf in _leaves(params):
        parts = (leaf.q, leaf.scale) if isinstance(leaf, QuantArray) \
            else (leaf,)
        total += sum(t.numel() * t.element_size() for t in parts)
    return total
