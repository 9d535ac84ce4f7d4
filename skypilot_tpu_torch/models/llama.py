"""Llama-family decoder (counterpart of ``skypilot_tpu/models/llama.py``).

This slice holds what the serving path needs: the config with its
presets, the stacked ``[n_layers, ...]`` parameter layout and init,
``mlp_block``, and ``params_from_jax`` which carries a parameter tree
of numpy arrays (made by the JAX package) across so both sides compute
the same function in the differential tests.

Params are a plain dict of tensors with the reference's layout; the
inference code loops over layers in Python where the reference uses
``lax.scan``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from skypilot_tpu_torch.ops import norms
from skypilot_tpu_torch.ops import quant as quant_lib

Params = Dict[str, Any]

_DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32,
           'float16': torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype behind a config dtype name ('bfloat16', ...)."""
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Copy of the reference config. The training-only fields are kept
    so the presets read the same; the serving path ignores them."""
    vocab_size: int = 128_256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14_336
    max_seq_len: int = 8192
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: str = 'bfloat16'
    attention_impl: str = 'auto'
    attn_block_q: Optional[int] = None
    attn_block_k: Optional[int] = None
    remat: bool = True
    remat_policy: str = 'full'
    loss_vocab_chunks: Optional[int] = None
    fused_loss: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    # ---- presets --------------------------------------------------------
    @staticmethod
    def llama3_8b(**kw) -> 'LlamaConfig':
        kw.setdefault('loss_vocab_chunks', 16)
        return LlamaConfig(**kw)

    @staticmethod
    def bench_350m(**kw) -> 'LlamaConfig':
        base = dict(vocab_size=32_768, dim=1024, n_layers=16,
                    n_heads=16, n_kv_heads=8, ffn_dim=4096,
                    max_seq_len=2048)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def bench_1b(**kw) -> 'LlamaConfig':
        base = dict(vocab_size=32_768, dim=1536, n_layers=24,
                    n_heads=12, n_kv_heads=12, ffn_dim=6144,
                    max_seq_len=2048, remat_policy='full',
                    attn_block_q=512, attn_block_k=512)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def tiny(**kw) -> 'LlamaConfig':
        """Test-sized config (CPU-fast)."""
        base = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                    n_kv_heads=2, ffn_dim=128, max_seq_len=128,
                    dtype='float32')
        base.update(kw)
        return LlamaConfig(**base)


def init_params(config: LlamaConfig, generator: torch.Generator,
                device='cpu') -> Params:
    """Scaled-normal init, layers stacked on axis 0, with the
    reference's shapes and scales. The numbers come from ``generator``
    (on ``device``), so they are not the reference's ``jax.random``
    bits; tests that compare with JAX use :func:`params_from_jax`.

    Each stacked weight is drawn one layer at a time in fp32 and cast
    into a preallocated tensor, so the fp32 temporaries stay one layer
    large (an 8B model's stacked fp32 draw would not fit beside it)."""
    dtype = torch_dtype(config.dtype)
    d, hd = config.dim, config.head_dim
    L = config.n_layers

    def normal(shape, scale, stacked=False):
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0] if stacked else 1):
            part = out[i] if stacked else out
            part.copy_(torch.randn(part.shape, generator=generator,
                                   dtype=torch.float32, device=device)
                       * scale)
        return out

    scale = d ** -0.5
    out_scale = scale / (2 * L) ** 0.5   # GPT-2-style residual scaling
    layers = {
        'attn_norm': torch.ones((L, d), dtype=dtype, device=device),
        'wq': normal((L, d, config.n_heads * hd), scale, True),
        'wk': normal((L, d, config.n_kv_heads * hd), scale, True),
        'wv': normal((L, d, config.n_kv_heads * hd), scale, True),
        'wo': normal((L, config.n_heads * hd, d), out_scale, True),
        'mlp_norm': torch.ones((L, d), dtype=dtype, device=device),
        'w_gate': normal((L, d, config.ffn_dim), scale, True),
        'w_up': normal((L, d, config.ffn_dim), scale, True),
        'w_down': normal((L, config.ffn_dim, d), out_scale, True),
    }
    return {
        'embed': normal((config.vocab_size, d), 1.0),
        'layers': layers,
        'final_norm': torch.ones((d,), dtype=dtype, device=device),
        'lm_head': normal((d, config.vocab_size), scale),
    }


def params_from_jax(tree: Params, device='cpu') -> Params:
    """Carry a reference parameter tree across: ``tree`` holds numpy
    arrays (``jax.tree.map(np.asarray, params)`` on the JAX side) in the
    reference's layout; the result is the same dict of tensors on
    ``device``. bf16 leaves arrive as ml_dtypes bfloat16 arrays and are
    reinterpreted bit for bit."""
    def convert(a):
        a = np.asarray(a)
        if a.dtype.name == 'bfloat16':
            t = torch.from_numpy(a.view(np.int16).copy())
            return t.view(torch.bfloat16).to(device)
        # A private copy: JAX hands out read-only buffers.
        return torch.from_numpy(np.array(a)).to(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return convert(node)
    return walk(tree)


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked layer weights (views)."""
    return {k: v[i] for k, v in params['layers'].items()}


def mlp_block(config: LlamaConfig, x: torch.Tensor,
              layer: Params) -> torch.Tensor:
    """norm -> SwiGLU -> residual."""
    h = norms.rms_norm(x, layer['mlp_norm'], config.norm_eps)
    gate = F.silu(quant_lib.qdot(h, layer['w_gate']))
    return x + quant_lib.qdot(gate * quant_lib.qdot(h, layer['w_up']),
                              layer['w_down'])
