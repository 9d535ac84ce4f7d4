"""Rotary position embeddings (RoPE), Llama-3 style (counterpart of
``skypilot_tpu/ops/rope.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rope_frequencies(head_dim: int, max_seq_len: int,
                     theta: float = 500_000.0,
                     device='cpu') -> Tuple[torch.Tensor, torch.Tensor]:
    """Precomputed (cos, sin) tables, shape [max_seq_len, head_dim//2],
    fp32. Callers compute them once and keep them."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim))
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate by halves: the last dim splits into two and the rotated
    halves are concatenated (not interleaved pairs).
    x: [..., seq, heads, head_dim]; ``positions``: optional [..., seq]
    absolute positions that gather the tables (defaults to arange)."""
    seq = x.shape[-3]
    if positions is None:
        c = cos[:seq][..., None, :]   # [seq, 1, hd/2]
        s = sin[:seq][..., None, :]
    else:
        c = cos[positions][..., None, :]
        s = sin[positions][..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
