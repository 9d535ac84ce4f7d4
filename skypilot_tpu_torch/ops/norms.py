"""Normalization ops (counterpart of ``skypilot_tpu/ops/norms.py``).

Plain PyTorch: RMSNorm is a bandwidth-bound elementwise pass with no
kernel of its own in the reference either.
"""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm (Llama-style, no bias). The variance is computed in fp32
    whatever the input dtype, and the result is cast back to it after
    the weight multiply, at the same point as the reference."""
    orig_dtype = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(orig_dtype)
