"""Matmul and embedding lookups (counterpart of ``skypilot_tpu/ops/quant.py``).

Only the plain-tensor branch of ``qdot``/``qembed`` is ported; the int8
``QuantArray`` path is a later slice of the port (ROADMAP queue 1,
item 1). The products stay ``torch.matmul``, as the reference leaves
them to XLA.
"""
from __future__ import annotations

import torch


def qdot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for plain weight tensors."""
    return x @ w


def qembed(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Row gather of a plain embedding table."""
    return embed[tokens]
