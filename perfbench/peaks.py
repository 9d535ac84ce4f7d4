"""The chip's peaks, and the roofline bound of an amount of work.

Published dense peaks of one NVIDIA H100 SXM (data sheet, no
sparsity): 989 TFLOP/s in bf16, 3.35 TB/s of HBM3. They assume the card's
full 700 W; a run prints the card's power limit beside its numbers.
"""
from __future__ import annotations

PEAKS = {
    'NVIDIA H100 80GB HBM3': {'bf16_flops': 989e12, 'hbm_bytes': 3.35e12},
}
DEFAULT = 'NVIDIA H100 80GB HBM3'


def peak(kind: str, device_name: str = DEFAULT) -> float:
    """``kind`` ('bf16_flops' or 'hbm_bytes') of ``device_name``; an
    unknown card reads as the H100 SXM (the only card in the table)."""
    return PEAKS.get(device_name, PEAKS[DEFAULT])[kind]


def bound_s(flops: float, nbytes: float,
            device_name: str = DEFAULT) -> float:
    """The least time the chip could take: the larger of operations over
    peak FLOP/s and bytes over peak bandwidth."""
    return max(flops / peak('bf16_flops', device_name),
               nbytes / peak('hbm_bytes', device_name))
