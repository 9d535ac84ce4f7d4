"""Training steps: ``batch`` rows of ``seq`` token ids a step.

Every step gets its own batch: all of a run's batches are made on the
device from the seed at set-up (uniform ids over the vocabulary; the
targets are the ids shifted by one), so the rows of every step differ
and the same seed gives the same batches.
"""
from __future__ import annotations

from typing import Any, Dict, List


def batches(params: Dict[str, Any], seed: int, n: int, vocab: int,
            device) -> List[Dict[str, Any]]:
    """The first ``n`` batches of the seed's sequence (each from its own
    generator, so any prefix is the same whatever ``n``)."""
    import torch
    out = []
    for i in range(n):
        gen = torch.Generator(device=device)
        gen.manual_seed((int(seed) * 7_368_787 + 104_729 * (i + 1))
                        % (2 ** 63 - 1))
        ids = torch.randint(0, vocab, (params['batch'], params['seq'] + 1),
                            generator=gen, device=device, dtype=torch.int32)
        out.append({'tokens': ids[:, :-1].contiguous(),
                    'targets': ids[:, 1:].contiguous()})
    return out
