"""Token sampling: greedy / temperature / top-k (counterpart of
``skypilot_tpu/infer/sampling.py``).

Greedy is argmax (the first maximal index on ties, as in the reference).
Temperature sampling draws with ``torch.multinomial`` from the engine's
``torch.Generator``; its bits can never match ``jax.random``, so tests
compare distributions, not tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0     # 0 -> greedy
    top_k: int = 0               # 0 -> no truncation

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError('temperature must be >= 0')


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           temperature: torch.Tensor, top_k: int = 0) -> torch.Tensor:
    """logits [slots, vocab], temperature [slots] -> tokens [slots]
    int32. Slots at temperature 0 take the argmax; the others draw from
    softmax(logits / temperature), truncated to the top_k logits when
    top_k > 0."""
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth,
                             torch.full_like(logits, float('-inf')), logits)
    greedy = torch.argmax(logits, dim=-1)
    # Decided on the caller's copy of the temperatures (the engine keeps
    # them on the host), so an all-greedy step never waits on the device.
    if not bool((temperature > 0).any()):
        return greedy.to(torch.int32)
    temperature = temperature.to(logits.device, torch.float32)
    temp = torch.clamp(temperature, min=1e-6)[:, None]
    probs = torch.softmax(logits / temp, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(temperature > 0, sampled, greedy).to(torch.int32)
