"""Token sampling: greedy / temperature / top-k (counterpart of
``skypilot_tpu/infer/sampling.py``).

Greedy is argmax (the first maximal index on ties, as in the reference).
Temperature sampling draws from the engine's ``torch.Generator`` by the
exponential race ``argmax(probs / Exp(1))``, which is what
``torch.multinomial`` computes for one sample, bit for bit, without its
host-side checks (so a step that samples can be captured in a CUDA
graph). Its bits can never match ``jax.random``, so tests compare
distributions, not tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0     # 0 -> greedy
    top_k: int = 0               # 0 -> no truncation

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError('temperature must be >= 0')


def speculative_accept(logits: torch.Tensor, drafts: torch.Tensor,
                       draft_len: torch.Tensor,
                       generator: Optional[torch.Generator],
                       temperature: torch.Tensor, top_k: int = 0,
                       sampled: Optional[bool] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-greedy draft acceptance over the verify logits.

    logits: [slots, K+1, vocab], position i the model's output after
    verify input i (input 0 the slot's last token, inputs 1..K the padded
    drafts); drafts: [slots, K] int32; draft_len: [slots] int32 valid
    drafts per slot; temperature and top_k as in :func:`sample`.

    Returns ``(emitted [slots, K+1] int32, accepted [slots] int32)``:
    position 0 goes through :func:`sample` (a sampled slot riding a
    verify step with draft_len 0 samples exactly as a decode step would),
    later positions take the argmax; ``accepted`` is the longest prefix
    where draft i equals the model's token at position i. The caller
    emits ``emitted[:, :accepted + 1]``: every emitted token is the
    model's own, so greedy outputs equal speculation-off's."""
    k = logits.shape[1] - 1
    first = sample(logits[:, 0], generator, temperature, top_k=top_k,
                   sampled=sampled)
    preds = torch.argmax(logits[:, 1:], dim=-1).to(torch.int32)
    emitted = torch.cat([first[:, None], preds], dim=1)
    match = ((drafts == emitted[:, :k])
             & (torch.arange(k, device=logits.device)[None, :]
                < draft_len[:, None]))
    accepted = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    return emitted, accepted.to(torch.int32)


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           temperature: torch.Tensor, top_k: int = 0,
           sampled: Optional[bool] = None) -> torch.Tensor:
    """logits [slots, vocab], temperature [slots] -> tokens [slots]
    int32. Slots at temperature 0 take the argmax; the others draw from
    softmax(logits / temperature), truncated to the top_k logits when
    top_k > 0. ``sampled`` says whether any slot samples, decided by the
    caller on its host copy of the temperatures (the engine keys its
    step graphs by it); None decides it here from ``temperature``, which
    then should lie on the host (on the device that is a sync)."""
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth,
                             torch.full_like(logits, float('-inf')), logits)
    greedy = torch.argmax(logits, dim=-1)
    if sampled is None:
        sampled = bool((temperature > 0).any())
    if not sampled:
        return greedy.to(torch.int32)
    temperature = temperature.to(logits.device, torch.float32)
    temp = torch.clamp(temperature, min=1e-6)[:, None]
    probs = torch.softmax(logits / temp, dim=-1)
    race = torch.empty_like(probs).exponential_(1, generator=generator)
    drawn = torch.argmax(probs / race, dim=-1)
    return torch.where(temperature > 0, drawn, greedy).to(torch.int32)
