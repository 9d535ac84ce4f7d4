"""The collectives of tensor-parallel serving. The reference has no
counterpart: GSPMD inserts its collectives from the shardings; the port
calls them where Megatron's rules put them (``sharding.py``).

- :func:`all_reduce_sum`: after a row-parallel product (``wo``,
  ``w_down``) and the vocab-parallel embedding.
- :func:`all_gather_last`: the column-parallel ``lm_head``'s logits,
  concatenated along the vocabulary in rank order (a copy, so every rank
  holds bitwise the same logits and samples the same token).
- :func:`broadcast_bytes` and :func:`all_gather_u32`: the lockstep
  driver's submissions (rank 0 to all) and its per-rank output digests,
  on the group's host ``gloo`` group, never on an NCCL one.

Each is the identity at world size 1 (``group`` None or of one rank): not
called, so a single-card engine runs exactly the launches it ran before.
The model's collectives run on ``group.pg``. With ``gloo`` over tensors
on a card (two ranks sharing one card, a correctness run) they stage
explicitly through the host: a copy to the CPU, the collective there, a
copy back. That synchronizes the stream, which is why such an engine runs
without CUDA graphs; NCCL runs them on the card, inside a graph.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from skypilot_tpu_torch.parallel.mesh import TPGroup


def _multi(group: Optional[TPGroup]) -> bool:
    return group is not None and group.world > 1


def all_reduce_sum(x: torch.Tensor,
                   group: Optional[TPGroup]) -> torch.Tensor:
    """The sum of every rank's ``x`` (in place where the tensor is not
    staged); ``x`` itself at world size 1."""
    if not _multi(group):
        return x
    if group.staged:
        host = x.cpu()
        dist.all_reduce(host, group=group.pg)
        return host.to(x.device)
    dist.all_reduce(x, group=group.pg)
    return x


def all_gather_last(x: torch.Tensor,
                    group: Optional[TPGroup]) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the last axis in rank
    order; ``x`` itself at world size 1."""
    if not _multi(group):
        return x
    src = x.contiguous()
    if group.staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(group.world)]
    dist.all_gather(parts, src, group=group.pg)
    out = torch.cat(parts, dim=-1)
    return out.to(x.device) if group.staged else out


def broadcast_bytes(data: Optional[bytes],
                    group: Optional[TPGroup]) -> bytes:
    """Rank 0's ``data`` on every rank, as two fixed-shape broadcasts on
    the host group: the length, then the zero-padded payload (``data`` is
    ignored on the other ranks; pass None)."""
    if not _multi(group):
        return data or b''
    n = torch.tensor([len(data) if data else 0], dtype=torch.int64)
    dist.broadcast(n, src=0, group=group.host_pg)
    size = int(n[0])
    if size == 0:
        return b''
    buf = torch.zeros((size,), dtype=torch.uint8)
    if group.rank == 0:
        buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
    dist.broadcast(buf, src=0, group=group.host_pg)
    return buf.numpy().tobytes()


def all_gather_u32(value: int, group: Optional[TPGroup]) -> List[int]:
    """Every rank's unsigned 32-bit ``value``, in rank order, on the host
    group (one fixed-shape all-gather; carried as int64)."""
    if not _multi(group):
        return [int(value) & 0xFFFFFFFF]
    mine = torch.tensor([int(value) & 0xFFFFFFFF], dtype=torch.int64)
    parts = [torch.zeros_like(mine) for _ in range(group.world)]
    dist.all_gather(parts, mine, group=group.host_pg)
    return [int(p[0]) for p in parts]
