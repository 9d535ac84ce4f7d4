"""The collectives the port calls where GSPMD would insert them. The
reference has no counterpart: XLA inserts its collectives from the
shardings; the port calls them where Megatron's and ZeRO-3's rules put
them (``sharding.py``).

Serving (no gradient):

- :func:`all_reduce_sum`: after a row-parallel product (``wo``,
  ``w_down``) and the vocab-parallel embedding.
- :func:`all_gather_last`: the column-parallel ``lm_head``'s logits,
  concatenated along the vocabulary in rank order (a copy, so every rank
  holds bitwise the same logits and samples the same token).
- :func:`broadcast_bytes` and :func:`all_gather_u32`: the lockstep
  driver's submissions (rank 0 to all) and its per-rank output digests,
  on the group's host ``gloo`` group, never on an NCCL one.

Training, each a ``torch.autograd.Function`` whose backward is stated with
the forward:

- :func:`gather_shards` (over ``fsdp``): forward all-gather; backward
  reduce-scatter, summed over the group's ranks.
- :func:`copy_to` (into ``tp``): forward identity; backward all-reduce.
- :func:`reduce_from` (from ``tp``): forward all-reduce; backward
  identity.
- :func:`gather_replicated` (over ``tp``, for a computation every rank of
  the group repeats): forward all-gather; backward keeps the rank's slice
  and does not sum, since every rank computed the same whole gradient.
- :func:`scatter_shards` (the MoE's expert exchange over ``ep``): forward
  reduce-scatter; backward all-gather. Its way back is
  :func:`gather_shards`.
- :func:`ppermute` (ring attention's K/V rotation over ``sp``, the
  pipeline's shift to the next stage over ``pp``): forward sends each
  rank's tensor along a permutation (``lax.ppermute``); backward sends the
  gradient along the inverse permutation. A rank that nobody sends to
  receives zeros.

``torch.distributed.nn.functional.all_reduce`` is not used: its backward
all-reduces again, which multiplies a replicated gradient by the group's
size. :func:`gather_along` and :func:`reduce_scatter_along` are the
no-gradient halves (the checkpoint gathers whole leaves with the first).

Each is the identity at world size 1 (``group`` None or of one rank): not
called, so a single-card engine runs exactly the launches it ran before.
The collectives run on ``group.pg``; :func:`send_recv`, :func:`ppermute`'s
no-gradient half, posts its sends and receives together
(``dist.batch_isend_irecv``), so that a ring cannot deadlock. With
``gloo`` over tensors on a card (ranks sharing one card, a correctness
run) they stage explicitly through
the host: a copy to the CPU, the collective there, a copy back. That
synchronizes the stream, which is why such an engine runs without CUDA
graphs; NCCL runs them on the card, inside a graph.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

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


# ---------------------------------------------------------------------------
# Training: tensors along an axis, and their autograd Functions
# ---------------------------------------------------------------------------
def _all_gather_single(out: torch.Tensor, src: torch.Tensor, pg) -> None:
    """Every rank's ``src`` stacked along axis 0 into ``out``.
    ``all_gather_single`` is the name torch 2.13 gives the operation it
    deprecates as ``all_gather_into_tensor``; a torch without the new name
    runs the same operation under the old one."""
    fn = getattr(dist, 'all_gather_single', None) \
        or dist.all_gather_into_tensor
    fn(out, src, group=pg)


def _reduce_scatter_single(out: torch.Tensor, src: torch.Tensor,
                           pg) -> None:
    """The sum over ranks of ``src``, rank ``i`` keeping the ``i``-th block
    of axis 0 in ``out`` (``reduce_scatter_single``, the 2.13 name of
    ``reduce_scatter_tensor``, as :func:`_all_gather_single`). gloo
    runs it at world size 2 and more, as NCCL does."""
    fn = getattr(dist, 'reduce_scatter_single', None) \
        or dist.reduce_scatter_tensor
    fn(out, src, group=pg)


def _stage(x: torch.Tensor, group: TPGroup) -> torch.Tensor:
    return x.cpu() if group.staged else x


def gather_along(x: torch.Tensor, group: Optional[TPGroup],
                 axis: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``axis`` in rank order (a new
    tensor); ``x`` itself at world size 1."""
    if not _multi(group):
        return x
    src = _stage(x.movedim(axis, 0).contiguous(), group)
    out = torch.empty((group.world * src.shape[0], *src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _all_gather_single(out, src, group.pg)
    return out.to(x.device).movedim(0, axis)


def reduce_scatter_along(x: torch.Tensor, group: Optional[TPGroup],
                         axis: int) -> torch.Tensor:
    """The sum of every rank's ``x``, of which this rank keeps its block of
    ``axis`` (a new tensor); ``x`` itself at world size 1."""
    if not _multi(group):
        return x
    src = _stage(x.movedim(axis, 0).contiguous(), group)
    out = torch.empty((src.shape[0] // group.world, *src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _reduce_scatter_single(out, src, group.pg)
    return out.to(x.device).movedim(0, axis)


def send_recv(x: torch.Tensor, group: Optional[TPGroup],
              perm: List[Tuple[int, int]]) -> torch.Tensor:
    """What this rank receives when every rank ``i`` of the group sends
    its ``x`` to ``j`` for each ``(i, j)`` of ``perm`` (a new tensor;
    zeros where nobody sends to this rank). ``x`` itself at world size
    1."""
    if not _multi(group):
        return x
    src = _stage(x.contiguous(), group)
    out = torch.zeros_like(src)
    ops = []
    for i, j in perm:
        if i == group.rank and j == group.rank:
            out.copy_(src)
        elif i == group.rank:
            ops.append(dist.P2POp(dist.isend, src,
                                  dist.get_global_rank(group.pg, j),
                                  group.pg))
        elif j == group.rank:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group.pg, i),
                                  group.pg))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out.to(x.device)


def _summed(x: torch.Tensor, group: TPGroup) -> torch.Tensor:
    """The sum of every rank's ``x`` as a new tensor (``x`` untouched)."""
    return all_reduce_sum(x.clone(), group)


def _keep(x: torch.Tensor, group: TPGroup, axis: int) -> torch.Tensor:
    n = x.shape[axis] // group.world
    return x.narrow(axis, group.rank * n, n).contiguous()


class _GatherShards(torch.autograd.Function):
    """Forward all-gather along ``axis``; backward reduce-scatter (the
    sum over the group of each rank's gradient of the whole tensor)."""

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return gather_along(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_along(g, ctx.group, ctx.axis), None, None


class _CopyTo(torch.autograd.Function):
    """Forward identity; backward all-reduce (each rank holds a partial
    gradient of the replicated input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """Forward all-reduce (sum of the ranks' partials); backward identity
    (the sum's gradient is the same on every rank)."""

    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherReplicated(torch.autograd.Function):
    """Forward all-gather along ``axis``; backward keeps this rank's block
    of ``axis`` and does not sum: every rank computed the same whole
    gradient from the same whole tensor."""

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return gather_along(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return _keep(g, ctx.group, ctx.axis), None, None


class _ScatterShards(torch.autograd.Function):
    """Forward reduce-scatter along ``axis`` (the sum over the group,
    this rank keeping its block); backward all-gather (every rank's
    block of the sum reads every rank's whole input)."""

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return reduce_scatter_along(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return gather_along(g, ctx.group, ctx.axis), None, None


class _PPermute(torch.autograd.Function):
    """Forward :func:`send_recv` along ``perm``; backward along the
    inverse permutation (the gradient of what a rank received goes back
    to the rank that sent it)."""

    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return send_recv(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        back = [(j, i) for i, j in ctx.perm]
        return send_recv(g, ctx.group, back), None, None


def gather_shards(x: torch.Tensor, group: Optional[TPGroup],
                  axis: int) -> torch.Tensor:
    """The whole tensor from the ranks' shards along ``axis``; its
    gradient is reduce-scattered (summed) back onto the shards."""
    return _GatherShards.apply(x, group, axis) if _multi(group) else x


def copy_to(x: torch.Tensor, group: Optional[TPGroup]) -> torch.Tensor:
    """``x`` entering the group's parallel region (column-parallel
    products): identity forward, all-reduced gradient."""
    return _CopyTo.apply(x, group) if _multi(group) else x


def reduce_from(x: torch.Tensor, group: Optional[TPGroup]) -> torch.Tensor:
    """The group's partial sums leaving its parallel region (row-parallel
    products): all-reduced forward, identity gradient."""
    return _ReduceFrom.apply(x, group) if _multi(group) else x


def gather_replicated(x: torch.Tensor, group: Optional[TPGroup],
                      axis: int) -> torch.Tensor:
    """The whole tensor from the ranks' blocks along ``axis``, for a
    computation that every rank of the group repeats whole; the gradient
    keeps the rank's block, unsummed."""
    return _GatherReplicated.apply(x, group, axis) if _multi(group) else x


def scatter_shards(x: torch.Tensor, group: Optional[TPGroup],
                   axis: int) -> torch.Tensor:
    """This rank's block along ``axis`` of the sum of every rank's ``x``;
    its gradient is all-gathered (the inverse of :func:`gather_shards`)."""
    return _ScatterShards.apply(x, group, axis) if _multi(group) else x


def ppermute(x: torch.Tensor, group: Optional[TPGroup],
             perm: List[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute`` over the group: rank ``j`` receives the ``x`` of
    rank ``i`` for each ``(i, j)`` of ``perm``, zeros if nobody sends to
    it; the gradient goes back along the inverse permutation. Every rank
    of the group calls it with the same ``perm``, and every rank must run
    its backward (keep the result in the graph on every rank, as a
    tensor-level ``where`` does), or a partner's send waits forever."""
    return _PPermute.apply(x, group, perm) if _multi(group) else x
