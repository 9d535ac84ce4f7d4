"""EDF (earliest-deadline-first) scheduling policy.

Absorbs the deadline machinery as *policy logic*: requests carry
an absolute wall-clock ``deadline`` (the ``X-SkyTpu-Deadline-S``
budget, turned absolute by the server), the base class's ``sweep``
already cancels expired work, and this policy additionally ORDERS by
deadline at every decision point:

- slot refill pops the earliest-deadline queued request (no deadline
  sorts last — best-effort traffic yields to budgeted traffic);
- the chunk budget goes to the most urgent prefilling slot;
- page-pressure preemption evicts the slot with the MOST slack
  (latest deadline; none = infinite slack), so the request closest to
  its cutoff keeps its pages.

Ties break FIFO (queue position / submission time), so two requests
with the same budget are served in arrival order — deterministic, and
what the deadline-ties test pins.
"""
from __future__ import annotations

from typing import Any, List

from skypilot_tpu_torch.infer.sched import base

_INF = float('inf')


def _deadline(req) -> float:
    return req.deadline if req.deadline is not None else _INF


class DeadlineScheduler(base.Scheduler):
    name = 'deadline'

    def pop_next(self):  # holds: _lock
        if not self._queue:
            return None
        # Tie-break on queue position: requeued (preempted) requests
        # sit at the front, so equal deadlines resume them first.
        i = min(range(len(self._queue)),
                key=lambda j: (_deadline(self._queue[j]), j))
        return self._queue.pop(i)

    def next_prefill_slot(self, candidates: List[int],  # holds: _lock
                          slots: List[Any]) -> int:
        return min(candidates,
                   key=lambda s: (_deadline(slots[s]),
                                  slots[s].submitted_at, s))

    def pick_victim(self, victims: List[int],  # holds: _lock
                    slots: List[Any]) -> int:
        # Most slack loses its pages; tie-break youngest (the fcfs
        # rule) so no-deadline victims keep the historical order.
        return max(victims,
                   key=lambda s: (_deadline(slots[s]),
                                  slots[s].submitted_at))
