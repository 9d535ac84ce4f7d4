"""Pluggable engine scheduler (docs/serving.md "Engine scheduler"): a
copy of ``skypilot_tpu/infer/sched/``, which the port cannot import (the
JAX package's ``infer/__init__.py`` loads JAX). Only the imports differ;
``tests/test_torch_sched.py`` holds each policy to the original's
decisions.

``make(name, config)`` builds the policy the engine step loop drives:
``fcfs`` (default, bit-identical to the historical inline behavior),
``deadline`` (EDF over per-request wall-clock budgets), ``wfq``
(deficit-round-robin weighted fair queueing over per-tenant queues).
"""
from __future__ import annotations

from typing import Dict, Optional, Type

from skypilot_tpu_torch.infer.sched.base import (AdmissionError,
                                                 DEFAULT_TENANT,
                                                 FCFSScheduler, Scheduler,
                                                 SchedulerConfig,
                                                 aggregate_stats,
                                                 request_cost)
from skypilot_tpu_torch.infer.sched.deadline import DeadlineScheduler
from skypilot_tpu_torch.infer.sched.wfq import WFQScheduler

POLICIES: Dict[str, Type[Scheduler]] = {
    'fcfs': FCFSScheduler,
    'deadline': DeadlineScheduler,
    'wfq': WFQScheduler,
}


def make(name: str,
         config: Optional[SchedulerConfig] = None) -> Scheduler:
    try:
        cls = POLICIES[name]
    except KeyError:
        raise ValueError(
            f'unknown scheduler policy {name!r} '
            f'(have: {", ".join(sorted(POLICIES))})') from None
    return cls(config)


__all__ = [
    'AdmissionError', 'DEFAULT_TENANT', 'DeadlineScheduler',
    'FCFSScheduler', 'POLICIES', 'Scheduler', 'SchedulerConfig',
    'WFQScheduler', 'aggregate_stats', 'make', 'request_cost',
]
