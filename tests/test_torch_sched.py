"""The port's scheduler copies (``skypilot_tpu_torch/infer/sched/``) make
the JAX package's decisions.

One scripted trace runs against each policy of both packages: admission
(accepted or refused, with the Retry-After estimate), enqueue, pop_next,
requeue, pick_victim, next_prefill_slot, spec_budget, the accounting
hooks, sweep (cancelled and expired requests) and the per-tenant
snapshot. The two logs must be identical, decision for decision.
"""
import dataclasses
from typing import List, Optional

import pytest

from skypilot_tpu.infer import sched as jsched
from skypilot_tpu_torch.infer import sched as tsched

pytestmark = pytest.mark.jax

T0 = 1_000_000.0


@dataclasses.dataclass
class Req:
    """The fields a scheduler reads off a request."""
    request_id: int
    tenant: str
    prompt_tokens: List[int]
    output_tokens: List[int]
    submitted_at: float
    deadline: Optional[float] = None
    cancelled: bool = False


# (tenant, prompt length, output already streamed, deadline offset).
ARRIVALS = [('gold', 12, 0, 50.0), ('free', 30, 0, None),
            ('free', 8, 0, 5.0), ('gold', 20, 4, None),
            ('bronze', 6, 0, 1.0), ('free', 40, 0, None),
            ('gold', 9, 0, 20.0), ('free', 7, 0, 30.0),
            ('bronze', 16, 2, None), ('gold', 64, 0, None),
            ('silver', 5, 0, None), ('copper', 5, 0, None)]


def _trace(mod, policy: str) -> list:
    cfg = mod.SchedulerConfig(max_queue_requests=4, max_queue_tokens=80,
                              tenant_weights={'gold': 3, 'free': 1})
    s = mod.make(policy, cfg)
    log = [s.name]
    reqs = {}
    slots = [None] * 4

    def admit(i):
        tenant, n, out, dl = ARRIVALS[i]
        r = Req(i, tenant, [i + 1] * n, [7] * out, T0 + i,
                None if dl is None else T0 + dl)
        reqs[i] = r
        try:
            s.admit(r, drain_tps=25.0)
        except mod.AdmissionError as e:
            log.append(('shed', i, round(e.retry_after_s, 9), str(e)))
            return
        s.enqueue(r)
        log.append(('admit', i, s.pending(), s.queued_tokens()))

    def pop():
        r = s.pop_next()
        log.append(('pop', None if r is None else r.request_id))
        return r

    for i in range(6):
        admit(i)
    log.append(('retry_after', {t: round(s.retry_after(t, 25.0), 9)
                                for t in ('gold', 'free', 'bronze')}))
    # Fill the slots, then requeue the youngest slot's request (a
    # preemption) and admit the rest against the bounds.
    for k in range(3):
        slots[k] = pop()
    victims = [k for k in range(4) if slots[k] is not None]
    victim = s.pick_victim(victims, slots)
    log.append(('victim', victim))
    s.requeue(slots[victim])
    slots[victim] = None
    for i in range(6, 10):
        admit(i)
    for k in range(4):
        if slots[k] is None:
            slots[k] = pop()
    for _ in range(5):
        cands = sorted(k for k in range(4) if slots[k] is not None)
        log.append(('chunk', s.next_prefill_slot(cands, slots)))
    log.append(('spec', [s.spec_budget(r, 4) for r in slots if r]))
    log.append(('victim', s.pick_victim(
        [k for k in range(4) if slots[k] is not None], slots)))
    for r in slots:
        if r is not None:
            s.note_queue_wait(r, 0.25 + r.request_id / 100)
            s.note_first_token(r, 0.5 + r.request_id / 100)
            s.note_tokens(r, 3)
    s.note_outcome(slots[0], 'cancelled')
    for i in range(10, len(ARRIVALS)):
        admit(i)
    # Sweep: one queued request cancelled, the deadlines of the others
    # judged at T0 + 25.
    queued = s.queued_requests()
    log.append(('queued', [r.request_id for r in queued]))
    queued[-1].cancelled = True
    queued[0].deadline = T0 + 24.0
    log.append(('sweep', [(r.request_id, why)
                          for r, why in s.sweep(T0 + 25.0)]))
    s.set_tenant_weights({'gold': 1, 'free': 5})
    log.append(('spec', [s.spec_budget(r, 4) for r in slots if r]))
    while s.pending():
        pop()
    pop()
    snap = s.snapshot()
    log.append(('snapshot', {t: snap[t] for t in sorted(snap)}))
    log.append(('aggregate', mod.aggregate_stats([snap], 2.0)))
    log.append(('cost', [mod.request_cost(reqs[i]) for i in sorted(reqs)]))
    return log


@pytest.mark.parametrize('policy', ['fcfs', 'deadline', 'wfq'])
def test_policy_decisions_equal_the_jax_policy(policy):
    want = _trace(jsched, policy)
    got = _trace(tsched, policy)
    assert got == want
    # The trace is not vacuous: it sheds, pops, preempts and sweeps.
    kinds = {e[0] for e in want[1:]}
    assert {'shed', 'admit', 'pop', 'victim', 'chunk', 'sweep'} <= kinds
    [swept] = [e[1] for e in want if e[0] == 'sweep']
    assert {why for _, why in swept} == {'cancelled', 'deadline'}


def test_policy_registry_and_errors_match():
    assert sorted(tsched.POLICIES) == sorted(jsched.POLICIES)
    assert issubclass(tsched.AdmissionError, ValueError)
    with pytest.raises(ValueError, match='unknown scheduler'):
        tsched.make('lifo')
    assert tsched.DEFAULT_TENANT == jsched.DEFAULT_TENANT
