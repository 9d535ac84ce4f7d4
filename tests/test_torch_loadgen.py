"""The port's trace generator (``skypilot_tpu_torch/utils/loadgen.py``)
against the reference's ``tests/load_tests/loadgen.py``, on the CPU.

- ``synthesize``: the ``tenants`` sweep's two-tenant spec (a victim and
  a 10x aggressor) at two seeds gives the reference's events field by
  field, and so does a spec with cohorts, disconnects, deadlines and an
  active window; a rate envelope, which the port does not carry, raises.
- ``load_trace``: a trace the reference's ``save_trace`` wrote reads
  back equal, meta included; a scrubbed incident record raises.
- ``tenant_summary`` of the same records equals the reference's.
"""
import dataclasses
import json

import pytest

from skypilot_tpu_torch.bench_ttft import tenant_trace_spec
from skypilot_tpu_torch.utils import loadgen as tloadgen
from tests.load_tests import loadgen as jloadgen

MIXED = {
    'gold': {'rps': 4.0, 'burst': 3, 'prompt_mean': 20, 'prompt_max': 80,
             'max_new': 12, 'shared_prefix_frac': 0.5, 'prefix_tokens': 24,
             'disconnect_frac': 0.25, 'deadline_s': 2.5},
    'free': {'rps': 9.0, 'start': 0.5, 'until': 2.5},
}


def _fields(events):
    return [dataclasses.astuple(e) for e in events]


@pytest.mark.parametrize('seed', [7, 1234])
def test_synthesize_equals_the_reference_field_by_field(seed):
    spec = tenant_trace_spec(2)
    got = tloadgen.synthesize(seed, spec, duration_s=3.0)
    want = jloadgen.synthesize(seed, spec, duration_s=3.0)
    assert len(got) == len(want) > 20
    assert [f.name for f in dataclasses.fields(tloadgen.TraceEvent)] == \
        [f.name for f in dataclasses.fields(jloadgen.TraceEvent)]
    assert _fields(got) == _fields(want)
    assert {e.tenant for e in got} == {'victim', 'aggressor'}


def test_synthesize_carries_the_constant_rate_shape_and_refuses_envelopes():
    got = tloadgen.synthesize(3, MIXED, duration_s=3.0)
    assert _fields(got) == _fields(jloadgen.synthesize(3, MIXED,
                                                       duration_s=3.0))
    assert any(e.cohort for e in got) and any(e.disconnect_after
                                              for e in got)
    with pytest.raises(ValueError, match='envelope'):
        tloadgen.synthesize(3, {'a': {'rps': 1.0, 'envelope': [[0, 1.0]]}})


def test_load_trace_reads_what_the_reference_saves(tmp_path):
    events = jloadgen.synthesize(11, MIXED, duration_s=2.0)
    path = str(tmp_path / 'trace.jsonl')
    jloadgen.save_trace(events, path, meta={'seed': 11, 'note': 'mixed'})
    got, meta = tloadgen.load_trace(path)
    want, want_meta = jloadgen.load_trace(path)
    assert _fields(got) == _fields(want) == _fields(events)
    assert meta == want_meta
    with open(path, 'a', encoding='utf-8') as f:
        f.write(json.dumps({'type': 'request', 't': 9.0, 'tenant': 'x',
                            'prompt_tokens': 5, 'max_new_tokens': 2,
                            'cohort': 'abc', 'prefix_tokens': 4}) + '\n')
    with pytest.raises(ValueError, match='scrubbed'):
        tloadgen.load_trace(path)


def test_tenant_summary_equals_the_reference():
    records = []
    for i, ev in enumerate(jloadgen.synthesize(5, MIXED, duration_s=2.0)):
        shed = i % 5 == 0
        records.append({
            'tenant': ev.tenant, 'shed': shed,
            'ttft': None if shed else 0.01 * (i % 7 + 1),
            'queue_wait': None if shed else 0.001 * i,
            'itls': [] if shed else [0.002 * (i % 3 + 1)] * 3,
            'finish_reason': 'shed' if shed else 'max_tokens',
            'tokens': 0 if shed else 4, 'completed': not shed})
    assert tloadgen.tenant_summary(records) == \
        jloadgen.tenant_summary(records)
