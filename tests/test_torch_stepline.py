"""The port's flight recorder and SDC sentinel row against the JAX
package, on the CPU.

- Pure observation: the recorder on vs off, and the sentinel on vs off,
  give identical greedy tokens, ``decode_steps`` and
  ``compiled_counts()`` over the preempting workload with fused mixed
  steps (and, for the sentinel, with speculation on), at depth 1; with
  the recorder on every program is recorded, each chunk once.
- The records: every worked step is recorded with its kind (decode,
  mixed, free; a step that only prefills is 'prefill'), its chunk tokens
  add up to the prefill tokens, the stage times are disjoint and the port's
  ``summarize`` equals the JAX ``stepline.summarize`` over the same
  records. Per request, the timeline events come in the JAX engine's
  order on the same workload (submit, first_dispatch, first_token,
  preemption and resume, done).
- Dumps: a TTFT-SLO breach and a preemption dump the ring into the
  port's span store; the JAX ``store.SpanStore`` reads the dump back from
  the same file (found by request id), and both Perfetto exports, the
  dump's and the snapshot's, pass the JAX ``stepline.validate_perfetto``.
  Admission sheds and ``cache_full`` finishes dump too.
- The profile-smoke twin (``python -m
  skypilot_tpu_torch.observability.stepline --device cpu``) exits 0.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax

from skypilot_tpu.infer import engine as jengine
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.observability import render as jrender
from skypilot_tpu.observability import stepline as jstepline
from skypilot_tpu.observability import store as jstore
from skypilot_tpu_torch.infer import engine as tengine
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.observability import stepline as tstepline
from skypilot_tpu_torch.observability import store as tstore

pytestmark = pytest.mark.jax

PROMPTS = [[11] * 60, [23] * 60, [37] * 60, [5, 17, 101, 7],
           [9, 8, 7, 6, 5]]
NEW = 6
KW = dict(n_slots=3, max_seq_len=128, prefill_buckets=(16, 32),
          prefill_chunk=32, page_size=16, n_pages=13)
TINY = dict(n_slots=2, max_seq_len=64, prefill_buckets=(16,),
            prefill_chunk=16, page_size=16)


@pytest.fixture(scope='module')
def params():
    cfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, jparams, tllama.params_from_jax(
        jax.tree.map(np.asarray, jparams))


@pytest.fixture
def dump_store(tmp_path):
    """The port's anomaly dumps land in a test-local store."""
    st = tstore.SpanStore(db_path=str(tmp_path / 'dumps.db'))
    tstepline.set_dump_store(st)
    yield st
    tstepline.flush_dumps(10.0)
    tstepline.set_dump_store(None)


def _port(tparams, kw=KW, **extra):
    return tengine.InferenceEngine(
        tllama.LlamaConfig.tiny(), tparams,
        tengine.EngineConfig(**{**kw, 'paged': True, **extra}),
        device='cpu')


def _run(eng, prompts=PROMPTS, new=NEW):
    reqs = eng.generate(prompts, max_new_tokens=new)
    return ([r.output_tokens for r in reqs], eng.metrics()['decode_steps'],
            eng.compiled_counts())


@pytest.fixture(scope='module')
def recorded(params):
    """The fused preempting workload with the recorder on (the
    default) and off, at depth 1."""
    _, _, tparams = params
    on = _port(tparams, fused_prefill=True)
    off = _port(tparams, fused_prefill=True, stepline=False)
    return on, _run(on), off, _run(off)


def test_recorder_on_off_identical(recorded):
    on, run_on, off, run_off = recorded
    assert run_on == run_off
    assert on.metrics()['preemptions'] >= 1
    assert on.metrics()['stepline_steps'] > 0
    assert off.metrics()['stepline_steps'] == 0
    # Every program of the workload was recorded, each chunk once.
    progs = [p for s in on.stepline_snapshot()['steps']
             for p in s['programs']]
    assert sum(p['kind'] != 'prefill' for p in progs) == \
        on.metrics()['decode_steps']
    assert sum(tl for p in progs for _, _, tl in p['chunks']) == \
        on.metrics()['prefill_tokens']
    assert off.stepline_snapshot() == {'enabled': False, 'steps': [],
                                       'events': []}
    assert off.stepline_summary() == {'enabled': False}


@pytest.mark.parametrize('extra', [dict(fused_prefill=True),
                                   dict(spec_k=3)])
def test_sentinel_on_off_identical(params, extra):
    _, _, tparams = params
    runs = {flag: _run(_port(tparams, sdc_sentinel=flag, **extra))
            for flag in (True, False)}
    assert runs[True] == runs[False]


def test_step_records_and_summary_match_jax_summarize(recorded):
    on = recorded[0]
    snap = on.stepline_snapshot()
    assert snap['enabled'] and snap['steps_total'] == len(snap['steps'])
    kinds = {r['kind'] for r in snap['steps']}
    assert {'mixed', 'decode'} <= kinds, kinds
    for r in snap['steps']:
        assert r['dur_s'] >= 0 and r['host_s'] >= 0
        assert (r['dispatch_s'] + r['drain_s'] + r['readback_s']
                <= r['dur_s'] + 1e-9)
        if r['kind'] == 'mixed':
            assert r['chunk_tokens'] > 0 and r['batch'] > 0
    assert sum(r['chunk_tokens'] for r in snap['steps']) == \
        on.metrics()['prefill_tokens']
    idx = [r['idx'] for r in snap['steps']]
    assert idx == list(range(len(idx)))
    recs = [tstepline.StepRecord(**{k: r[k] for k in
                                    tstepline.StepRecord.__slots__})
            for r in snap['steps']]
    jrecs = [jstepline.StepRecord(**{k: r[k] for k in
                                     jstepline.StepRecord.__slots__})
             for r in snap['steps']]
    got = on.stepline_summary()
    assert got.pop('enabled') is True
    assert got == tstepline.summarize(recs) == jstepline.summarize(jrecs)
    assert abs(sum(got[f'{s}_share'] for s in tstepline.STAGES) - 1) < 1e-3


def _timelines(snap):
    out = {}
    for ev in snap['events']:
        out.setdefault(ev['request_id'], []).append(ev['event'])
    return out


def test_request_timelines_match_jax(params, recorded, tmp_path):
    cfg, jparams, _ = params
    prev = jstepline._store
    jstepline.set_dump_store(jstore.SpanStore(
        db_path=str(tmp_path / 'jax_dumps.db')))
    try:
        je = jengine.InferenceEngine(
            cfg, jparams, jengine.EngineConfig(
                paged=True, pipeline_depth=1, fused_prefill=True, **KW))
        je.generate(PROMPTS, max_new_tokens=NEW)
        jsnap = je.stepline_snapshot()
    finally:
        jstepline.flush_dumps(10.0)
        jstepline.set_dump_store(prev)
    tl = _timelines(recorded[0].stepline_snapshot())
    assert tl == _timelines(jsnap)
    assert any('preemption' in evs and 'resume' in evs
               for evs in tl.values())


def _dumps_by_trigger(store):
    out = {}
    for t in store.list_traces(limit=200):
        spans = store.get_trace(t['trace_id'])
        for s in spans:
            if s['name'] == 'stepline.trigger':
                out.setdefault(s['attrs'].get('trigger'), []).append(spans)
    return out


def test_ttft_slo_dump_read_back_by_the_jax_store(params, dump_store):
    _, _, tparams = params
    eng = _port(tparams, TINY, ttft_slo_s=0.0)
    reqs = eng.generate([[7, 8, 9]], max_new_tokens=4)
    assert tstepline.flush_dumps(10.0), 'the dump writer did not drain'
    assert eng.metrics()['stepline_dumps'] >= 1
    reader = jstore.SpanStore(db_path=dump_store.db_path)
    by_trigger = _dumps_by_trigger(reader)
    assert 'ttft_slo' in by_trigger
    spans = by_trigger['ttft_slo'][0]
    names = {s['name'] for s in spans}
    assert {'stepline.dump', 'stepline.trigger'} <= names
    assert any(n.startswith('step.') for n in names)
    trigger = next(s for s in spans if s['name'] == 'stepline.trigger')
    assert trigger['status'] == 'anomaly:ttft_slo'
    rid = trigger['attrs']['request_id']
    assert rid == reqs[0].request_id
    assert reader.trace_for_request(str(rid))
    assert jstepline.validate_perfetto(jrender.to_perfetto(spans)) == []
    snap = eng.stepline_snapshot()
    assert jstepline.validate_perfetto(tstepline.to_perfetto(snap)) == []
    assert jstepline.validate_perfetto(
        tstepline.to_perfetto(snap, spans)) == []


def test_preemption_cache_full_and_shed_dumps(params, dump_store):
    _, _, tparams = params
    eng = _port(tparams, TINY, n_pages=5)
    eng.generate([[3] * 32, [5] * 32], max_new_tokens=8)
    assert eng.metrics()['preemptions'] > 0
    r = _port(tparams, TINY).generate([[3] * 40], max_new_tokens=200)[0]
    assert r.finish_reason == 'cache_full'
    shed = _port(tparams, TINY, max_queue_requests=1)
    shed.submit([1, 2, 3])
    with pytest.raises(tengine.AdmissionError):
        shed.submit([4, 5, 6])
    assert tstepline.flush_dumps(10.0)
    by_trigger = _dumps_by_trigger(jstore.SpanStore(
        db_path=dump_store.db_path))
    assert {'preemption', 'cache_full', 'admission_shed'} <= set(by_trigger)
    trig = next(s for s in by_trigger['preemption'][0]
                if s['name'] == 'stepline.trigger')
    assert 'tokens_recomputed' in trig['attrs']


def test_lifecycle_event_and_ring_cap(params):
    _, _, tparams = params
    eng = _port(tparams, TINY, stepline_cap=8)
    eng.note_lifecycle_event('warm', warm_s=0.5)
    eng.generate([[1, 2, 3], [4, 5]], max_new_tokens=12)
    snap = eng.stepline_snapshot()
    assert snap['cap'] == 8 and len(snap['steps']) == 8
    assert snap['steps_total'] > 8
    assert [r['idx'] for r in snap['steps']] == list(
        range(snap['steps_total'] - 8, snap['steps_total']))
    life = [e for e in snap['events'] if e['request_id'] == -1]
    assert life and life[0]['event'] == 'warm'


def test_profile_smoke_twin_exits_0_on_the_cpu():
    """``python -m skypilot_tpu_torch.observability.stepline --device
    cpu`` (the reference's ``make profile-smoke``): a forced dump, the
    live export and the dump's round trip validated, exit 0."""
    out = subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.observability.stepline',
         '--device', 'cpu'],
        cwd=pathlib.Path(__file__).resolve().parents[1], capture_output=True,
        text=True, timeout=300, env={**os.environ, 'OMP_NUM_THREADS': '1'})
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith('profile-smoke OK:'), out.stdout
    doc = json.loads(out.stdout.split(':', 1)[1])
    assert doc['device'] == 'cpu' and doc['steps'] > 0
    assert doc['dump_spans'] > 2
