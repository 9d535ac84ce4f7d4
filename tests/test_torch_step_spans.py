"""The flight recorder's spans and counters inside the port, on the CPU
with the tiny model (no JAX).

- Every step record's stage intervals (schedule, dispatch, readback,
  drain) are disjoint, in order, inside the step, and add up exactly to
  its ``dispatch_s`` / ``drain_s`` / ``readback_s``.
- The program records count the work each program was given: the chunk
  schedule of prompts of known lengths (``prefill_chunk`` 32, page 16),
  dense and paged, and each decode program's KV tokens read, rebuilt from
  the requests' outputs.
- The Perfetto export places programs and device gaps on the host clock;
  the pool's snapshot and ``GET /debug/stepline`` carry the programs.
- The train step keeps one record a step with its four phases, and
  reading the records changes nothing of the state.
"""
import json
import time
import urllib.request

import pytest
import torch

from skypilot_tpu_torch.infer import engine as tengine
from skypilot_tpu_torch.infer import server as tserver
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.observability import stepline
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.train import run as train_run
from skypilot_tpu_torch.train import trainer

CFG = llama.LlamaConfig.tiny()
KW = dict(n_slots=3, max_seq_len=128, prefill_buckets=(16, 32),
          prefill_chunk=32, page_size=16)
# Prompt lengths and the chunks (offset, true length) a 32-token chunk
# cap cuts them into.
LENGTHS = (60, 20, 45, 32, 33)
CHUNKS = {60: [(0, 32), (32, 28)], 20: [(0, 20)], 45: [(0, 32), (32, 13)],
          32: [(0, 32)], 33: [(0, 32), (32, 1)]}
FLAVORS = {'dense': dict(paged=False), 'paged': dict(paged=True)}


@pytest.fixture(scope='module')
def params():
    return tengine.init_params_sharded(CFG, 1, 0, 0, 'cpu')


def _engine(params, **extra):
    return tengine.InferenceEngine(
        CFG, params, tengine.EngineConfig(**{**KW, **extra}), device='cpu')


def _prompts():
    return [[(7 * i + j) % 200 + 1 for j in range(n)]
            for i, n in enumerate(LENGTHS)]


def _programs(snap):
    return [p for s in snap['steps'] for p in s['programs']]


@pytest.mark.parametrize('extra', [
    dict(paged=False), dict(paged=True),
    dict(paged=True, fused_prefill=True),
    dict(paged=True, spec_k=3),
    dict(paged=True, pipeline_depth=0),
], ids=['dense', 'paged', 'fused', 'spec', 'depth0'])
def test_stage_intervals_are_disjoint_ordered_and_sum_exactly(params,
                                                              extra):
    eng = _engine(params, **extra)
    eng.generate(_prompts(), max_new_tokens=6)
    steps = eng.stepline_snapshot()['steps']
    assert steps
    for s in steps:
        end = 0.0
        for stage, off, dur in s['stages']:
            assert stage in stepline.INTERVALS
            assert dur >= 0 and off >= end - 1e-9
            end = off + dur
        assert end <= s['dur_s'] + 1e-9
        for key in ('dispatch', 'drain', 'readback'):
            assert s[f'{key}_s'] == sum(d for st, _, d in s['stages']
                                        if st == key)
        n_disp = sum(st == 'dispatch' for st, _, _ in s['stages'])
        assert n_disp == len(s['programs'])
    # Steps that decode also waited on a pair and consumed it.
    assert any(st == 'readback' for s in steps for st, _, _ in s['stages'])
    assert any(st == 'schedule' for s in steps for st, _, _ in s['stages'])


@pytest.mark.parametrize('flavor', sorted(FLAVORS))
def test_program_chunks_are_the_chunk_schedule(params, flavor):
    eng = _engine(params, **FLAVORS[flavor])
    reqs = eng.generate(_prompts(), max_new_tokens=4)
    progs = _programs(eng.stepline_snapshot())
    got = {}
    for p in progs:
        assert p['kind'] in ('prefill', 'decode')
        if p['kind'] == 'prefill':
            (rid, off, tl), = p['chunks']
            assert p['rows'] == tl and p['kv_tokens'] == off + tl
            assert p['bucket'] >= tl
            got.setdefault(rid, []).append((off, tl))
        else:
            assert p['chunks'] == [] and p['rows'] > 0
        assert 0 < p['device_s'] <= p['dispatch_s']
        assert p['gap_before_s'] is None or p['gap_before_s'] >= 0
    assert progs[0]['gap_before_s'] is None
    assert all(p['gap_before_s'] is not None for p in progs[1:])
    assert got == {r.request_id: CHUNKS[len(r.prompt_tokens)] for r in reqs}
    assert sum(tl for chunks in got.values() for _, tl in chunks) == \
        eng.metrics()['prefill_tokens']
    assert len(progs) == eng.metrics()['decode_steps'] + sum(
        len(c) for c in CHUNKS.values())


@pytest.mark.parametrize('flavor', sorted(FLAVORS))
def test_decode_kv_tokens_are_the_slots_contexts(params, flavor):
    """At depth 0 each decode program is read back in its own step, so
    the requests whose outputs grew in a step are its rows, and the token
    each of them decoded (output i >= 1 of a P-token prompt, decoded at
    position P + i - 1) saw P + i keys."""
    eng = _engine(params, pipeline_depth=0, **FLAVORS[flavor])
    reqs = [eng.submit(p, max_new_tokens=5 + i)
            for i, p in enumerate(_prompts())]
    checked = 0
    while not eng.idle():
        before = [len(r.output_tokens) for r in reqs]
        eng.step()
        idx = eng.metrics()['stepline_steps'] - 1
        step = eng.stepline_snapshot()['steps'][-1]
        assert step['idx'] == idx
        grown = [(r, len(r.output_tokens)) for r, n in zip(reqs, before)
                 if len(r.output_tokens) > n]
        for p in step['programs']:
            if p['kind'] != 'decode':
                continue
            assert p['rows'] == len(grown)
            assert p['kv_tokens'] == sum(len(r.prompt_tokens) + n - 1
                                         for r, n in grown)
            checked += 1
    assert checked == eng.metrics()['decode_steps'] > 0


def test_perfetto_places_programs_and_gaps_on_the_host_clock():
    """A program whose gap is known starts where the one before it ended
    plus the gap, or at its start event's host time if later; the gap
    ends where its program starts."""
    prog = dict(step_idx=0, kind='decode', bucket=1, dispatch_s=0.001,
                rows=2, chunks=[], kv_tokens=10)
    steps = [{'idx': 0, 't': 10.0, 'dur_s': 0.1, 'kind': 'decode',
              'batch': 2, 'chunk_tokens': 0, 'queue_depth': 0,
              'host_s': 0.0, 'stages': [('dispatch', 0.01, 0.001)],
              'programs': [
                  dict(prog, t=10.0, device_s=0.02, gap_before_s=None),
                  dict(prog, t=10.001, device_s=0.02, gap_before_s=0.0),
                  dict(prog, t=10.05, device_s=0.01, gap_before_s=0.005),
              ]}]
    events = stepline.stepline_events({'steps': steps})
    assert stepline.validate_perfetto({'traceEvents': events}) == []
    starts = [e['ts'] / 1e6 for e in events if e['name'] ==
              'program.decode']
    assert starts == pytest.approx([10.0, 10.02, 10.05])
    gap, = [e for e in events if e['name'] == 'device.idle']
    assert gap['ts'] / 1e6 == pytest.approx(10.045)
    assert gap['dur'] / 1e6 == pytest.approx(0.005)
    stage, = [e for e in events if e['name'] == 'step.decode.dispatch']
    assert stage['ts'] / 1e6 == pytest.approx(10.01)


def test_pool_snapshot_carries_each_tiers_programs(params):
    pool = tengine.EnginePool([
        _engine(params, paged=False, max_seq_len=64),
        _engine(params, paged=False, max_seq_len=128)])
    reqs = pool.generate([[3] * 40, [5] * 100], max_new_tokens=3)
    snap = pool.stepline_snapshot()
    progs = _programs(snap)
    assert snap['programs_total'] == len(progs) == sum(
        e.stepline_snapshot()['programs_total'] for e in pool.engines)
    assert [s['t'] for s in snap['steps']] == sorted(
        s['t'] for s in snap['steps'])
    chunked = {c[0] for p in progs for c in p['chunks']}
    assert chunked == {r.request_id for r in reqs}


def _get_json(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read())


def test_debug_stepline_carries_the_programs(params):
    srv = tserver.InferenceServer(_engine(params, paged=True))
    url = f'http://127.0.0.1:{srv.start("127.0.0.1", 0)}'
    try:
        end = time.time() + 120
        while not srv.ready:
            assert time.time() < end and not srv.dead
            time.sleep(0.05)
        req = urllib.request.Request(
            url + '/generate', data=json.dumps(
                {'tokens': _prompts()[0], 'max_new_tokens': 3}).encode(),
            headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
        snap = _get_json(url + '/debug/stepline')
        progs = _programs(snap)
        assert snap['programs_total'] >= len(progs) > 0
        assert any(p['chunks'] and p['chunks'][0][2] == 28 for p in progs)
    finally:
        srv.shutdown()


def _train_step(seed=0):
    cfg = llama.LlamaConfig.tiny(max_seq_len=32)
    opt = trainer.make_optimizer(warmup_steps=1)
    gen = torch.Generator().manual_seed(seed)
    state = trainer.init_train_state(cfg, gen, opt)
    batch = trainer.synthetic_batch(cfg, 2, 32, torch.Generator()
                                    .manual_seed(1))
    return trainer.make_train_step(cfg, opt), state, batch


def test_train_step_records_its_phases():
    step, state, batch = _train_step()
    for _ in range(3):
        state, _ = step(state, batch)
    recs = step.records()
    assert [r['idx'] for r in recs] == [0, 1, 2]
    for r in recs:
        assert r['grad_sync'] is None
        phases = [r['forward'], r['backward'], r['optimizer']]
        assert all(p > 0 for p in phases)
        assert sum(phases) <= r['dur_s']
    assert recs[0]['t'] < recs[1]['t'] < recs[2]['t']


def test_train_state_is_the_same_whether_records_are_read():
    states = []
    for read in (False, True):
        step, state, batch = _train_step()
        for _ in range(2):
            state, _ = step(state, batch)
            if read:
                assert step.records()
        states.append(state)
    a, b = states
    assert int(a.step) == int(b.step) == 2
    for x, y in zip(trainer._leaves({'p': a.params, 'o': a.opt_state}),
                    trainer._leaves({'p': b.params, 'o': b.opt_state})):
        assert torch.equal(x, y)


def test_train_run_reports_the_phase_means():
    args = train_run.parse_args(['--model', 'llama-tiny', '--device', 'cpu',
                                 '--batch', '2', '--seq', '32',
                                 '--steps', '4', '--log-every', '2'])
    shape = mesh_lib.make_mesh(dp=1, fsdp=1, tp=1, n_devices=1)
    out = train_run.run_rank(args, shape)
    assert [e['step'] for e in out] == [2, 4]
    for e in out:
        assert e['grad_sync_ms'] is None
        assert all(e[f'{k}_ms'] > 0
                   for k in ('forward', 'backward', 'optimizer'))
