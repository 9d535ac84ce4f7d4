"""Bounded admission, cancel, deadlines and graceful drain on the port,
engine and server, on the CPU: twins of the reference's
``tests/unit_tests/test_infer_admission.py`` (the cases that need no
prefix cache and no ``resume_from``), plus the port server's 429 with
``Retry-After``, its ``/drain`` and the flags that configure the control
loop.

Cancelled and expired requests free their slot and their pages (every
page is back at idle), and an abandoned queued request stops occupying
an admission slot at once.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from skypilot_tpu_torch.infer import engine as tengine
from skypilot_tpu_torch.infer import server as tserver
from skypilot_tpu_torch.models import llama as tllama

CFG = tllama.LlamaConfig.tiny()


@pytest.fixture(scope='module')
def params():
    import torch
    gen = torch.Generator()
    gen.manual_seed(0)
    return tllama.init_params(CFG, gen, 'cpu')


def _engine(params, **kw):
    base = dict(n_slots=2, max_seq_len=64, prefill_buckets=(8, 16),
                prefill_chunk=16, paged=True, page_size=8)
    base.update(kw)
    return tengine.InferenceEngine(CFG, params, tengine.EngineConfig(**base),
                                   device='cpu')


def _all_pages_back(eng):
    al = eng.allocator
    return al.free_pages == al.n_pages - 1


# ---------- admission control ---------------------------------------------
def test_admission_queue_request_bound(params):
    eng = _engine(params, n_slots=1, max_queue_requests=2)
    eng.submit([1, 2], max_new_tokens=30)
    eng.submit([1, 2], max_new_tokens=30)
    with pytest.raises(tengine.AdmissionError) as ei:
        eng.submit([1, 2], max_new_tokens=30)
    assert ei.value.retry_after_s > 0
    assert isinstance(ei.value, ValueError)
    eng.run_until_idle()
    assert eng.metrics()['tenants']['default']['requests_shed'] == 1


def test_admission_queue_token_bound(params):
    eng = _engine(params, n_slots=1, max_queue_tokens=8)
    eng.submit([1] * 6, max_new_tokens=5)
    with pytest.raises(tengine.AdmissionError):
        eng.submit([1] * 6, max_new_tokens=5)
    eng.run_until_idle()


def test_abandoned_queued_request_dropped_before_admission(params):
    eng = _engine(params, n_slots=1)
    r1 = eng.submit([1, 2], max_new_tokens=40)
    while eng.metrics()['num_waiting'] > 0:
        eng.step()
    r2 = eng.submit([3, 4], max_new_tokens=5)
    r3 = eng.submit([5, 6], max_new_tokens=5)
    assert eng.cancel(r2)
    eng.step()
    assert r2.done and r2.finish_reason == 'cancelled'
    assert not r2.output_tokens
    eng.run_until_idle()
    assert r1.done and r3.done and r3.finish_reason == 'max_tokens'
    m = eng.metrics()
    assert m['requests_abandoned'] == 1
    assert m['requests_cancelled'] == 0
    assert eng.cancel(r2) is False


# ---------- deadlines ------------------------------------------------------
def test_deadline_expired_in_queue_cancelled(params):
    eng = _engine(params, n_slots=1)
    eng.submit([1, 2], max_new_tokens=30)
    late = eng.submit([3, 4], max_new_tokens=30, deadline=time.time() - 1)
    eng.step()
    assert late.done and late.finish_reason == 'deadline'
    assert not late.output_tokens
    eng.run_until_idle()
    assert eng.metrics()['requests_expired'] == 1


def test_deadline_cancels_mid_decode_and_frees_pages(params):
    # A far deadline, moved into the past once the request decodes: the
    # engine reads it from the request at every sweep, so the cut does
    # not depend on four steps fitting inside a wall-clock budget.
    eng = _engine(params)
    req = eng.submit(list(range(2, 12)), max_new_tokens=40,
                     deadline=time.time() + 3600.0)
    for _ in range(4):
        eng.step()
    assert not req.done and req.output_tokens
    req.deadline = time.time() - 1.0
    end = time.time() + 30
    while not req.done and time.time() < end:
        eng.step()
    assert req.finish_reason == 'deadline'
    assert req.output_tokens and len(req.output_tokens) < 40
    eng.run_until_idle()
    assert _all_pages_back(eng)
    assert eng.metrics()['requests_expired'] == 1


def test_cancel_active_frees_slot_and_pages(params):
    eng = _engine(params)
    req = eng.submit(list(range(2, 12)), max_new_tokens=50)
    for _ in range(5):
        eng.step()
    assert not req.done
    assert eng.cancel(req)
    eng.step()
    assert req.done and req.finish_reason == 'cancelled'
    eng.run_until_idle()
    assert _all_pages_back(eng)
    assert eng.metrics()['requests_cancelled'] == 1
    [after] = eng.generate([[9, 9]], max_new_tokens=3)
    assert len(after.output_tokens) == 3


def test_wallclock_cancel_disabled_ignores_deadline_and_cancel(params):
    eng = _engine(params)
    eng.set_wallclock_cancel(False)
    req = eng.submit([1, 2], max_new_tokens=4, deadline=time.time() - 1)
    eng.cancel(req)
    eng.run_until_idle()
    assert req.finish_reason == 'max_tokens'
    assert len(req.output_tokens) == 4


def test_set_scheduler_is_live_in_metrics(params):
    eng = _engine(params, n_slots=1)
    assert eng.metrics()['scheduler'] == 'fcfs'
    reqs = [eng.submit([1 + i, 2], max_new_tokens=3, tenant=t)
            for i, t in enumerate(['a', 'b', 'a'])]
    eng.set_scheduler('wfq', tenant_weights={'a': 2})
    m = eng.metrics()
    assert m['scheduler'] == 'wfq' and m['num_waiting'] == 3
    eng.run_until_idle()
    assert all(len(r.output_tokens) == 3 for r in reqs)
    assert set(eng.metrics()['tenants']) == {'a', 'b'}


# ---------- server layer ---------------------------------------------------
def _call(url, body=None, headers=None, timeout=60):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, headers={'Content-Type': 'application/json',
                                 **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _serve(engine):
    srv = tserver.InferenceServer(engine)
    base = f'http://127.0.0.1:{srv.start("127.0.0.1", 0)}'
    end = time.time() + 60
    while _call(base + '/health')[0] != 200:
        assert time.time() < end, 'server never turned healthy'
        time.sleep(0.05)
    return srv, base


def test_server_flags_configure_the_control_loop():
    args = tserver.parse_args([
        '--port', '0', '--device', 'cpu', '--paged', '--pipeline-depth', '0',
        '--scheduler', 'wfq', '--tenant-weights', 'gold=4,free=1',
        '--max-queue-requests', '3', '--max-queue-tokens', '500'])
    eng = tserver.engine_from_args(args)
    cfg = eng.ecfg
    assert (cfg.pipeline_depth, cfg.scheduler, cfg.max_queue_requests,
            cfg.max_queue_tokens) == (0, 'wfq', 3, 500)
    assert cfg.tenant_weights == {'gold': 4.0, 'free': 1.0}
    m = eng.metrics()
    assert m['scheduler'] == 'wfq' and m['pipeline_depth'] == 0
    assert tserver.parse_args(['--port', '0']).pipeline_depth == 1
    with pytest.raises(SystemExit):
        tserver.parse_tenant_weights('gold=0')


def test_server_sheds_with_429_and_retry_after(params):
    eng = _engine(params, n_slots=1, max_seq_len=128, prefill_chunk=16,
                  max_queue_requests=1)
    srv, base = _serve(eng)
    try:
        first = eng.submit([1, 2], max_new_tokens=120)
        while eng.metrics()['num_waiting']:
            time.sleep(0.005)
        queued = eng.submit([3, 4], max_new_tokens=120)
        status, headers, raw = _call(base + '/generate',
                                     {'tokens': [5], 'max_new_tokens': 2})
        assert status == 429, raw
        assert int(headers['Retry-After']) >= 1
        assert 'max_queue_requests' in json.loads(raw)['error']
        m = json.loads(_call(base + '/metrics')[2])
        assert m['requests_shed'] == 1 and m['scheduler'] == 'fcfs'
        # A spent deadline budget is a 504, a malformed one a 400.
        for hdr, want in (('0', 504), ('bogus', 400)):
            status, _, _ = _call(base + '/generate',
                                 {'tokens': [1], 'max_new_tokens': 2},
                                 {tserver.DEADLINE_HEADER: hdr})
            assert status == want
        eng.cancel(first)
        eng.cancel(queued)
        assert first.wait_done(30) and queued.wait_done(30)
    finally:
        srv.shutdown()


def test_server_drain_completes_inflight_then_reports(params):
    eng = _engine(params, max_seq_len=128)
    srv, base = _serve(eng)
    try:
        got = {}

        def stream():
            status, _, raw = _call(base + '/generate',
                                   {'tokens': [7, 7], 'stream': True,
                                    'max_new_tokens': 100})
            lines = [json.loads(x) for x in raw.splitlines() if x.strip()]
            got['stream'] = (status, lines)

        def drain():
            got['drain'] = _call(base + '/drain', {'deadline_s': 30})

        t = threading.Thread(target=stream)
        t.start()
        end = time.time() + 30
        while not eng.metrics()['num_active']:
            assert time.time() < end
            time.sleep(0.005)
        d = threading.Thread(target=drain)
        d.start()
        while not srv.draining:
            time.sleep(0.005)
        status, headers, _ = _call(base + '/generate',
                                   {'tokens': [1], 'max_new_tokens': 2})
        assert status == 503 and headers.get('Retry-After') == '1'
        status, _, raw = _call(base + '/health')
        assert status == 503 and json.loads(raw)['status'] == 'draining'
        t.join(60)
        d.join(60)
        status, lines = got['stream']
        assert status == 200 and lines[-1]['done']
        assert len([x for ln in lines[:-1] for x in ln['tokens']]) == 100
        status, _, raw = got['drain']
        report = json.loads(raw)
        assert status == 200 and report['status'] == 'drained'
        assert report['inflight'] == 0
        m = json.loads(_call(base + '/metrics')[2])
        assert m['draining'] is True and m['drain_duration_s'] is not None
    finally:
        srv.shutdown()
