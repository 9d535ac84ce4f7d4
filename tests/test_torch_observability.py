"""The port's replica observability and integrity surface against the
JAX package, on the CPU.

- ``observability/prometheus.render_replica`` gives the JAX
  ``render_replica``'s text, byte for byte, for the same metrics dict
  (a port replica's, after a run, with hostile tenant ids).
- The SDC sentinel: a NaN planted in one embedding row, used by one
  prompt only, finishes that request ``'sdc'`` in the port and in the
  JAX engine alike, with the same finish reasons and tokens for every
  request, marks the engine ``integrity_suspect`` and counts the event;
  the port's verdict holds fused on and off.
- The server: ``GET /debug/stepline`` and ``GET
  /metrics?format=prometheus``; once the sentinel tripped, ``/health``
  answers 503 ``{"status": "corrupt"}`` and ``/generate`` 503
  ``quarantined``; ``resume_from`` streams only the new tokens, the same
  ones the JAX server streams for the same body.
"""
import asyncio
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from skypilot_tpu.infer import engine as jengine
from skypilot_tpu.infer import server as jserver
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.observability import prometheus as jprom
from skypilot_tpu.utils import common as common_lib
from skypilot_tpu_torch.infer import engine as tengine
from skypilot_tpu_torch.infer import server as tserver
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.observability import prometheus as tprom

pytestmark = pytest.mark.jax

KW = dict(n_slots=3, max_seq_len=128, prefill_buckets=(16, 32),
          prefill_chunk=32, page_size=16)
NAN_TOKEN = 201
PROMPTS = [[5, 17, 101, 7], [9, 8, 7, 6, 5, NAN_TOKEN, 4], [23] * 40,
           [11] * 20]
NEW = 8


@pytest.fixture(scope='module')
def params():
    cfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, jparams, tllama.params_from_jax(
        jax.tree.map(np.asarray, jparams))


def _port(tparams, **kw):
    return tengine.InferenceEngine(
        tllama.LlamaConfig.tiny(), tparams,
        tengine.EngineConfig(**{**KW, 'paged': True, **kw}), device='cpu')


def _poisoned(params):
    """Both sides' weights with embedding row NAN_TOKEN set to NaN."""
    cfg, jparams, tparams = params
    jp = dict(jparams, embed=jparams['embed'].at[NAN_TOKEN].set(np.nan))
    tp = dict(tparams, embed=tparams['embed'].clone())
    tp['embed'][NAN_TOKEN] = float('nan')
    return jp, tp


def test_render_replica_matches_jax(params):
    _, _, tparams = params
    eng = _port(tparams, fused_prefill=True, spec_k=2)
    eng.generate(PROMPTS[::2], max_new_tokens=NEW)
    m = eng.metrics()
    m.update(requests_shed=3, server_inflight=1, draining=False)
    m['tenants'] = dict(m['tenants'], **{
        'evil"}\nx': {'queue_depth': 2, 'decode_tokens': 7,
                      'requests_shed': 1, 'ttft_p99_s': 0.5}})
    text = tprom.render_replica(m)
    assert text == jprom.render_replica(m)
    for family in ('sky_tpu_engine_fused_steps',
                   'sky_tpu_engine_decode_stall_steps',
                   'sky_tpu_engine_stepline_steps',
                   'sky_tpu_engine_sdc_events_total',
                   'sky_tpu_engine_integrity_state{state="ok"} 1'):
        assert family in text
    # The hostile tenant id is sanitized, never breaks a line.
    assert 'tenant="evil___x"' in text
    assert all(line.startswith(('# TYPE ', 'sky_tpu_'))
               for line in text.splitlines())


@pytest.mark.parametrize('fused', [False, True])
def test_nan_row_finishes_sdc_like_the_jax_engine(params, fused):
    cfg, _, _ = params
    jp, tp = _poisoned(params)
    je = jengine.InferenceEngine(cfg, jp, jengine.EngineConfig(
        paged=True, pipeline_depth=1, fused_prefill=fused, **KW))
    jreqs = je.generate(PROMPTS, max_new_tokens=NEW)
    eng = _port(tp, fused_prefill=fused)
    reqs = eng.generate(PROMPTS, max_new_tokens=NEW)
    reasons = [r.finish_reason for r in reqs]
    assert reasons == [r.finish_reason for r in jreqs]
    assert reasons[1] == 'sdc' and reasons.count('sdc') == 1
    assert [r.output_tokens for r in reqs] == [r.output_tokens
                                               for r in jreqs]
    m, jm = eng.metrics(), je.metrics()
    assert m['integrity'] == jm['integrity'] == 'suspect'
    assert m['sdc_events_total'] == jm['sdc_events_total'] == 1
    assert eng.integrity_suspect()
    # The clean requests' tokens are those of the clean weights.
    clean = _port(params[2], fused_prefill=fused).generate(
        PROMPTS, max_new_tokens=NEW)
    for i in (0, 2, 3):
        assert reqs[i].output_tokens == clean[i].output_tokens
    assert eng.allocator.free_pages == eng.allocator.n_pages - 1


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)
    except (urllib.error.URLError, ConnectionError, OSError):
        return None, b'', {}


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type':
                                          'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wait_ok(url):
    end = time.time() + 120
    while _get(url + '/health')[0] != 200:
        assert time.time() < end, f'{url} never became healthy'
        time.sleep(0.1)


def _lines(raw: bytes):
    return [json.loads(x) for x in raw.splitlines() if x.strip()]


def test_server_routes_and_corrupt_verdict(params):
    _, tp = _poisoned(params)
    srv = tserver.InferenceServer(_port(tp))
    url = f'http://127.0.0.1:{srv.start("127.0.0.1", 0)}'
    try:
        _wait_ok(url)
        status, raw = _post(url + '/generate',
                            {'tokens': PROMPTS[0], 'max_new_tokens': 4})
        assert status == 200 and json.loads(raw)['finish_reason'] == \
            'max_tokens'
        status, raw, headers = _get(url + '/metrics?format=prometheus')
        assert status == 200 and headers['Content-Type'].startswith(
            'text/plain')
        assert 'sky_tpu_engine_integrity_state{state="ok"} 1' in \
            raw.decode()
        status, raw, _ = _get(url + '/debug/stepline')
        snap = json.loads(raw)
        assert status == 200 and snap['enabled'] and snap['steps']
        assert any(e['event'] == 'coldstart.compiled'
                   for e in snap['events'])
        status, raw = _post(url + '/generate',
                            {'tokens': PROMPTS[1], 'max_new_tokens': 4})
        assert status == 200 and json.loads(raw)['finish_reason'] == 'sdc'
        status, raw, _ = _get(url + '/health')
        assert status == 503 and json.loads(raw) == {'status': 'corrupt'}
        status, raw = _post(url + '/generate', {'tokens': PROMPTS[0]})
        assert status == 503 and json.loads(raw)['quarantined'] is True
        m = json.loads(_get(url + '/metrics')[1])
        assert m['integrity'] == 'suspect' and m['sdc_events_total'] == 1
        assert 'sky_tpu_engine_integrity_state{state="suspect"} 1' in \
            _get(url + '/metrics?format=prometheus')[1].decode()
    finally:
        srv.shutdown()


def test_resume_from_streams_only_new_tokens_like_the_jax_server(params):
    cfg, jparams, tparams = params
    tsrv = tserver.InferenceServer(_port(tparams))
    torch_url = f'http://127.0.0.1:{tsrv.start("127.0.0.1", 0)}'
    jsrv = jserver.InferenceServer(jengine.InferenceEngine(
        cfg, jparams, jengine.EngineConfig(paged=True, **KW)))
    jport = common_lib.free_port()
    jax_url = f'http://127.0.0.1:{jport}'
    loop = asyncio.new_event_loop()
    runners = []

    def run():
        from aiohttp import web
        asyncio.set_event_loop(loop)
        runner = web.AppRunner(jsrv.make_app())
        runners.append(runner)
        loop.run_until_complete(runner.setup())
        loop.run_until_complete(
            web.TCPSite(runner, '127.0.0.1', jport).start())
        loop.run_forever()

    jsrv._thread.start()
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        _wait_ok(torch_url)
        _wait_ok(jax_url)
        prompt = list(range(1, 41))
        full = json.loads(_post(torch_url + '/generate',
                                {'tokens': prompt,
                                 'max_new_tokens': 10})[1])['tokens']
        for k in (3, 9, 10):
            body = {'tokens': prompt, 'max_new_tokens': 10,
                    'resume_from': full[:k], 'stream': True}
            got = {}
            for name, url in (('torch', torch_url), ('jax', jax_url)):
                status, raw = _post(url + '/generate', body)
                assert status == 200
                lines = _lines(raw)
                assert lines[-1]['done']
                got[name] = ([t for ln in lines[:-1] for t in ln['tokens']],
                             lines[-1]['finish_reason'])
            assert got['torch'] == got['jax'], k
            assert got['torch'][0] == full[k:]
            plain = json.loads(_post(torch_url + '/generate', dict(
                body, stream=False))[1])
            assert plain['tokens'] == full
        status, raw = _post(torch_url + '/generate',
                            {'tokens': prompt, 'resume_from': ['x']})
        assert status == 400
    finally:
        async def close():
            for runner in runners:
                await runner.cleanup()
        asyncio.run_coroutine_threadsafe(close(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
        loop.close()
        tsrv.shutdown()
        jsrv._stop.set()
