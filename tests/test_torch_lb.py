"""The serving gate end to end: the real load balancer
(``skypilot_tpu/serve/load_balancer.py``) in front of the port's replica
server on the CPU and, beside it, in front of the JAX replica server on
the same weights (``params_from_jax``). Streamed ``/generate`` answers
through the two load balancers must carry the same tokens (joined
across their lines) and the same finish reason. Then the ``cache_aware``
policy with its fleet prefix index in front of a torch prefill replica
and a torch decode replica: the decode replica pulls the cohort's prefix
from the prefill replica, and every stream equals a JAX replica's. Last,
the load balancer's mid-stream resume: a chaos proxy
(``tests/chaos/chaos_proxy.py``) severs a torch replica's stream, and the
load balancer splices it onto the replica again with ``resume_from``.

Each replica runs its own default control loop (the port: depth 1, fcfs,
paged; the JAX replica: paged at depth 1), so the gate also holds the
port's dispatch-ahead loop to the reference through the unchanged HTTP
surface.
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
from skypilot_tpu.serve import load_balancer as lb_lib
from skypilot_tpu.serve import state as serve_state
from skypilot_tpu.utils import common as common_lib
from skypilot_tpu_torch.infer import engine as tengine
from skypilot_tpu_torch.infer import server as tserver
from skypilot_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.jax

ENGINE_KW = dict(n_slots=2, max_seq_len=128, prefill_buckets=(16, 32),
                 prefill_chunk=32, page_size=16)
PROMPTS = [[5, 6, 7], list(range(1, 41)), [9] * 17]
NEW = 12


def _get(url, timeout=5):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status
    except (urllib.error.URLError, ConnectionError, OSError):
        return None


def _stream(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type':
                                          'application/json'})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200
        return [json.loads(x) for x in r.read().splitlines() if x.strip()]


def _wait(url, what):
    end = time.time() + 120
    while _get(url) != 200:
        assert time.time() < end, f'{what} never answered 200 at {url}'
        time.sleep(0.1)


def test_lb_streams_identical_from_torch_and_jax_replicas():
    cfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(0))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams))
    tsrv = tserver.InferenceServer(tengine.InferenceEngine(
        tllama.LlamaConfig.tiny(), tparams,
        tengine.EngineConfig(paged=True, **ENGINE_KW), device='cpu'))
    jsrv = jserver.InferenceServer(jengine.InferenceEngine(
        cfg, jparams, jengine.EngineConfig(paged=True, **ENGINE_KW)))
    torch_url = f'http://127.0.0.1:{tsrv.start("127.0.0.1", 0)}'
    jport = common_lib.free_port()
    jax_url = f'http://127.0.0.1:{jport}'
    lbs = {'torch-svc': (torch_url, common_lib.free_port()),
           'jax-svc': (jax_url, common_lib.free_port())}
    for name, (url, _) in lbs.items():
        serve_state.add_service(name, spec_json='{}', task_yaml='',
                                lb_port=0, lb_policy='round_robin')
        rid = serve_state.add_replica(name, f'{name}-replica', version=1)
        serve_state.set_replica_url(rid, url)
        serve_state.set_replica_status(rid,
                                       serve_state.ReplicaStatus.READY)
    loop = asyncio.new_event_loop()
    balancers, tasks, runners = [], [], []

    def run_all():
        from aiohttp import web
        asyncio.set_event_loop(loop)
        runner = web.AppRunner(jsrv.make_app())
        runners.append(runner)
        loop.run_until_complete(runner.setup())
        loop.run_until_complete(
            web.TCPSite(runner, '127.0.0.1', jport).start())
        for name, (url, port) in lbs.items():
            lb = lb_lib.LoadBalancer(name, 'round_robin')
            lb.policy.set_ready_replicas([url])
            balancers.append(lb)
            tasks.append(loop.create_task(lb.run('127.0.0.1', port)))
        loop.run_forever()

    async def close():
        await asyncio.gather(*tasks, return_exceptions=True)
        for runner in runners:
            await runner.cleanup()

    jsrv._thread.start()
    thread = threading.Thread(target=run_all, daemon=True)
    thread.start()
    try:
        _wait(torch_url + '/health', 'the torch replica')
        _wait(jax_url + '/health', 'the JAX replica')
        for _, port in lbs.values():
            _wait(f'http://127.0.0.1:{port}/-/urls', 'a load balancer')
        for prompt in PROMPTS:
            body = {'tokens': prompt, 'max_new_tokens': NEW, 'stream': True}
            got = {}
            for name, (_, port) in lbs.items():
                lines = _stream(f'http://127.0.0.1:{port}/generate', body)
                assert lines[-1]['done'], lines[-1]
                got[name] = ([t for ln in lines[:-1] for t in ln['tokens']],
                             lines[-1]['finish_reason'])
            assert got['torch-svc'] == got['jax-svc']
            assert len(got['torch-svc'][0]) == NEW
            assert got['torch-svc'][1] == 'max_tokens'
    finally:
        for lb in balancers:
            lb.stop()
        asyncio.run_coroutine_threadsafe(close(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
        loop.close()
        tsrv.shutdown()
        jsrv._stop.set()


def _kv_replica(tparams, role):
    srv = tserver.InferenceServer(
        tengine.InferenceEngine(
            tllama.LlamaConfig.tiny(), tparams, tengine.EngineConfig(
                **{**ENGINE_KW, 'n_slots': 3}, paged=True, n_pages=13,
                kv_dtype='int8', prefix_cache=True),
            device='cpu'), role=role)
    return srv, f'http://127.0.0.1:{srv.start("127.0.0.1", 0)}'


def _metrics(url):
    with urllib.request.urlopen(url + '/metrics', timeout=10) as r:
        return json.loads(r.read())


def test_cache_aware_lb_routes_a_cohort_through_a_torch_prefill_decode_pair(
        monkeypatch):
    """The real load balancer with its ``cache_aware`` policy and the
    fleet prefix index in front of a torch ``--role prefill`` replica and
    a torch ``--role decode`` replica (int8 pages, prefix cache): the
    cold seed goes to the prefill replica, its radix summary reaches the
    index through ``/metrics``, and the cohort goes to the decode replica
    naming the prefill replica as donor, so the decode replica pulls the
    prefix over ``/kv/export``. Every stream equals a JAX replica's on
    the same weights (int8 pages, no transfer)."""
    monkeypatch.setenv('SKY_TPU_LB_SYNC_INTERVAL_S', '0.2')
    cfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(0))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams))
    (psrv, pre), (dsrv, dec) = (_kv_replica(tparams, 'prefill'),
                                _kv_replica(tparams, 'decode'))
    jsrv = jserver.InferenceServer(jengine.InferenceEngine(
        cfg, jparams, jengine.EngineConfig(
            paged=True, **{**ENGINE_KW, 'n_slots': 3}, n_pages=13,
            kv_dtype='int8')))
    jport = common_lib.free_port()
    jax_url = f'http://127.0.0.1:{jport}'
    name = 'torch-disagg-svc'
    serve_state.add_service(name, spec_json='{}', task_yaml='', lb_port=0,
                            lb_policy='cache_aware')
    for i, url in enumerate((pre, dec)):
        rid = serve_state.add_replica(name, f'{name}-r{i}', version=1)
        serve_state.set_replica_url(rid, url)
        serve_state.set_replica_status(rid,
                                       serve_state.ReplicaStatus.READY)
    lb_port = common_lib.free_port()
    loop = asyncio.new_event_loop()
    lb = lb_lib.LoadBalancer(name, 'cache_aware')
    lb.policy.set_ready_replicas([pre, dec])
    runners, tasks = [], []

    def run_all():
        from aiohttp import web
        asyncio.set_event_loop(loop)
        runner = web.AppRunner(jsrv.make_app())
        runners.append(runner)
        loop.run_until_complete(runner.setup())
        loop.run_until_complete(
            web.TCPSite(runner, '127.0.0.1', jport).start())
        tasks.append(loop.create_task(lb.run('127.0.0.1', lb_port)))
        loop.run_forever()

    async def close():
        await asyncio.gather(*tasks, return_exceptions=True)
        for runner in runners:
            await runner.cleanup()

    jsrv._thread.start()
    thread = threading.Thread(target=run_all, daemon=True)
    thread.start()
    base = f'http://127.0.0.1:{lb_port}'
    shared = [(i * 7 + 3) % 250 for i in range(32)]
    cohort = [shared + [100 + i, 7, 9, i] for i in range(4)]
    try:
        for url, what in ((pre, 'the prefill replica'),
                          (dec, 'the decode replica'),
                          (jax_url, 'the JAX replica')):
            _wait(url + '/health', what)
        _wait(base + '/-/urls', 'the load balancer')

        def both(prompt):
            body = {'tokens': prompt, 'max_new_tokens': NEW, 'stream': True}
            got = _stream(base + '/generate', body)
            want = _stream(jax_url + '/generate', body)
            assert got[-1]['done'] and want[-1]['done']
            toks = [t for ln in got[:-1] for t in ln['tokens']]
            assert toks == [t for ln in want[:-1] for t in ln['tokens']]
            assert len(toks) == NEW
            return got[-1]

        both(shared + [1])                  # cold: the prefill replica
        assert _metrics(pre)['decode_tokens'] >= NEW
        end = time.time() + 30
        while not _lb_metrics(base).get('fleet_prefix_pages'):
            assert time.time() < end, 'the fleet index never folded'
            time.sleep(0.1)
        done = [both(p) for p in cohort]
        assert done[0]['cached_tokens'] == 32
        mp, md = _metrics(pre), _metrics(dec)
        assert md['kv_transfers_total'] >= 1
        assert md['kv_transfer_failures'] == 0
        assert mp['kv_transfers_total'] >= 1, 'the donor never exported'
        assert md['decode_tokens'] >= len(cohort) * NEW - len(cohort)
        assert md['prefix_hits'] >= len(cohort)
    finally:
        lb.stop()
        asyncio.run_coroutine_threadsafe(close(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
        loop.close()
        psrv.shutdown()
        dsrv.shutdown()
        jsrv._stop.set()


def _lb_metrics(base):
    with urllib.request.urlopen(base + '/-/metrics', timeout=10) as r:
        return json.loads(r.read())


def test_lb_resumes_a_severed_torch_stream_bitwise():
    """The real load balancer (round_robin) over two routes to one torch
    replica: first through a chaos proxy that severs every stream after 3
    response chunks, then direct. A severed stream completes, its done
    line counts at least one resume, and its tokens are the same
    request's uninterrupted tokens (greedy: ``resume_from`` continues
    exactly)."""
    from tests.chaos.chaos_proxy import ChaosProxy
    srv = tserver.InferenceServer(tserver.build_engine(
        'tiny', 2, 128, 16, None, 'cpu', seed=0, paged=True))
    port = srv.start('127.0.0.1', 0)
    direct = f'http://127.0.0.1:{port}'
    proxy = ChaosProxy(target_port=port, kill_every_s=3600.0,
                       kill_after_chunks=3).start()
    name = 'torch-resume-svc'
    routes = [f'http://127.0.0.1:{proxy.port}', direct]
    serve_state.add_service(name, spec_json='{}', task_yaml='', lb_port=0,
                            lb_policy='round_robin')
    for i, url in enumerate(routes):
        rid = serve_state.add_replica(name, f'{name}-r{i}', version=1)
        serve_state.set_replica_url(rid, url)
        serve_state.set_replica_status(rid, serve_state.ReplicaStatus.READY)
    lb = lb_lib.LoadBalancer(name, 'round_robin')
    lb.policy.set_ready_replicas(list(routes))
    lb_port = common_lib.free_port()
    loop = asyncio.new_event_loop()
    thread = threading.Thread(
        target=lambda: (asyncio.set_event_loop(loop),
                        loop.run_until_complete(lb.run('127.0.0.1',
                                                       lb_port))),
        daemon=True)
    thread.start()
    body = {'tokens': [5, 6, 7], 'max_new_tokens': 24, 'stream': True}
    try:
        _wait(direct + '/health', 'the torch replica')
        _wait(f'http://127.0.0.1:{lb_port}/-/urls', 'the load balancer')
        oracle = _stream(direct + '/generate', body)
        lines = _stream(f'http://127.0.0.1:{lb_port}/generate', body)
        done = lines[-1]
        assert done.get('done') and done.get('resumed', 0) >= 1, done
        assert [t for ln in lines[:-1] for t in ln['tokens']] == \
            [t for ln in oracle[:-1] for t in ln['tokens']]
        assert proxy.kills >= 1
        m = _lb_metrics(f'http://127.0.0.1:{lb_port}')
        assert m['requests_resumed'] >= 1 and m['requests_failed'] == 0
    finally:
        lb.stop()
        thread.join(10)
        loop.close()
        proxy.stop()
        srv.shutdown()
