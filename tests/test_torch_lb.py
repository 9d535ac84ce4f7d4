"""The serving gate end to end: the real load balancer
(``skypilot_tpu/serve/load_balancer.py``) in front of the port's replica
server on the CPU and, beside it, in front of the JAX replica server on
the same weights (``params_from_jax``). Streamed ``/generate`` answers
through the two load balancers must carry the same tokens (joined
across their lines) and the same finish reason.

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
        tengine.EngineConfig(**ENGINE_KW), device='cpu'))
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
