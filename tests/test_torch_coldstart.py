"""The port replica's cold-start timeline against the JAX server's, on the
CPU.

The reference stamps two lifecycle events into the flight recorder:
``coldstart.weights_loaded`` with ``load_s`` once ``main`` has the
weights, and ``coldstart.compiled`` with ``warm_s`` and ``total_s`` once
the warm-up is done (its ``bench_ttft --sweep coldstart`` reads them from
``/debug/stepline``). The JAX replica is its own ``main``, run as a
process (``python -m skypilot_tpu.infer.server --model tiny --paged``,
random weights from ``PRNGKey(0)``); the port replica is built the way
its ``main`` builds it (``server_from_args``) on those weights carried
across. After warm-up both must show the same lifecycle event names with
the same detail keys, the times rounded to the millisecond and
ordered (weights before compiled, total_s >= warm_s).
"""
import json
import os
import pathlib
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from skypilot_tpu.models import llama as jllama
from skypilot_tpu.utils import common as common_lib
from skypilot_tpu_torch.infer import server as tserver
from skypilot_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.jax

REPO = pathlib.Path(__file__).resolve().parents[1]
FLAGS = ['--model', 'tiny', '--slots', '2', '--max-seq-len', '128',
         '--page-size', '16']


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()
    except (urllib.error.URLError, ConnectionError):
        return None, b''


def _wait_ok(url, proc=None):
    end = time.time() + 180
    while _get(url + '/health')[0] != 200:
        assert proc is None or proc.poll() is None, \
            f'{url}: the server exited with {proc.returncode}'
        assert time.time() < end, f'{url} never became healthy'
        time.sleep(0.2)


def _lifecycle(url):
    status, raw = _get(url + '/debug/stepline')
    assert status == 200
    return [ev for ev in json.loads(raw)['events']
            if ev['event'].startswith('coldstart.')]


def _shape(events):
    skip = {'request_id', 'tenant', 'event', 't'}
    return [(ev['event'], sorted(set(ev) - skip)) for ev in events]


def test_coldstart_events_match_the_jax_server(monkeypatch, tmp_path):
    # The reference's main, booting while the port replica builds.
    jport = common_lib.free_port()
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [os.environ.get('PYTHONPATH')]
                                  if p]))
    log = open(tmp_path / 'jax_server.log', 'wb')
    proc = subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu.infer.server', '--host',
         '127.0.0.1', '--port', str(jport), '--paged'] + FLAGS,
        cwd=str(REPO), env=env, stdout=log, stderr=subprocess.STDOUT)
    jax_url = f'http://127.0.0.1:{jport}'
    tsrv = None
    try:
        boot_t0 = time.time()
        jparams = jllama.init_params(jllama.LlamaConfig.tiny(),
                                     jax.random.PRNGKey(0))
        tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams))
        # The port's main path on the weights the reference serves.
        monkeypatch.setattr(tserver, 'load_params',
                            lambda args, config: tparams)
        args = tserver.parse_args(['--port', '0', '--device', 'cpu',
                                   '--paged'] + FLAGS)
        tsrv = tserver.server_from_args(args, boot_t0)
        torch_url = f'http://127.0.0.1:{tsrv.start("127.0.0.1", 0)}'
        _wait_ok(torch_url)
        _wait_ok(jax_url, proc)
        tevents, jevents = _lifecycle(torch_url), _lifecycle(jax_url)
        assert _shape(tevents) == _shape(jevents) == [
            ('coldstart.weights_loaded', ['load_s']),
            ('coldstart.compiled', ['total_s', 'warm_s'])]
        for events in (tevents, jevents):
            loaded, compiled = events
            for v in (loaded['load_s'], compiled['warm_s'],
                      compiled['total_s']):
                assert v >= 0 and round(v, 3) == v
            assert compiled['total_s'] >= compiled['warm_s']
            assert compiled['t'] >= loaded['t']
        assert not any(ev['event'] == 'warm' for ev in json.loads(
            _get(torch_url + '/debug/stepline')[1])['events'])
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        log.close()
        if tsrv is not None:
            tsrv.shutdown()
