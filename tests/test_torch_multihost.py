"""The port's lockstep driver (``infer/multihost.py``) and the
tensor-parallel replica on the CPU.

- ``python -m skypilot_tpu_torch.infer.server --device cpu --model tiny
  --tp 2`` (rank 0 starts rank 1 itself) answers ``/generate`` with the
  tokens the ``tp``=1 replica of the same command line serves, and on
  SIGTERM both ranks exit 0; ``--tp 2`` on a host with fewer GPUs exits at
  once naming both counts, and ``--paged --tp 2`` is refused.
- The watchdog cases of the reference's
  ``tests/unit_tests/test_infer_multihost.py``: a dead follower makes rank
  0 exit ``WATCHDOG_EXIT_CODE`` (two spawned ``gloo`` ranks, short
  deadlines through the env names), a slow step is ignored, a hung
  collective fires, the hard backstop fires on a wedged step, and a
  desynced digest raises.
"""
import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

import torch_tp_ranks as ranks
from skypilot_tpu_torch.infer import multihost
from skypilot_tpu_torch.infer import server as tserver
from skypilot_tpu_torch.parallel import mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
SERVER = [sys.executable, '-m', 'skypilot_tpu_torch.infer.server',
          '--model', 'tiny', '--device', 'cpu', '--host', '127.0.0.1']


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status
    except (urllib.error.URLError, OSError):
        return None


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type':
                                          'application/json'})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _tp2_serves_tp1_tokens(tmp_path, flags, prompts):
    """``flags`` served at ``--tp 2`` (rank 0 starts rank 1) answer each
    prompt with the tokens that the ``tp``=1 replica of the same flags
    serves, and SIGTERM stops both ranks with exit 0. Returns rank 0's
    /metrics."""
    args = tserver.parse_args(SERVER[3:] + flags + ['--port', '0'])
    want = [r.output_tokens for r in tserver.server_from_args(
        args).engine.generate(prompts, max_new_tokens=9)]
    port = mesh.free_port()
    log_path = tmp_path / 'server.log'
    log = open(log_path, 'w')
    # One intra-op thread a rank (both inherit it): beside a loaded test
    # run, each rank's pool of spinning OpenMP threads slows this tiny
    # server past its deadlines (as test_torch_bench_ttft._run found).
    proc = subprocess.Popen(SERVER + flags + ['--tp', '2', '--port',
                                              str(port)],
                            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                            env={**os.environ, 'OMP_NUM_THREADS': '1'})
    base = f'http://127.0.0.1:{port}'

    def server_log():
        return '\nserver log:\n' + log_path.read_text()
    try:
        deadline = time.time() + 90
        while _get(base + '/health') != 200:
            assert proc.poll() is None, server_log()
            assert time.time() < deadline, ('tp=2 server never turned '
                                            'healthy' + server_log())
            time.sleep(0.2)
        try:
            got = [_post(base + '/generate',
                         {'tokens': p, 'max_new_tokens': 9})
                   for p in prompts]
        except OSError as e:
            raise AssertionError(f'/generate failed: {e!r}' + server_log())
        assert [g['tokens'] for g in got] == want, server_log()
        with urllib.request.urlopen(base + '/metrics', timeout=10) as r:
            metrics = json.loads(r.read())
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, server_log()
    finally:
        if proc.poll() is None:
            proc.kill()
        log.close()
    assert 'tp-rank-1 exited 0' in log_path.read_text(), server_log()
    return metrics


def test_tp2_server_serves_tp1_tokens_and_both_ranks_exit_0(tmp_path):
    metrics = _tp2_serves_tp1_tokens(
        tmp_path, [], [[5, 17, 101, 7], list(range(20, 57))])
    # The driver pins the synchronous loop on every rank.
    assert metrics['pipeline_depth'] == 0


@pytest.fixture(scope='module')
def saved_tiny(tmp_path_factory):
    """A tiny params tree saved as a checkpoint (seed 3)."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import checkpoint as ckpt
    gen = torch.Generator().manual_seed(3)
    path = tmp_path_factory.mktemp('ckpt')
    ckpt.CheckpointManager(str(path)).save(
        0, llama.init_params(llama.LlamaConfig.tiny(), gen, 'cpu'))
    return str(path)


@pytest.mark.parametrize('case', ['long_slots', 'checkpoint',
                                  'checkpoint_quantize',
                                  'compile_cache_dir'])
def test_tp2_server_tiers_and_checkpoints_serve_tp1_tokens(
        tmp_path, saved_tiny, case):
    """The recipes' other ``--tp`` command lines: a long tier beside the
    short one (a prompt past the short tier's cap routes there, on both
    ranks' sliced weights), ``--checkpoint`` restored and sliced by
    each rank, quantized whole first with ``--quantize``, and
    ``--compile-cache-dir``, which the process and the spawned rank each
    apply (the rank inherits no module globals)."""
    prompts = [[5, 17, 101, 7]]
    if case == 'long_slots':
        flags = ['--max-seq-len', '64', '--long-slots', '1',
                 '--long-seq-len', '128']
        prompts.append(list(range(20, 100)))
    elif case == 'compile_cache_dir':
        flags = ['--compile-cache-dir', str(tmp_path / 'kernels')]
    else:
        flags = ['--checkpoint', saved_tiny]
        if case == 'checkpoint_quantize':
            flags.append('--quantize')
        prompts.append(list(range(20, 57)))
    metrics = _tp2_serves_tp1_tokens(tmp_path, flags, prompts)
    if case == 'long_slots':
        assert len(metrics['tiers']) == 2
        assert [t['max_seq_len'] for t in metrics['tiers']] == [64, 128]
        # The warm-up's 64 tokens and the 80-token prompt.
        assert metrics['tiers'][1]['prefill_tokens'] >= 64 + 80
    if case == 'compile_cache_dir':
        assert metrics['kernel_build_dir'] == str(tmp_path / 'kernels')
        assert metrics['kernel_build_s'] == {}     # the CPU builds nothing
        # Applied in this process (rank 0) and again in rank 1's.
        log = (tmp_path / 'server.log').read_text()
        assert log.count('kernel build directory (compile cache) at') == 2, \
            log


def test_tp_beyond_the_gpus_and_paged_tp_fail_fast():
    t0 = time.time()
    out = subprocess.run([sys.executable, '-m',
                          'skypilot_tpu_torch.infer.server', '--model',
                          'tiny', '--tp', '2', '--port', '0'], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    import torch
    have = torch.cuda.device_count()
    assert out.returncode != 0
    assert f'--tp 2 needs 2 GPUs on this host but it has {have}' \
        in out.stderr
    assert time.time() - t0 < 30
    with pytest.raises(SystemExit, match='paged KV is single-device'):
        tserver.parse_args(['--port', '0', '--tp', '2', '--paged'])


def test_watchdog_detects_dead_follower(tmp_path, monkeypatch):
    """A follower killed mid-lockstep: rank 0 must not hang in the
    broadcast; it exits WATCHDOG_EXIT_CODE within the deadline (gloo may
    report the closed peer first; run() exits the same way)."""
    monkeypatch.setenv(multihost.TICK_DEADLINE_ENV, '5')
    up = tmp_path / 'up'
    rank0, rank1 = ranks.start(ranks.watchdog_rank, 2, (str(up),))
    try:
        deadline = time.time() + 60
        while not up.exists():
            assert time.time() < deadline, 'lockstep never started'
            assert rank0.exitcode is None and rank1.exitcode is None
            time.sleep(0.1)
        time.sleep(0.5)
        rank1.kill()
        t0 = time.time()
        rank0.join(timeout=45)
        assert rank0.exitcode is not None, (
            'rank 0 still alive 45 s after its follower died')
        assert rank0.exitcode == multihost.WATCHDOG_EXIT_CODE
        assert time.time() - t0 < 45
    finally:
        for p in (rank0, rank1):
            if p.is_alive():
                p.kill()
            p.join()


class _FakeEngine:
    """An engine stub for the watchdog's semantics (no device work)."""

    def __init__(self, step_s=0.0):
        self.step_s = step_s
        self.steps = 0

    def submit(self, *a, **kw):
        return None

    def step(self):
        self.steps += 1
        if self.step_s:
            time.sleep(self.step_s)

    def idle(self):
        return True


def _driver(monkeypatch, engine, deadline_s):
    drv = multihost.MultihostEngineDriver(engine)
    drv._tick_deadline = deadline_s
    died = []
    monkeypatch.setattr(drv, '_die',
                        lambda stalled, **kw: died.append(stalled))
    return drv, died


def _wait(died, seconds=10):
    deadline = time.time() + seconds
    while not died and time.time() < deadline:
        time.sleep(0.05)


def test_watchdog_ignores_slow_step(monkeypatch):
    """A slow engine.step far past the tick deadline must not kill a
    healthy rank: the watchdog watches time-in-collective only."""
    monkeypatch.setattr(multihost, '_broadcast_bytes',
                        lambda data, group: data)
    drv, died = _driver(monkeypatch, _FakeEngine(step_s=0.4), 0.1)
    drv._start_watchdog()
    for _ in range(3):
        assert drv.tick()
    assert drv.engine.steps == 3
    assert died == []
    drv.stop()


def test_watchdog_fires_when_collective_hangs(monkeypatch):
    hang = threading.Event()
    monkeypatch.setattr(multihost, '_broadcast_bytes',
                        lambda data, group: (hang.wait(30), b'')[1])
    drv, died = _driver(monkeypatch, _FakeEngine(), 0.2)
    drv._start_watchdog()
    t = threading.Thread(target=drv.tick, daemon=True)
    t.start()
    _wait(died)
    assert died and died[0] > 0.2
    drv.stop()
    hang.set()
    t.join(timeout=5)


def test_watchdog_hard_backstop_covers_wedged_step(monkeypatch):
    monkeypatch.setattr(multihost, '_broadcast_bytes',
                        lambda data, group: data)
    wedged = threading.Event()

    class WedgedEngine(_FakeEngine):
        def step(self):
            wedged.wait(30)   # a peer died inside a model collective

    drv, died = _driver(monkeypatch, WedgedEngine(), 60.0)
    drv._hard_deadline = 0.2
    drv._start_watchdog()
    t = threading.Thread(target=drv.tick, daemon=True)
    t.start()
    _wait(died)
    assert died, 'hard backstop never fired on a wedged step'
    drv.stop()
    wedged.set()
    t.join(timeout=5)


def test_watchdog_deadlines_read_from_the_env(monkeypatch):
    monkeypatch.setenv(multihost.TICK_DEADLINE_ENV, '3.5')
    monkeypatch.setenv(multihost.HARD_DEADLINE_ENV, '0')
    drv = multihost.MultihostEngineDriver(_FakeEngine())
    assert (drv._tick_deadline, drv._hard_deadline) == (3.5, 0.0)
    assert (drv.rank, drv.world) == (0, 1)


def test_desync_digest_check_fails_loudly():
    drv = multihost.MultihostEngineDriver(_FakeEngine())
    drv._check_digests([0xdeadbeef] * 4)
    drv._check_digests([5])
    with pytest.raises(RuntimeError, match='lockstep desync'):
        drv._check_digests([7, 7, 8, 7])


def test_host_env_reads_the_agents_names(monkeypatch):
    for name in (mesh.NUM_PROCESSES_ENV, mesh.PROCESS_ID_ENV,
                 mesh.COORDINATOR_ENV):
        monkeypatch.delenv(name, raising=False)
    assert mesh.host_env() == (1, 0, None)
    monkeypatch.setenv(mesh.NUM_PROCESSES_ENV, '2')
    monkeypatch.setenv(mesh.PROCESS_ID_ENV, '1')
    monkeypatch.setenv(mesh.COORDINATOR_ENV, '10.0.0.1:8476')
    assert mesh.host_env() == (2, 1, '10.0.0.1:8476')
    assert os.environ[mesh.NUM_PROCESSES_ENV] == '2'
