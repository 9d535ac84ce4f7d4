"""The port's two-tier ``EnginePool`` and the replica's ``--long-slots``.

- The pool against the JAX ``EnginePool`` on the same weights (the port's
  copy of ``tests/unit_tests/test_infer.py``'s two-tier case): a short
  and a long prompt route to the same tiers, get the same request ids and
  the JAX pool's live greedy tokens, and the merged metrics carry every
  key the JAX pool's do with the same counter values.
- The reference's four usage errors, each a SystemExit before any weight
  is drawn.
- A ``--long-slots`` replica on the CPU: both tiers warm before
  ``/health`` turns ready, ``/generate`` answers a short prompt from the
  first tier and a long one from the second, each with the tokens an
  in-process dense engine of that tier's size gives on the same weights.
"""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from skypilot_tpu.infer import engine as jengine
from skypilot_tpu.models import llama as jllama
from skypilot_tpu_torch.infer import engine as tengine
from skypilot_tpu_torch.infer import server as tserver
from skypilot_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.jax

SHORT = [5, 17, 101, 7]
LONG = [(i * 7 + 3) % 250 for i in range(40)]   # > 31 tokens: long tier
TIERS = (dict(n_slots=2, max_seq_len=32, prefill_buckets=(8,)),
         dict(n_slots=1, max_seq_len=64, prefill_buckets=(8,)))


def test_pool_routes_and_merges_as_the_jax_pool():
    cfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(0))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams))
    jpool = jengine.EnginePool([
        jengine.InferenceEngine(cfg, jparams, jengine.EngineConfig(**kw),
                                seed=i)
        for i, kw in enumerate(reversed(TIERS))])
    tpool = tengine.EnginePool([
        tengine.InferenceEngine(tllama.LlamaConfig.tiny(), tparams,
                                tengine.EngineConfig(**kw), seed=i,
                                device='cpu')
        for i, kw in enumerate(reversed(TIERS))])
    # Both sort the tiers by length and share one params object.
    assert [e.ecfg.max_seq_len for e in tpool.engines] == [32, 64]
    assert tpool.engines[0].params is tpool.engines[1].params
    jreqs = jpool.generate([SHORT, LONG], max_new_tokens=5)
    treqs = tpool.generate([SHORT, LONG], max_new_tokens=5)
    assert [r.output_tokens for r in treqs] == [r.output_tokens
                                                for r in jreqs]
    assert [r.request_id for r in treqs] == [r.request_id for r in jreqs]
    assert [tpool.tier_of(r) for r in treqs] == [0, 1]
    tm, jm = tpool.metrics(), jpool.metrics()
    assert set(jm) <= set(tm)
    for key in ('decode_steps', 'decode_tokens', 'prefill_tokens',
                'num_active', 'num_waiting', 'tokens_in_flight',
                'pipeline_depth', 'integrity', 'sdc_events_total'):
        assert tm[key] == jm[key], key
    assert [(t['max_seq_len'], t['n_slots'], t['decode_tokens'])
            for t in tm['tiers']] == [
        (t['max_seq_len'], t['n_slots'], t['decode_tokens'])
        for t in jm['tiers']]
    assert tm['tiers'][1]['decode_tokens'] > 0      # the long tier served
    assert tm['paged'] is False and not tpool.kv_index_armed()
    assert tpool.output_digest() == tpool.output_digest()
    with pytest.raises(ValueError, match='every pool tier'):
        tpool.submit(list(range(70)))


@pytest.mark.parametrize('flags,message', [
    (['--paged', '--long-slots', '2'], 'drop --long-slots'),
    (['--prefix-cache'], '--prefix-cache requires --paged'),
    (['--kv-dtype', 'int8'], '--kv-dtype int8 requires --paged'),
    (['--max-seq-len', '128', '--long-slots', '1', '--long-seq-len', '256'],
     'must exceed --max-seq-len'),
], ids=['paged-long-slots', 'prefix-cache', 'kv-int8', 'tier-order'])
def test_server_usage_errors_exit_at_once(flags, message, monkeypatch):
    monkeypatch.setattr(tserver, 'load_params', None)   # never reached
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match=message):
        tserver.parse_args(['--port', '0', '--model', 'tiny', '--device',
                            'cpu'] + flags)
    assert time.perf_counter() - t0 < 1.0


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _generate(base, tokens):
    req = urllib.request.Request(
        base + '/generate', data=json.dumps(
            {'tokens': tokens, 'max_new_tokens': 6}).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_long_slots_replica_serves_both_tiers():
    args = tserver.parse_args(
        ['--port', '0', '--model', 'tiny', '--device', 'cpu', '--slots',
         '2', '--max-seq-len', '64', '--long-slots', '1', '--long-seq-len',
         '128', '--pipeline-depth', '1'])
    srv = tserver.server_from_args(args)
    pool = srv.engine
    assert isinstance(pool, tengine.EnginePool)
    assert pool.engines[0].params is pool.engines[1].params
    base = f'http://127.0.0.1:{srv.start("127.0.0.1", 0)}'
    try:
        deadline = time.time() + 60
        while True:
            try:
                if _get(base + '/health')['status'] == 'ok':
                    break
            except urllib.error.HTTPError:
                pass
            assert time.time() < deadline, 'replica never turned healthy'
            time.sleep(0.05)
        # Warm-up ran both tiers before ready: the long one took a
        # 64-token prompt.
        m = _get(base + '/metrics')
        assert m['paged'] is False and len(m['tiers']) == 2
        assert m['tiers'][1]['prefill_tokens'] >= 64
        events = [e['event'] for e in _get(base + '/debug/stepline')[
            'events']]
        assert 'coldstart.compiled' in events
        long_prompt = [(i * 5 + 1) % 250 for i in range(100)]
        short_ans = _generate(base, SHORT)
        long_ans = _generate(base, long_prompt)
        # Tier i counts request ids i + 1, i + 3, ...
        assert (short_ans['request_id'] - 1) % 2 == 0
        assert (long_ans['request_id'] - 1) % 2 == 1
        for prompt, ans, (slots, seq) in ((SHORT, short_ans, (2, 64)),
                                          (long_prompt, long_ans, (1, 128))):
            want = tserver.build_engine('tiny', slots, seq, 64, None, 'cpu',
                                        seed=0).generate([prompt],
                                                         max_new_tokens=6)
            assert ans['tokens'] == want[0].output_tokens
    finally:
        srv.shutdown()
