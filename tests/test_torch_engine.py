"""The port's InferenceEngine vs the JAX reference engine.

Both engines, paged with the synchronous loop (``pipeline_depth=0``),
serve the same mixed-length prompts on the tiny config with the same
weights (``params_from_jax``); greedy outputs must be identical token for
token. The JAX engine's Pallas kernels run in interpret mode. Pages are
bf16 on both sides (the engines' default cache dtype).
"""
import numpy as np
import pytest

import jax
import torch

from skypilot_tpu.infer import engine as jengine
from skypilot_tpu.models import llama as jllama
from skypilot_tpu_torch.infer import engine as tengine
from skypilot_tpu_torch.models import llama as tllama

jax.config.update('jax_default_matmul_precision', 'highest')
torch.backends.cuda.matmul.allow_tf32 = False

pytestmark = pytest.mark.jax

ENGINE_KW = dict(n_slots=3, max_seq_len=128, prefill_buckets=(16, 32),
                 prefill_chunk=32, page_size=16)


@pytest.fixture(scope='module')
def params():
    cfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, jparams, tllama.params_from_jax(
        jax.tree.map(np.asarray, jparams))


def _port(tparams, **kw):
    return tengine.InferenceEngine(
        tllama.LlamaConfig.tiny(), tparams,
        tengine.EngineConfig(**{**ENGINE_KW, 'paged': True,
                                'pipeline_depth': 0, **kw}),
        device='cpu')


def test_greedy_outputs_identical_to_jax_engine(params):
    cfg, jparams, tparams = params
    je = jengine.InferenceEngine(
        cfg, jparams, jengine.EngineConfig(paged=True, pipeline_depth=0,
                                           **ENGINE_KW))
    te = _port(tparams)
    # 4 prompts on 3 slots (one waits for a free slot); lengths cross
    # page (16) and chunk (32) boundaries.
    prompts = [[5, 6, 7], list(range(1, 41)), list(range(3, 70)),
               [9] * 17]
    jr = je.generate(prompts, max_new_tokens=34)
    tr = te.generate(prompts, max_new_tokens=34)
    for a, b in zip(jr, tr):
        assert b.output_tokens == a.output_tokens
        assert b.finish_reason == a.finish_reason == 'max_tokens'
    tm, jm = te.metrics(), je.metrics()
    for key in ('decode_steps', 'decode_tokens', 'prefill_tokens',
                'pages_total', 'pages_free', 'page_size', 'num_active',
                'num_waiting'):
        assert tm[key] == jm[key], key
    assert tm['kernel_launches'] == dict.fromkeys(
        ['paged_decode_attention', 'paged_prefill_attention',
         'paged_verify_attention', 'paged_decode_attention_int8',
         'paged_prefill_attention_int8', 'paged_verify_attention_int8',
         'qdot_int8'], 0)
    assert tm['ttft_p50_s'] is not None


def test_max_seq_len_cap_finishes_cache_full(params):
    _, _, tparams = params
    te = _port(tparams, max_seq_len=64, n_slots=2)
    [req] = te.generate([[3] * 60], max_new_tokens=50)
    assert req.finish_reason == 'cache_full'
    # The reference's rule: 60 prompt + 3 decoded tokens fill positions
    # 0..62, and the 4th output token ends the request (slot_len + 1
    # reaches max_seq_len).
    assert len(req.output_tokens) == 4
    assert te.idle() and te.metrics()['pages_free'] == 8


def test_engine_config_guards(params):
    _, _, tparams = params
    with pytest.raises(ValueError, match='pipeline_depth'):
        _port(tparams, pipeline_depth=-1)
    with pytest.raises(ValueError, match='multiple of page_size'):
        _port(tparams, page_size=24)
    te = _port(tparams)
    with pytest.raises(ValueError):
        te.submit([])
    with pytest.raises(ValueError):
        te.submit([1] * 200)
    with pytest.raises(ValueError):
        te.submit([1000])
    with pytest.raises(ValueError):
        te.submit([1], max_new_tokens=0)


def test_cuda_is_required_when_asked_for(params, monkeypatch):
    _, _, tparams = params
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        tengine.InferenceEngine(tllama.LlamaConfig.tiny(), tparams,
                                tengine.EngineConfig(paged=True,
                                                     **ENGINE_KW))
