"""The port's dispatch-ahead loop and recompute preemption against the JAX
engine, on the CPU.

The reference's determinism workload (``tests/unit_tests/
test_infer_pipeline.py``): mixed short and multi-chunk prompts, more
requests than slots, and a pool of 12 usable pages of 16 tokens, small
enough to preempt mid-run. The port at ``pipeline_depth=1`` must give the
JAX engine's live greedy tokens at depth 1, exactly, with as many
preemptions (at least one), return every page, and give the same tokens
at depth 0 after ``set_pipeline_depth`` drained it. Speculation on (an
oracle drafter, so drafts are accepted) at depth 1 must give
speculation-off's tokens; a sampled run must complete. On the CPU the
step programs run eagerly over the same static device buffers the CUDA
graphs read, so ``compiled_counts()`` stays at one program per kind (and
per chunk bucket for prefill).
"""
import numpy as np
import pytest

import jax
import torch

from skypilot_tpu.infer import engine as jengine
from skypilot_tpu.models import llama as jllama
from skypilot_tpu_torch.infer import engine as tengine
from skypilot_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.jax

PROMPTS = [[11] * 60, [23] * 60, [37] * 60, [5, 17, 101, 7],
           [9, 8, 7, 6, 5]]
NEW = 6
KW = dict(n_slots=3, max_seq_len=128, prefill_buckets=(16, 32),
          prefill_chunk=32, page_size=16, n_pages=13)


class OracleDrafter:
    """Proposes each known prompt's speculation-off continuation, off by
    one at draft index 1 for the prompts in ``wrong``."""

    def __init__(self, prompts, outputs, wrong=()):
        self.known = [(list(p), list(o)) for p, o in zip(prompts, outputs)]
        self.wrong = {tuple(p) for p in wrong}

    def propose(self, context, k, memo=None):
        del memo
        for prompt, out in self.known:
            if list(context[:len(prompt)]) == prompt:
                draft = out[len(context) - len(prompt):][:k]
                if tuple(prompt) in self.wrong and len(draft) > 1:
                    draft[1] = (draft[1] + 1) % 256
                return draft
        return []


def _outputs(reqs):
    return [r.output_tokens for r in reqs]


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


@pytest.fixture(scope='module')
def jax_depth1(params):
    cfg, jparams, _ = params
    je = jengine.InferenceEngine(
        cfg, jparams, jengine.EngineConfig(paged=True, pipeline_depth=1,
                                           **KW))
    return _outputs(je.generate(PROMPTS, max_new_tokens=NEW)), je.metrics()


@pytest.fixture(scope='module')
def port_runs(params):
    """One port engine: depth 1 (the default), then depth 0 on the same
    engine after set_pipeline_depth."""
    _, _, tparams = params
    eng = _port(tparams)
    assert eng.ecfg.pipeline_depth == 1
    out1 = _outputs(eng.generate(PROMPTS, max_new_tokens=NEW))
    m1 = eng.metrics()
    free1 = eng.allocator.free_pages
    eng.set_pipeline_depth(0)
    out0 = _outputs(eng.generate(PROMPTS, max_new_tokens=NEW))
    return eng, out1, m1, free1, out0


def test_depth1_equals_jax_depth1_and_depth0_under_preemption(
        port_runs, jax_depth1):
    eng, out1, m1, free1, out0 = port_runs
    jout, jm = jax_depth1
    assert out1 == jout
    assert out0 == out1
    assert m1['preemptions'] >= 1, 'the workload never preempted'
    assert m1['preemptions'] == jm['preemptions']
    for key in ('decode_steps', 'decode_tokens', 'pages_free'):
        assert m1[key] == jm[key], key
    assert m1['pipeline_depth'] == 1 and m1['tokens_in_flight'] == 0
    assert free1 == eng.allocator.n_pages - 1
    assert eng.allocator.free_pages == eng.allocator.n_pages - 1
    assert all(eng.allocator.refcount(p) == 0
               for p in range(1, eng.allocator.n_pages))
    assert eng.compiled_counts() == {'prefill': 2, 'decode': 1}


def test_set_pipeline_depth_drains(params):
    _, _, tparams = params
    eng = _port(tparams, n_pages=None)
    reqs = [eng.submit(p, 20) for p in PROMPTS[3:]]
    while not eng._queue:
        eng.step()
    assert eng.metrics()['tokens_in_flight'] > 0
    eng.set_pipeline_depth(0)
    assert not eng._queue
    m = eng.metrics()
    assert m['tokens_in_flight'] == 0 and m['pipeline_depth'] == 0
    eng.run_until_idle()
    assert all(len(r.output_tokens) == 20 for r in reqs)


def test_spec_on_at_depth1_equals_spec_off(params, port_runs):
    """Drafts are proposed, accepted and rejected (an oracle drafter),
    under the same page pressure; the tokens stay speculation-off's."""
    _, _, tparams = params
    off = port_runs[1]
    on = _port(tparams, spec_k=4)
    on._drafter = OracleDrafter(PROMPTS, off, wrong=PROMPTS[::2])
    assert _outputs(on.generate(PROMPTS, max_new_tokens=NEW)) == off
    m = on.metrics()
    assert m['spec_accepted_tokens'] >= 1
    assert m['spec_accepted_tokens'] < m['spec_drafted_tokens']
    assert on.allocator.free_pages == on.allocator.n_pages - 1
    assert on.compiled_counts() == {'prefill': 2, 'decode': 1,
                                    'verify': 1}


def test_sampled_run_completes_at_depth1(port_runs):
    eng = port_runs[0]
    eng.set_pipeline_depth(1)
    outs = _outputs(eng.generate(PROMPTS, max_new_tokens=NEW,
                                 temperature=1.0))
    assert all(len(o) == NEW for o in outs)
    assert all(0 <= t < 256 for o in outs for t in o)
    assert eng.allocator.free_pages == eng.allocator.n_pages - 1
    # A sampled step is its own program beside the greedy one (the
    # sampled chunks likewise, per bucket).
    assert eng.compiled_counts() == {'prefill': 4, 'decode': 2}


def test_reserved_workspace_covers_every_verify_width(monkeypatch):
    """A step graph keeps the split kernel's workspace pointer: the
    engine reserves room for the widest verify step before any capture,
    every decode and verify width then gets the same buffers, and a
    launch that would move buffers a graph holds raises instead."""
    from skypilot_tpu_torch.ops import paged_attention as tpa
    monkeypatch.setattr(tpa, '_kernel',
                        lambda symbol: lambda: tpa.PAGES_PER_SPLIT)
    monkeypatch.setattr(tpa, '_split_buffers', {})
    monkeypatch.setattr(tpa, '_captured_buffers', set())
    tpa._checked_pages_per_split.cache_clear()
    try:
        slots, hkv, hd, maxp, group = 3, 2, 16, 8, 4
        tpa.reserve_split_scratch('cpu', slots, hkv, hd, maxp)
        q = torch.zeros(1)
        ws, counters = tpa._split_scratch(q, slots, hkv, group, hd, maxp)
        for r in tpa.CUDA_VERIFY_QUERIES:
            if r * group <= tpa.CUDA_MAX_ROWS:
                got = tpa._split_scratch(q, slots, hkv, r * group, hd, maxp)
                assert got[0] is ws and got[1] is counters
        tpa._captured_buffers.add(('decode', torch.device('cpu')))
        with pytest.raises(RuntimeError, match='CUDA graph holds'):
            tpa._split_scratch(q, slots + 1, hkv, group, hd, maxp)
    finally:
        tpa._checked_pages_per_split.cache_clear()
