"""The port's dense-cache engine (``EngineConfig.paged=False``, the
reference's default) against the JAX dense engine, and its invariants.

Both engines serve the same prompts (more requests than slots, single-
and multi-chunk, a 16-token bucket tail) on the tiny config with the same
weights (``params_from_jax``), fp32. The greedy tokens must be the JAX
dense engine's live output token for token (never the frozen goldens of
the JAX tests), and ``metrics()`` must carry every key the JAX dense
engine emits, with no ``pages_*``. Within the port, the reference's own
invariants hold bitwise: depth 0 == depth 1, speculation on (an oracle
drafter, so drafts are accepted) == off, fused on == off; and the dense
engine's tokens equal the paged engine's (the port's copy of
``test_infer_paged.py``'s dense-vs-paged case). On the CPU the step
programs run eagerly over the same static buffers the card's graphs read.
"""
import numpy as np
import pytest

import jax

from skypilot_tpu.infer import engine as jengine
from skypilot_tpu.models import llama as jllama
from skypilot_tpu_torch.infer import engine as tengine
from skypilot_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.jax

PROMPTS = [[5, 17, 101, 7], list(range(1, 41)), [9] * 17,
           [(i * 7 + 3) % 250 for i in range(60)]]
NEW = 8
KW = dict(n_slots=3, max_seq_len=128, prefill_buckets=(16, 32),
          prefill_chunk=32, prefill_chunks_per_step=1)
# Keys the port adds to a single engine's metrics (the reference has no
# CUDA graphs, kernel counters or device name).
PORT_ONLY = {'paged', 'cuda_graphs', 'step_programs', 'device',
             'param_bytes', 'kernel_launches', 'kv_cache_bytes',
             'prefill_chunks'}


class OracleDrafter:
    """Proposes each known prompt's speculation-off continuation."""

    def __init__(self, prompts, outputs):
        self.known = [(list(p), list(o)) for p, o in zip(prompts, outputs)]

    def propose(self, context, k, memo=None):
        del memo
        for prompt, out in self.known:
            if list(context[:len(prompt)]) == prompt:
                return out[len(context) - len(prompt):][:k]
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
        tengine.EngineConfig(**{**KW, 'pipeline_depth': 0, **kw}),
        device='cpu')


@pytest.fixture(scope='module')
def baseline(params):
    """The port's dense engine at depth 0, synchronous and unfused."""
    eng = _port(params[2])
    return eng, _outputs(eng.generate(PROMPTS, max_new_tokens=NEW))


def test_greedy_and_metrics_equal_jax_dense_engine(params, baseline):
    cfg, jparams, _ = params
    je = jengine.InferenceEngine(cfg, jparams, jengine.EngineConfig(
        paged=False, pipeline_depth=0, **KW))
    jreqs = je.generate(PROMPTS, max_new_tokens=NEW)
    eng, out = baseline
    assert out == _outputs(jreqs)
    tm, jm = eng.metrics(), je.metrics()
    assert set(tm) - set(jm) == PORT_ONLY
    assert set(jm) <= set(tm)
    assert tm['paged'] is False
    assert not any(k.startswith('pages_') for k in tm)
    for key in ('decode_steps', 'decode_tokens', 'prefill_tokens',
                'num_active', 'num_waiting', 'fused_steps',
                'decode_stall_steps'):
        assert tm[key] == jm[key], key
    # The reference's buckets, no page ladder: one program per bucket
    # used, one decode program.
    assert eng._buckets == [16, 32]
    assert eng.compiled_counts() == {'prefill': 2, 'decode': 1}
    # K and V of 3 slots x 128 rows in the default bf16 cache_dtype.
    assert tm['kv_cache_bytes'] == 2 * cfg.n_layers * 3 * 128 * \
        cfg.n_kv_heads * cfg.head_dim * 2


@pytest.mark.parametrize('variant', ['depth1', 'spec', 'fused-depth0',
                                     'fused-depth1'])
def test_dense_invariants_bitwise(params, baseline, variant):
    _, want = baseline
    kw = {'depth1': dict(pipeline_depth=1),
          'spec': dict(pipeline_depth=1, spec_k=3),
          'fused-depth0': dict(fused_prefill=True),
          'fused-depth1': dict(fused_prefill=True, pipeline_depth=1)}[variant]
    eng = _port(params[2], **kw)
    if variant == 'spec':
        eng._drafter = OracleDrafter(PROMPTS, want)
    assert _outputs(eng.generate(PROMPTS, max_new_tokens=NEW)) == want
    m = eng.metrics()
    if variant == 'spec':
        assert m['spec_accepted_tokens'] > 0
        assert m['step_programs']['verify'] == 1
    if variant.startswith('fused'):
        assert m['fused_steps'] > 0 and m['decode_stall_steps'] == 0


def test_dense_equals_paged_greedy(params, baseline):
    _, want = baseline
    paged = _port(params[2], paged=True, page_size=16)
    assert _outputs(paged.generate(PROMPTS, max_new_tokens=NEW)) == want
    assert paged.metrics()['paged'] is True


def test_dense_cache_full_and_config_errors(params):
    _, _, tparams = params
    eng = _port(tparams, max_seq_len=64, n_slots=2)
    [req] = eng.generate([[3] * 60], max_new_tokens=50)
    # The reference's rule: positions 0..62 fill, the 4th token ends it.
    assert req.finish_reason == 'cache_full'
    assert len(req.output_tokens) == 4
    assert eng.idle() and eng.allocator is None
    assert eng.kv_page_size() == 0 and not eng.kv_index_armed()
    with pytest.raises(ValueError, match='kv_dtype=int8 requires the paged'):
        _port(tparams, kv_dtype='int8')
    with pytest.raises(ValueError, match='prefix_cache requires the paged'):
        _port(tparams, prefix_cache=True)
    with pytest.raises(ValueError, match='multiple of the chunk'):
        _port(tparams, max_seq_len=80)


@pytest.mark.parametrize('paged', [False, True])
def test_warm_programs_leave_tokens_unchanged(params, baseline, paged):
    """``warm_programs`` (the replica's warm-up on the card, where it
    captures each program) runs every greedy program on an idle engine:
    the tokens served after it are the unwarmed engine's, and serving
    them adds no program."""
    _, want = baseline
    kw = dict(paged=True, page_size=16) if paged else {}
    eng = _port(params[2], pipeline_depth=1, spec_k=3, fused_prefill=True,
                **kw)
    eng._drafter = OracleDrafter(PROMPTS, want)
    keys = eng.warm_programs()
    assert keys == ([('prefill', b, False) for b in (16, 32)]
                    + [('decode', 1, False), ('verify', 4, False)]
                    + [('mixed', b, False) for b in (16, 32)])
    counts = eng.compiled_counts()
    assert counts == {'prefill': 2, 'decode': 1, 'verify': 1, 'mixed': 2}
    assert _outputs(eng.generate(PROMPTS, max_new_tokens=NEW)) == want
    assert eng.compiled_counts() == counts
    eng.submit(PROMPTS[0], max_new_tokens=NEW)
    with pytest.raises(RuntimeError, match='idle engine'):
        eng.warm_programs()
