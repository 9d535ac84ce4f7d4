"""Speculative decoding on the port's engine vs the JAX reference engine.

Both engines are paged with the synchronous loop (``pipeline_depth=0``)
on the tiny config with the same weights (``params_from_jax``); the JAX
engine's Pallas kernels run in interpret mode. Greedy outputs must be
identical token for token: speculation on vs off in the port, and the
port vs the JAX engine at ``spec_k=4``.

The JAX package's own speculation gates are vacuous on this workload
(random weights: the prompt-lookup drafter's proposals are never
accepted). So the non-vacuous tests set a test-side
``OracleDrafter`` as ``_drafter`` on both engines: it proposes the
speculation-off greedy continuation, wrong at a fixed offset for some
prompts, so drafts are proposed, accepted and rejected at known places;
the speculation counters must then equal the JAX engine's, acceptance
must be >= 1, and no page may leak. ``paged_verify_step`` itself is held
to JAX's logits at 1e-4 for bf16 and int8 pages.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from skypilot_tpu.infer import engine as jengine
from skypilot_tpu.infer import model as jmodel
from skypilot_tpu.infer import paged_cache as jpc
from skypilot_tpu.models import llama as jllama
from skypilot_tpu_torch.infer import engine as tengine
from skypilot_tpu_torch.infer import model as tmodel
from skypilot_tpu_torch.infer import paged_cache as tpc
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.ops import paged_attention as tpa

jax.config.update('jax_default_matmul_precision', 'highest')
torch.backends.cuda.matmul.allow_tf32 = False

pytestmark = pytest.mark.jax

ENGINE_KW = dict(n_slots=3, max_seq_len=128, prefill_buckets=(16, 32),
                 prefill_chunk=32, page_size=16)
# The reference's speculation workload (tests/unit_tests/test_infer_spec.py):
# mixed short and multi-chunk prompts, more requests than slots.
PROMPTS = [[11] * 60, [23] * 60, [37] * 60, [5, 17, 101, 7],
           [9, 8, 7, 6, 5]]
NEW = 12
SPEC_KEYS = ('spec_steps', 'spec_slot_steps', 'spec_drafted_tokens',
             'spec_accepted_tokens', 'spec_emitted_tokens',
             'accepted_len_mean')


class OracleDrafter:
    """Proposes the speculation-off greedy continuation of each known
    prompt. For prompts in ``wrong`` the draft's token at index
    ``offset`` is off by one, so those runs are accepted up to it and
    rejected there."""

    def __init__(self, prompts, outputs, wrong=(), offset=2, vocab=256):
        self.known = [(list(p), list(o)) for p, o in zip(prompts, outputs)]
        self.wrong = {tuple(p) for p in wrong}
        self.offset, self.vocab = offset, vocab

    def propose(self, context, k, memo=None):
        del memo
        for prompt, out in self.known:
            if list(context[:len(prompt)]) == prompt:
                n = len(context) - len(prompt)
                draft = out[n:n + k]
                if tuple(prompt) in self.wrong and len(draft) > self.offset:
                    draft[self.offset] = (draft[self.offset] + 1) % self.vocab
                return draft
        return []


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


def _jax(cfg, jparams, **kw):
    return jengine.InferenceEngine(
        cfg, jparams, jengine.EngineConfig(paged=True, pipeline_depth=0,
                                           **{**ENGINE_KW, **kw}))


def _outputs(reqs):
    return [r.output_tokens for r in reqs]


@pytest.fixture(scope='module')
def spec_off(params):
    _, _, tparams = params
    return _outputs(_port(tparams).generate(PROMPTS, max_new_tokens=NEW))


def _oracle(spec_off, wrong=PROMPTS[::2]):
    return OracleDrafter(PROMPTS, spec_off, wrong=wrong)


def _no_leaks(eng):
    al = eng.allocator
    assert al.free_pages == al.n_pages - 1
    assert all(al.refcount(pid) == 0 for pid in range(1, al.n_pages))


def test_spec_on_identical_to_spec_off_and_jax(params, spec_off):
    cfg, jparams, tparams = params
    on = _port(tparams, spec_k=4)
    assert _outputs(on.generate(PROMPTS, max_new_tokens=NEW)) == spec_off
    je = _jax(cfg, jparams, spec_k=4)
    assert _outputs(je.generate(PROMPTS, max_new_tokens=NEW)) == spec_off
    tm, jm = on.metrics(), je.metrics()
    for key in ('decode_steps', 'decode_tokens', 'spec_k', *SPEC_KEYS):
        assert tm[key] == jm[key], key
    _no_leaks(on)


def test_oracle_drafts_accepted_and_identical_to_jax(params, spec_off):
    """Non-vacuous: drafts are accepted (fully for two prompts, up to
    offset 2 for the others), the outputs stay speculation-off's, every
    counter equals the JAX engine's under the same drafter, steps drop,
    and every page comes home."""
    cfg, jparams, tparams = params
    on = _port(tparams, spec_k=4)
    on._drafter = _oracle(spec_off)
    assert _outputs(on.generate(PROMPTS, max_new_tokens=NEW)) == spec_off
    je = _jax(cfg, jparams, spec_k=4)
    je._drafter = _oracle(spec_off)
    assert _outputs(je.generate(PROMPTS, max_new_tokens=NEW)) == spec_off
    tm, jm = on.metrics(), je.metrics()
    for key in ('decode_steps', 'decode_tokens', *SPEC_KEYS):
        assert tm[key] == jm[key], key
    assert tm['spec_accepted_tokens'] >= 1
    assert tm['spec_accepted_tokens'] < tm['spec_drafted_tokens']
    assert tm['accepted_len_mean'] > 1.0
    off = _port(tparams)
    off.generate(PROMPTS, max_new_tokens=NEW)
    assert tm['decode_steps'] < off.metrics()['decode_steps']
    _no_leaks(on)
    assert tm['kernel_launches'] == dict.fromkeys(tm['kernel_launches'], 0)


@pytest.mark.parametrize('budget', [1, 2, 5, 9])
def test_max_tokens_inside_an_accepted_run(params, spec_off, budget):
    """A run accepted past the request's budget drops the surplus: the
    output lands exactly on max_new_tokens, token for token
    speculation-off's."""
    _, _, tparams = params
    prompt = PROMPTS[1]
    off = _port(tparams).generate([prompt], max_new_tokens=budget)[0]
    on = _port(tparams, spec_k=4)
    on._drafter = OracleDrafter([prompt], [spec_off[1]])
    req = on.generate([prompt], max_new_tokens=budget)[0]
    assert req.output_tokens == off.output_tokens == spec_off[1][:budget]
    assert req.finish_reason == off.finish_reason == 'max_tokens'
    _no_leaks(on)


def test_eos_inside_an_accepted_run(params, spec_off):
    """A token the greedy continuation emits mid-stream declared EOS:
    both lanes stop at its first occurrence with identical output."""
    _, _, tparams = params
    out = spec_off[0]
    eos = next(t for i, t in enumerate(out) if i >= 3 and t not in out[:i])
    off = _port(tparams, eos_id=eos).generate([PROMPTS[0]], NEW)[0]
    on = _port(tparams, spec_k=4, eos_id=eos)
    on._drafter = OracleDrafter([PROMPTS[0]], [out])
    req = on.generate([PROMPTS[0]], NEW)[0]
    assert req.output_tokens == off.output_tokens == out[:out.index(eos) + 1]
    assert req.finish_reason == off.finish_reason == 'eos'
    assert on.metrics()['spec_accepted_tokens'] >= 1
    _no_leaks(on)


def test_cache_end_inside_a_run(params):
    """Near the cache end the draft is cut so every drafted position and
    the corrected token fit, and the request finishes 'cache_full' where
    speculation-off does."""
    _, _, tparams = params
    prompt = [23] * 56
    off = _port(tparams, max_seq_len=64).generate([prompt], 50)[0]
    on = _port(tparams, max_seq_len=64, spec_k=4)
    on._drafter = OracleDrafter([prompt], [off.output_tokens])
    req = on.generate([prompt], 50)[0]
    assert req.output_tokens == off.output_tokens
    assert req.finish_reason == off.finish_reason == 'cache_full'
    assert on.metrics()['spec_accepted_tokens'] >= 1
    _no_leaks(on)


def test_opted_out_and_sampled_requests_never_verify(params, spec_off):
    _, _, tparams = params
    on = _port(tparams, spec_k=4)
    on._drafter = _oracle(spec_off, wrong=())
    reqs = [on.submit(p, NEW, spec=False) for p in PROMPTS]
    on.run_until_idle()
    assert _outputs(reqs) == spec_off
    reqs = [on.submit(p, NEW, temperature=1.0) for p in PROMPTS]
    on.run_until_idle()
    assert all(len(r.output_tokens) == NEW for r in reqs)
    m = on.metrics()
    assert m['spec_steps'] == 0 and m['spec_drafted_tokens'] == 0
    assert m['accepted_len_mean'] is None
    assert all(r.spec_steps == 0 for r in reqs)


def test_set_spec_k_and_metrics_keys(params, spec_off):
    _, _, tparams = params
    eng = _port(tparams)
    eng.generate([PROMPTS[3]], 4)
    assert 'spec_steps' not in eng.metrics()
    eng.set_spec_k(3)
    eng._drafter = _oracle(spec_off, wrong=())
    req = eng.generate([PROMPTS[2]], NEW)[0]
    assert req.output_tokens == spec_off[2]
    m = eng.metrics()
    assert m['spec_k'] == 3 and m['spec_accepted_tokens'] >= 1
    assert req.spec_steps >= 1
    assert m['accepted_len_mean'] == pytest.approx(
        req.spec_emitted / req.spec_steps, abs=1e-3)
    eng.set_spec_k(0)
    assert eng.metrics()['spec_k'] == 0


def test_model_hands_the_wrappers_what_the_cuda_kernels_take(
        params, spec_off, monkeypatch):
    """On the CPU the wrappers take any layout; on CUDA tensors they
    refuse strided inputs and non-int32 tables before a launch. So hold
    the model to that contract here, through every decode, prefill and
    verify call of a speculating engine on int8 pages."""
    _, _, tparams = params
    seen = set()

    def checked(name, fn):
        def wrapper(q, k_pages, v_pages, *rest, **kw):
            index = [t for t in rest if isinstance(t, torch.Tensor)]
            for t in (q, k_pages, v_pages, *index, *kw.values()):
                assert t.is_contiguous(), name
            assert all(t.dtype == torch.int32 for t in index), name
            assert set(kw) == {'k_scales', 'v_scales'}, name
            seen.add(name)
            return fn(q, k_pages, v_pages, *rest, **kw)
        return wrapper

    for name in ('paged_decode_attention', 'paged_prefill_attention',
                 'paged_verify_attention'):
        monkeypatch.setattr(tpa, name, checked(name, getattr(tpa, name)))
    eng = _port(tparams, spec_k=4, kv_dtype='int8')
    eng._drafter = _oracle(spec_off)
    eng.generate(PROMPTS, NEW)
    assert seen == {'paged_decode_attention', 'paged_prefill_attention',
                    'paged_verify_attention'}


@pytest.mark.parametrize('kv_dtype', ['bfloat16', 'int8'])
def test_paged_verify_step_matches_jax(params, kv_dtype):
    """Prefill three slots (5, 33 and 50 tokens: page and chunk edges),
    then one verify step of R 5 over all four slots (slot 3 inactive,
    its run into the sink): logits of the active slots at 1e-4, lengths
    not advanced."""
    cfg, jparams, tparams = params
    tcfg = tllama.LlamaConfig.tiny()
    rng = np.random.default_rng(7)
    slots, page, chunk, maxp, R = 4, 16, 32, 8, 5
    n_pages = 3 * maxp + 1
    tables = np.zeros((slots, maxp), np.int32)
    tables[:3] = rng.permutation(np.arange(1, n_pages)).reshape(3, maxp)
    L, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    jdt, tdt = ((jnp.int8, torch.int8) if kv_dtype == 'int8'
                else (jnp.bfloat16, torch.bfloat16))
    jkv = jpc.init_paged_cache(L, slots, n_pages, page, hkv, hd, dtype=jdt)
    tkv = tpc.init_paged_cache(L, slots, n_pages, page, hkv, hd, dtype=tdt)
    rope = tmodel.rope_tables(tcfg)
    jprefill = jax.jit(functools.partial(jmodel.paged_prefill_chunk, cfg))
    for slot, n in enumerate((5, 33, 50)):
        toks = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        for off in range(0, n, chunk):
            tl = min(chunk, n - off)
            padded = np.zeros((chunk,), np.int32)
            padded[:tl] = toks[off:off + tl]
            jkv, _ = jprefill(jparams, jkv, jnp.int32(slot),
                              jnp.asarray(tables[slot]), jnp.asarray(padded),
                              jnp.int32(off), jnp.int32(tl))
            tkv, _ = tmodel.paged_prefill_chunk(
                tcfg, tparams, tkv, slot, torch.from_numpy(tables[slot]),
                torch.from_numpy(padded), off, tl, rope)
    tokens = rng.integers(0, cfg.vocab_size, (slots, R)).astype(np.int32)
    jlogits, jkv = jmodel.paged_verify_step(
        cfg, jparams, jkv, jnp.asarray(tables), jnp.asarray(tokens))
    tlogits, tkv = tmodel.paged_verify_step(
        tcfg, tparams, tkv, torch.from_numpy(tables),
        torch.from_numpy(tokens), rope)
    assert tlogits.shape == (slots, R, cfg.vocab_size)
    np.testing.assert_allclose(tlogits.numpy()[:3], np.asarray(jlogits)[:3],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tkv.lengths.numpy(), [5, 33, 50, 0])
    np.testing.assert_array_equal(np.asarray(jkv.lengths), [5, 33, 50, 0])
