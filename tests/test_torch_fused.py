"""The port's fused mixed steps and its device-scalar prefill against the
JAX package, on the CPU.

- ``model.paged_mixed_step`` (one chunk of one slot and one decode step
  of every slot, layer by layer) gives the JAX ``paged_mixed_step``'s
  logits, chunk and decode, within ``test_torch_model.py``'s fp32
  tolerance, and exactly the port's own standalone chunk followed by its
  standalone decode step.
- Prefill with the slot, offset and true length as 0-d device tensors
  (what the engine's chunk programs pass) equals prefill with host
  integers exactly: the attention wrapper and the whole chunk.
- The engine with ``fused_prefill`` on gives the live JAX paged engine's
  greedy tokens with fused_prefill on, token for token, over the
  reference's preempting workload (the pipeline gate's: mixed short and
  multi-chunk prompts, a pool of 12 usable pages), at depth 1 and depth 0,
  with speculation off and on (an oracle drafter); and the port's fused
  off gives the same tokens. Fused on dispatches mixed steps and never
  stalls the decode batch on a standalone chunk; fused off does.
  ``compiled_counts()`` holds at most one mixed program per (chunk
  bucket, samples) and shows none with fused off.
"""
import dataclasses
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

pytestmark = pytest.mark.jax

TOL = 1e-4          # test_torch_model.py's fp32 tolerance
PAGE, CHUNK, MAXP = 16, 32, 8
PROMPTS = [[11] * 60, [23] * 60, [37] * 60, [5, 17, 101, 7],
           [9, 8, 7, 6, 5]]
NEW = 6
KW = dict(n_slots=3, max_seq_len=128, prefill_buckets=(16, 32),
          prefill_chunk=32, page_size=16, n_pages=13)


class OracleDrafter:
    """Proposes each prompt's known continuation, off by one at draft
    index 1 for every other prompt (accepted and rejected runs)."""

    def __init__(self, prompts, outputs):
        self.known = [(list(p), list(o)) for p, o in zip(prompts, outputs)]

    def propose(self, context, k, memo=None):
        del memo
        for n, (prompt, out) in enumerate(self.known):
            if list(context[:len(prompt)]) == prompt:
                draft = out[len(context) - len(prompt):][:k]
                if n % 2 and len(draft) > 1:
                    draft[1] = (draft[1] + 1) % 256
                return draft
        return []


@pytest.fixture(scope='module')
def params():
    cfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, jparams, tllama.params_from_jax(
        jax.tree.map(np.asarray, jparams))


def _outputs(reqs):
    return [r.output_tokens for r in reqs]


def _port(tparams, **kw):
    return tengine.InferenceEngine(
        tllama.LlamaConfig.tiny(), tparams,
        tengine.EngineConfig(**{**KW, 'paged': True, **kw}), device='cpu')


@pytest.fixture(scope='module')
def jax_fused(params):
    cfg, jparams, _ = params
    je = jengine.InferenceEngine(
        cfg, jparams, jengine.EngineConfig(paged=True, pipeline_depth=1,
                                           fused_prefill=True, **KW))
    return _outputs(je.generate(PROMPTS, max_new_tokens=NEW)), je.metrics()


@pytest.fixture(scope='module')
def port_fused(params):
    """One fused engine at depth 1, then depth 0 after
    set_pipeline_depth; and a fused-off engine at depth 1."""
    _, _, tparams = params
    eng = _port(tparams, fused_prefill=True)
    out1 = _outputs(eng.generate(PROMPTS, max_new_tokens=NEW))
    m1 = eng.metrics()
    eng.set_pipeline_depth(0)
    out0 = _outputs(eng.generate(PROMPTS, max_new_tokens=NEW))
    off = _port(tparams)
    out_off = _outputs(off.generate(PROMPTS, max_new_tokens=NEW))
    return eng, out1, m1, out0, off, out_off


def test_fused_equals_jax_fused_and_unfused_under_preemption(
        port_fused, jax_fused):
    eng, out1, m1, out0, off, out_off = port_fused
    jout, jm = jax_fused
    assert out1 == jout
    assert out0 == out1
    assert out_off == out1
    assert m1['preemptions'] >= 1, 'the workload never preempted'
    assert m1['fused_steps'] > 0 and m1['decode_stall_steps'] == 0
    assert m1['fused_steps'] == jm['fused_steps']
    assert m1['decode_stall_steps'] == jm['decode_stall_steps']
    assert m1['prefill_tokens_per_step'] > 0
    assert eng.allocator.free_pages == eng.allocator.n_pages - 1
    assert off.metrics()['decode_stall_steps'] > 0
    assert off.metrics()['fused_steps'] == 0


def test_compiled_counts_one_mixed_program_per_bucket(port_fused):
    eng, _, _, _, off, _ = port_fused
    counts = eng.compiled_counts()
    buckets = {k[1] for k in eng._programs if k[0] == 'mixed'}
    assert 0 < counts['mixed'] <= len(eng._buckets)
    assert counts['mixed'] == len(buckets)
    assert counts['decode'] == 1
    assert 'mixed' not in off.compiled_counts()


@pytest.mark.parametrize('depth', [1, 0])
def test_fused_spec_on_equals_spec_off(params, port_fused, depth):
    """Speculation on (drafts accepted and rejected) with fused steps:
    a chunk riding a step stands speculation down for it; the tokens stay
    speculation-off's."""
    _, _, tparams = params
    off = port_fused[1]
    eng = _port(tparams, fused_prefill=True, spec_k=3,
                pipeline_depth=depth)
    eng._drafter = OracleDrafter(PROMPTS, off)
    assert _outputs(eng.generate(PROMPTS, max_new_tokens=NEW)) == off
    m = eng.metrics()
    assert m['spec_accepted_tokens'] >= 1 and m['fused_steps'] > 0
    assert eng.allocator.free_pages == eng.allocator.n_pages - 1
    assert eng.compiled_counts()['verify'] == 1


def test_sampled_fused_run_completes(params):
    _, _, tparams = params
    eng = _port(tparams, fused_prefill=True)
    outs = _outputs(eng.generate(PROMPTS, max_new_tokens=NEW,
                                 temperature=1.0))
    assert all(len(o) == NEW for o in outs)
    # Sampled mixed programs beside none greedy: at most one per bucket.
    keys = [k for k in eng._programs if k[0] == 'mixed']
    assert keys and all(k[2] for k in keys)
    assert len(keys) <= len(eng._buckets)


def _clone(pkv):
    return dataclasses.replace(pkv, **{
        f.name: getattr(pkv, f.name).clone()
        for f in dataclasses.fields(pkv)
        if isinstance(getattr(pkv, f.name), torch.Tensor)})


def _tensors(pkv):
    return [getattr(pkv, f.name) for f in dataclasses.fields(pkv)
            if isinstance(getattr(pkv, f.name), torch.Tensor)]


def _paged_setup(jcfg, seed):
    rng = np.random.default_rng(seed)
    slots, n_pages = 4, 3 * MAXP + 1
    tables = np.zeros((slots, MAXP), np.int32)
    tables[:3] = rng.permutation(np.arange(1, n_pages)).reshape(3, MAXP)
    L, hkv, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    jkv = jpc.init_paged_cache(L, slots, n_pages, PAGE, hkv, hd,
                               dtype=jnp.float32)
    tkv = tpc.init_paged_cache(L, slots, n_pages, PAGE, hkv, hd,
                               dtype=torch.float32)
    return rng, tables, jkv, tkv


def test_paged_mixed_step_matches_jax(params):
    """Slots 0 and 1 decode while slot 2 prefills its second chunk (a
    page-aligned, not chunk-aligned offset) in the same mixed step; slot
    3 rides inactive. Both halves' logits match the JAX mixed step, and
    equal the port's standalone chunk then standalone decode exactly."""
    jcfg, jparams, tparams = params
    tcfg = tllama.LlamaConfig.tiny()
    rope = tmodel.rope_tables(tcfg)
    rng, tables, jkv, tkv = _paged_setup(jcfg, 11)
    jprefill = jax.jit(functools.partial(jmodel.paged_prefill_chunk, jcfg))
    prompts = {0: 20, 1: 7, 2: 16}
    last = np.zeros((4,), np.int32)
    for slot, n in prompts.items():
        toks = rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
        bucket = PAGE if n <= PAGE else CHUNK
        padded = np.zeros((bucket,), np.int32)
        padded[:n] = toks
        jkv, jl = jprefill(jparams, jkv, jnp.int32(slot),
                           jnp.asarray(tables[slot]), jnp.asarray(padded),
                           jnp.int32(0), jnp.int32(n))
        tkv, tl = tmodel.paged_prefill_chunk(
            tcfg, tparams, tkv, slot, torch.from_numpy(tables[slot]),
            torch.from_numpy(padded), 0, n, rope)
        last[slot] = int(np.argmax(np.asarray(jl)))
    chunk = np.zeros((CHUNK,), np.int32)
    chunk[:21] = rng.integers(0, jcfg.vocab_size, 21)
    active = np.array([True, True, False, False])
    jc, jd, jkv2 = jax.jit(functools.partial(jmodel.paged_mixed_step,
                                             jcfg))(
        jparams, jkv, jnp.int32(2), jnp.asarray(tables[2]),
        jnp.asarray(chunk), jnp.int32(16), jnp.int32(21),
        jnp.asarray(tables), jnp.asarray(last), jnp.asarray(active))
    twin = _clone(tkv)
    tc, td, tkv = tmodel.paged_mixed_step(
        tcfg, tparams, tkv, torch.tensor(2, dtype=torch.int32),
        torch.from_numpy(tables[2]), torch.from_numpy(chunk),
        torch.tensor(16, dtype=torch.int32),
        torch.tensor(21, dtype=torch.int32), torch.from_numpy(tables),
        torch.from_numpy(last), rope, torch.from_numpy(active))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(td.numpy()[:2], np.asarray(jd)[:2],
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tkv.lengths.numpy(),
                                  np.asarray(jkv2.lengths))
    # The same two halves run standalone, in the unfused order.
    twin, sc = tmodel.paged_prefill_chunk(
        tcfg, tparams, twin, 2, torch.from_numpy(tables[2]),
        torch.from_numpy(chunk), 16, 21, rope)
    sd, twin = tmodel.paged_decode_step(
        tcfg, tparams, twin, torch.from_numpy(tables),
        torch.from_numpy(last), rope, torch.from_numpy(active))
    assert torch.equal(sc, tc) and torch.equal(sd, td)
    assert torch.equal(twin.lengths, tkv.lengths)
    assert torch.equal(twin.k_pages, tkv.k_pages)
    assert torch.equal(twin.v_pages, tkv.v_pages)


@pytest.mark.parametrize('kv_dtype', [torch.float32, torch.int8])
def test_device_scalar_prefill_equals_host_scalar(params, kv_dtype):
    """The whole chunk and the attention wrapper, with slot, offset and
    true length as 0-d tensors, against host integers: identical logits,
    pages, scales and lengths (fp32 activations, fp32 or int8 pages)."""
    _, _, tparams = params
    tcfg = tllama.LlamaConfig.tiny()
    rope = tmodel.rope_tables(tcfg)
    rng = np.random.default_rng(3)
    n_pages = MAXP + 1
    row = torch.from_numpy(rng.permutation(np.arange(1, n_pages))
                           .astype(np.int32))
    caches = [tpc.init_paged_cache(tcfg.n_layers, 2, n_pages, PAGE,
                                   tcfg.n_kv_heads, tcfg.head_dim,
                                   dtype=kv_dtype) for _ in range(2)]
    toks = rng.integers(0, tcfg.vocab_size, 70).astype(np.int32)
    off = 0
    while off < len(toks):
        tl = min(CHUNK, len(toks) - off)
        padded = np.zeros((CHUNK,), np.int32)
        padded[:tl] = toks[off:off + tl]
        caches[0], host = tmodel.paged_prefill_chunk(
            tcfg, tparams, caches[0], 1, row, torch.from_numpy(padded), off,
            tl, rope)
        caches[1], dev = tmodel.paged_prefill_chunk(
            tcfg, tparams, caches[1], torch.tensor(1, dtype=torch.int32),
            row, torch.from_numpy(padded),
            torch.tensor(off, dtype=torch.int32),
            torch.tensor(tl, dtype=torch.int32), rope)
        assert torch.equal(host, dev), off
        off += tl
    for a, b in zip(_tensors(caches[0]), _tensors(caches[1])):
        assert torch.equal(a, b)
    q = torch.from_numpy(rng.normal(size=(CHUNK, tcfg.n_kv_heads,
                                          tcfg.n_heads // tcfg.n_kv_heads,
                                          tcfg.head_dim)).astype(np.float32))
    kv = tmodel._layer_pages(caches[0], 1)
    scales = tmodel._scales(kv)
    for offset, tl in ((0, 5), (32, 32), (48, 17)):
        host = tpa.paged_prefill_attention(
            q, kv['k_pages'], kv['v_pages'], row, offset, tl, **scales)
        dev = tpa.paged_prefill_attention(
            q, kv['k_pages'], kv['v_pages'], row,
            torch.tensor(offset, dtype=torch.int32),
            torch.tensor(tl, dtype=torch.int32), **scales)
        assert torch.equal(host, dev), (offset, tl)
    with pytest.raises(TypeError, match='both'):
        tpa.paged_prefill_attention(q, kv['k_pages'], kv['v_pages'], row,
                                    torch.tensor(0, dtype=torch.int32), 5)


def test_reserved_prefill_workspace_covers_every_chunk(monkeypatch):
    """A chunk graph keeps the prefill kernel's workspace pointer: the
    reservation covers the device-scalar entry's widest launch (the
    whole table row at the largest chunk), every smaller chunk and every
    host-scalar launch then gets the same buffers, and growth past a
    captured reservation raises."""
    monkeypatch.setattr(tpa, '_kernel', lambda symbol: lambda:
                        tpa.PREFILL_PAGES_PER_SPLIT)
    monkeypatch.setattr(tpa, '_split_buffers', {})
    monkeypatch.setattr(tpa, '_captured_buffers', set())
    tpa._checked_pages_per_split.cache_clear()
    try:
        hkv, hd, maxp, group, cap = 2, 16, 40, 4, 64
        tpa.reserve_prefill_scratch('cpu', hkv, cap * group, hd, maxp)
        q = torch.zeros(1)
        ws, counters = tpa._prefill_scratch(q, hkv, cap * group, hd, maxp)
        for rows in (16 * group, 32 * group):
            for live in (1, 16, 17, maxp):
                got = tpa._prefill_scratch(q, hkv, rows, hd, live)
                assert got[0] is ws and got[1] is counters
        tpa._captured_buffers.add(('prefill', torch.device('cpu')))
        with pytest.raises(RuntimeError, match='CUDA graph holds'):
            tpa._prefill_scratch(q, hkv, 2 * cap * group, hd, maxp)
    finally:
        tpa._checked_pages_per_split.cache_clear()
