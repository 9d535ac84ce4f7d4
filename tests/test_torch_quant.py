"""The port's int8 weight path (``skypilot_tpu_torch/ops/quant.py``)
against the JAX package's, on the CPU.

- ``quantize_weight``, ``quantize_embed`` and ``quantize_params`` give the
  JAX functions' int8 bytes and bf16 scales bit for bit, from fp32 and
  bf16 sources, stacked and not, with exact .5 ties (both round half to
  even) and all-zero columns (the 1e-8 scale floor).
- ``qdot`` (its plain version, what the CPU runs) and ``qembed`` against
  the JAX ones at fp32 and bf16; ``qembed`` returns bf16 rows whatever
  the model's dtype, as the reference's does.
- the server's random int8 weights (``random_params(quantize=True)``)
  are ``quantize_params(init_params)`` on the same seed, tree, shapes,
  dtypes and bits, with the JAX ``init_params_quantized`` tree's
  structure (the reference's structure check), and the engine with ``quantize=True`` halves the
  param bytes and keeps the first greedy token of the fp32 model.
- ``params_from_jax`` carries a quantized JAX tree across, and
  ``layer_params`` slices its leaves.
- The paged engine with ``quantize=True`` on the tiny config against the
  JAX paged engine with ``quantize=True`` on the same carried params,
  over the preempting workload of ``test_torch_fused.py``: a chunk's
  logits within the bf16 tolerance below, the greedy tokens equal except
  where the JAX logits' own top-2 margin is within it; and within the
  port, bit for bit, depth 0 == depth 1, speculation on == off and fused
  on == off.
- On the CUDA path, a wrong dtype or layout raises ValueError before
  anything launches, and mixed devices raise (no silent fallback).
"""
import functools
import pathlib
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from skypilot_tpu.infer import engine as jengine
from skypilot_tpu.infer import model as jmodel
from skypilot_tpu.infer import paged_cache as jpc
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.ops import quant as jquant
from skypilot_tpu_torch.infer import engine as tengine
from skypilot_tpu_torch.infer import model as tmodel
from skypilot_tpu_torch.infer import paged_cache as tpc
from skypilot_tpu_torch.infer import server as tserver
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.ops import quant as tquant

jax.config.update('jax_default_matmul_precision', 'highest')

pytestmark = pytest.mark.jax

PROMPTS = [[11] * 60, [23] * 60, [37] * 60, [5, 17, 101, 7],
           [9, 8, 7, 6, 5]]
NEW = 6
KW = dict(n_slots=3, max_seq_len=128, prefill_buckets=(16, 32),
          prefill_chunk=32, page_size=16, n_pages=13)
# The quantized tiny model runs its residual stream in bf16 (qembed's
# rows are bf16). The port rounds every op to bf16 as the reference's
# formulas read; under jit the JAX reference keeps bf16 intermediates of
# a fusion in fp32 (XLA's excess precision on the CPU), so logits of
# magnitude ~2 differ by up to a few bf16 steps there (2^-6 = 0.0156 at
# 2): within BF16_LOGIT_ATOL, and a greedy token may part from JAX's
# only where JAX's own top-2 logits lie that close.
BF16_LOGIT_ATOL = 0.05
CSRC = (pathlib.Path(__file__).resolve().parents[1]
        / 'skypilot_tpu_torch/ops/csrc/qdot_int8.cu')


def _np(t):
    """A torch tensor as numpy, bf16 as fp32 (exact)."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == 'bfloat16' else a


def _weights(rng, shape):
    """Normal draws with exact .5 ties after the scale (a column whose
    absmax is 127 has scale 1.0) and an all-zero column."""
    w = rng.normal(size=shape).astype(np.float32)
    w[..., 0, 1] = 127.0
    w[..., 1:6, 1] = [2.5, -3.5, 0.5, -0.5, 1.5]
    w[..., :, 2] = 0.0
    return w


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', [(64, 48), (3, 64, 48)])
def test_quantize_weight_bitwise_jax(dtype, shape):
    w = _weights(np.random.default_rng(0), shape)
    jw = jquant.quantize_weight(jnp.asarray(w).astype(dtype))
    tw = tquant.quantize_weight(
        torch.from_numpy(w).to(getattr(torch, dtype)))
    assert tw.q.dtype == torch.int8 and tw.scale.dtype == torch.bfloat16
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    np.testing.assert_array_equal(_np(tw.scale), _jnp(jw.scale))
    # The ties rounded half to even; the zero column has the floor.
    col = tw.q[..., 1:6, 1].reshape(-1, 5)[0].tolist()
    assert col == [2, -4, 0, 0, 2]
    assert (tw.q[..., :, 2] == 0).all()
    assert torch.equal(tw.scale[..., 2], torch.full_like(
        tw.scale[..., 2], 1e-8))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_quantize_embed_bitwise_jax(dtype):
    w = np.swapaxes(_weights(np.random.default_rng(1), (32, 40)), 0, 1)
    jw = jquant.quantize_embed(jnp.asarray(w).astype(dtype))
    tw = tquant.quantize_embed(
        torch.from_numpy(np.ascontiguousarray(w)).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    np.testing.assert_array_equal(_np(tw.scale), _jnp(jw.scale))


@pytest.fixture(scope='module')
def params():
    cfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(0))
    jq = jquant.quantize_params(jparams)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams))
    return cfg, jparams, tparams, jq, tllama.params_from_jax(
        jax.tree.map(np.asarray, jq))


def _leaves(tree, prefix=''):
    """(path, tensor) pairs in sorted key order (JAX's tree order), a
    QuantArray as its q and scale."""
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + '/')
        elif isinstance(v, tquant.QuantArray):
            yield prefix + k + '.q', v.q
            yield prefix + k + '.scale', v.scale
        else:
            yield prefix + k, v


def test_quantize_params_bitwise_jax_and_carried_across(params):
    """The port's quantize_params of the carried fp32 tree is bitwise the
    JAX quantize_params carried across (params_from_jax rebuilds its
    QuantArray nodes), leaf by leaf; layer_params slices them."""
    _, _, tparams, _, carried = params
    mine = tquant.quantize_params(tparams)
    got, want = list(_leaves(mine)), list(_leaves(carried))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    assert isinstance(carried['lm_head'], tquant.QuantArray)
    layer = tllama.layer_params(carried, 1)
    assert torch.equal(layer['wq'].q, carried['layers']['wq'].q[1])
    assert torch.equal(layer['wq'].scale, carried['layers']['wq'].scale[1])
    assert layer['wq'].shape == carried['layers']['wq'].shape[1:]
    assert layer['wq'].dtype == torch.bfloat16
    assert torch.equal(layer['attn_norm'],
                       carried['layers']['attn_norm'][1])
    # The source tree is left as it was.
    assert not tquant.is_quantized(tparams)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_qdot_and_qembed_match_jax(dtype):
    """qdot: fp32 within summation order (1e-5); bf16 within one bf16
    step (2^-7 relative: both round the product to bf16, then the scaled
    product, from sums taken in other orders). qembed: the same gather
    and product, exact, in bf16 whatever the table's source dtype."""
    rng = np.random.default_rng(2)
    w = (rng.normal(size=(64, 96)) * 64 ** -0.5).astype(np.float32)
    x = rng.normal(size=(5, 7, 64)).astype(np.float32)
    jw = jquant.quantize_weight(jnp.asarray(w))
    tw = tquant.QuantArray(q=torch.from_numpy(np.asarray(jw.q).copy()),
                           scale=torch.from_numpy(
                               np.asarray(jw.scale).view(np.int16).copy()
                           ).view(torch.bfloat16))
    tdt = getattr(torch, dtype)
    jy = jquant.qdot(jnp.asarray(x).astype(dtype), jw)
    ty = tquant.qdot(torch.from_numpy(x).to(tdt), tw)
    assert ty.dtype == tdt and ty.shape == (5, 7, 96)
    rtol = 1e-5 if dtype == 'float32' else 2.0 ** -7
    np.testing.assert_allclose(_np(ty), _jnp(jy), rtol=rtol, atol=1e-5)
    assert torch.equal(ty, tquant.qdot_reference(
        torch.from_numpy(x).to(tdt), tw))
    table = rng.normal(size=(50, 64)).astype(np.float32)
    je = jquant.quantize_embed(jnp.asarray(table).astype(dtype))
    te = tquant.quantize_embed(torch.from_numpy(table).to(tdt))
    tokens = rng.integers(0, 50, size=(3, 9))
    jrows = jquant.qembed(je, jnp.asarray(tokens))
    trows = tquant.qembed(te, torch.from_numpy(tokens))
    assert trows.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(trows), _jnp(jrows))
    plain = torch.from_numpy(table)
    assert torch.equal(tquant.qembed(plain, torch.from_numpy(tokens)),
                       plain[torch.from_numpy(tokens)])


def test_quantized_init_matches_structure(params):
    """The server's random int8 weights are quantize_params(init_params)
    exactly: tree, shapes, dtypes, and (the same seed) bits; the JAX
    init_params_quantized tree has the same structure."""
    tcfg = tllama.LlamaConfig.tiny()
    direct = tserver.random_params(tcfg, 1, 'cpu', quantize=True)
    via = tquant.quantize_params(tllama.init_params(
        tcfg, torch.Generator().manual_seed(1)))
    got, want = list(_leaves(direct)), list(_leaves(via))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert torch.equal(a, b), path
    assert tquant.is_quantized(direct)
    assert not tquant.is_quantized(params[2])
    # The JAX tree's structure, leaf for leaf.
    jdirect = jquant.init_params_quantized(jllama.LlamaConfig.tiny(),
                                           jax.random.PRNGKey(1))
    jleaves = jax.tree_util.tree_leaves(jdirect)
    assert [tuple(a.shape) for a in jleaves] == \
        [tuple(t.shape) for _, t in got]
    assert [np.dtype(a.dtype).name for a in jleaves] == \
        [str(t.dtype).split('.')[1] for _, t in got]


def test_quantized_engine_generates(params):
    """The reference's check: the int8 engine halves the param bytes and
    its first greedy token is the fp32 model's."""
    _, _, tparams, _, _ = params
    tcfg = tllama.LlamaConfig.tiny()
    eng = tengine.InferenceEngine(
        tcfg, tparams, tengine.EngineConfig(
            n_slots=2, max_seq_len=64, prefill_buckets=(16,),
            prefill_chunk=16, paged=True, page_size=16, quantize=True),
        device='cpu')
    assert tquant.is_quantized(eng.params)
    assert tquant.param_bytes(eng.params) < tquant.param_bytes(tparams) / 2
    prompt = [5, 17, 101, 7]
    [req] = eng.generate([prompt], max_new_tokens=4)
    plain = tengine.InferenceEngine(
        tcfg, tparams, tengine.EngineConfig(
            n_slots=2, max_seq_len=64, prefill_buckets=(16,),
            prefill_chunk=16, paged=True, page_size=16), device='cpu')
    [oracle] = plain.generate([prompt], max_new_tokens=4)
    assert req.output_tokens[0] == oracle.output_tokens[0]
    assert all(0 <= t < tcfg.vocab_size for t in req.output_tokens)


PAGE, MAXP, CHUNK = 16, 8, 128


@functools.lru_cache(maxsize=None)
def _jax_prefill(cfg):
    return jax.jit(functools.partial(jmodel.paged_prefill_chunk, cfg))


def _jax_chunk_logits(cfg, jq, tokens):
    """JAX's logits after ``tokens`` (one CHUNK-token prefill chunk on a
    fresh bf16 cache)."""
    jkv = jpc.init_paged_cache(cfg.n_layers, 1, MAXP + 1, PAGE,
                               cfg.n_kv_heads, cfg.head_dim,
                               dtype=jnp.bfloat16)
    padded = np.zeros((CHUNK,), np.int32)
    padded[:len(tokens)] = tokens
    _, logits = _jax_prefill(cfg)(
        jq, jkv, jnp.int32(0), jnp.arange(1, MAXP + 1, dtype=jnp.int32),
        jnp.asarray(padded), jnp.int32(0), jnp.int32(len(tokens)))
    return np.asarray(logits)


def test_quantized_chunk_logits_match_jax(params):
    """One quantized prefill chunk, JAX (jit) against the port, bf16
    pages: logits within BF16_LOGIT_ATOL."""
    cfg, _, _, jq, carried = params
    tcfg = tllama.LlamaConfig.tiny()
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, 50).astype(np.int32)
    tkv = tpc.init_paged_cache(tcfg.n_layers, 1, MAXP + 1, PAGE,
                               tcfg.n_kv_heads, tcfg.head_dim,
                               dtype=torch.bfloat16)
    padded = np.zeros((CHUNK,), np.int32)
    padded[:50] = tokens
    _, tl = tmodel.paged_prefill_chunk(
        tcfg, carried, tkv, 0,
        torch.arange(1, MAXP + 1, dtype=torch.int32),
        torch.from_numpy(padded), 0, 50, tmodel.rope_tables(tcfg))
    np.testing.assert_allclose(tl.numpy(), _jax_chunk_logits(cfg, jq, tokens),
                               rtol=0, atol=BF16_LOGIT_ATOL)


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


def _port(carried, **kw):
    return tengine.InferenceEngine(
        tllama.LlamaConfig.tiny(), carried,
        tengine.EngineConfig(**{**KW, 'paged': True, 'quantize': True,
                                **kw}),
        device='cpu')


def _outputs(reqs):
    return [r.output_tokens for r in reqs]


@pytest.fixture(scope='module')
def quantized_runs(params):
    cfg, jparams, _, jq, carried = params
    je = jengine.InferenceEngine(
        cfg, jparams, jengine.EngineConfig(paged=True, pipeline_depth=1,
                                           quantize=True, **KW))
    jout = _outputs(je.generate(PROMPTS, max_new_tokens=NEW))
    eng = _port(carried)
    out1 = _outputs(eng.generate(PROMPTS, max_new_tokens=NEW))
    return jout, out1, eng.metrics(), eng


def _jax_margin(cfg, jq, tokens):
    """JAX's top-2 logit margin after ``tokens``."""
    top = np.sort(_jax_chunk_logits(cfg, jq, tokens))[::-1]
    return float(top[0] - top[1])


def test_quantized_engine_greedy_matches_jax(params, quantized_runs):
    """The int8-weight paged engine against the JAX one (quantize=True,
    depth 1) over the preempting workload: every request's tokens equal,
    except that a request may part where JAX's own top-2 margin is within
    BF16_LOGIT_ATOL (then its later tokens follow another context)."""
    cfg, _, _, jq, _ = params
    jout, out1, m, eng = quantized_runs
    assert m['preemptions'] >= 1, 'the workload never preempted'
    assert eng.allocator.free_pages == eng.allocator.n_pages - 1
    parted = 0
    for prompt, a, b in zip(PROMPTS, out1, jout):
        if a == b:
            continue
        parted += 1
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        margin = _jax_margin(cfg, jq, list(prompt) + b[:i])
        assert margin <= BF16_LOGIT_ATOL, (prompt[:4], i, margin)
    assert parted < len(PROMPTS)


@pytest.mark.parametrize('variant', ['depth0', 'spec', 'fused',
                                     'fused_spec_depth0'])
def test_quantized_invariants_bitwise(params, quantized_runs, variant):
    """Within the port, with int8 weights: depth 0, speculation on (an
    oracle drafter) and fused mixed steps each give the depth-1 tokens
    exactly."""
    _, _, _, _, carried = params
    out1 = quantized_runs[1]
    kw = {'depth0': dict(pipeline_depth=0),
          'spec': dict(spec_k=3),
          'fused': dict(fused_prefill=True),
          'fused_spec_depth0': dict(fused_prefill=True, spec_k=3,
                                    pipeline_depth=0)}[variant]
    eng = _port(carried, **kw)
    if 'spec_k' in kw:
        eng._drafter = OracleDrafter(PROMPTS, out1)
    assert _outputs(eng.generate(PROMPTS, max_new_tokens=NEW)) == out1
    m = eng.metrics()
    if 'spec_k' in kw:
        assert m['spec_accepted_tokens'] >= 1
    if 'fused_prefill' in kw:
        assert m['fused_steps'] > 0
    assert eng.allocator.free_pages == eng.allocator.n_pages - 1


def test_cuda_path_refuses_what_the_kernel_does_not_take():
    """The kernel's wrapper checks before it launches: bf16 x only,
    contiguous operands, K a multiple of its tile and N of 16 (the
    source's own constants); mixed devices raise in qdot."""
    w = tquant.quantize_weight(torch.randn(64, 32))
    with pytest.raises(ValueError, match='bf16 x'):
        tquant._qdot_cuda(torch.randn(3, 64), w)
    with pytest.raises(ValueError, match='contiguous'):
        tquant._qdot_cuda(torch.randn(64, 3).to(torch.bfloat16).t(), w)
    odd = tquant.quantize_weight(torch.randn(48, 32))
    with pytest.raises(ValueError, match='multiple'):
        tquant._qdot_cuda(torch.randn(3, 48).to(torch.bfloat16), odd)
    with pytest.raises(ValueError, match='does not match'):
        tquant._qdot_cuda(torch.randn(3, 32).to(torch.bfloat16), w)
    meta = tquant.QuantArray(q=w.q.to('meta'), scale=w.scale.to('meta'))
    with pytest.raises(ValueError, match='all lie on the CPU'):
        tquant.qdot(torch.randn(3, 64), meta)
    src = CSRC.read_text()
    assert int(re.search(r'constexpr int kBK = (\d+);', src).group(1)) == \
        tquant.CUDA_K_MULTIPLE
    assert 'N % 16' in src and tquant.CUDA_N_MULTIPLE == 16
