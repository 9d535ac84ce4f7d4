"""int8 KV pages in the port vs the JAX reference.

- ``quantize_rows``: int8 values and fp32 scales byte-identical to JAX's
  on random rows, on exact .5 ties (round half to even) and on all-zero
  rows (scale 1.0).
- The int8 write paths (``write_chunk_pages``, ``append_token_pages``,
  ``append_run_pages`` with scales) leave page and scale tensors
  byte-identical to JAX's after the same writes.
- The int8 plain versions of decode, prefill and verify against JAX's
  int8 kernels run in interpret mode, on the same int8 pages and scales,
  at the shapes of tests/unit_tests/test_infer_paged.py:188: fp32, atol
  2e-5 (online vs one-pass softmax; values O(1)).
- The engine: the port's int8 engine gives the JAX int8 engine's greedy
  tokens, and the reference's int8 pins hold on the port: int8 and bf16
  greedy outputs agree for at least 12 steps, the one-step decode-logit
  delta is in (0, 0.25], and the page-bytes ratio is exactly
  2 hd / (hd + 4).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from skypilot_tpu.infer import engine as jengine
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.ops import paged_attention as jpa
from skypilot_tpu_torch.infer import engine as tengine
from skypilot_tpu_torch.infer import model as tmodel
from skypilot_tpu_torch.infer import paged_cache as tpc
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.ops import paged_attention as tpa

jax.config.update('jax_default_matmul_precision', 'highest')
torch.backends.cuda.matmul.allow_tf32 = False

ATOL = 2e-5
# The reference's int8 pins (tests/unit_tests/test_infer_fused.py).
MAX_LOGIT_DELTA = 0.25
DIVERGENCE_FLOOR = 12


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------- quantize_rows --------------------------------------------------
def _rows(kind):
    rng = np.random.default_rng(11)
    if kind == 'random':
        return (rng.normal(size=(3, 7, 64)) * 5.0).astype(np.float32)
    if kind == 'ties':
        # absmax 127 gives scale exactly 1.0, so each value is its own
        # x / scale: .5 ties round to the even neighbour.
        return np.asarray([[127.0, 2.5, -3.5, 0.5, 1.5, -0.5, 126.5, -127.0],
                           [-127.0, 4.5, -2.5, 5.5, 0.0, -1.5, 3.0, 6.5]],
                          np.float32)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    x[1] = 0.0
    x[3] = 0.0
    return x


@pytest.mark.parametrize('kind', ['random', 'ties', 'zero_rows'])
def test_quantize_rows_byte_identical_to_jax(kind):
    x = _rows(kind)
    jq, js = jpa.quantize_rows(jnp.asarray(x))
    tq, ts = tpa.quantize_rows(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    if kind == 'ties':
        np.testing.assert_array_equal(
            tq.numpy(), [[127, 2, -4, 0, 2, 0, 126, -127],
                         [-127, 4, -2, 6, 0, -2, 3, 6]])
    if kind == 'zero_rows':
        assert ts[1].item() == ts[3].item() == 1.0
        assert not tq[1].any() and not tq[3].any()


def test_int8_writes_byte_identical_to_jax():
    """Chunk writes at a page-aligned offset, token appends crossing a
    page with an inactive slot writing into the sink, then a run write
    past a table's coverage: int8 pages and fp32 scales identical."""
    rng = np.random.default_rng(4)
    hkv, hd, page, P, maxp, slots, C = 2, 8, 4, 12, 4, 3, 8
    j = [jnp.zeros((hkv, P, page, hd), jnp.int8)] * 2 + \
        [jnp.zeros((hkv, P, page), jnp.float32)] * 2
    t = [torch.zeros((hkv, P, page, hd), dtype=torch.int8) for _ in '12'] \
        + [torch.zeros((hkv, P, page)) for _ in '12']
    tables = np.zeros((slots, maxp), np.int32)
    tables[0] = [5, 2, 9, 7]
    tables[1] = [3, 11, 4, 0]     # slot 2 stays inactive: row of zeros

    def both(jfn, tfn, *args):
        nonlocal j
        jargs = [jnp.asarray(a) for a in args]
        kn, vn, *rest = jargs
        j = list(jfn(j[0], j[1], kn, vn, *rest, j[2], j[3]))
        out = tfn(t[0], t[1], *[_t(a) for a in args[:2]],
                  *[_t(a) if isinstance(a, np.ndarray) else a
                    for a in args[2:]], t[2], t[3])
        assert all(a is b for a, b in zip(out, t))   # updated in place

    for row, off in ((0, 0), (0, 4), (1, 4)):
        both(jpa.write_chunk_pages, tpa.write_chunk_pages,
             rng.normal(size=(C, hkv, hd)).astype(np.float32) * 3,
             rng.normal(size=(C, hkv, hd)).astype(np.float32),
             tables[row], np.int32(off))
    lengths = np.array([11, 12, 0], np.int32)
    for _ in range(3):   # slot 0: 11 -> 13 crosses into page 9
        both(jpa.append_token_pages, tpa.append_token_pages,
             rng.normal(size=(slots, hkv, hd)).astype(np.float32),
             rng.normal(size=(slots, hkv, hd)).astype(np.float32),
             tables, lengths.copy())
        lengths[:2] += 1
    # A run of 2: slot 0 from 13 within page 7; slot 1 from 15, whose
    # table column 3 is the sink and whose position 16 is past the
    # table's coverage (sink, row 0); the inactive slot 2 into sink rows
    # 1 and 2. No two lanes share a sink row, so the bytes are defined.
    both(jpa.append_run_pages, tpa.append_run_pages,
         rng.normal(size=(slots, 2, hkv, hd)).astype(np.float32),
         rng.normal(size=(slots, 2, hkv, hd)).astype(np.float32),
         tables, np.array([13, 15, 1], np.int32))
    for tt, jj in zip(t, j):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jj))
    assert t[2][:, 0].any()                 # the sink took garbage rows
    assert not t[2][:, 1].any()             # never-written pages: 0 scales


# ---------- int8 plain versions vs JAX's int8 kernels ---------------------
@pytest.mark.parametrize('which', ['decode', 'prefill', 'verify'])
def test_int8_plain_versions_match_jax_int8_kernels(which):
    rng = np.random.default_rng(7)
    slots, hkv, group, hd, R = 4, 2, 4, 64, 4
    page, P, maxp, C = 16, 32, 8, 32
    kf = rng.normal(size=(hkv, P, page, hd)).astype(np.float32)
    vf = rng.normal(size=(hkv, P, page, hd)).astype(np.float32)
    kp, ks = jpa.quantize_rows(jnp.asarray(kf))
    vp, vs = jpa.quantize_rows(jnp.asarray(vf))
    ids = rng.permutation(np.arange(1, P))[:slots * maxp - slots]
    tables = np.zeros((slots, maxp), np.int32)
    tables.flat[:len(ids)] = ids
    lengths = np.asarray([17, 64, 1, 100], np.int32)
    scales = dict(k_scales=ks, v_scales=vs)
    tscales = {k: _t(v) for k, v in scales.items()}
    tp = (_t(kp), _t(vp))
    if which == 'prefill':
        q = rng.normal(size=(C, hkv, group, hd)).astype(np.float32)
        ref = jpa.paged_prefill_attention(
            jnp.asarray(q), kp, vp, jnp.asarray(tables[0]), jnp.int32(16),
            jnp.int32(20), interpret=True, **scales)[:20]
        out = tpa.paged_prefill_attention(_t(q), *tp, _t(tables[0]), 16, 20,
                                          **tscales)[:20]
    else:
        shape = ((slots, hkv, group, hd) if which == 'decode'
                 else (slots, R, hkv, group, hd))
        q = rng.normal(size=shape).astype(np.float32)
        jfn = getattr(jpa, f'paged_{which}_attention')
        tfn = getattr(tpa, f'paged_{which}_attention')
        ref = jfn(jnp.asarray(q), kp, vp, jnp.asarray(tables),
                  jnp.asarray(lengths), interpret=True, **scales)
        out = tfn(_t(q), *tp, _t(tables), _t(lengths), **tscales)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_cuda_wrappers_refuse_int8_pages_without_scales():
    """On CUDA tensors int8 pages never reach a bf16 kernel, nor bf16
    pages the int8 one: the wrappers' check, which runs before any
    launch, refuses both (here given CPU tensors directly)."""
    q = torch.zeros((2, 2, 4, 64), dtype=torch.bfloat16)
    pages = torch.zeros((2, 4, 16, 64), dtype=torch.int8)
    tables = torch.zeros((2, 4), dtype=torch.int32)
    lengths = torch.ones((2,), dtype=torch.int32)
    with pytest.raises(TypeError, match='int8 pages need'):
        tpa._check_cuda('paged_decode_attention', q, pages, pages, None,
                        None, tables, lengths)
    scales = torch.zeros((2, 4, 16))
    with pytest.raises(TypeError, match='int8 pages with fp32 scales'):
        tpa._check_cuda('paged_decode_attention', q, pages.bfloat16(),
                        pages.bfloat16(), scales, scales, tables, lengths)
    assert tpa._check_cuda('paged_decode_attention', q, pages, pages,
                           scales, scales, tables, lengths)
    with pytest.raises(ValueError, match='both'):
        tpa._check_cuda('paged_decode_attention', q, pages, pages, scales,
                        None, tables, lengths)


# ---------- the engine ----------------------------------------------------
ENGINE_KW = dict(n_slots=3, max_seq_len=128, prefill_buckets=(16, 32),
                 prefill_chunk=32, page_size=16)
PROMPTS = [[11] * 60, [23] * 60, [37] * 60, [5, 17, 101, 7],
           [9, 8, 7, 6, 5]]


@pytest.fixture(scope='module')
def params():
    cfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, jparams, tllama.params_from_jax(
        jax.tree.map(np.asarray, jparams))


def _port(tparams, **kw):
    return tengine.InferenceEngine(
        tllama.LlamaConfig.tiny(), tparams,
        tengine.EngineConfig(**{**ENGINE_KW, 'paged': True, **kw}),
        device='cpu')


@pytest.fixture(scope='module')
def int8_outputs(params):
    _, _, tparams = params
    eng = _port(tparams, kv_dtype='int8')
    return eng, [r.output_tokens
                 for r in eng.generate(PROMPTS, max_new_tokens=14)]


@pytest.mark.jax
def test_int8_engine_matches_jax_int8_engine(params, int8_outputs):
    cfg, jparams, _ = params
    je = jengine.InferenceEngine(
        cfg, jparams, jengine.EngineConfig(paged=True, pipeline_depth=0,
                                           kv_dtype='int8', **ENGINE_KW))
    jout = [r.output_tokens for r in je.generate(PROMPTS, max_new_tokens=14)]
    eng, tout = int8_outputs
    assert tout == jout
    assert eng.metrics()['kv_dtype'] == je.metrics()['kv_dtype'] == 'int8'
    assert eng.metrics()['kv_page_bytes'] == je.metrics()['kv_page_bytes']


def test_int8_greedy_divergence_floor(params, int8_outputs):
    _, _, tparams = params
    bf16 = [r.output_tokens
            for r in _port(tparams).generate(PROMPTS, max_new_tokens=14)]
    for a, b in zip(bf16, int8_outputs[1]):
        agree = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
        assert agree >= DIVERGENCE_FLOOR, (a, b)


def test_int8_decode_logit_delta_pinned(params):
    """Prefill one prompt into a bf16 and an int8 cache, decode one
    step: the logits differ (the int8 path ran) by at most the pin."""
    _, _, tparams = params
    cfg = tllama.LlamaConfig.tiny()
    page, n_pages, slots, maxp = 16, 9, 2, 6
    prompt = torch.tensor([7, 3, 11, 3] * 4, dtype=torch.int32)
    tables = torch.zeros((slots, maxp), dtype=torch.int32)
    tables[0, :2] = torch.tensor([1, 2])
    rope = tmodel.rope_tables(cfg)
    logits = {}
    for dt in (torch.bfloat16, torch.int8):
        cache = tpc.init_paged_cache(cfg.n_layers, slots, n_pages, page,
                                     cfg.n_kv_heads, cfg.head_dim, dtype=dt)
        cache, _ = tmodel.paged_prefill_chunk(cfg, tparams, cache, 0,
                                              tables[0], prompt, 0, 16, rope)
        step, _ = tmodel.paged_decode_step(
            cfg, tparams, cache, tables, torch.tensor([5, 0],
                                                      dtype=torch.int32),
            rope, torch.tensor([True, False]))
        logits[dt] = step[0]
    delta = (logits[torch.bfloat16] - logits[torch.int8]).abs().max().item()
    assert 0.0 < delta <= MAX_LOGIT_DELTA, delta


def test_int8_page_bytes_ratio(params, int8_outputs):
    _, _, tparams = params
    hd = tllama.LlamaConfig.tiny().head_dim
    bf16 = _port(tparams).metrics()['kv_page_bytes']
    ratio = bf16 / int8_outputs[0].metrics()['kv_page_bytes']
    assert ratio == pytest.approx(2 * hd / (hd + 4))
    with pytest.raises(ValueError, match='kv_dtype'):
        _port(tparams, kv_dtype='fp8')
