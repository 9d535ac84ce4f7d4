"""The port's paged attention vs the JAX reference.

- Both plain versions against the JAX native Pallas kernels run in
  interpret mode (as tests/unit_tests/test_infer_paged.py runs them on the
  CPU) and against the JAX references: fp32, atol 1e-5 (online vs
  one-pass softmax and other summation orders; the values are O(1)).
- The cache writes leave page tensors byte-identical to JAX after the
  same write sequence, inactive slots writing into sink page 0 included.
- On CPU tensors the wrappers run the plain version and launch nothing.

The CUDA kernels themselves are held to these plain versions on the card
by ``chip_smoke.py``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from skypilot_tpu.ops import paged_attention as jpa
from skypilot_tpu_torch.ops import paged_attention as tpa

jax.config.update('jax_default_matmul_precision', 'highest')
torch.backends.cuda.matmul.allow_tf32 = False

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _pages(rng, hkv, P, page, hd):
    k = rng.normal(size=(hkv, P, page, hd)).astype(np.float32)
    v = rng.normal(size=(hkv, P, page, hd)).astype(np.float32)
    return k, v


def _decode_inputs(seed=0):
    """group > 1; lengths of 1, exactly a page, a page + 1 and several
    pages; non-contiguous page ids in the tables."""
    rng = np.random.default_rng(seed)
    slots, hkv, group, hd = 4, 2, 4, 32
    page, P, maxp = 16, 40, 8
    q = rng.normal(size=(slots, hkv, group, hd)).astype(np.float32)
    k, v = _pages(rng, hkv, P, page, hd)
    ids = rng.permutation(np.arange(1, P))[:slots * maxp - slots]
    tables = np.zeros((slots, maxp), np.int32)
    tables.flat[:len(ids)] = ids
    lengths = np.array([1, 16, 17, 100], np.int32)
    return q, k, v, tables, lengths


@pytest.mark.parametrize('against', ['interpret_kernel', 'jax_reference'])
def test_decode_reference_matches_jax(against):
    q, k, v, tables, lengths = _decode_inputs()
    args = [jnp.asarray(a) for a in (q, k, v, tables, lengths)]
    if against == 'interpret_kernel':
        ref = jpa.paged_decode_attention(*args, interpret=True,
                                         impl='native')
    else:
        ref = jpa.paged_decode_attention_reference(*args)
    out = tpa.paged_decode_attention_reference(
        *[_t(a) for a in (q, k, v, tables, lengths)])
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


# (offset, true_len): from zero; page-aligned but not C-aligned
# (C = 32, page 16) with true_len < C; a single valid row.
PREFILL_CASES = [(0, 32), (48, 20), (16, 1), (80, 32)]


@pytest.mark.parametrize('against', ['interpret_kernel', 'jax_reference'])
@pytest.mark.parametrize('offset,true_len', PREFILL_CASES)
def test_prefill_reference_matches_jax(against, offset, true_len):
    rng = np.random.default_rng(1)
    hkv, group, hd = 2, 4, 32
    page, P, maxp, C = 16, 32, 8, 32
    q = rng.normal(size=(C, hkv, group, hd)).astype(np.float32)
    k, v = _pages(rng, hkv, P, page, hd)
    row = rng.permutation(np.arange(1, P))[:maxp].astype(np.int32)
    jargs = [jnp.asarray(a) for a in (q, k, v, row)]
    if against == 'interpret_kernel':
        ref = jpa.paged_prefill_attention(
            *jargs, jnp.int32(offset), jnp.int32(true_len),
            interpret=True)
    else:
        ref = jpa.paged_prefill_attention_reference(*jargs, offset,
                                                    true_len)
    out = tpa.paged_prefill_attention_reference(
        *[_t(a) for a in (q, k, v, row)], offset, true_len)
    # Rows past true_len are pad garbage by contract.
    np.testing.assert_allclose(out.numpy()[:true_len],
                               np.asarray(ref)[:true_len], atol=ATOL,
                               rtol=0)


def test_cpu_wrappers_run_the_plain_version_and_launch_nothing():
    tpa.reset_launches()
    q, k, v, tables, lengths = [_t(a) for a in _decode_inputs(2)]
    out = tpa.paged_decode_attention(q, k, v, tables, lengths)
    ref = tpa.paged_decode_attention_reference(q, k, v, tables, lengths)
    assert torch.equal(out, ref)
    qp = q[:2].reshape(2, 2, 4, 32).repeat(16, 1, 1, 1)   # C = 32
    out = tpa.paged_prefill_attention(qp, k, v, tables[3], 16, 20)
    ref = tpa.paged_prefill_attention_reference(qp, k, v, tables[3], 16,
                                                20)
    assert torch.equal(out, ref)
    assert tpa.launches == dict.fromkeys(
        ['paged_decode_attention', 'paged_prefill_attention',
         'paged_verify_attention', 'paged_decode_attention_int8',
         'paged_prefill_attention_int8', 'paged_verify_attention_int8'], 0)


def test_wrappers_refuse_mixed_devices():
    q, k, v, tables, lengths = [_t(a) for a in _decode_inputs(3)]
    with pytest.raises(ValueError):
        tpa.paged_decode_attention(q.to('meta'), k, v, tables, lengths)


@pytest.mark.parametrize('preset', ['llama3_8b', 'bench_350m', 'bench_1b'])
def test_cuda_kernels_take_every_preset_shape(preset):
    """The shapes the CUDA kernels take (each held against the plain
    version on the card by chip_smoke.py) cover the served presets at
    every page size the kernels take."""
    from skypilot_tpu_torch.models import llama
    cfg = getattr(llama.LlamaConfig, preset)()
    for page in tpa.CUDA_PAGE_SIZES:
        tpa.check_cuda_shape(cfg.head_dim, cfg.n_heads // cfg.n_kv_heads,
                             page)


@pytest.mark.parametrize('head_dim,group,page',
                         [(256, 4, 64), (128, 3, 64), (128, 4, 128),
                          (16, 2, 16)])
def test_cuda_kernels_refuse_unchecked_shapes(head_dim, group, page):
    with pytest.raises(ValueError, match='CUDA paged attention'):
        tpa.check_cuda_shape(head_dim, group, page)


def _bits(x):
    """bf16 tensor/array -> its raw 16-bit patterns."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def test_page_writes_byte_identical_to_jax():
    """The same sequence of chunk writes and token appends, on bf16
    pages, leaves identical bytes: chunk writes at a page-aligned offset
    that is not C-aligned, appends crossing a page boundary, and an
    inactive slot (zeroed table row) writing into sink page 0."""
    rng = np.random.default_rng(4)
    hkv, hd, page, P, maxp, slots, C = 2, 8, 4, 12, 4, 3, 8
    jk = jnp.zeros((hkv, P, page, hd), jnp.bfloat16)
    jv = jnp.zeros((hkv, P, page, hd), jnp.bfloat16)
    tk = torch.zeros((hkv, P, page, hd), dtype=torch.bfloat16)
    tv = torch.zeros((hkv, P, page, hd), dtype=torch.bfloat16)
    tables = np.zeros((slots, maxp), np.int32)
    tables[0] = [5, 2, 9, 7]
    tables[1] = [3, 11, 4, 0]     # slot 2 stays inactive: row of zeros
    for row, off in ((0, 0), (0, 4), (1, 4)):
        kn = rng.normal(size=(C, hkv, hd)).astype(np.float32)
        vn = rng.normal(size=(C, hkv, hd)).astype(np.float32)
        jk, jv = jpa.write_chunk_pages(jk, jv, jnp.asarray(kn),
                                       jnp.asarray(vn),
                                       jnp.asarray(tables[row]),
                                       jnp.int32(off))
        tpa.write_chunk_pages(tk, tv, _t(kn), _t(vn), _t(tables[row]),
                              off)
    lengths = np.array([11, 12, 0], np.int32)
    for _ in range(3):   # slot 0: 11 -> 13 crosses into page 9
        kn = rng.normal(size=(slots, hkv, hd)).astype(np.float32)
        vn = rng.normal(size=(slots, hkv, hd)).astype(np.float32)
        jk, jv = jpa.append_token_pages(jk, jv, jnp.asarray(kn),
                                        jnp.asarray(vn),
                                        jnp.asarray(tables),
                                        jnp.asarray(lengths))
        out = tpa.append_token_pages(tk, tv, _t(kn), _t(vn), _t(tables),
                                     _t(lengths))
        assert out[0] is tk and out[1] is tv   # updated in place
        lengths[:2] += 1
    np.testing.assert_array_equal(_bits(tk), _bits(jk))
    np.testing.assert_array_equal(_bits(tv), _bits(jv))
    # The inactive slot's garbage landed in the sink page, row 0.
    assert _bits(tk)[:, 0, 0].any()
