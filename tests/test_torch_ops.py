"""Numeric primitives of the PyTorch port vs the JAX reference.

Same numpy-seeded inputs through both; fp32 on the CPU, atol 1e-6 (the
functions are elementwise or short reductions; only the order of a mean's
sum can differ). TF32 is off for every torch matmul here.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from skypilot_tpu.ops import norms as jnorms
from skypilot_tpu.ops import quant as jquant
from skypilot_tpu.ops import rope as jrope
from skypilot_tpu_torch.ops import norms as tnorms
from skypilot_tpu_torch.ops import quant as tquant
from skypilot_tpu_torch.ops import rope as trope

jax.config.update('jax_default_matmul_precision', 'highest')
torch.backends.cuda.matmul.allow_tf32 = False

ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize('shape', [(3, 64), (2, 5, 48)])
def test_rms_norm_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=shape[-1:]).astype(np.float32)
    ref = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    out = tnorms.rms_norm(_t(x), _t(w), 1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_rms_norm_bf16_casts_back_like_jax():
    """bf16 in -> fp32 variance -> cast back after the weight multiply:
    both sides round at the same point, so the bits agree."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    ref = jnorms.rms_norm(jnp.asarray(x, jnp.bfloat16),
                          jnp.asarray(w, jnp.bfloat16))
    out = tnorms.rms_norm(_t(x).to(torch.bfloat16),
                          _t(w).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=0, rtol=2 ** -7)


@pytest.mark.parametrize('head_dim,seq', [(16, 128), (128, 64)])
def test_rope_frequencies_match_jax(head_dim, seq):
    jc, js = jrope.rope_frequencies(head_dim, seq, 500_000.0)
    tc, ts = trope.rope_frequencies(head_dim, seq, 500_000.0)
    assert tuple(tc.shape) == (seq, head_dim // 2)
    assert tc.dtype == torch.float32
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize('with_positions', [False, True])
def test_apply_rope_matches_jax(with_positions):
    """Rotation by halves, tables gathered by explicit positions (decode
    and chunked prefill) or by arange."""
    rng = np.random.default_rng(2)
    b, s, h, hd, max_len = 2, 6, 3, 16, 64
    x = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    pos = rng.integers(0, max_len, size=(b, s)).astype(np.int32)
    jc, js = jrope.rope_frequencies(hd, max_len)
    tc, ts = trope.rope_frequencies(hd, max_len)
    if with_positions:
        ref = jrope.apply_rope(jnp.asarray(x), jc, js, jnp.asarray(pos))
        out = trope.apply_rope(_t(x), tc, ts, _t(pos))
    else:
        ref = jrope.apply_rope(jnp.asarray(x), jc, js)
        out = trope.apply_rope(_t(x), tc, ts)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_qdot_and_qembed_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 24)).astype(np.float32)
    w = rng.normal(size=(24, 40)).astype(np.float32) * 0.2
    table = rng.normal(size=(50, 8)).astype(np.float32)
    tokens = rng.integers(0, 50, size=(7,)).astype(np.int32)
    np.testing.assert_allclose(
        tquant.qdot(_t(x), _t(w)).numpy(),
        np.asarray(jquant.qdot(jnp.asarray(x), jnp.asarray(w))),
        atol=ATOL, rtol=0)
    np.testing.assert_array_equal(
        tquant.qembed(_t(table), _t(tokens)).numpy(),
        np.asarray(jquant.qembed(jnp.asarray(table), jnp.asarray(tokens))))
