"""The port's training attention (``skypilot_tpu_torch/ops/attention.py``)
vs the JAX reference (``skypilot_tpu/ops/attention.py``).

Inputs come from a numpy seed and go through both sides in fp32. The
JAX flash kernels run in interpret mode, as
``tests/unit_tests/test_ops.py`` runs them on the CPU; on CPU tensors the
port runs its plain blockwise versions. Tolerance 1e-5 absolute and
relative: both sides accumulate in fp32 over the same blocks, and the
values are O(1), so only summation order separates them.

The CUDA kernels themselves are held to these plain versions on the card
by ``chip_smoke.py``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from skypilot_tpu.ops import attention as jatt
from skypilot_tpu_torch.ops import attention as tatt

jax.config.update('jax_default_matmul_precision', 'highest')
torch.backends.cuda.matmul.allow_tf32 = False

TOL = 1e-5


def _qkv(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, hq, s, d), (b, hkv, s, d),
                               (b, hkv, s, d), (b, hq, s, d)))


def _close(out, ref, tol=TOL, name=''):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('hq,hkv', [(4, 4), (8, 2)])
def test_dense_and_flash_forward_match_jax(causal, hq, hkv):
    q, k, v, _ = _qkv(0, 2, hq, hkv, 256, 64)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    _close(tatt.dense_attention(tq, tk, tv, causal=causal),
           jatt.dense_attention(jq, jk, jv, causal=causal), name='dense')
    scale = 64 ** -0.5
    j_out, j_lse = jatt._flash_forward(jq, jk, jv, causal, scale, 128, 128,
                                       interpret=True)
    t_out, t_lse = tatt._flash_forward(tq, tk, tv, causal, scale, 128)
    assert tuple(t_lse.shape) == (2, hq, 1, 256) == j_lse.shape
    _close(t_out, j_out, name='out')
    _close(t_lse, j_lse, name='lse')
    _close(tatt.flash_attention(tq, tk, tv, causal=causal, block_q=128,
                                block_k=128), j_out, name='flash_attention')


@pytest.mark.parametrize('block_q,block_k', [(64, 128), (128, 64)])
@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('hq,hkv', [(4, 4), (8, 2)])
def test_flash_gradients_match_jax(block_q, block_k, causal, hq, hkv):
    q, k, v, g = _qkv(1, 1, hq, hkv, 256, 32)

    def f(q, k, v):
        return jatt.flash_attention(q, k, v, causal=causal, block_q=block_q,
                                    block_k=block_k, interpret=True)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    j_grads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tatt.flash_attention(tq, tk, tv, causal=causal, block_q=block_q,
                               block_k=block_k)
    t_grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, a, b in zip(('dq', 'dk', 'dv'), t_grads, j_grads):
        _close(a, b, name=name)


def test_flash_backward_pieces_match_the_dense_gradient():
    """The plain backward, called with the saved statistics directly,
    gives the gradient autograd takes through dense attention."""
    q, k, v, g = _qkv(2, 1, 8, 2, 128, 32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    dense = tatt.dense_attention(tq, tk, tv, causal=True)
    want = torch.autograd.grad(dense, (tq, tk, tv), torch.from_numpy(g))
    scale = 32 ** -0.5
    out, lse = tatt.flash_forward_reference(tq.detach(), tk.detach(),
                                            tv.detach(), causal=True,
                                            sm_scale=scale, block_k=64)
    delta = (torch.from_numpy(g) * out).sum(-1)[:, :, None, :]
    got = tatt.flash_backward_reference(
        tq.detach(), tk.detach(), tv.detach(), torch.from_numpy(g), lse,
        delta, causal=True, sm_scale=scale, block_k=64)
    for name, a, b in zip(('dq', 'dk', 'dv'), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_fit_block_matches_jax():
    for seq in (1, 16, 96, 128, 200, 256, 384, 768, 1000, 2048, 8192):
        for want in (64, 128, 256, 512, 1024):
            assert tatt._fit_block(want, seq) == jatt._fit_block(want, seq)


def test_auto_takes_dense_on_the_cpu_and_launches_nothing():
    q, k, v, _ = _qkv(3, 1, 4, 2, 256, 32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    before = dict(tatt.launches)
    out = tatt.attention(tq, tk, tv, impl='auto')
    assert torch.equal(out, tatt.dense_attention(tq, tk, tv))
    flash = tatt.attention(tq, tk, tv, impl='flash')
    _close(flash, out.detach().numpy(), name='flash vs dense')
    assert tatt.launches == before


def test_explicit_flash_refuses_sub_128_tiles_like_the_reference():
    x = np.zeros((1, 2, 200, 32), np.float32)
    with pytest.raises(ValueError, match='>=128 tile'):
        jatt.attention(jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
                       impl='flash', block_q=128)
    t = torch.from_numpy(x)
    with pytest.raises(ValueError, match='>=128 tile'):
        tatt.attention(t, t, t, impl='flash', block_q=128)


def test_cuda_shape_check():
    tatt.check_cuda_shape((6, 12, 2048, 128), (6, 12, 2048, 128))
    tatt.check_cuda_shape((1, 16, 256, 64), (1, 2, 256, 64))
    for q_shape, kv_shape in [((1, 4, 256, 32), (1, 4, 256, 32)),
                              ((1, 32, 256, 64), (1, 2, 256, 64)),
                              ((1, 4, 200, 64), (1, 4, 200, 64)),
                              ((1, 4, 256, 64), (1, 3, 256, 64))]:
        with pytest.raises(ValueError):
            tatt.check_cuda_shape(q_shape, kv_shape)
