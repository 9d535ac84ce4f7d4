"""The port's cross-entropy (``skypilot_tpu_torch/ops/cross_entropy.py``)
vs the JAX reference (``skypilot_tpu/ops/cross_entropy.py``).

Same numpy-seeded inputs through both sides in fp32; the JAX fused
forward kernel runs in interpret mode; on CPU tensors the port runs the
plain version of its kernel. Tolerance 1e-5 absolute and relative on
the per-token NLL, the logsumexp and both gradients: fp32 on both
sides, O(1) values, only the summation order differs.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from skypilot_tpu.ops import cross_entropy as jce
from skypilot_tpu_torch.ops import cross_entropy as tce

jax.config.update('jax_default_matmul_precision', 'highest')
torch.backends.cuda.matmul.allow_tf32 = False

TOL = 1e-5


def _inputs(seed, T, d, V, w_scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, d)).astype(np.float32)
    w = (rng.normal(size=(d, V)) * w_scale).astype(np.float32)
    tgt = rng.integers(0, V, size=(T,)).astype(np.int32)
    g = rng.normal(size=(T,)).astype(np.float32)
    return x, w, tgt, g


def _close(out, ref, name=''):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=TOL, atol=TOL, err_msg=name)


def _both(jfn, tfn, x, w, tgt, g):
    """(nll, dx, dw) of the JAX and the torch function, pulled back
    with the cotangent ``g``."""
    nll_j, vjp = jax.vjp(lambda x, w: jfn(x, w, jnp.asarray(tgt)),
                         jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    nll_t = tfn(tx, tw, torch.from_numpy(tgt))
    dx_t, dw_t = torch.autograd.grad(nll_t, (tx, tw), torch.from_numpy(g))
    return (nll_j, dx_j, dw_j), (nll_t, dx_t, dw_t)


def test_chunked_cross_entropy_matches_jax():
    x, w, tgt, g = _inputs(0, 24, 32, 64)
    ref, out = _both(lambda x, w, t: jce.chunked_cross_entropy(x, w, t, 4),
                     lambda x, w, t: tce.chunked_cross_entropy(x, w, t, 4),
                     x, w, tgt, g)
    for name, a, b in zip(('nll', 'dx', 'dw'), out, ref):
        _close(a, b, name)


def test_fused_cross_entropy_matches_jax():
    x, w, tgt, g = _inputs(1, 64, 128, 256, w_scale=0.05)
    before = dict(tce.launches)
    ref, out = _both(
        lambda x, w, t: jce.fused_cross_entropy(x, w, t, 32, 128,
                                                interpret=True),
        lambda x, w, t: tce.fused_cross_entropy(x, w, t, 32, 128),
        x, w, tgt, g)
    for name, a, b in zip(('nll', 'dx', 'dw'), out, ref):
        _close(a, b, name)
    assert tce.launches == before     # CPU tensors: the plain version


def test_fused_chunked_backward_branch_matches_jax(monkeypatch):
    """The large-vocab backward branch, reached on both sides by
    lowering ONE_SHOT_BWD_MAX_VOCAB, gives the reference's gradients
    (and the one-shot branch's)."""
    x, w, tgt, g = _inputs(2, 32, 64, 256, w_scale=0.05)

    def run():
        return _both(
            lambda x, w, t: jce.fused_cross_entropy(x, w, t, 32, 128,
                                                    interpret=True),
            lambda x, w, t: tce.fused_cross_entropy(x, w, t, 32, 128),
            x, w, tgt, g)

    _, one_shot = run()
    monkeypatch.setattr(jce, 'ONE_SHOT_BWD_MAX_VOCAB', 0)
    monkeypatch.setattr(tce, 'ONE_SHOT_BWD_MAX_VOCAB', 0)
    ref, out = run()
    for name, a, b, c in zip(('nll', 'dx', 'dw'), out, ref, one_shot):
        _close(a, b, name)
        _close(a, c.detach().numpy(), name + ' vs one-shot')


def test_fused_forward_edge_targets_match_the_reference_kernel():
    """A target in the last vocab tile picks its logit; a target that no
    column matches (negative, or past the vocabulary) picks nothing, so
    its NLL is the logsumexp, as in the reference kernel."""
    x, w, tgt, _ = _inputs(3, 32, 64, 384, w_scale=0.05)
    tgt[:4] = [383, 256, -1, 384]
    j_nll, j_lse = jce._fused_fwd(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(tgt), 32, 128, True)
    t_nll, t_lse = tce.fused_forward_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(tgt), 128)
    assert tuple(t_lse.shape) == (32, 1) == j_lse.shape
    _close(t_nll, j_nll, 'nll')
    _close(t_lse, j_lse, 'lse')
    assert t_nll[2] == t_lse[2, 0] and t_nll[3] == t_lse[3, 0]


def test_auto_block_matches_jax():
    for n in (1, 8, 24, 32, 100, 128, 1000, 12288, 32768, 128256):
        for want, floor in ((512, 8), (512, 128), (8192, 128)):
            assert tce._auto_block(n, want, floor) == \
                jce._auto_block(n, want, floor)


def test_cuda_shape_check():
    tce.check_cuda_shape((12288, 1536), (1536, 32768))
    tce.check_cuda_shape((5, 64), (64, 1000))
    for x_shape, w_shape in [((8, 48), (48, 256)), ((8, 64), (64, 1001)),
                             ((8, 64), (32, 256))]:
        with pytest.raises(ValueError):
            tce.check_cuda_shape(x_shape, w_shape)
