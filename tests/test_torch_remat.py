"""The reference's selective remat policies in the port
(``models/llama.py``: ``torch.utils.checkpoint`` with
``create_selective_checkpoint_contexts``) on the tiny config in fp32.

- ``dots`` and ``save_attn`` give ``full``'s loss and gradients bit for
  bit, with flash attention (the registered flash operators, here their
  plain versions) and with dense attention.
- They give the JAX package's gradients under the same policy at
  ``test_torch_train.py``'s tolerance (1e-4; JAX at 'highest' matmul
  precision, its flash kernel in interpret mode).
- What each policy saves: under ``full`` the flash forward operator runs
  2 x layers times a step (the forward and its recompute), under
  ``save_attn`` layers times (its out and lse are kept); under ``dots``
  the backward recomputes none of the six 2-D products (``aten.mm``) a
  layer that ``full`` recomputes, and still recomputes the attention.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from skypilot_tpu.models import llama as jllama
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.ops import attention as tatt

jax.config.update('jax_default_matmul_precision', 'highest')

pytestmark = pytest.mark.jax

TOL = 1e-4
B, S = 2, 16


@pytest.fixture(scope='module')
def models():
    jparams = jllama.init_params(jllama.LlamaConfig.tiny(),
                                 jax.random.PRNGKey(0))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, size=(B, S)).astype(np.int32)
    targets = rng.integers(0, 256, size=(B, S)).astype(np.int32)
    return jparams, tparams, tokens, targets


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _grads(cfg, params, tokens, targets, mode=None):
    """(loss, {path: grad}); ``mode`` (a dispatch mode) watches only the
    backward."""
    leaves = [(p, t.clone().requires_grad_()) for p, t in _paths(params)]
    tree = {}
    for path, t in leaves:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    loss = tllama.loss_fn(cfg, tree, torch.from_numpy(tokens),
                          torch.from_numpy(targets))
    if mode is None:
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
    else:
        with mode:
            grads = torch.autograd.grad(loss, [t for _, t in leaves])
    return loss, {path: g for (path, _), g in zip(leaves, grads)}


def _cfg(impl, policy, **kw):
    return tllama.LlamaConfig.tiny(attention_impl=impl, remat_policy=policy,
                                   **kw)


@pytest.fixture(scope='module')
def full(models):
    """``full``'s loss and gradients, by attention implementation."""
    _, tparams, tokens, targets = models
    return {impl: _grads(_cfg(impl, 'full'), tparams, tokens, targets)
            for impl in ('flash', 'dense')}


@pytest.mark.parametrize('policy', ['dots', 'save_attn'])
@pytest.mark.parametrize('impl', ['flash', 'dense'])
def test_policy_gradients_equal_full_bitwise(models, full, impl, policy):
    _, tparams, tokens, targets = models
    loss_full, g_full = full[impl]
    loss, g = _grads(_cfg(impl, policy), tparams, tokens, targets)
    assert torch.equal(loss, loss_full)
    for path in g_full:
        assert torch.equal(g[path], g_full[path]), path


@pytest.mark.parametrize('impl, policy', [('dense', 'dots'),
                                          ('flash', 'save_attn')])
def test_policy_gradients_match_jax_under_the_same_policy(models, impl,
                                                          policy):
    jparams, tparams, tokens, targets = models
    jcfg = jllama.LlamaConfig.tiny(attention_impl=impl, remat_policy=policy)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jllama.loss_fn(jcfg, p, jnp.asarray(tokens),
                                 jnp.asarray(targets))))(jparams)
    t_loss, t_grads = _grads(_cfg(impl, policy), tparams, tokens, targets)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=TOL,
                               atol=TOL)
    for path, g in t_grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(_get(j_grads, path)),
                                   rtol=TOL, atol=TOL, err_msg=str(path))


@pytest.mark.parametrize('policy, forwards', [('full', 2), ('dots', 2),
                                              ('save_attn', 1)])
def test_flash_forward_calls_a_step(models, policy, forwards):
    """The registered flash forward's calls over one forward and backward,
    per layer: the recompute runs it again unless ``save_attn`` kept its
    outputs. The backward operators run once a layer either way."""
    _, tparams, tokens, targets = models
    cfg = _cfg('flash', policy, fused_loss=True)
    tatt.reset_launches()
    _grads(cfg, tparams, tokens, targets)
    layers = cfg.n_layers
    assert tatt.op_calls == {'flash_fwd': forwards * layers,
                             'flash_bwd_dq': layers,
                             'flash_bwd_dkv': layers}
    # No kernel on the CPU: the operators ran their plain versions.
    assert not any(tatt.launches.values())


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] = self.ops.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_dots_saves_the_2d_products(models):
    """The backward under ``full`` recomputes six of each layer's seven
    2-D products (q, k, v, wo, gate, up; not ``w_down``'s, which no
    backward needs: the recompute stops once it has what was saved)
    before differentiating them (two products each, as under ``dots``);
    under ``dots`` it recomputes none, and still recomputes the flash
    forward (not a product it saves)."""
    _, tparams, tokens, targets = models
    counts = {}
    for policy in ('full', 'dots'):
        mode = _Count()
        tatt.reset_launches()
        _grads(_cfg('flash', policy), tparams, tokens, targets, mode)
        counts[policy] = (mode.ops.get(torch.ops.aten.mm.default, 0),
                          tatt.op_calls['flash_fwd'])
    layers = tllama.LlamaConfig.tiny().n_layers
    assert counts['full'][0] - counts['dots'][0] == 6 * layers, counts
    # The backward's own: dX and dW of the seven products and lm_head.
    assert counts['dots'][0] == 2 * (7 * layers + 1), counts
    assert counts['full'][1] == counts['dots'][1] == 2 * layers


def test_an_unknown_policy_raises(models):
    _, tparams, tokens, _ = models
    with pytest.raises(ValueError, match='Unknown remat_policy'):
        tllama.backbone(_cfg('dense', 'bogus'), tparams,
                        torch.from_numpy(tokens))
