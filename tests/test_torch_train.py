"""The port's training path (``models/llama.py`` forward and loss,
``train/trainer.py``) vs the JAX reference on ``LlamaConfig.tiny``.

Weights: ``llama.init_params(tiny, PRNGKey(0))`` carried across with
``params_from_jax``; tokens and targets from a numpy seed. fp32
throughout, TF32 off, JAX at 'highest' matmul precision. Tolerances:
logits, losses and every gradient leaf at 1e-4 (a two-layer model's
fp32 matmuls summed in different orders by XLA and PyTorch); three
optimizer steps' params at 1e-5 (the updates are lr-sized, the params
O(0.1)). The JAX flash and fused-CE kernels run in interpret mode.
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from skypilot_tpu.models import llama as jllama
from skypilot_tpu.train import trainer as jtrainer
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.parallel import mesh as tmesh
from skypilot_tpu_torch.train import trainer as ttrainer

jax.config.update('jax_default_matmul_precision', 'highest')
torch.backends.cuda.matmul.allow_tf32 = False

pytestmark = pytest.mark.jax

TOL = 1e-4
B, S = 2, 16

# (attention_impl, loss branch) pairs: the dense path, the kernel path
# (flash + fused CE) and the vocab-chunked CE.
BRANCHES = {
    'dense': dict(attention_impl='dense'),
    'flash_fused': dict(attention_impl='flash', fused_loss=True),
    'chunked': dict(attention_impl='dense', loss_vocab_chunks=4),
}


@pytest.fixture(scope='module')
def models():
    jparams = jllama.init_params(jllama.LlamaConfig.tiny(),
                                 jax.random.PRNGKey(0))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, size=(B, S)).astype(np.int32)
    targets = rng.integers(0, 256, size=(B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.3).astype(np.float32)
    return jparams, tparams, tokens, targets, mask


def _leaves_with_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _torch_grads(cfg, params, tokens, targets, mask=None):
    leaves = [(p, t.clone().requires_grad_())
              for p, t in _leaves_with_paths(params)]
    tree = {}
    for path, t in leaves:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    loss = tllama.loss_fn(cfg, tree, tokens, targets, mask)
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    return loss, {path: g for (path, _), g in zip(leaves, grads)}


def test_forward_logits_match_jax(models):
    jparams, tparams, tokens, _, _ = models
    ref = jllama.forward(jllama.LlamaConfig.tiny(), jparams,
                         jnp.asarray(tokens))
    out = tllama.forward(tllama.LlamaConfig.tiny(), tparams,
                         torch.from_numpy(tokens))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('branch', sorted(BRANCHES))
def test_loss_and_every_gradient_leaf_match_jax(models, branch, masked):
    jparams, tparams, tokens, targets, mask = models
    kw = BRANCHES[branch]
    jcfg = jllama.LlamaConfig.tiny(**kw)
    tcfg = tllama.LlamaConfig.tiny(**kw)
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    j_loss, j_grads = jax.value_and_grad(
        lambda p: jllama.loss_fn(jcfg, p, jnp.asarray(tokens),
                                 jnp.asarray(targets), jm))(jparams)
    t_loss, t_grads = _torch_grads(tcfg, tparams, torch.from_numpy(tokens),
                                   torch.from_numpy(targets), tm)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=TOL,
                               atol=TOL)
    for path, g in t_grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(_get(j_grads, path)),
                                   rtol=TOL, atol=TOL, err_msg=str(path))


def test_remat_on_equals_off_bitwise(models):
    _, tparams, tokens, targets, _ = models
    out = []
    for remat in (True, False):
        cfg = tllama.LlamaConfig.tiny(remat=remat, **BRANCHES['flash_fused'])
        out.append(_torch_grads(cfg, tparams, torch.from_numpy(tokens),
                                torch.from_numpy(targets)))
    (loss_on, g_on), (loss_off, g_off) = out
    assert torch.equal(loss_on, loss_off)
    for path in g_on:
        assert torch.equal(g_on[path], g_off[path]), path


def test_remat_policies(models):
    _, tparams, tokens, _, _ = models
    t = torch.from_numpy(tokens)
    full = tllama.backbone(tllama.LlamaConfig.tiny(), tparams, t)
    for policy in ('dots', 'save_attn'):
        # Ported (selective checkpointing): the forward is full's, bit for
        # bit; tests/test_torch_remat.py holds the gradients.
        assert torch.equal(tllama.backbone(
            tllama.LlamaConfig.tiny(remat_policy=policy), tparams, t), full)
    with pytest.raises(ValueError, match='Unknown remat_policy'):
        tllama.backbone(tllama.LlamaConfig.tiny(remat_policy='bogus'),
                        tparams, t)
    # Without remat the policy is not read, as in the reference.
    tllama.backbone(tllama.LlamaConfig.tiny(remat=False,
                                            remat_policy='bogus'),
                    tparams, t)


def test_three_train_steps_match_jax(models):
    jparams, tparams, tokens, targets, _ = models
    # lr 1e-3 moves the params by ~1e-3 a step, 100x the tolerance.
    # Adam's update g / (|g| + eps) is ill-conditioned for the rare
    # gradient element near 1e-7, where fp32 summation order shows up
    # as a fraction of a percent of the lr; at this lr that stays under
    # the 1e-5 tolerance.
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    jcfg = jllama.LlamaConfig.tiny(**BRANCHES['flash_fused'])
    tcfg = tllama.LlamaConfig.tiny(**BRANCHES['flash_fused'])
    jopt = jtrainer.make_optimizer(**kw)
    topt = ttrainer.make_optimizer(**kw)
    jstate = jtrainer.TrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree.map(jnp.array, jparams),
        opt_state=jopt.init(jparams))
    tstate = ttrainer.TrainState(
        step=torch.zeros((), dtype=torch.int32),
        params=jax.tree.map(lambda t: t.clone(), tparams),
        opt_state=topt.init(tparams))
    jstep = jtrainer.make_train_step(jcfg, jopt)
    tstep = ttrainer.make_train_step(tcfg, topt)
    jbatch = {'tokens': jnp.asarray(tokens), 'targets': jnp.asarray(targets)}
    tbatch = {'tokens': torch.from_numpy(tokens),
              'targets': torch.from_numpy(targets)}
    start = {p: t.clone() for p, t in _leaves_with_paths(tparams)}
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch)
        tstate, tm = tstep(tstate, tbatch)
        assert int(tm['step']) == int(jm['step']) == i + 1
        np.testing.assert_allclose(tm['loss'].item(), float(jm['loss']),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tm['grad_norm'].item(),
                                   float(jm['grad_norm']), rtol=TOL,
                                   atol=TOL)
        moved = 0.0
        for path, t in _leaves_with_paths(tstate.params):
            j = np.asarray(_get(jstate.params, path))
            np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-5,
                                       err_msg=f'step {i + 1} {path}')
            moved = max(moved, (t - start[path]).abs().max().item())
            if i == 0:     # lr is 0 at count 0 on both sides
                np.testing.assert_array_equal(j, start[path].numpy())
        assert moved == 0.0 if i == 0 else moved > 1e-4, (i, moved)


@pytest.mark.parametrize('mu_dtype', [None, 'bfloat16', 'float32'])
def test_optimizer_state_dtypes_equal_optax(mu_dtype):
    jcfg = jllama.LlamaConfig.tiny(dtype='bfloat16')
    jparams = jax.eval_shape(lambda: jllama.init_params(
        jcfg, jax.random.PRNGKey(0)))
    jstate = jax.eval_shape(
        jtrainer.make_optimizer(mu_dtype=mu_dtype).init, jparams)
    adam = jstate[1][0]
    assert isinstance(adam, optax.ScaleByAdamState)
    tcfg = tllama.LlamaConfig.tiny(dtype='bfloat16')
    tstate = ttrainer.init_train_state(
        tcfg, torch.Generator().manual_seed(0),
        ttrainer.make_optimizer(mu_dtype=mu_dtype))
    opt = tstate.opt_state
    assert str(opt['count'].dtype) == 'torch.' + str(adam.count.dtype)
    for name in ('mu', 'nu'):
        for path, t in _leaves_with_paths(opt[name]):
            want = _get(getattr(adam, name), path).dtype
            assert str(t.dtype) == 'torch.' + str(want), (name, path)
    assert str(tstate.step.dtype) == 'torch.int32'


def test_schedule_matches_optax():
    for warmup, total in ((100, 10_000), (2, 10), (5, 3)):
        j = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup,
                                               max(total, warmup + 1))
        t = ttrainer.make_optimizer(warmup_steps=warmup, total_steps=total)
        for count in (0, 1, warmup - 1, warmup, warmup + 1, total, 2 * total):
            np.testing.assert_allclose(t.schedule(count), float(j(count)),
                                       rtol=1e-6, atol=1e-12)


def test_make_train_step_refuses_a_mesh(models):
    """A mesh is ported (tests/test_torch_train_mesh.py runs one): a
    one-rank mesh steps exactly as no mesh does, and a mesh whose fsdp
    does not divide the model dimension is refused with the reference's
    divisibility error."""
    _, tparams, tokens, targets, _ = models
    cfg = tllama.LlamaConfig.tiny()
    batch = {'tokens': torch.from_numpy(tokens),
             'targets': torch.from_numpy(targets)}
    out = []
    for mesh in (None, tmesh.single_mesh()):
        opt = ttrainer.make_optimizer(warmup_steps=1, total_steps=10)
        params = jax.tree.map(lambda t: t.clone(), tparams)
        state = ttrainer.TrainState(step=torch.zeros((), dtype=torch.int32),
                                    params=params,
                                    opt_state=opt.init(params))
        step = ttrainer.make_train_step(cfg, opt, mesh=mesh)
        for _ in range(2):
            state, metrics = step(state, batch)
        out.append((metrics, state.params))
    (m0, p0), (m1, p1) = out
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(p0),
                                                 jax.tree.leaves(p1)))
    with pytest.raises(ValueError, match='fsdp=3 must divide dim=64'):
        ttrainer.make_train_step(
            cfg, ttrainer.make_optimizer(),
            mesh=tmesh.TrainMesh(shape=tmesh.MeshShape(1, 3, 1)))


@pytest.mark.parametrize('preset', ['tiny', 'bench_350m', 'bench_1b',
                                    'llama3_8b', 'llama3_70b'])
def test_num_params_and_flops_per_token_equal(preset):
    jcfg = getattr(jllama.LlamaConfig, preset)()
    tcfg = getattr(tllama.LlamaConfig, preset)()
    assert tcfg == tllama.LlamaConfig(**{
        f: getattr(jcfg, f) for f in tllama.LlamaConfig.__dataclass_fields__})
    assert tcfg.num_params == jcfg.num_params
    assert tllama.flops_per_token(tcfg) == jllama.flops_per_token(jcfg)
    assert tllama.LLAMA_LAYER_TREE == jllama.LLAMA_LAYER_TREE
