"""The port's MoE (``models/moe.py``) against the JAX MoE on the tiny
config in fp32, from the JAX init and numpy-seeded inputs.

- One rank: ``_route``'s dispatch exactly and its combine within 1e-6;
  ``forward``'s logits and aux losses, at the default capacity factor
  and at 0.25 (tokens dropped); at 8.0 no token dropped (combine sums to
  1, dispatch to K), as the reference's tests.
- ``fsdp 2 x tp 2 x ep 2`` as 8 ``gloo`` ranks
  (``torch_parallel_ranks.moe_rank``: each rank its blocks of
  ``moe.PARAM_SPECS`` and its rows of the batch) against the JAX
  unsharded ``loss_fn``: the loss and its aux terms within the
  reference's rel 1e-4 (``test_moe_sharded_matches_unsharded``), every
  rank's gradient blocks (finished by ``moe.reduce_grads``) within rtol
  1e-4 / atol 1e-6; then five SGD steps at the reference's lr 0.05 whose
  losses follow the JAX steps' within rel 1e-4 and fall
  (``test_moe_trains``).
- ``train.run --model moe-tiny`` exits with the reference's message.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_ranks as pranks
import torch_tp_ranks as ranks
from skypilot_tpu.models import moe as jmoe
from skypilot_tpu.train import run as jrun
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.models import moe as tmoe
from skypilot_tpu_torch.parallel import mesh as tmesh
from skypilot_tpu_torch.parallel import sharding as tsharding
from skypilot_tpu_torch.train import run

pytestmark = pytest.mark.jax

JCFG = jmoe.MoEConfig.tiny()
TCFG = tmoe.MoEConfig.tiny()
B, S = 4, 16
SIZES = (2, 2, 2)
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
AUX = ('ce_loss', 'load_balance_loss', 'router_z_loss')


def _jax_steps(params, tokens, targets, steps):
    """The reference's SGD steps: the losses before each update, the
    first step's aux terms and gradients."""
    @jax.jit
    def step(p):
        (l, aux), g = jax.value_and_grad(
            lambda q: jmoe.loss_fn(JCFG, q, tokens, targets),
            has_aux=True)(p)
        return l, aux, g, jax.tree.map(lambda w, d: w - pranks.MOE_LR * d,
                                       p, g)
    losses = []
    for i in range(steps + 1):
        loss, aux, grads, params = step(params)
        losses.append(float(loss))
        if i == 0:
            first = (float(loss), {k: float(aux[k]) for k in AUX},
                     {path: np.asarray(g) for path, g in
                      tsharding.tree_leaves(grads).items()})
    return losses, first


@pytest.fixture(scope='module')
def setup():
    params = jax.tree.map(np.asarray,
                          jmoe.init_params(JCFG, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, JCFG.vocab_size, (B, S)).astype(np.int32)
    return params, tokens, np.roll(tokens, -1, axis=1)


@pytest.fixture(scope='module')
def mesh_run(setup, tmp_path_factory):
    """The 8 ranks' results, and the reference's steps computed here
    meanwhile."""
    params, tokens, targets = setup
    tmp = tmp_path_factory.mktemp('moe')
    ranks.save_params({**params, 'tokens': tokens, 'targets': targets},
                      tmp / 'data.npz')
    procs = ranks.start(pranks.moe_rank, 8,
                        (SIZES, str(tmp / 'data.npz'),
                         str(tmp / 'moe{rank}.npz')))
    want = _jax_steps(jax.tree.map(jnp.asarray, params), jnp.asarray(tokens),
                      jnp.asarray(targets), pranks.MOE_STEPS)
    for p in procs:
        p.join(300)
    assert [p.exitcode for p in procs] == [0] * 8
    return [dict(np.load(tmp / f'moe{r}.npz')) for r in range(8)], want


def _block(path, whole, coords):
    """The rank at ``coords``'s block of a whole leaf (the rank program's
    ``moe.shard_for``)."""
    spec = tmoe.leaf_spec(path)
    out = whole
    for axis, n in zip(tmesh.EP_AXES, SIZES):
        a = getattr(spec, axis)
        if a is not None:
            size = out.shape[a] // n
            out = np.take(out, range(coords[axis] * size,
                                     (coords[axis] + 1) * size), axis=a)
    return out


def test_route_matches_the_reference(setup):
    params, _, _ = setup
    h = np.random.default_rng(2).standard_normal((32, JCFG.dim)).astype(
        np.float32)
    router = params['layers']['router'][0]
    # Capacity factors 0.25 (drops), 1, 4 and 8 (no drops) at T 32.
    for capacity in (4, 16, 64, 128):
        jd, jc, (jlb, jz) = jmoe._route(JCFG, jnp.asarray(h),
                                        jnp.asarray(router), capacity)
        td, tc, (tlb, tz) = tmoe._route(TCFG, torch.from_numpy(h),
                                        torch.tensor(router), capacity)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
        assert float(tlb) == pytest.approx(float(jlb), rel=1e-6)
        assert float(tz) == pytest.approx(float(jz), rel=1e-6)


@pytest.mark.parametrize('capacity_factor', [1.25, 0.25])
def test_forward_matches_the_reference(setup, capacity_factor):
    params, tokens, _ = setup
    jcfg = jmoe.MoEConfig.tiny(capacity_factor=capacity_factor)
    tcfg = tmoe.MoEConfig.tiny(capacity_factor=capacity_factor)
    jl, jaux = jmoe.forward(jcfg, jax.tree.map(jnp.asarray, params),
                            jnp.asarray(tokens))
    tl, taux = tmoe.forward(tcfg, tllama.params_from_jax(params),
                            torch.from_numpy(tokens).long())
    assert np.isfinite(tl.detach().numpy()).all()
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=2e-5, rtol=2e-5)
    for k in ('load_balance_loss', 'router_z_loss'):
        assert float(taux[k]) == pytest.approx(float(jaux[k]), rel=1e-5)
    # The reference's bounds (test_moe_forward_shapes_and_aux).
    assert 0.5 < float(taux['load_balance_loss']) < 4.0


def test_generous_capacity_drops_nothing_and_tiny_capacity_drops(setup):
    params, _, _ = setup
    h = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (32, TCFG.dim)).astype(np.float32))
    router = torch.tensor(params['layers']['router'][0])
    K, E = TCFG.experts_per_token, TCFG.n_experts
    for factor, full in ((8.0, True), (0.25, False)):
        capacity = int(factor * 32 * K / E)
        dispatch, combine, _ = tmoe._route(TCFG, h, router, capacity)
        sums = combine.sum(dim=(1, 2)).numpy()
        if full:
            np.testing.assert_allclose(sums, np.ones_like(sums), rtol=1e-5)
            np.testing.assert_array_equal(dispatch.sum(dim=(1, 2)).numpy(),
                                          K)
        else:
            assert dispatch.sum() < 32 * K
            assert (dispatch.sum(dim=0) <= 1).all()
            assert (dispatch.sum(dim=(0, 2)) <= capacity).all()


def test_sharded_loss_and_grads_match_the_unsharded_reference(mesh_run):
    got, (_, (loss, aux, grads)) = mesh_run
    shape = tmesh.AxesShape(tmesh.EP_AXES, SIZES)
    for rank, res in enumerate(got):
        assert float(res['loss']) == pytest.approx(loss, rel=LOSS_RTOL)
        for k in AUX:
            assert float(res[k]) == pytest.approx(aux[k], rel=LOSS_RTOL)
        coords = shape.coords(rank)
        for path, g in grads.items():
            np.testing.assert_allclose(
                res['grad/' + '/'.join(path)], _block(path, g, coords),
                rtol=GRAD_RTOL, atol=GRAD_ATOL,
                err_msg=f'rank {rank} {path}')


def test_sharded_sgd_steps_follow_the_reference(mesh_run):
    got, (losses, _) = mesh_run
    for res in got:
        np.testing.assert_allclose(res['losses'], losses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]


def test_train_run_refuses_moe_like_the_reference():
    with pytest.raises(SystemExit) as want:
        jrun.main(['--model', 'moe-tiny', '--steps', '1'])
    with pytest.raises(SystemExit) as exc:
        run.main(['--model', 'moe-tiny', '--device', 'cpu', '--steps', '1'])
    assert str(exc.value) == str(want.value)
