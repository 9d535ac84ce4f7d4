"""The port's GPipe pipeline (``parallel/pipeline.py``) against the JAX
``llama_pp_loss_fn`` (``shard_map`` over the conftest's CPU devices) and
against the sequential ``llama.loss_fn``, on the tiny config at 4 layers
in fp32, from the JAX init and a numpy-seeded batch.

pp 2 and pp 4, and dp 2 x pp 2, each as ``gloo`` ranks
(``torch_parallel_ranks.pp_rank``, all started together): the loss within
the reference's rel 1e-5, and every rank's gradients (its stage's layers
and the embed, final norm and head it holds whole, finished by
``pipeline.reduce_grads``) within the reference's rtol 2e-4 / atol 2e-5 of
``jax.grad`` of both. The reference's two ``ValueError``s: layers that do
not split over the stages, a batch that does not split into microbatches.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import torch_parallel_ranks as pranks
import torch_tp_ranks as ranks
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel import pipeline as jpipeline
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.parallel import pipeline as tpipeline
from skypilot_tpu_torch.parallel import sharding as tsharding
from skypilot_tpu_torch.parallel.mesh import TPGroup

pytestmark = pytest.mark.jax

CFG = jllama.LlamaConfig.tiny(n_layers=4)
B, S = 4, 16
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
# (dp, pp) of each run.
LAYOUTS = [(1, 2), (1, 4), (2, 2)]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Every layout's ranks, started together, while the reference's
    sequential and pipelined losses and gradients are computed here."""
    tmp = tmp_path_factory.mktemp('pp')
    params = jax.tree.map(np.asarray,
                          jllama.init_params(CFG, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, CFG.vocab_size, (B, S)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    ranks.save_params({**params, 'tokens': tokens, 'targets': targets},
                      tmp / 'data.npz')
    procs = {}
    for dp, pp in LAYOUTS:
        procs[dp, pp] = ranks.start(
            pranks.pp_rank, dp * pp,
            (dp, str(tmp / 'data.npz'), str(tmp / f'{dp}x{pp}_{{rank}}.npz')))
    jp = jax.tree.map(jnp.asarray, params)
    args = (jnp.asarray(tokens), jnp.asarray(targets))
    seq = jax.value_and_grad(
        lambda p: jllama.loss_fn(CFG, p, *args))(jp)
    want = {'sequential': seq}
    for dp, pp in LAYOUTS:
        mesh = Mesh(np.array(jax.devices()[:dp * pp]).reshape(dp, pp),
                    ('dp', 'pp'))
        fn = jpipeline.llama_pp_loss_fn(CFG, mesh, num_microbatches=2)
        want[dp, pp] = jax.jit(jax.value_and_grad(fn))(jp, *args)
    got = {}
    for layout, started in procs.items():
        for p in started:
            p.join(300)
        assert [p.exitcode for p in started] == [0] * len(started), layout
        got[layout] = [dict(np.load(tmp / f'{layout[0]}x{layout[1]}_{r}.npz'))
                       for r in range(len(started))]
    return got, {k: (float(v[0]), tsharding.tree_leaves(v[1]))
                 for k, v in want.items()}


@pytest.mark.parametrize('dp,pp', LAYOUTS)
@pytest.mark.parametrize('against', ['pipeline', 'sequential'])
def test_pipeline_matches_the_reference(runs, dp, pp, against):
    got, want = runs
    loss, grads = want[(dp, pp) if against == 'pipeline' else 'sequential']
    n = CFG.n_layers // pp
    for rank, res in enumerate(got[dp, pp]):
        assert float(res['loss']) == pytest.approx(loss, rel=LOSS_RTOL)
        stage = rank % pp
        for path, g in grads.items():
            g = np.asarray(g)
            if path[0] == 'layers':
                g = g[stage * n:(stage + 1) * n]
            key = '/'.join(path)
            np.testing.assert_allclose(res[f'grad/{key}'], g,
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f'rank {rank} {key}')


def test_pipeline_rejects_bad_layer_split():
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ('dp', 'pp'))
    with pytest.raises(ValueError):
        jpipeline.llama_pp_loss_fn(jllama.LlamaConfig.tiny(n_layers=3),
                                   mesh, num_microbatches=2)
    with pytest.raises(ValueError, match='not divisible by pp=2'):
        tpipeline.llama_pp_loss_fn(tllama.LlamaConfig.tiny(n_layers=3),
                                   TPGroup(world=2), 2)


def test_pipeline_rejects_a_batch_that_does_not_split():
    cfg = tllama.LlamaConfig.tiny(n_layers=4)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0))
    fn = tpipeline.llama_pp_loss_fn(cfg, None, num_microbatches=2)
    tokens = torch.zeros((3, 8), dtype=torch.long)
    with pytest.raises(ValueError, match='not divisible by M=2'):
        fn(params, tokens, tokens)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ('dp', 'pp'))
    jfn = jpipeline.llama_pp_loss_fn(CFG, mesh, num_microbatches=2)
    jparams = jllama.init_params(CFG, jax.random.PRNGKey(0))
    with pytest.raises(ValueError):
        jfn(jparams, jnp.zeros((3, 8), jnp.int32), jnp.zeros((3, 8),
                                                             jnp.int32))


def test_one_stage_pipeline_is_the_sequential_loss():
    cfg = tllama.LlamaConfig.tiny(n_layers=4)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (4, 16),
                           generator=torch.Generator().manual_seed(1))
    targets = tokens.roll(-1, 1)
    got = tpipeline.llama_pp_loss_fn(cfg, None, 2)(params, tokens, targets)
    want = tllama.loss_fn(cfg, params, tokens, targets)
    assert float(got) == pytest.approx(float(want), rel=LOSS_RTOL)
