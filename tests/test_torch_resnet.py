"""The port's ResNet and its DDP entry point (``models/resnet.py``,
``train/run_vision.py``) against the JAX reference on
``ResNetConfig.tiny`` in fp32.

- Forward logits, loss and every gradient leaf equal the JAX model's
  (``params_from_jax``: HWIO convs to ``[out, in, kh, kw]``) within 1e-5,
  at an even image size (XLA's 'SAME' pads a stride-2 window at the end)
  and an odd one.
- ``run_vision.SGD`` (nesterov momentum 0.9 under the cosine decay)
  equals ``optax.sgd(optax.cosine_decay_schedule(lr, steps), momentum=0.9,
  nesterov=True)`` over 3 steps.
- DDP at 2 ``gloo`` ranks (``run_vision``'s rank program) equals one rank:
  each step's loss and the final params within 1e-5 (the gradient's sum
  over ranks differs from one rank's only in summation order); and
  ``python -m skypilot_tpu_torch.train.run_vision --device cpu --dp 2``
  runs both ranks and logs one rank's losses.
"""
import pathlib
import re
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_tp_ranks as ranks
import torch_train_ranks as train_ranks
from skypilot_tpu.models import resnet as jresnet
from skypilot_tpu_torch.models import resnet as tresnet
from skypilot_tpu_torch.train import run_vision

jax.config.update('jax_default_matmul_precision', 'highest')

pytestmark = pytest.mark.jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5
VISION = ['--model', 'tiny', '--steps', '3', '--batch', '8',
          '--image-size', '32', '--log-every', '1']


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.fixture(scope='module')
def ddp(tmp_path_factory):
    """The 2-rank rank program's losses and params and the 2-rank
    command's log, started together; then one rank in process."""
    tmp = tmp_path_factory.mktemp('ddp')
    procs = ranks.start(train_ranks.vision_rank, 2,
                        (VISION + ['--device', 'cpu'], str(tmp / 'dp2.npz')))
    cli = subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.train.run_vision',
         *VISION, '--device', 'cpu', '--dp', '2'], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    one = run_vision.run_rank(run_vision.parse_args(VISION), 1)
    _, log = cli.communicate(timeout=300)
    assert cli.returncode == 0, log[-3000:]
    for p in procs:
        p.join(300)
    assert [p.exitcode for p in procs] == [0, 0]
    with np.load(tmp / 'dp2.npz') as data:
        dp2 = {k: data[k] for k in data.files}
    return one, dp2, log


@pytest.mark.parametrize('size', [32, 33])
def test_forward_loss_and_every_gradient_match_jax(size):
    jcfg, tcfg = jresnet.ResNetConfig.tiny(), tresnet.ResNetConfig.tiny()
    jparams = jresnet.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tresnet.params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(size)
    images = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (2,)).astype(np.int32)
    def loss_and_logits(p):
        return (jresnet.loss_fn(jcfg, p, jnp.asarray(images),
                                jnp.asarray(labels)),
                jresnet.forward(jcfg, p, jnp.asarray(images)))
    (j_loss, j_logits), j_grads = jax.jit(jax.value_and_grad(
        loss_and_logits, has_aux=True))(jparams)
    np.testing.assert_allclose(
        tresnet.forward(tcfg, tparams, torch.from_numpy(images)).numpy(),
        np.asarray(j_logits), rtol=TOL, atol=TOL)
    leaves = [t.requires_grad_() for t in _leaves(tparams)]
    t_loss = tresnet.loss_fn(tcfg, tparams, torch.from_numpy(images),
                             torch.from_numpy(labels))
    grads = torch.autograd.grad(t_loss, leaves)
    assert t_loss.item() == pytest.approx(float(j_loss), rel=TOL)
    want = _leaves(tresnet.params_from_jax(jax.tree.map(np.asarray,
                                                        j_grads)))
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL)


def test_sgd_nesterov_cosine_equals_optax():
    steps, lr = 3, 0.1
    rng = np.random.default_rng(0)
    params = [rng.standard_normal((4, 5)).astype(np.float32),
              rng.standard_normal((3,)).astype(np.float32)]
    grads = [[rng.standard_normal(p.shape).astype(np.float32)
              for p in params] for _ in range(steps)]
    opt = optax.sgd(optax.cosine_decay_schedule(lr, steps), momentum=0.9,
                    nesterov=True)
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    sgd = run_vision.SGD(lr, steps)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = sgd.init(tp)
    for g in grads:
        updates, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        sgd.update([torch.from_numpy(x) for x in g], tstate, tp)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-7)
    assert [sgd.schedule(c) for c in range(steps + 1)] == pytest.approx(
        [float(optax.cosine_decay_schedule(lr, steps)(c))
         for c in range(steps + 1)], abs=1e-9)


def test_ddp_at_two_ranks_equals_one_rank(ddp):
    one, dp2, _ = ddp
    np.testing.assert_allclose(dp2['losses'],
                               [r['loss'] for r in one['logged']],
                               rtol=TOL)
    assert len(one['params']) == len(dp2) - 1
    for i, p in enumerate(one['params']):
        np.testing.assert_allclose(dp2[f'p{i}'], p.numpy(), rtol=0,
                                   atol=TOL)


def test_run_vision_cli_runs_two_ranks(ddp):
    one, _, log = ddp
    assert 'DDP over 2 devices, model=tiny' in log
    assert 'vision-rank-1 exited 0' in log
    losses = [float(x) for x in re.findall(r'loss=([\d.]+)', log)]
    assert losses == pytest.approx([r['loss'] for r in one['logged']],
                                   abs=1e-4)
