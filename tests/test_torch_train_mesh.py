"""The port's sharded training (``parallel/mesh.py``,
``parallel/sharding.py``, ``parallel/collectives.py``, the mesh step of
``train/trainer.py``, ``train/checkpoint.py``'s mesh save and restore,
``train/run.py``'s mesh flags) against the JAX reference on the tiny
config in fp32, with ``gloo`` ranks spawned on the CPU.

- 8 ranks at ``dp 2 x fsdp 2 x tp 2`` (``torch_train_ranks.mesh_steps``)
  from the JAX init against ``make_train_step(mesh=make_mesh(2, 2, 2))``
  (conftest's 8 CPU devices): two steps' loss and ``grad_norm`` within rel
  1e-4 (the reference's own bound in ``test_sharded_matches_unsharded``),
  every parameter leaf of the mesh's checkpoint (``save_mesh``, in
  pieces of one block row, no rank allocating a whole leaf) within atol
  1e-5. The reference's mesh step takes no mask (its ``in_shardings``
  name tokens and targets only), so the masked run is held to the
  reference's one-device step with the mask, which that same reference
  test holds its mesh step to.
- ``python -m skypilot_tpu_torch.train.run --device cpu --dp 2 --fsdp 2
  --tp 2 --lr 0.02`` (8 ranks started by the command) from the port's
  own init: logged losses and the checkpointed params against the JAX
  mesh step from the same params and batch.
- A ``1 x 4 x 1`` run against the port's one-device run, saving each
  step; its step-1 checkpoint restored at one device and at ``1 x 2 x
  2`` lands where the uninterrupted one-device run does.
- Shard shapes: the 8B tree at ``fsdp 8`` equals ``NamedSharding``'s
  ``shard_shape`` on ``make_mesh(1, 8, 1)``; the 70B tree at ``fsdp 16 x
  tp 2`` the reference specs' arithmetic. Rank order, axis groups, batch
  rows and the layout functions' errors against the reference's.
"""
import json
import logging
import pathlib
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_tp_ranks as ranks
import torch_train_ranks as train_ranks
from skypilot_tpu import topology
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.parallel import sharding as jsharding
from skypilot_tpu.train import trainer as jtrainer
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.parallel import mesh as tmesh
from skypilot_tpu_torch.parallel import sharding as tsharding
from skypilot_tpu_torch.train import run
from skypilot_tpu_torch.train import trainer as ttrainer

pytestmark = pytest.mark.jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-5
B, S = 8, 16
# train.run's flags for the tiny runs.
RUN = ['--model', 'llama-tiny', '--device', 'cpu', '--seq', '32',
       '--log-every', '1']


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _jax_steps(params, batch, opt, steps, mesh=None, cfg=None):
    """``steps`` reference steps from ``params`` (numpy tree) on ``batch``
    (numpy), on the mesh or one device; returns (metrics, params)."""
    cfg = cfg or jllama.LlamaConfig.tiny()
    with jax.default_matmul_precision('float32'):
        jparams = jax.tree.map(jnp.asarray, params)
        state = jtrainer.TrainState(step=jnp.zeros((), jnp.int32),
                                    params=jparams,
                                    opt_state=opt.init(jparams))
        data = {k: jnp.asarray(v) for k, v in batch.items()}
        if mesh is not None:
            state = jtrainer.shard_train_state(state, mesh)
            data = {k: jax.device_put(v, jsharding.batch_sharding(mesh))
                    for k, v in data.items()}
        step = jtrainer.make_train_step(cfg, opt, mesh=mesh)
        out = []
        for _ in range(steps):
            state, m = step(state, data)
            out.append({'loss': float(m['loss']),
                        'grad_norm': float(m['grad_norm'])})
    return out, _np_tree(state.params)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield '/'.join(prefix), np.asarray(tree)


def _assert_params(got: dict, want, err=''):
    want = dict(_flat(want))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(np.asarray(got[key]), value,
                                   atol=PARAM_ATOL, rtol=0,
                                   err_msg=f'{err} {key}')


def _assert_metrics(got, want):
    for g, w in zip(got, want, strict=True):
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=LOSS_RTOL), (k, got, want)


def _cli(flags) -> subprocess.Popen:
    """``python -m skypilot_tpu_torch.train.run`` on the tiny config with
    ``flags``, started (see :func:`_done`)."""
    return subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.train.run', *RUN,
         *flags], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _done(proc: subprocess.Popen, timeout: float = 300) -> str:
    """The started command's log, once it exited 0."""
    _, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return err


def _losses(text):
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r'step (\d+)/\d+ loss=([\d.]+)', text)}


def _flat_torch(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_torch(v, prefix + (k,))
    else:
        yield '/'.join(prefix), tree


def _saved(path):
    """(step, optimizer count, whole params as numpy) of a checkpoint."""
    saved = torch.load(path / 'state.pt', weights_only=False)
    return (int(saved.step), int(saved.opt_state['count']),
            {k: v.numpy() for k, v in _flat_torch(saved.params)})


# The CLI at 2 x 2 x 2: two steps (warmup 100, so the second update is
# lr / 100) at an lr whose second update moves the params by about 2e-4,
# 20x PARAM_ATOL, small enough that Adam's magnified summation order at a
# gradient element near eps (see torch_train_ranks.OPT) stays under it.
CLI8 = ['--steps', '2', '--batch', '8', '--lr', '0.02']
# 1 x 4 x 1 and the resumes: an lr past the warmup's first updates
# (steps 2 and 3 move the params by about 2e-4 and 4e-4), small enough
# that Adam's magnified summation order at a gradient element near eps
# (see torch_train_ranks.OPT) stays under PARAM_ATOL.
RESUME = ['--batch', '4', '--lr', '0.02', '--steps', '3']


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Every multi-rank run of this module, started together: the
    port's 8 ranks on the JAX init (the rank program), ``train.run`` at
    2 x 2 x 2 from the port's init, and ``train.run`` at 1 x 4 x 1 saving
    every step, while the reference runs and the one-device run go on
    here; then, as soon as it is written, the 1 x 4 x 1 run's step-1
    checkpoint resumed at one device (here) and at 1 x 2 x 2."""
    tmp = tmp_path_factory.mktemp('mesh')
    params = _np_tree(jllama.init_params(jllama.LlamaConfig.tiny(),
                                         jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    batch = {'tokens': rng.integers(0, 256, (B, S)).astype(np.int32),
             'targets': rng.integers(0, 256, (B, S)).astype(np.int32),
             'mask': (rng.random((B, S)) > 0.3).astype(np.float32)}
    ranks.save_params({**params, **batch}, tmp / 'data.npz')
    procs = ranks.start(train_ranks.mesh_steps, 8,
                        ((2, 2, 2), str(tmp / 'data.npz'), str(tmp)))
    cli8 = _cli(CLI8 + ['--dp', '2', '--fsdp', '2', '--tp', '2',
                        '--checkpoint-dir', str(tmp / 'cli8'),
                        '--checkpoint-every', '1'])
    fsdp4 = _cli(RESUME + ['--fsdp', '4', '--checkpoint-dir',
                           str(tmp / 'fsdp4'), '--checkpoint-every', '1'])
    out = {}

    opt = jtrainer.make_optimizer(**train_ranks.OPT)
    plain = {k: v for k, v in batch.items() if k != 'mask'}
    out['ref'] = {'plain': _jax_steps(params, plain, opt, train_ranks.STEPS,
                                      jmesh.make_mesh(2, 2, 2)),
                  'masked': _jax_steps(params, batch, opt,
                                       train_ranks.STEPS)}
    cfg = tllama.LlamaConfig.tiny(max_seq_len=32)
    init = tllama.init_params(cfg, torch.Generator().manual_seed(0))
    data = ttrainer.synthetic_batch(cfg, 8, 32,
                                    torch.Generator().manual_seed(1))
    out['cli8_init'] = dict(_flat(jax.tree.map(lambda t: t.numpy(), init)))
    out['cli8_ref'] = _jax_steps(
        jax.tree.map(lambda t: t.numpy(), init),
        {k: v.numpy() for k, v in data.items()},
        jtrainer.make_optimizer(learning_rate=0.02, total_steps=2), 2,
        jmesh.make_mesh(2, 2, 2), jllama.LlamaConfig.tiny(max_seq_len=32))
    logs = out['logs'] = {}
    logs['one'] = _run_here(RESUME + ['--checkpoint-dir', str(tmp / 'one'),
                                      '--checkpoint-every', '1'])
    out['one'] = _saved(tmp / 'one' / '3')

    # The 1 x 4 x 1 run's first checkpoint (renamed into place whole) is
    # resumed while that run goes on.
    first = tmp / 'fsdp4' / '1'
    deadline = time.monotonic() + 300
    while not first.exists() and fsdp4.poll() is None \
            and time.monotonic() < deadline:
        time.sleep(0.1)
    if not first.exists():
        _done(fsdp4)     # its log, if it failed
    assert first.exists()
    for name in ('at_one', 'at_1x2x2'):
        shutil.copytree(first, tmp / name / '1')
    at_1x2x2 = _cli(RESUME + ['--fsdp', '2', '--tp', '2', '--checkpoint-dir',
                              str(tmp / 'at_1x2x2'), '--checkpoint-every',
                              '1'])
    logs['at_one'] = _run_here(RESUME + ['--checkpoint-dir',
                                         str(tmp / 'at_one'),
                                         '--checkpoint-every', '1'])
    out['at_one'] = _saved(tmp / 'at_one' / '3')

    for p in procs:
        p.join(300)
    assert [p.exitcode for p in procs] == [0] * 8
    metrics = json.loads((tmp / 'metrics.json').read_text())
    out['world8'] = {
        name: (metrics[name],
               _saved(tmp / name / str(train_ranks.STEPS))[2])
        for name in ('plain', 'masked')}
    out['saves'] = [json.loads((tmp / f'save{r}.json').read_text())
                    for r in range(8)]
    for name, proc, step in (('cli8', cli8, 2), ('fsdp4', fsdp4, 3),
                             ('at_1x2x2', at_1x2x2, 3)):
        logs[name] = _done(proc)
        out[name] = _saved(tmp / name / str(step))
    return out


def _run_here(flags) -> str:
    """``train.run`` at one device in this process; its log lines."""
    handler = _Lines()
    log = logging.getLogger(run.__name__)
    log.addHandler(handler)
    level = log.level
    log.setLevel(logging.INFO)
    try:
        run.main(RUN + flags)
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    return '\n'.join(handler.lines)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


# ---------------------------------------------------------------------------
# dp 2 x fsdp 2 x tp 2 against the reference's mesh step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('name', ['plain', 'masked'])
def test_2x2x2_matches_the_reference(runs, name):
    got_metrics, got_params = runs['world8'][name]
    want_metrics, want_params = runs['ref'][name]
    _assert_metrics(got_metrics, want_metrics)
    _assert_params(got_params, want_params, name)


def test_train_run_cli_2x2x2_matches_the_reference_mesh_step(runs):
    text = runs['logs']['cli8']
    assert 'devices=8 mesh dp=2 fsdp=2 tp=2' in text
    assert len(re.findall(r'train-rank-\d exited 0', text)) == 7
    want, want_params = runs['cli8_ref']
    # Logged at 4 decimals.
    assert list(_losses(text).values()) == pytest.approx(
        [m['loss'] for m in want], abs=1e-4)
    step, count, params = runs['cli8']
    assert (step, count) == (2, 2)
    _assert_params(params, want_params)
    # The params check sees the update: the reference's moved far past
    # PARAM_ATOL.
    init = runs['cli8_init']
    moved = max(np.abs(v - init[k]).max() for k, v in _flat(want_params))
    assert moved > 10 * PARAM_ATOL, moved


@pytest.mark.parametrize('name', ['plain', 'masked'])
def test_a_mesh_save_sends_pieces_and_no_rank_allocates_a_whole_leaf(
        runs, name):
    """``save_mesh`` at 2 x 2 x 2 in pieces of one block row (the
    checkpoint the 2 x 2 x 2 tests read): no rank's save allocates more
    than one row of its largest block, a small part of a whole leaf; rank
    0 maps each whole leaf from a file, the other ranks map nothing."""
    for rank, saves in enumerate(runs['saves']):
        s = saves[name]
        assert 0 < s['largest_allocation'] <= s['block_row'], (rank, s)
        assert s['mapped'] == (s['leaves'] if rank == 0 else 0), (rank, s)
        assert 8 * s['block_row'] <= s['whole_leaf'], (rank, s)


# ---------------------------------------------------------------------------
# 1 x 4 x 1 against one device, and resume across meshes
# ---------------------------------------------------------------------------
def test_1x4x1_matches_one_device(runs):
    straight = _losses(runs['logs']['one'])
    assert sorted(straight) == [1, 2, 3]
    text = runs['logs']['fsdp4']
    assert 'devices=4 mesh dp=1 fsdp=4 tp=1' in text
    assert _losses(text) == pytest.approx(straight, abs=1e-4)
    assert runs['fsdp4'][:2] == (3, 3)
    _assert_params(runs['fsdp4'][2], runs['one'][2], '1x4x1 vs one device')


@pytest.mark.parametrize('where', ['at_one', 'at_1x2x2'])
def test_a_1x4x1_checkpoint_resumes_where_one_device_lands(runs, where):
    """The 1 x 4 x 1 run's step-1 checkpoint (the whole state, written by
    rank 0) resumed at one device and at 1 x 2 x 2 lands where the
    uninterrupted one-device run does."""
    straight = _losses(runs['logs']['one'])
    text = runs['logs'][where]
    assert 'resumed from checkpoint at step 1' in text
    assert _losses(text) == pytest.approx({k: straight[k] for k in (2, 3)},
                                          abs=1e-4)
    assert runs[where][:2] == (3, 3)
    _assert_params(runs[where][2], runs['one'][2], where)


# ---------------------------------------------------------------------------
# Shapes and layouts against the reference
# ---------------------------------------------------------------------------
def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _jax_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_8b_shard_shapes_at_fsdp8_equal_the_reference():
    jcfg = jllama.LlamaConfig.llama3_8b()
    struct = jax.eval_shape(lambda: jllama.init_params(
        jcfg, jax.random.PRNGKey(0)))
    shardings = jsharding.param_shardings(jmesh.make_mesh(1, 8, 1), struct)
    tcfg = tllama.LlamaConfig.llama3_8b()
    meta = tllama.init_params(tcfg, None, 'meta')
    shape = tmesh.MeshShape(1, 8, 1)
    for rank in range(8):
        mesh = tmesh.TrainMesh(shape=shape, rank=rank)
        blocks = tsharding.shard_train_tree(meta, mesh)
        for path, _ in _paths(meta):
            want = _jax_get(shardings, path).shard_shape(
                _jax_get(struct, path).shape)
            assert tuple(_jax_get(blocks, path).shape) == want, path


def test_70b_shard_shapes_at_fsdp16_tp2_follow_the_reference_specs():
    cfg = tllama.LlamaConfig.llama3_70b()
    meta = tllama.init_params(cfg, None, 'meta')
    sizes = {'fsdp': 16, 'tp': 2, None: 1}
    tsharding.check_divisible(cfg, 2, 16)
    blocks = tsharding.shard_train_tree(meta, tmesh.TrainMesh(
        shape=tmesh.MeshShape(1, 16, 2), rank=31))
    for path, leaf in _paths(meta):
        spec = _jax_get(jsharding.LLAMA_PARAM_SPECS, path)
        want = tuple(n // sizes[a] for n, a in zip(
            leaf.shape, tuple(spec) + (None,) * (leaf.dim() - len(spec))))
        assert tuple(_jax_get(blocks, path).shape) == want, path
    with pytest.raises(ValueError, match='fsdp=3 must divide dim=8192'):
        tsharding.check_divisible(cfg, 2, 3)


def test_rank_order_axis_groups_and_batch_rows_equal_the_reference():
    jm = jmesh.make_mesh(2, 2, 2)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    order = [d.id for d in jax.devices()]
    shape = tmesh.MeshShape(2, 2, 2)
    for rank, dev_id in enumerate(order):
        assert shape.coords(rank) == tuple(
            int(i) for i in np.argwhere(ids == dev_id)[0])
    rank_of = {dev_id: r for r, dev_id in enumerate(order)}
    as_ranks = np.vectorize(rank_of.get)(ids)
    assert shape.axis_groups('tp') == as_ranks.reshape(-1, 2).tolist()
    assert shape.axis_groups('fsdp') == as_ranks.transpose(
        0, 2, 1).reshape(-1, 2).tolist()
    assert shape.axis_groups('dp') == as_ranks.transpose(
        1, 2, 0).reshape(-1, 2).tolist()
    assert shape.axis_groups('data') == as_ranks.transpose(
        2, 0, 1).reshape(2, -1).tolist()
    batch = np.arange(8 * 3, dtype=np.int32).reshape(8, 3)
    placed = jax.device_put(batch, jsharding.batch_sharding(jm))
    rows = {s.device.id: np.asarray(s.data)
            for s in placed.addressable_shards}
    for rank, dev_id in enumerate(order):
        mesh = tmesh.TrainMesh(shape=shape, rank=rank)
        got = tsharding.batch_rows({'t': torch.from_numpy(batch)}, mesh)
        np.testing.assert_array_equal(got['t'].numpy(), rows[dev_id])


def test_layout_functions_and_their_errors_equal_the_reference():
    n = len(jax.devices())
    for dp, fsdp, tp in ((2, 2, 2), (1, 8, 1), (8, 1, 1), (1, 4, 2)):
        assert tmesh.make_mesh(dp, fsdp, tp, n).shape == dict(
            jmesh.make_mesh(dp, fsdp, tp).shape)
    with pytest.raises(ValueError, match=r'mesh 3x1x1=3 != 8 devices'):
        tmesh.make_mesh(3, 1, 1, n)
    with pytest.raises(ValueError):
        jmesh.make_mesh(3, 1, 1)
    for tp in (None, 2, 8):
        assert tmesh.auto_mesh(n, tp=tp).shape == dict(
            jmesh.auto_mesh(tp=tp).shape)
    for fn in (lambda: tmesh.auto_mesh(n, tp=3),
               lambda: jmesh.auto_mesh(tp=3)):
        with pytest.raises(ValueError, match='tp=3 does not divide 8'):
            fn()
    for kw in ({}, dict(tp=2), dict(fsdp=2, tp=2)):
        assert tmesh.make_multislice_mesh(2, n, **kw).shape == dict(
            jmesh.make_multislice_mesh(2, **kw).shape)
    for kw, match in ((dict(tp=3), 'tp=3 must divide 4'),
                      (dict(fsdp=3, tp=1), r'fsdp=3 \* tp=1 != 4')):
        for fn in (lambda: tmesh.make_multislice_mesh(2, n, **kw),
                   lambda: jmesh.make_multislice_mesh(2, **kw)):
            with pytest.raises(ValueError, match=match):
                fn()
    with pytest.raises(ValueError, match='do not split into 3 slices'):
        tmesh.make_multislice_mesh(3, n)
    # mesh_from_slice's rule over hosts: tp = a host's devices.
    s = topology.parse_tpu('v5e-8')
    assert tmesh.mesh_from_hosts(s.num_hosts, s.chips_per_host).shape == \
        dict(jmesh.mesh_from_slice(s).shape)
    assert tmesh.mesh_from_hosts(1, 8, tp=2, dp=2).shape == dict(
        jmesh.mesh_from_slice(s, tp=2, dp=2).shape)
    s16 = topology.parse_tpu('v5e-16')
    for fn in (lambda: tmesh.mesh_from_hosts(s16.num_hosts,
                                             s16.chips_per_host, tp=3),
               lambda: jmesh.mesh_from_slice(s16, tp=3)):
        with pytest.raises(ValueError, match='tp=3 must divide 16'):
            fn()
    assert tmesh.mesh_from_hosts(2, 8).shape == {'dp': 1, 'fsdp': 2,
                                                 'tp': 8}
