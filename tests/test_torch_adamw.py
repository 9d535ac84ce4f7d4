"""The AdamW update of one leaf (``ops/adamw.py``, ``csrc/adamw.cu``).

On the CPU: the wrapper takes the plain version and launches nothing,
``AdamW.update`` gives the bits of the eager loop it had before the
kernel (a copy of that loop is kept here), over every (param dtype, mu
dtype) pair that ``train.run`` and ``bench.py`` build, clip on and off,
at the first count (lr 0) and a later one; the wrapper's argument checks;
the train step hands the update contiguous leaves, as the kernel takes
them, and a mesh's gradient block comes back contiguous.

On the card (``-m chip``, skipped without CUDA): the kernel against the
plain version on CUDA tensors, bitwise, over the same pairs, clip on and
off, both counts, leaf lengths on and off the 16-byte vector, one
element, a stacked 3-D leaf, ZeRO-3 blocks of the mesh tests' shapes and
a leaf whose pointer is not 16-byte aligned; ``AdamW.update`` bitwise the
eager loop; the launch counter; a non-contiguous leaf refused.
"""
import itertools

import numpy as np
import pytest
import torch

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import adamw as adamw_lib
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.train import trainer

BF16, F32 = torch.bfloat16, torch.float32
# (param dtype, mu_dtype): the ft stage's bf16 params and moments,
# bench.py's bf16 params with mu_dtype 'bfloat16', fp32 params and
# moments, fp32 params with a bf16 first moment, bf16 params with an fp32
# one.
PAIRS = [(BF16, None), (BF16, 'bfloat16'), (F32, None), (F32, 'bfloat16'),
         (BF16, 'float32')]
PAIR_IDS = ['bf16', 'bf16-mu-bf16', 'fp32', 'fp32-mu-bf16', 'bf16-mu-fp32']


def _old_update(opt, grads, opt_state, params, g_norm=None):
    """``AdamW.update`` as it was before the kernel: the eager loop."""
    leaves = trainer._leaves(grads)
    if g_norm is None:
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in leaves))
    clip = not bool(g_norm < opt.grad_clip)
    count = int(opt_state['count'])
    count_inc = count + 1
    f32 = torch.float32
    bc1 = 1 - torch.tensor(opt.b1, dtype=f32) ** count_inc
    bc2 = 1 - torch.tensor(opt.b2, dtype=f32) ** count_inc
    step_size = torch.tensor(-opt.schedule(count), dtype=f32)
    for g, mu, nu, p in zip(leaves, trainer._leaves(opt_state['mu']),
                            trainer._leaves(opt_state['nu']),
                            trainer._leaves(params)):
        if clip:
            g = (g / g_norm.to(g.dtype)) * opt.grad_clip
        mu_new = (1 - opt.b1) * g + opt.b1 * mu
        nu.copy_((1 - opt.b2) * g ** 2 + opt.b2 * nu)
        mu_hat = mu_new / bc1.to(mu_new.dtype)
        nu_hat = nu / bc2.to(nu.dtype)
        u = mu_hat / (torch.sqrt(nu_hat) + opt.eps)
        u = u + opt.weight_decay * p
        u = step_size.to(u.dtype) * u
        mu.copy_(mu_new)
        p.copy_(p + u)
    opt_state['count'] = torch.tensor(count_inc, dtype=torch.int32)
    return g_norm


def _tree(shapes, dtype, mu_dtype, seed, device, g_scale):
    """(grads, opt_state, params) of seeded leaves: moments as a few
    steps leave them (nu >= 0, some zeros), params ~1."""
    rng = np.random.default_rng(seed)
    mu_t = llama.torch_dtype(mu_dtype) if mu_dtype else dtype

    def leaf(shape, scale, dt, positive=False):
        x = rng.standard_normal(shape).astype(np.float32) * scale
        if positive:
            x = np.abs(x)
        x.reshape(-1)[3::7] = 0.0
        return torch.from_numpy(x).to(device=device, dtype=dt)
    names = [f'w{i}' for i in range(len(shapes))]
    grads = {n: leaf(s, g_scale, dtype) for n, s in zip(names, shapes)}
    params = {n: leaf(s, 1.0, dtype) for n, s in zip(names, shapes)}
    state = {'count': torch.zeros((), dtype=torch.int32),
             'mu': {n: leaf(s, 1e-2, mu_t) for n, s in zip(names, shapes)},
             'nu': {n: leaf(s, 1e-4, dtype, True)
                    for n, s in zip(names, shapes)}}
    return grads, state, params


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone()


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def _assert_same_bits(a, b):
    a, b = _flat(a), _flat(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(-1).view(torch.int16 if x.dtype == BF16
                                           else torch.int32),
                           y.view(-1).view(torch.int16 if y.dtype == BF16
                                           else torch.int32))


def _scalars(opt, count):
    """The update's bias corrections and step size at ``count``, as
    ``AdamW.update`` makes them."""
    f32 = torch.float32
    bc1 = 1 - torch.tensor(opt.b1, dtype=f32) ** (count + 1)
    bc2 = 1 - torch.tensor(opt.b2, dtype=f32) ** (count + 1)
    return bc1, bc2, torch.tensor(-opt.schedule(count), dtype=f32)


def _hyper(opt):
    return dict(b1=opt.b1, b2=opt.b2, eps=opt.eps,
                weight_decay=opt.weight_decay, grad_clip=opt.grad_clip)


SHAPES = [(1,), (8,), (13,), (3, 40, 17), (2, 16, 32)]


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('pair', PAIRS, ids=PAIR_IDS)
def test_cpu_takes_plain_version_and_launches_nothing(pair):
    dtype, mu_dtype = pair
    opt = trainer.make_optimizer(warmup_steps=2, total_steps=10,
                                 mu_dtype=mu_dtype)
    grads, state, params = _tree([(5, 7)], dtype, mu_dtype, 1, 'cpu', 1.0)
    ref = _clone((state, params))
    bc1, bc2, step = _scalars(opt, 3)
    g_norm = torch.sqrt(torch.sum(grads['w0'] * grads['w0']))
    before = dict(adamw_lib.launches)
    adamw_lib.adamw_update(grads['w0'], state['mu']['w0'],
                           state['nu']['w0'], params['w0'], g_norm, True,
                           bc1, bc2, step, **_hyper(opt))
    adamw_lib.adamw_update_reference(
        grads['w0'], ref[0]['mu']['w0'], ref[0]['nu']['w0'],
        ref[1]['w0'], g_norm, True, bc1, bc2, step, **_hyper(opt))
    assert adamw_lib.launches == before
    _assert_same_bits((state['mu'], state['nu'], params),
                      (ref[0]['mu'], ref[0]['nu'], ref[1]))
    assert not torch.equal(params['w0'], _tree([(5, 7)], dtype, mu_dtype,
                                               1, 'cpu', 1.0)[2]['w0'])


def test_update_on_cpu_gives_the_eager_loops_bits():
    """Every dtype pair, clip on and off, the first count and a later
    one: ``AdamW.update`` against the loop it had before the kernel."""
    for (dtype, mu_dtype), clip, count in itertools.product(
            PAIRS, (True, False), (0, 150)):
        opt = trainer.make_optimizer(warmup_steps=100, total_steps=1000,
                                     mu_dtype=mu_dtype)
        # A gradient norm of ~50 clips at grad_clip 1; ~0.05 does not.
        grads, state, params = _tree(SHAPES, dtype, mu_dtype, 2, 'cpu',
                                     1.0 if clip else 1e-3)
        state['count'] = torch.tensor(count, dtype=torch.int32)
        old = _clone((state, params))
        n_new = opt.update(grads, state, params)
        n_old = _old_update(opt, grads, old[0], old[1])
        assert bool(n_new >= opt.grad_clip) == clip
        _assert_same_bits([n_new], [n_old])
        _assert_same_bits((state['mu'], state['nu'], params),
                          (old[0]['mu'], old[0]['nu'], old[1]))
        assert int(state['count']) == int(old[0]['count']) == count + 1
        fresh = _tree(SHAPES, dtype, mu_dtype, 2, 'cpu', 1.0)[2]
        # lr 0 at the first count leaves the params; a later count moves
        # them.
        same = [torch.equal(x, y) for x, y in zip(trainer._leaves(params),
                                                  trainer._leaves(fresh))]
        assert all(same) if count == 0 else not all(same)


def test_bench_counts_and_resets_the_update_launches():
    """``bench.py`` reads and zeroes the update's counter with the
    training kernels'."""
    from skypilot_tpu_torch import bench
    adamw_lib.launches['adamw_update'] = 7
    assert bench.kernel_launches()['adamw_update'] == 7
    bench.reset_launches()
    assert adamw_lib.launches == {'adamw_update': 0}


def test_update_on_cpu_with_a_mesh_norm_gives_the_eager_loops_bits():
    """A mesh hands the update the whole gradient's fp32 norm."""
    opt = trainer.make_optimizer(warmup_steps=2, total_steps=10)
    grads, state, params = _tree(SHAPES, BF16, None, 3, 'cpu', 1.0)
    state['count'] = torch.tensor(5, dtype=torch.int32)
    old = _clone((state, params))
    norm = torch.tensor(3.3, dtype=F32)
    opt.update(grads, state, params, norm)
    _old_update(opt, grads, old[0], old[1], norm)
    _assert_same_bits((state['mu'], state['nu'], params),
                      (old[0]['mu'], old[0]['nu'], old[1]))


@pytest.mark.parametrize('bad', ['mu_shape', 'nu_shape', 'p_shape',
                                 'g_dtype', 'nu_dtype'])
def test_wrapper_refuses_mismatched_leaves(bad):
    opt = trainer.make_optimizer()
    leaf = {k: torch.zeros(4, 6, dtype=BF16) for k in 'gmnp'}
    if bad.endswith('shape'):
        leaf[bad[0]] = torch.zeros(4, 5, dtype=BF16)
        err = ValueError
    else:
        leaf[bad[0]] = torch.zeros(4, 6, dtype=F32)
        err = TypeError
    bc1, bc2, step = _scalars(opt, 1)
    with pytest.raises(err, match='adamw_update'):
        adamw_lib.adamw_update(leaf['g'], leaf['m'], leaf['n'], leaf['p'],
                               None, False, bc1, bc2, step, **_hyper(opt))


def test_train_step_hands_the_update_contiguous_leaves(monkeypatch):
    """The kernel takes contiguous leaves only: every gradient, moment
    and parameter of a train step must reach the update contiguous."""
    seen = []
    real = adamw_lib.adamw_update

    def record(g, mu, nu, p, *args, **kwargs):
        seen.append(all(t.is_contiguous() for t in (g, mu, nu, p)))
        return real(g, mu, nu, p, *args, **kwargs)
    monkeypatch.setattr(adamw_lib, 'adamw_update', record)
    config = llama.LlamaConfig.tiny(dtype='bfloat16', remat=True)
    opt = trainer.make_optimizer(warmup_steps=1, total_steps=10)
    gen = torch.Generator().manual_seed(0)
    state = trainer.init_train_state(config, gen, opt)
    step = trainer.make_train_step(config, opt)
    batch = trainer.synthetic_batch(config, 2, 16, gen)
    step(state, batch)
    assert len(seen) == len(trainer._leaves(state.params)) and all(seen)


def test_mesh_gradient_block_comes_back_contiguous():
    """The embedding's fsdp block is cut on its axis 1: the
    reduce-scatter hands it back transposed, and ``reduce_grad`` makes it
    contiguous for the update."""
    g = torch.arange(12, dtype=F32).reshape(3, 4).t()
    out = sharding.reduce_grad(('embed',), g, mesh_lib.single_mesh())
    assert out.is_contiguous() and torch.equal(out, g)


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


# Leaf lengths: one element, 8 and 13 (on and off an 8-wide bf16 vector,
# 13 also off a 4-wide fp32 one), a length past several vectors of each
# unrolled pass with a ragged tail, a stacked 3-D leaf, and ZeRO-3 blocks
# of the tiny model at dp 2 x fsdp 2 x tp 2 as test_torch_train_mesh.py
# runs it (w_down's [2, 64, 16], the embedding's [128, 32]).
CARD_SHAPES = [(1,), (8,), (13,), (1_000_003,), (4, 33, 129), (2, 64, 16),
               (128, 32)]


@pytest.mark.chip
@pytest.mark.parametrize('count', [0, 150], ids=['count0', 'count150'])
@pytest.mark.parametrize('clip', [None, 1.0, 0.7],
                         ids=['noclip', 'clip1', 'clip0.7'])
@pytest.mark.parametrize('pair', PAIRS, ids=PAIR_IDS)
def test_kernel_is_bitwise_the_chain(cuda, pair, clip, count):
    dtype, mu_dtype = pair
    opt = trainer.make_optimizer(warmup_steps=100, total_steps=1000,
                                 mu_dtype=mu_dtype,
                                 grad_clip=clip or 1.0)
    bc1, bc2, step = _scalars(opt, count)
    for i, shape in enumerate(CARD_SHAPES):
        grads, state, params = _tree([shape], dtype, mu_dtype, 10 + i, cuda,
                                     1.0 if clip else 1e-4)
        ref = _clone((state, params))
        g = grads['w0']
        g_norm = torch.sqrt(torch.sum(g * g))
        before = adamw_lib.launches['adamw_update']
        adamw_lib.adamw_update(g, state['mu']['w0'], state['nu']['w0'],
                               params['w0'], g_norm, clip is not None,
                               bc1, bc2, step, **_hyper(opt))
        assert adamw_lib.launches['adamw_update'] == before + 1
        adamw_lib.adamw_update_reference(
            g, ref[0]['mu']['w0'], ref[0]['nu']['w0'], ref[1]['w0'],
            g_norm, clip is not None, bc1, bc2, step, **_hyper(opt))
        torch.cuda.synchronize()
        _assert_same_bits((state['mu'], state['nu'], params),
                          (ref[0]['mu'], ref[0]['nu'], ref[1]))
        if count == 0:
            fresh = _tree([shape], dtype, mu_dtype, 10 + i, cuda, 1.0)[2]
            assert torch.equal(params['w0'], fresh['w0'])


# Values at the edges of bf16 and fp32: zeros of both signs, bf16's
# smallest subnormal and normal, tiny and huge normals, bf16's largest
# finite value, infinities and NaN.
EDGES = [0.0, -0.0, 2.0 ** -133, -2.0 ** -133, 2.0 ** -126, 1e-30, -1e-30,
         1e-8, 3e-5, -3e-5, 1.0, -1.0, 1e30, 3.3e38, float('inf'),
         float('-inf'), float('nan')]


@pytest.mark.chip
@pytest.mark.parametrize('clip', [None, 1.0, 0.7],
                         ids=['noclip', 'clip1', 'clip0.7'])
@pytest.mark.parametrize('pair', PAIRS, ids=PAIR_IDS)
def test_kernel_is_bitwise_the_chain_at_edge_values(cuda, pair, clip):
    """Every combination of edge values in g, mu, nu and p (some leaves
    mixed with ordinary values), and a norm at the range's edges."""
    dtype, mu_dtype = pair
    mu_t = llama.torch_dtype(mu_dtype) if mu_dtype else dtype
    opt = trainer.make_optimizer(warmup_steps=1, total_steps=10,
                                 mu_dtype=mu_dtype, grad_clip=clip or 1.0)
    bc1, bc2, step = _scalars(opt, 5)
    k = len(EDGES)
    idx = np.indices((k, k, k, k)).reshape(4, -1)
    values = np.array(EDGES, dtype=np.float32)[idx]
    for norm in (3.0, 2.0 ** -126, 2.0 ** 126, 1e-38):
        leaf = [torch.from_numpy(values[i].copy()).to(cuda, dt)
                for i, dt in enumerate((dtype, mu_t, dtype, dtype))]
        ref = [t.clone() for t in leaf]
        g_norm = torch.tensor(norm, dtype=dtype, device=cuda)
        adamw_lib.adamw_update(*leaf, g_norm, clip is not None, bc1, bc2,
                               step, **_hyper(opt))
        adamw_lib.adamw_update_reference(*ref, g_norm, clip is not None,
                                         bc1, bc2, step, **_hyper(opt))
        _assert_same_bits(leaf, ref)


@pytest.mark.chip
@pytest.mark.parametrize('pair', PAIRS, ids=PAIR_IDS)
def test_kernel_takes_an_unaligned_leaf_bitwise(cuda, pair):
    """A contiguous leaf one element into its storage: the kernel's
    scalar loop takes all of it."""
    dtype, mu_dtype = pair
    opt = trainer.make_optimizer(warmup_steps=1, total_steps=10,
                                 mu_dtype=mu_dtype)
    bc1, bc2, step = _scalars(opt, 4)
    grads, state, params = _tree([(4097,)], dtype, mu_dtype, 30, cuda, 1.0)
    leaves = [grads['w0'], state['mu']['w0'], state['nu']['w0'],
              params['w0']]
    ref = [t.clone() for t in leaves]
    views = [t[1:] for t in leaves]
    assert all(v.is_contiguous() and v.data_ptr() % 16 for v in views)
    g_norm = torch.sqrt(torch.sum(views[0] * views[0]))
    adamw_lib.adamw_update(*views, g_norm, True, bc1, bc2, step,
                           **_hyper(opt))
    adamw_lib.adamw_update_reference(*[t[1:] for t in ref], g_norm, True,
                                     bc1, bc2, step, **_hyper(opt))
    _assert_same_bits(leaves, ref)


@pytest.mark.chip
@pytest.mark.parametrize('clip', [True, False], ids=['clip', 'noclip'])
@pytest.mark.parametrize('pair', PAIRS, ids=PAIR_IDS)
def test_update_on_the_card_is_bitwise_the_eager_loop(cuda, pair, clip):
    dtype, mu_dtype = pair
    opt = trainer.make_optimizer(warmup_steps=100, total_steps=1000,
                                 mu_dtype=mu_dtype)
    grads, state, params = _tree(CARD_SHAPES, dtype, mu_dtype, 40, cuda,
                                 1.0 if clip else 1e-4)
    state['count'] = torch.tensor(150, dtype=torch.int32)
    old = _clone((state, params))
    before = adamw_lib.launches['adamw_update']
    opt.update(grads, state, params)
    assert adamw_lib.launches['adamw_update'] == before + len(CARD_SHAPES)
    _old_update(opt, grads, old[0], old[1])
    _assert_same_bits((state['mu'], state['nu'], params),
                      (old[0]['mu'], old[0]['nu'], old[1]))


@pytest.mark.chip
def test_kernel_refuses_a_non_contiguous_leaf(cuda):
    opt = trainer.make_optimizer()
    bc1, bc2, step = _scalars(opt, 1)
    leaf = [torch.zeros(8, 6, dtype=BF16, device=cuda) for _ in range(4)]
    leaf[3] = torch.zeros(6, 8, dtype=BF16, device=cuda).t()
    before = adamw_lib.launches['adamw_update']
    with pytest.raises(ValueError, match='contiguous'):
        adamw_lib.adamw_update(*leaf, None, False, bc1, bc2, step,
                               **_hyper(opt))
    assert adamw_lib.launches['adamw_update'] == before
