"""The port's ring attention (``ops/ring_attention.py``) and its
``collectives.ppermute`` against the JAX ring (``shard_map`` over a
4-device ``('sp',)`` mesh of the conftest's CPU devices) on the same
inputs, made from a numpy seed, in fp32.

sp 4 as 4 ``gloo`` ranks (``torch_parallel_ranks.ring_rank``), causal and
not, 4/4 and 4/2 heads, both implementations (the plain loop and the
Function on the flash operators, whose CPU implementations are the plain
blockwise versions): the outputs within the reference's own 2e-5 against
dense attention, and the gradients of q, k and v against ``jax.vjp`` of
the JAX ring (the reference checks only that they are finite). The flash
implementation calls each operator once a block it does not skip: rank
``r`` ``r + 1`` times under the causal mask, 4 times without it.
"""
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import torch_parallel_ranks as pranks
import torch_tp_ranks as ranks
from skypilot_tpu.ops import ring_attention as jring
from skypilot_tpu.parallel import shard_map
from skypilot_tpu_torch.ops import attention
from skypilot_tpu_torch.ops import ring_attention as tring

pytestmark = pytest.mark.jax

SP = 4
B, S, D = 2, SP * 16, 32
# The reference's bound for the output (test_ring_matches_dense); the
# gradients sum more terms in other orders.
OUT_TOL = 2e-5
GRAD_TOL = 1e-4
CASES = pranks.RING_CASES


def _key(causal, hq, hkv):
    return f'{int(causal)}_{hq}_{hkv}'


def _jax_ring(causal, q, k, v, ct):
    mesh = Mesh(np.array(jax.devices()[:SP]), ('sp',))
    spec = P(None, None, 'sp', None)
    fn = jax.jit(shard_map(
        lambda q_, k_, v_: jring.ring_attention(q_, k_, v_, axis_name='sp',
                                                causal=causal),
        mesh=mesh, in_specs=(spec,) * 3, out_specs=spec))
    with jax.default_matmul_precision('float32'):
        out, vjp = jax.vjp(fn, *(jnp.asarray(t) for t in (q, k, v)))
        grads = vjp(jnp.asarray(ct))
    return [np.asarray(t) for t in (out, *grads)]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The 4 ranks' results, shards concatenated along the sequence, and
    the JAX ring's (out, dq, dk, dv) for every case."""
    tmp = tmp_path_factory.mktemp('ring')
    rng = np.random.default_rng(0)
    data = {}
    for causal, hq, hkv in CASES:
        key = _key(causal, hq, hkv)
        for name, h in (('q', hq), ('k', hkv), ('v', hkv), ('ct', hq)):
            data[f'{name}_{key}'] = rng.standard_normal(
                (B, h, S, D)).astype(np.float32)
    np.savez(tmp / 'ring.npz', **data)
    procs = ranks.start(pranks.ring_rank, SP,
                        (str(tmp / 'ring.npz'), str(tmp / 'ring{rank}.npz')))
    want = {}
    for causal, hq, hkv in CASES:
        key = _key(causal, hq, hkv)
        want[key] = _jax_ring(causal, *(data[f'{n}_{key}']
                                        for n in ('q', 'k', 'v', 'ct')))
    for p in procs:
        p.join(300)
    assert [p.exitcode for p in procs] == [0] * SP
    got = [dict(np.load(tmp / f'ring{r}.npz')) for r in range(SP)]
    return data, got, want


@pytest.mark.parametrize('impl', list(pranks.RING_IMPLS))
@pytest.mark.parametrize('causal,hq,hkv', CASES)
def test_ring_matches_the_jax_ring(runs, impl, causal, hq, hkv):
    data, got, want = runs
    key = _key(causal, hq, hkv)
    for i, name in enumerate(('out', 'dq', 'dk', 'dv')):
        whole = np.concatenate([g[f'{name}_{impl}_{key}'] for g in got],
                               axis=2)
        tol = OUT_TOL if name == 'out' else GRAD_TOL
        np.testing.assert_allclose(whole, want[key][i], atol=tol, rtol=tol,
                                   err_msg=f'{name} {impl} {key}')
    # The reference's own check: the JAX ring against dense attention.
    dense = attention.dense_attention(
        *(torch.from_numpy(data[f'{n}_{key}']) for n in ('q', 'k', 'v')),
        causal=causal).numpy()
    np.testing.assert_allclose(want[key][0], dense, atol=OUT_TOL,
                               rtol=OUT_TOL)


@pytest.mark.parametrize('causal', [True, False])
def test_flash_ring_skips_the_masked_blocks(runs, causal):
    _, got, _ = runs
    key = _key(causal, 4, 2)
    for r, g in enumerate(got):
        want = r + 1 if causal else SP
        assert list(g[f'calls_flash_{key}']) == [want] * 3, (r, causal)
        assert list(g[f'calls_reference_{key}']) == [0] * 3


@pytest.mark.parametrize('causal', [True, False])
def test_one_rank_ring_is_flash_attention(causal):
    """Without a group the ring is one block: the flash operators once
    each, and the plain ring equals dense attention."""
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((1, 4, 32, 16), generator=gen)
               for _ in range(3))
    k, v = k[:, :2], v[:, :2]
    attention.reset_launches()
    got = tring.ring_attention(q, k, v, None, causal=causal)
    assert attention.op_calls['flash_fwd'] == 1
    want = attention.dense_attention(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, atol=OUT_TOL, rtol=OUT_TOL)
    torch.testing.assert_close(
        tring.ring_attention_reference(q, k, v, None, causal=causal), want,
        atol=OUT_TOL, rtol=OUT_TOL)
