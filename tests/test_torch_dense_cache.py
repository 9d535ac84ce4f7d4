"""The port's dense KV cache writes vs ``skypilot_tpu/infer/cache.py``.

The same seeded numpy K/V go through the JAX functions (layout ``[slots,
S, kv, hd]`` per layer) and the port's (``[hkv, slots, S, hd]``, compared
through a transpose). Writes copy values, so the tolerance is zero:
every row must be bitwise the reference's, including the reference's
meaning past the cache end (a one-token append at S or beyond lands on row
S - 1; a run keeps the values already there for its positions >= S), and
no write may touch another slot's rows.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from skypilot_tpu.infer import cache as jcache
from skypilot_tpu_torch.infer import cache as tcache

pytestmark = pytest.mark.jax

SLOTS, S, HKV, HD = 3, 32, 2, 4


def _layers(rng):
    """A filled layer (K, V) in the reference's layout, and the port's."""
    k = rng.normal(size=(SLOTS, S, HKV, HD)).astype(np.float32)
    v = rng.normal(size=(SLOTS, S, HKV, HD)).astype(np.float32)
    to_port = lambda a: torch.from_numpy(a.transpose(2, 0, 1, 3).copy())
    return (jnp.asarray(k), jnp.asarray(v)), (to_port(k), to_port(v))


def _same(port, ref):
    np.testing.assert_array_equal(port.numpy().transpose(1, 2, 0, 3),
                                  np.asarray(ref))


@pytest.mark.parametrize('positions', [[0, 7, 31], [31, 32, 40]],
                         ids=['inside', 'full-slot'])
def test_append_token_matches_reference(positions):
    rng = np.random.default_rng(0)
    (jk, jv), (tk, tv) = _layers(rng)
    new_k = rng.normal(size=(SLOTS, HKV, HD)).astype(np.float32)
    new_v = rng.normal(size=(SLOTS, HKV, HD)).astype(np.float32)
    pos = np.asarray(positions, np.int32)
    rk, rv = jcache.append_token(jk, jv, jnp.asarray(new_k),
                                 jnp.asarray(new_v), jnp.asarray(pos))
    before = tk.clone()
    tcache.append_token(tk, tv, torch.from_numpy(new_k),
                        torch.from_numpy(new_v), torch.from_numpy(pos))
    _same(tk, rk)
    _same(tv, rv)
    # Each slot changed in one row of its own (S - 1 when full).
    changed = (tk != before).any(dim=-1).any(dim=0)        # [slots, S]
    for s, p in enumerate(positions):
        assert changed[s].nonzero().flatten().tolist() == [min(p, S - 1)]


@pytest.mark.parametrize('starts', [[0, 10, 27], [29, 31, 33]],
                         ids=['inside', 'padded-past-end'])
def test_append_run_matches_reference(starts):
    rng = np.random.default_rng(1)
    R = 5
    (jk, jv), (tk, tv) = _layers(rng)
    new_k = rng.normal(size=(SLOTS, R, HKV, HD)).astype(np.float32)
    new_v = rng.normal(size=(SLOTS, R, HKV, HD)).astype(np.float32)
    pos = np.asarray(starts, np.int32)
    rk, rv = jcache.append_run(jk, jv, jnp.asarray(new_k),
                               jnp.asarray(new_v), jnp.asarray(pos))
    before = tk.clone()
    tcache.append_run(tk, tv, torch.from_numpy(new_k),
                      torch.from_numpy(new_v), torch.from_numpy(pos))
    _same(tk, rk)
    _same(tv, rv)
    changed = (tk != before).any(dim=-1).any(dim=0)
    for s, start in enumerate(starts):
        rows = changed[s].nonzero().flatten().tolist()
        assert rows == list(range(min(start, S), min(start + R, S)))


@pytest.mark.parametrize('slot,offset', [(1, 16), (2, 24)],
                         ids=['inside', 'clamped-start'])
def test_write_chunk_matches_dynamic_update_slice(slot, offset):
    """A chunk lands where the reference's ``dynamic_update_slice`` puts it
    (its start clamped so the chunk ends at S), from host integers and from
    0-d tensors alike."""
    rng = np.random.default_rng(2)
    C = 16
    (jk, jv), (tk, tv) = _layers(rng)
    new = rng.normal(size=(C, HKV, HD)).astype(np.float32)
    rk = jax.lax.dynamic_update_slice(jk, jnp.asarray(new)[None],
                                      (slot, offset, 0, 0))
    tk2, tv2 = tk.clone(), tv.clone()
    tcache.write_chunk(tk, tv, torch.from_numpy(new), torch.from_numpy(new),
                       slot, offset)
    tcache.write_chunk(tk2, tv2, torch.from_numpy(new),
                       torch.from_numpy(new), torch.tensor(slot),
                       torch.tensor(offset, dtype=torch.int32))
    _same(tk, rk)
    assert torch.equal(tk, tk2) and torch.equal(tv, tv2)


def test_free_slot_and_page_view():
    cache = tcache.init_cache(2, SLOTS, S, HKV, HD, dtype=torch.float32,
                              page=8)
    ref = jcache.init_cache(2, SLOTS, S, HKV, HD, dtype=jnp.float32)
    cache.lengths[:] = torch.tensor([5, 9, 3], dtype=torch.int32)
    ref = jcache.KVCache(k=ref.k, v=ref.v,
                         lengths=jnp.asarray([5, 9, 3], jnp.int32))
    np.testing.assert_array_equal(
        tcache.free_slot(cache, 1).lengths.numpy(),
        np.asarray(jcache.free_slot(ref, 1).lengths))
    # Slot s owns pages s * S / page .. (s + 1) * S / page - 1 of the view.
    assert cache.tables.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7],
                                     [8, 9, 10, 11]]
    cache.k[1, :, 2, 9] = 7.0
    kp, _ = tcache.page_view(cache, 1)
    assert kp.shape == (HKV, SLOTS * S // 8, 8, HD)
    assert (kp[:, int(cache.tables[2, 1]), 1] == 7.0).all()
    assert tcache.table_row(cache, torch.tensor(2)).tolist() == [8, 9, 10, 11]
    assert tcache.dense_page(2048, 256) == 64
    assert tcache.dense_page(128, 16) == 16
    assert tcache.dense_page(64, 8) == 8
