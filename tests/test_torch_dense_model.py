"""The port's dense steps (``prefill_chunk``, ``decode_step``,
``verify_step``, ``mixed_step``) vs the JAX reference's
``skypilot_tpu/infer/model.py``.

The reference attends with fp32 einsums over the whole static cache and a
length mask; the port runs the paged kernels' plain versions over the
dense cache's page view and its identity table. Weights:
``llama.init_params(tiny, PRNGKey(0))`` carried across with
``params_from_jax``; fp32 weights, activations and cache. Logits and every
cache row agree to rtol/atol 1e-4 (fp32 sums in different orders, as in
``test_torch_model.py``); lengths are equal. The workload: a 5-token
prompt in a 16-token bucket, a 58-token prompt in a 32-token chunk plus a
26-token tail (its slot ends 3 rows short of the cache end), decode steps
with an inactive slot riding along, a verify run padded past the cache
end, and a mixed step. TF32 is off.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from skypilot_tpu.infer import cache as jcache
from skypilot_tpu.infer import model as jmodel
from skypilot_tpu.models import llama as jllama
from skypilot_tpu_torch.infer import cache as tcache
from skypilot_tpu_torch.infer import model as tmodel
from skypilot_tpu_torch.models import llama as tllama

jax.config.update('jax_default_matmul_precision', 'highest')
torch.backends.cuda.matmul.allow_tf32 = False

pytestmark = pytest.mark.jax

TOL = 1e-4
SLOTS, S, PAGE, CHUNK = 3, 64, 16, 32


def _close(port, ref, msg=''):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=TOL,
                               atol=TOL, err_msg=msg)


def _same_cache(tkv, jkv):
    # Port [L, hkv, slots, S, hd] vs reference [L, slots, S, kv, hd].
    _close(tkv.k.numpy().transpose(0, 2, 3, 1, 4), jkv.k, 'k')
    _close(tkv.v.numpy().transpose(0, 2, 3, 1, 4), jkv.v, 'v')
    np.testing.assert_array_equal(tkv.lengths.numpy(),
                                  np.asarray(jkv.lengths))


@pytest.fixture(scope='module')
def steps():
    """Both sides after the prompts and the decode steps (shared by the
    verify and mixed cases), with the per-step comparisons made."""
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.LlamaConfig.tiny()
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams))
    rope = tmodel.rope_tables(tcfg)
    L, hkv, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    jkv = jcache.init_cache(L, SLOTS, S, hkv, hd, dtype=jnp.float32)
    tkv = tcache.init_cache(L, SLOTS, S, hkv, hd, dtype=torch.float32,
                            page=PAGE)
    rng = np.random.default_rng(3)
    prompts = {0: rng.integers(0, jcfg.vocab_size, 5),
               1: rng.integers(0, jcfg.vocab_size, 58)}
    jprefill = jax.jit(functools.partial(jmodel.prefill_chunk, jcfg))
    last = np.zeros((SLOTS,), np.int32)
    for slot, toks in prompts.items():
        off = 0
        while off < len(toks):
            tl = min(CHUNK, len(toks) - off)
            bucket = 16 if tl <= 16 else CHUNK
            padded = np.zeros((bucket,), np.int32)
            padded[:tl] = toks[off:off + tl]
            jkv, jlogits = jprefill(jparams, jkv, jnp.int32(slot),
                                    jnp.asarray(padded), jnp.int32(off),
                                    jnp.int32(tl))
            tkv, tlogits = tmodel.prefill_chunk(
                tcfg, tparams, tkv, slot, torch.from_numpy(padded), off, tl,
                rope)
            _close(tlogits, jlogits, f'prefill slot {slot} off {off}')
            off += tl
        last[slot] = int(np.argmax(np.asarray(jlogits)))
    _same_cache(tkv, jkv)

    jdecode = jax.jit(functools.partial(jmodel.decode_step, jcfg))
    active = np.array([True, True, False])
    for step in range(3):
        jlogits, jkv = jdecode(jparams, jkv, jnp.asarray(last),
                               jnp.asarray(active))
        tlogits, tkv = tmodel.decode_step(
            tcfg, tparams, tkv, torch.from_numpy(last), rope,
            torch.from_numpy(active))
        _close(tlogits.numpy()[:2], np.asarray(jlogits)[:2],
               f'decode step {step}')
        last = np.where(active, np.argmax(np.asarray(jlogits), -1),
                        last).astype(np.int32)
    _same_cache(tkv, jkv)
    return dict(jcfg=jcfg, jparams=jparams, tcfg=tcfg, tparams=tparams,
                rope=rope, jkv=jkv, tkv=tkv, last=last, rng=rng)


def test_prefill_and_decode_match_jax(steps):
    # Slot 1 ends 3 rows short of the cache end: 58 prompt + 3 decoded.
    assert steps['tkv'].lengths.tolist() == [8, 61, 0]


def test_verify_step_matches_jax_padded_past_end(steps):
    """R = 4: slot 1's run reaches position 64, one past the cache end
    (its last lane keeps the row already there); the inactive slot's lanes
    write at its own frontier."""
    st = steps
    jkv, tkv = st['jkv'], tcache.KVCache(
        k=st['tkv'].k.clone(), v=st['tkv'].v.clone(),
        lengths=st['tkv'].lengths.clone(), tables=st['tkv'].tables)
    drafts = st['rng'].integers(0, st['jcfg'].vocab_size, (SLOTS, 3))
    tokens = np.concatenate([st['last'][:, None], drafts], 1).astype(
        np.int32)
    jlogits, jkv = jax.jit(functools.partial(jmodel.verify_step,
                                             st['jcfg']))(
        st['jparams'], jkv, jnp.asarray(tokens))
    tlogits, tkv = tmodel.verify_step(st['tcfg'], st['tparams'], tkv,
                                      torch.from_numpy(tokens), st['rope'])
    assert tlogits.shape == (SLOTS, 4, st['jcfg'].vocab_size)
    _close(tlogits.numpy()[:2], np.asarray(jlogits)[:2], 'verify')
    _same_cache(tkv, jkv)


def test_mixed_step_matches_jax(steps):
    """One 16-token chunk of a new prompt into slot 2 and a decode step of
    slots 0 and 1 in one call."""
    st = steps
    jkv, tkv = st['jkv'], tcache.KVCache(
        k=st['tkv'].k.clone(), v=st['tkv'].v.clone(),
        lengths=st['tkv'].lengths.clone(), tables=st['tkv'].tables)
    chunk = np.zeros((16,), np.int32)
    chunk[:11] = st['rng'].integers(0, st['jcfg'].vocab_size, 11)
    active = np.array([True, True, False])
    jc, jd, jkv = jax.jit(functools.partial(jmodel.mixed_step, st['jcfg']))(
        st['jparams'], jkv, jnp.int32(2), jnp.asarray(chunk), jnp.int32(0),
        jnp.int32(11), jnp.asarray(st['last']), jnp.asarray(active))
    tc, td, tkv = tmodel.mixed_step(
        st['tcfg'], st['tparams'], tkv, 2, torch.from_numpy(chunk), 0, 11,
        torch.from_numpy(st['last']), st['rope'], torch.from_numpy(active))
    _close(tc, jc, 'mixed chunk')
    _close(td.numpy()[:2], np.asarray(jd)[:2], 'mixed decode')
    _same_cache(tkv, jkv)
    assert tkv.lengths.tolist() == [9, 62, 11]
