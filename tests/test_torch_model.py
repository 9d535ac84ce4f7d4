"""The port's paged prefill/decode forward vs the JAX reference.

Weights: ``llama.init_params(tiny, PRNGKey(0))`` carried across with
``params_from_jax``, so both sides compute the same function. The JAX
side's Pallas kernels run in interpret mode (its default on the CPU).
fp32 weights, activations and pages; logits agree to rtol/atol 1e-4
(fp32 matmuls summed in different orders by XLA and by PyTorch), and the
greedy tokens of 32+ decode steps are identical for prompts whose
lengths cross page (16) and chunk (32) boundaries, with an inactive slot
riding every decode step into the sink page. TF32 is off.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from skypilot_tpu.infer import model as jmodel
from skypilot_tpu.infer import paged_cache as jpc
from skypilot_tpu.infer import sampling as jsampling
from skypilot_tpu.models import llama as jllama
from skypilot_tpu_torch.infer import model as tmodel
from skypilot_tpu_torch.infer import paged_cache as tpc
from skypilot_tpu_torch.infer import sampling as tsampling
from skypilot_tpu_torch.models import llama as tllama

jax.config.update('jax_default_matmul_precision', 'highest')
torch.backends.cuda.matmul.allow_tf32 = False

pytestmark = pytest.mark.jax

TOL = 1e-4
PAGE, CHUNK, MAXP = 16, 32, 8


@pytest.fixture(scope='module')
def models():
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tllama.LlamaConfig.tiny(), tparams


def test_params_from_jax_layout(models):
    jcfg, jparams, tcfg, tparams = models
    assert tcfg == tllama.LlamaConfig(**{
        f: getattr(jcfg, f) for f in tllama.LlamaConfig.__dataclass_fields__})
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in flat_j:
        node = tparams
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    # The port's own init has the reference's layout and scales.
    own = tllama.init_params(tcfg, torch.Generator().manual_seed(0))
    assert (jax.tree.map(lambda a: a.shape, jparams)
            == jax.tree.map(lambda t: tuple(t.shape), own,
                            is_leaf=lambda x: isinstance(x, torch.Tensor)))
    std = own['layers']['wq'].std().item()
    assert abs(std - jcfg.dim ** -0.5) < 0.1 * jcfg.dim ** -0.5


def test_mlp_block_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    x = np.random.default_rng(0).normal(size=(2, 3, jcfg.dim)).astype(
        np.float32)
    jl = jax.tree.map(lambda a: a[1], jparams['layers'])
    ref = jllama.mlp_block(jcfg, jnp.asarray(x), jl)
    out = tllama.mlp_block(tcfg, torch.from_numpy(x),
                           tllama.layer_params(tparams, 1))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_paged_prefill_and_decode_match_jax(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(7)
    slots = 4                          # slot 3 stays inactive
    n_pages = 3 * MAXP + 1             # page 0 is the sink
    tables = np.zeros((slots, MAXP), np.int32)
    tables[:3] = rng.permutation(np.arange(1, n_pages)).reshape(3, MAXP)
    prompt_lens = {0: 5, 1: 33, 2: 50}
    prompts = {s: rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for s, n in prompt_lens.items()}
    L, hkv, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    jkv = jpc.init_paged_cache(L, slots, n_pages, PAGE, hkv, hd,
                               dtype=jnp.float32)
    tkv = tpc.init_paged_cache(L, slots, n_pages, PAGE, hkv, hd,
                               dtype=torch.float32)
    rope = tmodel.rope_tables(tcfg)
    jprefill = jax.jit(functools.partial(jmodel.paged_prefill_chunk, jcfg))
    jdecode = jax.jit(functools.partial(jmodel.paged_decode_step, jcfg))

    last = np.zeros((slots,), np.int32)
    for slot, toks in prompts.items():
        off = 0
        while off < len(toks):
            tl = min(CHUNK, len(toks) - off)
            bucket = PAGE if tl <= PAGE else CHUNK
            padded = np.zeros((bucket,), np.int32)
            padded[:tl] = toks[off:off + tl]
            jkv, jlogits = jprefill(
                jparams, jkv, jnp.int32(slot), jnp.asarray(tables[slot]),
                jnp.asarray(padded), jnp.int32(off), jnp.int32(tl))
            tkv, tlogits = tmodel.paged_prefill_chunk(
                tcfg, tparams, tkv, slot, torch.from_numpy(tables[slot]),
                torch.from_numpy(padded), off, tl, rope)
            np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                       rtol=TOL, atol=TOL,
                                       err_msg=f'slot {slot} off {off}')
            off += tl
        last[slot] = int(np.argmax(np.asarray(jlogits)))
        assert int(torch.argmax(tlogits)) == last[slot]
    np.testing.assert_array_equal(tkv.lengths.numpy(),
                                  np.asarray(jkv.lengths))

    active = np.array([True, True, True, False])
    jtok, ttok = jnp.asarray(last), torch.from_numpy(last.copy())
    jout, tout = [], []
    for step in range(34):
        jlogits, jkv = jdecode(jparams, jkv, jnp.asarray(tables), jtok,
                               jnp.asarray(active))
        tlogits, tkv = tmodel.paged_decode_step(
            tcfg, tparams, tkv, torch.from_numpy(tables), ttok, rope,
            torch.from_numpy(active))
        np.testing.assert_allclose(tlogits.numpy()[:3],
                                   np.asarray(jlogits)[:3], rtol=TOL,
                                   atol=TOL, err_msg=f'step {step}')
        jtok = jsampling.sample(jlogits, jax.random.PRNGKey(0),
                                jnp.zeros((slots,)))
        ttok = tsampling.sample(tlogits, None, torch.zeros(slots))
        jout.append(np.asarray(jtok)[:3])
        tout.append(ttok.numpy()[:3])
    np.testing.assert_array_equal(np.stack(tout), np.stack(jout))
    np.testing.assert_array_equal(tkv.lengths.numpy(),
                                  np.asarray(jkv.lengths))
    assert tkv.lengths[3].item() == 0   # inactive: never advanced
