"""The port's tensor parallelism (``parallel/``, ``EngineConfig.tp``)
against the JAX ``tp``=2 engine, on the tiny config.

- ``sharding.shard_params``' slices for ranks 0 and 1 equal the JAX
  ``tp``=2 engine's addressable shards exactly, bf16 (here fp32, the tiny
  config's dtype) and int8, every ``scale`` included.
- The port at ``tp`` 2, two ``gloo`` ranks spawned on the CPU and driven
  through the lockstep driver, gives the JAX ``tp``=2 engine's greedy
  tokens on the reference's workload (``tests/unit_tests/test_infer.py``
  ``test_tensor_parallel_matches_single_device``): plain, with
  ``quantize=True`` (against the JAX ``quantize=True``, ``tp``=2 engine)
  and with ``spec_k`` 3 under an oracle drafter (against the JAX plain
  tokens, which speculation leaves unchanged); the first chunk's logits
  match JAX's ``prefill_chunk`` over the ``tp``=2 engine's sharded params
  at ``TOL``.
- ``tp`` 3 raises the reference's ``must divide``; the paged cache at
  ``tp`` 2 raises as the reference's engine does.
- The sharded random init (bf16 and int8) equals the slices of the
  unsharded one, and every collective is the identity at world size 1.
"""
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_tp_ranks as ranks
from skypilot_tpu.infer import cache as jcache
from skypilot_tpu.infer import engine as jengine
from skypilot_tpu.infer import model as jmodel
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.ops import quant as jquant
from skypilot_tpu_torch.infer import engine as tengine
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.ops import quant as tquant
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel import mesh
from skypilot_tpu_torch.parallel import sharding

pytestmark = pytest.mark.jax

# fp32 logits, as the dense model's differential tests hold them.
TOL = 1e-4


def _jax_engine(jparams, **kw):
    return jengine.InferenceEngine(
        jllama.LlamaConfig.tiny(), jparams,
        jengine.EngineConfig(tp=2, **ranks.KW, **kw))


@pytest.fixture(scope='module')
def jparams():
    return jllama.init_params(jllama.LlamaConfig.tiny(),
                              jax.random.PRNGKey(0))


@pytest.fixture(scope='module')
def world2(jparams, tmp_path_factory):
    """The JAX tp=2 engines' tokens and first-chunk logits, and the port's
    from two spawned ranks."""
    out = {}
    for name, kw in (('plain', {}), ('quantize', dict(quantize=True))):
        eng = _jax_engine(jparams, **kw)
        out[name] = [r.output_tokens
                     for r in eng.generate(ranks.PROMPTS, ranks.NEW)]
        out[name + '_metrics'] = sorted(eng.metrics())
        if name == 'plain':
            cfg = jllama.LlamaConfig.tiny()
            kv = jcache.init_cache(cfg.n_layers, 1, 64, cfg.n_kv_heads,
                                   cfg.head_dim, dtype=jnp.float32)
            padded = np.zeros((8,), np.int32)
            padded[:4] = ranks.PROMPTS[0]
            _, logits = jax.jit(functools.partial(jmodel.prefill_chunk, cfg))(
                eng.params, kv, jnp.int32(0), jnp.asarray(padded),
                jnp.int32(0), jnp.int32(4))
            out['logits'] = np.asarray(logits)
    tmp = tmp_path_factory.mktemp('tp2')
    ranks.save_params(jax.tree.map(np.asarray, jparams), tmp / 'p.npz')
    codes = ranks.spawn(ranks.generate_rank, 2,
                        (str(tmp / 'p.npz'), str(tmp / 'out.json'),
                         out['plain']), timeout=120)
    assert codes == [0, 0], f'rank exit codes {codes}'
    return out, json.loads((tmp / 'out.json').read_text())


def _jax_leaves(tree, path=()):
    """(path, field, array) of every leaf of a JAX param tree, a
    QuantArray's q and scale as fields."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _jax_leaves(v, path + (k,))
    elif isinstance(tree, jquant.QuantArray):
        yield path, 'q', tree.q
        yield path, 'scale', tree.scale
    else:
        yield path, None, tree


def _port_leaf(tree, path, field):
    for key in path:
        tree = tree[key]
    return tree if field is None else getattr(tree, field)


@pytest.mark.parametrize('quantize', [False, True], ids=['bf16', 'int8'])
def test_shards_equal_jax_tp2_engine_shards(jparams, quantize):
    eng = _jax_engine(jparams, quantize=quantize)
    devices = list(eng.mesh.devices.ravel())
    whole = tllama.params_from_jax(jax.tree.map(np.asarray, jparams))
    if quantize:
        whole = tquant.quantize_params(whole)
    port = [sharding.shard_params(whole, rank, 2) for rank in range(2)]
    n = 0
    for path, field, arr in _jax_leaves(eng.params):
        for shard in arr.addressable_shards:
            rank = devices.index(shard.device)
            want = np.asarray(shard.data)
            got = _port_leaf(port[rank], path, field)
            if got.dtype == torch.bfloat16:
                got = got.view(torch.int16).numpy()
                want = want.view(np.int16)
            else:
                got = got.numpy()
            assert got.shape == want.shape, (path, field, rank)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f'{path} {field} {rank}')
            n += 1
    # Every leaf on both ranks (the int8 tree's q and scale apart).
    assert n == 2 * (12 + 9 * quantize)


@pytest.mark.parametrize('variant', ['plain', 'quantize', 'spec'])
def test_tp2_tokens_equal_jax_tp2_engine(world2, variant):
    jax_out, port = world2
    want = jax_out['quantize' if variant == 'quantize' else 'plain']
    assert port[variant] == want
    if variant == 'spec':
        # The oracle's drafts were accepted: verify steps really ran.
        assert port['spec_accepted'] > 0
    else:
        # Every key the JAX tp=2 engine emits.
        assert set(jax_out[variant + '_metrics']) <= set(
            port[variant + '_metrics'])


def test_tp2_first_chunk_logits_match_jax_tp2(world2):
    jax_out, port = world2
    np.testing.assert_allclose(np.asarray(port['logits']), jax_out['logits'],
                               rtol=TOL, atol=TOL)


def test_tp3_must_divide_and_paged_tp2_raises(jparams):
    cfg = tllama.LlamaConfig.tiny()
    whole = tllama.params_from_jax(jax.tree.map(np.asarray, jparams))
    with pytest.raises(ValueError, match='must divide'):
        tengine.InferenceEngine(cfg, whole, tengine.EngineConfig(
            tp=3, **ranks.KW), device='cpu')
    with pytest.raises(ValueError, match='paged KV is single-device'):
        tengine.InferenceEngine(cfg, whole, tengine.EngineConfig(
            tp=2, paged=True, page_size=8, **ranks.KW), device='cpu')
    # tp > 1 needs its group, and a tp set beside the group must be its
    # size.
    with pytest.raises(ValueError, match='process group'):
        tengine.InferenceEngine(cfg, whole, tengine.EngineConfig(
            tp=2, **ranks.KW), device='cpu')
    with pytest.raises(ValueError, match='the group has 1 ranks'):
        tengine.InferenceEngine(cfg, whole, tengine.EngineConfig(
            tp=2, **ranks.KW), device='cpu', group=mesh.single('cpu'))
    with pytest.raises(ValueError, match='must divide'):
        sharding.check_divisible(cfg, 3)


@pytest.mark.parametrize('quantize', [False, True], ids=['bf16', 'int8'])
def test_sharded_random_init_equals_unsharded_slices(quantize):
    cfg = tllama.LlamaConfig.tiny(dtype='bfloat16')

    def gen():
        g = torch.Generator()
        g.manual_seed(5)
        return g

    whole = tllama.init_params(cfg, gen())
    if quantize:
        whole = tquant.quantize_params(whole)
    for rank in range(2):
        if quantize:
            part = tquant.init_params_quantized(cfg, gen(), 'cpu', 2, rank)
        else:
            part = tengine.init_params_sharded(cfg, 2, rank, seed=5,
                                               device='cpu')
        _assert_same_tree(sharding.shard_params(whole, rank, 2), part)
    # The row-parallel scale stays whole; the column one splits.
    if quantize:
        assert part['layers']['wo'].scale.shape == (2, cfg.dim)
        assert part['layers']['wq'].scale.shape == (2, cfg.dim // 2)
        assert part['embed'].scale.shape == (cfg.vocab_size // 2,)


def _assert_same_tree(want, got):
    pairs = []
    sharding.map_tree(lambda p, leaf: pairs.append(
        (p, leaf, _port_leaf(got, p, None))), want)
    for path, a, b in pairs:
        if isinstance(a, tquant.QuantArray):
            assert torch.equal(a.q, b.q) and torch.equal(a.scale,
                                                         b.scale), path
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.mark.parametrize('quantize', [False, True], ids=['bf16', 'int8'])
def test_rank_weights_equal_slices_of_the_whole_tree(tmp_path, quantize):
    """The server's per-rank loader, from a checkpoint and from the seed:
    each rank's leaves are bitwise the slices of the whole tree that the
    single-rank replica loads (int8: quantized whole, then sliced, so a
    row-parallel weight keeps its whole-axis scale)."""
    from skypilot_tpu_torch.infer import server as tserver
    from skypilot_tpu_torch.train import checkpoint as ckpt
    cfg = tllama.LlamaConfig.tiny()
    ckpt.CheckpointManager(str(tmp_path)).save(0, tllama.init_params(
        cfg, torch.Generator().manual_seed(7)))
    flags = ['--port', '0', '--device', 'cpu'] + (
        ['--quantize'] if quantize else [])
    for source in ([], ['--checkpoint', str(tmp_path)]):
        args = tserver.parse_args(flags + source)
        whole = tserver.load_params(args, cfg)
        for rank in range(2):
            part = tserver.load_rank_params(
                args, cfg, mesh.TPGroup(rank=rank, world=2))
            _assert_same_tree(sharding.shard_params(whole, rank, 2), part)


def test_world_size_one_collectives_are_identity_and_layout_rules():
    x = torch.arange(6.0).reshape(2, 3)
    one = mesh.single('cpu')
    for group in (None, one):
        assert collectives.all_reduce_sum(x, group) is x
        assert collectives.all_gather_last(x, group) is x
        assert collectives.broadcast_bytes(b'abc', group) == b'abc'
        assert collectives.all_gather_u32(-1, group) == [0xFFFFFFFF]
    assert one.capturable and not one.staged
    assert mesh.check_layout(8, 1, 8) == 8
    assert mesh.check_layout(8, 2, 4) == 4
    with pytest.raises(ValueError, match='only 4 devices'):
        mesh.check_layout(8, 1, 4)
    with pytest.raises(ValueError, match='multiple of the process count'):
        mesh.check_layout(6, 4, 2)
    assert mesh.default_backend('cpu') == 'gloo'
    assert mesh.default_backend('cuda:1') == 'nccl'
