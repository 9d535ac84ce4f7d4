"""KV prefix transfer on the port, and across the two packages, on the CPU.

The reference's disaggregation gate (``tests/unit_tests/
test_disagg_identity.py``) inside the port: int8 pages exported by one
port engine and imported by another give greedy tokens bitwise those of a
local recompute at depth 1 and 0 (the lead request starts from the
imported pages: ``cached_tokens == 32``), speculation on too (an oracle
drafter), and the imported pages still hold the donor's bytes at the end.

Across packages: a blob the JAX engine exported, imported by the port
engine, gives the tokens the JAX engine gives importing the same blob;
and a blob the port exported, imported by the JAX engine, gives the
tokens the port gives importing it. (The JAX engine runs without
speculation here: its speculation lanes do not fire under this jax.)

The export is read-only on the donor (refcounts, free pages and cache
statistics unchanged), an import grafts only past the puller's own
boundary, bf16 pools land within the reference's pinned tolerance (half
a scale step per row) and hold exactly the dequantized wire values, and
a page-size or geometry mismatch, a corrupt payload or an uncached
prefix degrade as the reference's do.
"""
import numpy as np
import pytest

import jax
import torch

from skypilot_tpu.infer import engine as jengine
from skypilot_tpu.infer import kv_wire as jwire
from skypilot_tpu.models import llama as jllama
from skypilot_tpu_torch.infer import engine as tengine
from skypilot_tpu_torch.infer import kv_wire as twire
from skypilot_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.jax

KW = dict(n_slots=3, max_seq_len=128, prefill_buckets=(16, 32),
          prefill_chunk=32, page_size=16, n_pages=13, prefix_cache=True)
# 40 tokens: 2 full pages (the transferable prefix) + an 8-token tail.
PREFIX = [(i * 7 + 3) % 250 for i in range(40)]
WORKLOAD = [PREFIX + [101, 55, 3, 9], [9, 8, 7, 6, 5],
            PREFIX + [200, 201, 202, 203, 204, 205]]
NEW = 8


class OracleDrafter:
    def __init__(self, prompts, outputs):
        self.known = [(list(p), list(o)) for p, o in zip(prompts, outputs)]

    def propose(self, context, k, memo=None):
        del memo
        for prompt, out in self.known:
            if list(context[:len(prompt)]) == prompt:
                return out[len(context) - len(prompt):][:k]
        return []


@pytest.fixture(scope='module')
def params():
    cfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, jparams, tllama.params_from_jax(
        jax.tree.map(np.asarray, jparams))


def _port(params, kv_dtype='int8', **kw):
    return tengine.InferenceEngine(
        tllama.LlamaConfig.tiny(), params[2],
        tengine.EngineConfig(**{**KW, 'paged': True, 'kv_dtype': kv_dtype,
                                **kw}),
        device='cpu')


def _jax(params, kv_dtype='int8', **kw):
    cfg, jparams, _ = params
    return jengine.InferenceEngine(
        cfg, jparams, jengine.EngineConfig(
            paged=True, **{**KW, 'kv_dtype': kv_dtype, **kw}))


def _outputs(reqs):
    return [r.output_tokens for r in reqs]


def _pool(eng, pages, name):
    return np.asarray(getattr(eng.cache, name)[:, :, pages])


@pytest.fixture(scope='module')
def port_blob(params):
    donor = _port(params)
    donor.generate([PREFIX], 4)
    blob = donor._kv_export(PREFIX)
    assert blob is not None
    return blob


@pytest.fixture(scope='module')
def jax_blob(params):
    donor = _jax(params)
    donor.generate([PREFIX], 4)
    blob = donor._kv_export(PREFIX)
    assert blob is not None
    return blob


@pytest.mark.parametrize('spec', [False, True], ids=['spec-off', 'spec-on'])
def test_import_is_bitwise_a_local_recompute(params, port_blob, spec):
    oracle, puller = _port(params), _port(params)
    assert puller._kv_import(port_blob) == 2
    blk = twire.unpack(port_blob)
    for depth in (1, 0):
        want = _outputs(oracle.generate(WORKLOAD, NEW))
        if spec:
            puller.set_spec_k(4)
            puller._drafter = OracleDrafter(WORKLOAD, want)
        puller.set_pipeline_depth(depth)
        oracle.set_pipeline_depth(depth)
        got = puller.generate(WORKLOAD, NEW)
        assert _outputs(got) == want, f'depth {depth}'
        if depth == 1:
            assert got[0].cached_tokens == 32
        if spec:
            assert puller.metrics()['spec_accepted_tokens'] > 0
    pages, n = puller.prefix.peek(PREFIX, whole=True)
    assert n == 32
    for name, wire in (('k_pages', blk.k), ('v_pages', blk.v),
                       ('k_scales', blk.k_scales),
                       ('v_scales', blk.v_scales)):
        np.testing.assert_array_equal(_pool(puller, pages, name), wire)
    m = puller.metrics()
    assert m['kv_transfers_total'] == 0   # _kv_import called directly
    al = puller.allocator
    assert al.free_pages + puller.prefix.cached_pages == al.n_pages - 1


def test_jax_blob_imported_by_the_port_continues_as_jax(params, jax_blob):
    port, jaxe = _port(params), _jax(params)
    assert port._kv_import(jax_blob) == jaxe._kv_import(jax_blob) == 2
    for depth in (1, 0):
        port.set_pipeline_depth(depth)
        jaxe.set_pipeline_depth(depth)
        got = port.generate(WORKLOAD, NEW)
        assert _outputs(got) == _outputs(jaxe.generate(WORKLOAD, NEW))
        if depth == 1:
            assert got[0].cached_tokens == 32
    blk = jwire.unpack(jax_blob)
    pages, _ = port.prefix.peek(PREFIX, whole=True)
    np.testing.assert_array_equal(_pool(port, pages, 'k_pages'), blk.k)
    # The port re-exports the JAX donor's pages to the identical blob.
    assert port._kv_export(PREFIX) == jax_blob


def test_port_blob_imported_by_jax_continues_as_the_port(params, port_blob):
    port, jaxe = _port(params), _jax(params)
    assert jaxe._kv_import(port_blob) == port._kv_import(port_blob) == 2
    got = jaxe.generate(WORKLOAD, NEW)
    assert _outputs(got) == _outputs(port.generate(WORKLOAD, NEW))
    assert got[0].cached_tokens == 32
    assert jaxe._kv_export(PREFIX) == port_blob


def test_export_is_read_only_and_reimports_to_the_same_blob(params,
                                                           port_blob):
    donor = _port(params)
    donor.generate([PREFIX], 4)
    pages, matched = donor.prefix.peek(PREFIX, whole=True)
    assert matched == 32 and len(pages) == 2
    al = donor.allocator
    al.attach(0, pages)                     # shared with a live slot
    refs = [al.refcount(p) for p in pages]
    free, hits, misses = al.free_pages, donor.prefix.hits, \
        donor.prefix.misses
    blob = donor._kv_export(PREFIX)
    assert blob == port_blob
    assert [al.refcount(p) for p in pages] == refs == [2, 2]
    assert al.free_pages == free
    assert (donor.prefix.hits, donor.prefix.misses) == (hits, misses)
    al.free(0)
    blk = twire.unpack(blob)
    assert blk.tokens == PREFIX[:32]
    np.testing.assert_array_equal(blk.k, _pool(donor, pages, 'k_pages'))
    np.testing.assert_array_equal(blk.v_scales,
                                  _pool(donor, pages, 'v_scales'))
    puller = _port(params)
    assert puller._kv_import(blob) == 2
    assert puller._kv_export(PREFIX) == blob


def test_import_grafts_only_past_the_local_boundary(params, port_blob):
    puller = _port(params)
    puller.generate([PREFIX[:20]], 4)       # caches page 1
    assert puller.prefix.peek(PREFIX, whole=True)[1] == 16
    free = puller.allocator.free_pages
    assert puller._kv_import(port_blob) == 1
    assert puller.allocator.free_pages == free - 1
    assert puller.prefix.peek(PREFIX, whole=True)[1] == 32
    assert puller._kv_import(port_blob) == 0


def test_bf16_round_trip_within_the_pinned_tolerance(params):
    donor = _port(params, kv_dtype='bfloat16')
    donor.generate([PREFIX], 4)
    pages, _ = donor.prefix.peek(PREFIX, whole=True)
    blob = donor._kv_export(PREFIX)
    blk = twire.unpack(blob)
    want = donor.cache.k_pages[:, :, pages].float().numpy()
    deq = twire.dequantize_rows_np(blk.k, blk.k_scales)
    assert (np.abs(deq - want) <= blk.k_scales[..., None] * 0.5
            + 1e-6).all()
    # The blob is what the JAX package's quantizer makes of these rows.
    q, s = jwire.quantize_rows_np(want)
    np.testing.assert_array_equal(q, blk.k)
    np.testing.assert_array_equal(s, blk.k_scales)
    puller = _port(params, kv_dtype='bfloat16')
    assert puller._kv_import(blob) == 2
    got, n = puller.prefix.peek(PREFIX, whole=True)
    assert n == 32
    land = puller.cache.k_pages[:, :, got]
    assert land.dtype == torch.bfloat16
    assert torch.equal(land, torch.from_numpy(deq).to(torch.bfloat16))
    # And the JAX bf16 engine lands the same bits from the same blob.
    jaxe = _jax(params, kv_dtype='bfloat16')
    assert jaxe._kv_import(blob) == 2
    jgot, _ = jaxe.prefix.peek(PREFIX, whole=True)
    np.testing.assert_array_equal(
        np.asarray(jaxe.cache.k_pages[:, :, jgot], np.float32),
        land.float().numpy())


def test_mismatch_corruption_and_uncached_prefix_degrade(params, port_blob):
    puller = _port(params)
    L, HKV, HD = 2, 2, 16
    k8 = np.ones((L, HKV, 1, 8, HD), np.int8)
    s8 = np.ones((L, HKV, 1, 8), np.float32)
    with pytest.raises(twire.WireError, match='page size'):
        puller._kv_import(twire.pack(list(range(8)), 8, k8, k8, s8, s8))
    k2 = np.zeros((L, HKV, 1, 16, 4), np.int8)
    s2 = np.ones((L, HKV, 1, 16), np.float32)
    with pytest.raises(twire.WireError, match='geometry'):
        puller._kv_import(twire.pack(list(range(16)), 16, k2, k2, s2, s2))
    bad = bytearray(port_blob)
    bad[-1] ^= 0x01
    free = puller.allocator.free_pages
    with pytest.raises(twire.WireError):
        puller._kv_import(bytes(bad))
    assert puller.allocator.free_pages == free
    assert puller._kv_import(port_blob) == 2
    donor = _port(params)
    assert donor._kv_export([9] * 40) is None
    donor.generate([PREFIX], 4)
    assert donor._kv_export([9] * 40) is None
    off = _port(params, prefix_cache=False)
    with pytest.raises(ValueError):
        off._kv_export(PREFIX)
    assert off.kv_index_snapshot() is None and not off.kv_index_armed()


def test_jobs_serviced_on_the_step_count_transfers(params, port_blob):
    """The job queue the server uses: an export and an import serviced by
    the next step, counted with their bytes and durations; a corrupt
    import is a counted failure handed its error; an uncached export is
    None and counts nothing."""
    eng = _port(params)
    ok = eng.request_kv_import(port_blob, fetch_s=0.25)
    bad = eng.request_kv_import(port_blob[:-1] + b'\x00')
    miss = eng.request_kv_export([9] * 40)
    eng.step()
    assert ok.wait(0) and ok.result == 2 and ok.error is None
    assert bad.wait(0) and isinstance(bad.error, twire.WireError)
    assert miss.wait(0) and miss.result is None
    exp = eng.request_kv_export(PREFIX)
    eng.step()
    assert exp.result == port_blob
    m = eng.metrics()
    assert m['kv_transfers_total'] == 2
    assert m['kv_transfer_bytes'] == 2 * len(port_blob)
    assert m['kv_transfer_failures'] == 1
    assert m['kv_transfer_p99_s'] >= 0.25
    snap = eng.kv_index_snapshot(-1)
    assert len(snap['full']) == 2 and snap['page'] == 16
    assert eng.kv_index_snapshot(snap['gen']) == {
        'gen': snap['gen'], 'crc': snap['crc'], 'page': 16, 'delta': []}
