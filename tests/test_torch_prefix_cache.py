"""The port's shared-prefix KV cache against the JAX package's, on the CPU.

Host side: one seeded trace of allocator and radix-tree operations
(extend, attach, match, peek, donate, evict, alloc_pages + insert_remote,
cow, shrink, free) runs on the JAX ``PrefixCache`` over the JAX
``PageAllocator`` and on the port's copies; every returned page id, every
refcount, the free count, the block tables, ``stats()`` and the wire
index snapshots must be identical after every operation.

Engine side, the cases of ``tests/unit_tests/test_infer_prefix.py`` on
the port (tiny model, the JAX init converted through numpy): greedy
tokens with the cache on equal the cache off and the JAX engine with
``prefix_cache=True`` over the preempting workload submitted twice, at
depth 1 and 0, fused on and off, speculation on (an oracle drafter);
the cache adds no step program; pages are conserved at idle; a
preempted request re-matches its own donated prefix; eviction relieves
pressure without preemption; a forced shared frontier page is
copy-on-written; a matched offset's bucket never overshoots the cache;
an attach whose chunk defers rolls back; a submit storm conserves pages.
Every engine run also holds the mechanical gate: each page the tree
holds keeps, to the end of the run, the bytes it had when it was donated
or imported (an inactive lane's garbage write into a cached page would
break it even where no token shows it).
"""
import numpy as np
import pytest

import jax
import torch

from skypilot_tpu.infer import engine as jengine
from skypilot_tpu.infer import paged_cache as jpc
from skypilot_tpu.infer import prefix_cache as jprefix
from skypilot_tpu.models import llama as jllama
from skypilot_tpu_torch.infer import engine as tengine
from skypilot_tpu_torch.infer import paged_cache as tpc
from skypilot_tpu_torch.infer import prefix_cache as tprefix
from skypilot_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.jax

KW = dict(n_slots=3, max_seq_len=128, prefill_buckets=(16, 32),
          prefill_chunk=32, page_size=16, n_pages=13)
# The mixed-length + preemption workload (12 usable pages of 16 tokens
# for about 3 x 66), submitted twice so the second wave hits what the
# first donated.
PROMPTS = [[11] * 60, [23] * 60, [37] * 60, [5, 17, 101, 7], [9, 8, 7, 6, 5]]
WORKLOAD = PROMPTS + PROMPTS
NEW = 6


# ---------- host side: one trace on both packages ------------------------
def _tree_state(al, tree):
    return (al.free_pages, [al.refcount(p) for p in range(al.n_pages)],
            al.table().tolist(), al.used_tokens_capacity(), tree.stats(),
            tree.index_snapshot(-1), tree.index_snapshot(tree.index_gen - 2))


def _trace(seed, ops=400):
    """[(op, args)] over 4 slots, pages of 4 tokens, a pool of 25, token
    ids from a 3-letter alphabet (prefixes overlap often)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(ops):
        op = rng.choice(['fill', 'fill', 'donate', 'free', 'evict',
                         'import', 'cow', 'peek', 'shrink'])
        seq = [int(t) for t in rng.integers(1, 4, size=rng.integers(1, 30))]
        out.append((str(op), int(rng.integers(0, 4)), seq,
                    int(rng.integers(0, 40)), bool(rng.integers(0, 2))))
    return out


def _run_trace(pc_lib, prefix_lib, trace):
    al = pc_lib.PageAllocator(n_pages=25, page_size=4, n_slots=4,
                              max_pages_per_slot=8)
    tree = prefix_lib.PrefixCache(al)
    seqs = {}
    log = []
    for op, slot, seq, k, flag in trace:
        res = None
        if op == 'fill' and slot not in seqs:
            pages, matched = tree.match(seq)
            al.attach(slot, pages)
            ok = al.extend(slot, len(seq))
            res = (list(map(int, pages)), matched, ok)
            if ok:
                seqs[slot] = seq
            else:
                al.free(slot)
        elif op == 'donate' and slot in seqs:
            res = tree.donate(seqs.pop(slot)[:k], slot)
        elif op == 'free' and slot in seqs:
            seqs.pop(slot)
            al.free(slot)
        elif op == 'evict':
            res = tree.evict(k % 6)
        elif op == 'import':
            full = seq[:len(seq) // 4 * 4]
            _, have = tree.peek(full, whole=True)
            need = len(full) // 4 - have // 4
            new = al.alloc_pages(need) if need > 0 else None
            if new is not None:
                res = (list(map(int, new)), tree.insert_remote(
                    full, [None] * (have // 4) + new))
        elif op == 'cow' and slot in seqs and al.pages_of(slot):
            pair = al.cow(slot, k % al.pages_of(slot))
            res = None if pair is None else tuple(map(int, pair))
        elif op == 'peek':
            pages, n = tree.peek(seq, whole=flag)
            res = (list(map(int, pages)), n)
        elif op == 'shrink' and slot in seqs:
            res = al.shrink(slot, k % (len(seqs[slot]) + 1))
            seqs[slot] = seqs[slot][:k % (len(seqs[slot]) + 1)]
        log.append((op, res, _tree_state(al, tree)))
    for slot in list(seqs):
        tree.donate(seqs.pop(slot), slot)
    log.append(('evict-all', tree.evict(al.n_pages), _tree_state(al, tree)))
    return log


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_allocator_and_tree_trace_identical_to_jax(seed):
    trace = _trace(seed)
    got = _run_trace(tpc, tprefix, trace)
    want = _run_trace(jpc, jprefix, trace)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f'op {i} ({trace[i][0] if i < len(trace) else ""})'
    stats = got[-2][2][4]
    assert stats['prefix_hits'] > 0 and stats['prefix_evictions'] > 0
    assert got[-1][2][0] == 24, 'the trace leaked pages'


def test_copy_page_duplicates_values_and_scales_in_place():
    for dtype in (torch.float32, torch.int8):
        cache = tpc.init_paged_cache(2, 2, 5, 4, 2, 8, dtype=dtype)
        k_ptr = cache.k_pages.data_ptr()
        cache.k_pages[:, :, 2] = 7
        cache.v_pages[:, :, 2] = 3
        if cache.k_scales is not None:
            cache.k_scales[:, :, 2] = 0.5
        tpc.copy_page(cache, 2, 4)
        assert cache.k_pages.data_ptr() == k_ptr
        assert (cache.k_pages[:, :, 4] == 7).all()
        assert (cache.v_pages[:, :, 4] == 3).all()
        assert (cache.k_pages[:, :, 1] == 0).all()
        if cache.k_scales is not None:
            assert (cache.k_scales[:, :, 4] == 0.5).all()


# ---------- engine ----------------------------------------------------------
class TreeGuard:
    """Snapshots each page the tree takes (donated or imported) and holds
    every page still in the tree to those bytes."""

    def __init__(self, eng):
        self.eng, self.snap = eng, {}
        tree = eng.prefix
        for name in ('donate', 'insert_remote'):
            orig = getattr(tree, name)

            def wrapped(*a, _orig=orig, **kw):
                out = _orig(*a, **kw)
                self._take()
                return out
            setattr(tree, name, wrapped)

    def _nodes(self):
        stack = list(self.eng.prefix._root.children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def _bytes(self, pid):
        c = self.eng.cache
        return [t[:, :, pid].clone() for t in
                (c.k_pages, c.v_pages, c.k_scales, c.v_scales)
                if t is not None]

    def _take(self):
        for node in self._nodes():
            if id(node) not in self.snap:
                self.snap[id(node)] = (node, self._bytes(node.page_id))

    def check(self):
        nodes = list(self._nodes())
        for node in nodes:
            _, want = self.snap[id(node)]
            for a, b in zip(self._bytes(node.page_id), want):
                assert torch.equal(a, b), f'cached page {node.page_id} changed'
        return len(nodes)


class OracleDrafter:
    """Proposes each known prompt's speculation-off continuation, off by
    one at draft index 1 for the prompts in ``wrong``."""

    def __init__(self, prompts, outputs, wrong=()):
        self.known = [(list(p), list(o)) for p, o in zip(prompts, outputs)]
        self.wrong = {tuple(p) for p in wrong}

    def propose(self, context, k, memo=None):
        del memo
        for prompt, out in self.known:
            if list(context[:len(prompt)]) == prompt:
                draft = out[len(context) - len(prompt):][:k]
                if tuple(prompt) in self.wrong and len(draft) > 1:
                    draft[1] = (draft[1] + 1) % 256
                return draft
        return []


def _outputs(reqs):
    return [r.output_tokens for r in reqs]


def _conserved(eng):
    al = eng.allocator
    cached = eng.prefix.cached_pages if eng.prefix is not None else 0
    return (al.free_pages + cached == al.n_pages - 1
            and all(al.refcount(p) in (0, 1) for p in range(1, al.n_pages)))


@pytest.fixture(scope='module')
def params():
    cfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, jparams, tllama.params_from_jax(
        jax.tree.map(np.asarray, jparams))


def _port(tparams, guard=True, **kw):
    eng = tengine.InferenceEngine(
        tllama.LlamaConfig.tiny(), tparams,
        tengine.EngineConfig(**{**KW, 'paged': True, **kw}), device='cpu')
    if guard and eng.prefix is not None:
        eng.guard = TreeGuard(eng)
    return eng


def _jax(params, **kw):
    cfg, jparams, _ = params
    return jengine.InferenceEngine(
        cfg, jparams, jengine.EngineConfig(paged=True, **{**KW, **kw}))


@pytest.fixture(scope='module')
def runs(params):
    """The port off and on, and the JAX engine on, over WORKLOAD at depth
    1 and then (the same engines after set_pipeline_depth) at depth 0."""
    _, _, tparams = params
    off, on = _port(tparams), _port(tparams, prefix_cache=True)
    jon = _jax(params, prefix_cache=True, pipeline_depth=1)
    out = {}
    for depth in (1, 0):
        for name, eng in (('off', off), ('on', on), ('jax', jon)):
            eng.set_pipeline_depth(depth)
            out[(name, depth)] = _outputs(eng.generate(WORKLOAD, NEW))
            if name == 'on':
                out[('metrics', depth)] = on.metrics()
            if name == 'jax':
                out[('jmetrics', depth)] = jon.metrics()
    return off, on, jon, out


@pytest.mark.parametrize('depth', [1, 0])
def test_greedy_cache_on_equals_off_and_jax(runs, depth):
    _, on, _, out = runs
    assert out[('on', depth)] == out[('off', depth)]
    assert out[('on', depth)] == out[('jax', depth)]
    m, jm = out[('metrics', depth)], out[('jmetrics', depth)]
    assert m['preemptions'] >= 1, 'the workload never preempted'
    assert m['prefix_hits'] >= 1, 'the workload never hit the cache'
    for key in ('prefix_hits', 'prefix_misses', 'prefix_tokens_saved',
                'prefix_cached_pages', 'prefix_evictions', 'preemptions',
                'decode_steps', 'pages_free'):
        assert m[key] == jm[key], key
    assert on.guard.check() > 0


def test_prefix_cache_adds_no_step_program(runs):
    off, on, _, _ = runs
    counts = on.compiled_counts()
    assert counts == {**off.compiled_counts(), 'cow': 0}
    on.generate(PROMPTS, NEW)
    assert on.compiled_counts() == counts
    assert on.guard.check() > 0


def test_pages_conserved_and_metrics_at_idle(runs):
    _, on, _, _ = runs
    assert _conserved(on)
    m = on.metrics()
    for key in ('prefix_hit_rate', 'prefix_tokens_saved',
                'prefix_cached_pages', 'prefix_evictions', 'prefix_hits',
                'prefix_misses', 'prefix_indexed_pages'):
        assert key in m, key
    assert 0.0 <= m['prefix_hit_rate'] <= 1.0
    assert m['prefix_tokens_saved'] >= on.prefix.page
    assert m['kv_transfers_total'] == 0 and m['kv_transfer_p99_s'] is None
    snap = on.kv_index_snapshot(-1)
    assert snap is None or snap['page'] == 16


def test_repeat_prompt_hits_and_stamps_ttft(params):
    _, _, tparams = params
    on = _port(tparams, prefix_cache=True)
    prompt = [91] * 33                      # 2 full pages + 1
    [first] = on.generate([prompt], 4)
    [again] = on.generate([prompt], 4)
    assert first.cached_tokens == 0 and again.cached_tokens == 32
    assert again.output_tokens == first.output_tokens
    assert again.ttft is not None and again.ttft > 0
    assert on.kv_index_snapshot(-1)['full'], 'the index advertises nothing'
    assert on.guard.check() == 2


def test_preempted_request_rematches_own_prefix(params):
    _, _, tparams = params
    prompts = [[41] * 60, [43] * 60, [47] * 60]
    on = _port(tparams, prefix_cache=True)
    got = _outputs(on.generate(prompts, NEW))
    je = _jax(params, prefix_cache=True)
    assert got == _outputs(je.generate(prompts, NEW))
    m = on.metrics()
    assert m['preemptions'] >= 1
    assert on.prefix.hits >= m['preemptions']
    assert (on.prefix.hits, m['preemptions']) == (je.prefix.hits,
                                                  je.metrics()['preemptions'])
    assert all(len(o) == NEW for o in got)
    assert _conserved(on)
    assert on.guard.check() > 0


def test_eviction_under_pressure_without_preemption(params):
    _, _, tparams = params
    on = _port(tparams, prefix_cache=True)
    je = _jax(params, prefix_cache=True)
    for seed in (3, 5, 7, 11, 13):
        [r] = on.generate([[seed] * 60], NEW)
        [w] = je.generate([[seed] * 60], NEW)
        assert r.output_tokens == w.output_tokens
        assert len(r.output_tokens) == NEW
    m = on.metrics()
    assert m['prefix_evictions'] >= 1
    assert m['prefix_evictions'] == je.metrics()['prefix_evictions']
    assert m['preemptions'] == 0
    assert _conserved(on)
    assert on.guard.check() > 0


def test_forced_shared_frontier_page_is_cowed(params):
    _, _, tparams = params
    on = _port(tparams, prefix_cache=True)
    al = on.allocator
    k_ptr = on.cache.k_pages.data_ptr()
    assert al.extend(0, 20)                 # 2 pages
    old = al.owned_pages(0)
    al.incref(old[1])                       # a tree reference, simulated
    on._attached_slots.add(0)
    on.cache.k_pages[:, :, old[1]] = 5.0
    assert on._unshare_write_range(0, 17, 20)
    new = al.owned_pages(0)
    assert new[0] == old[0] and new[1] != old[1]
    assert al.refcount(old[1]) == 1 and al.refcount(new[1]) == 1
    assert (on.cache.k_pages[:, :, new[1]] == 5.0).all()
    assert on.cache.k_pages.data_ptr() == k_ptr, 'the pool was rebound'
    al.free(0)
    al.decref(old[1])
    assert al.free_pages == al.n_pages - 1


def test_matched_offset_bucket_never_overshoots(params):
    """Page 16, cap 64, max_seq 128: a match at 80 with 40 left rounds to
    bucket 64 -> 144 unless clamped."""
    _, _, tparams = params
    kw = dict(n_slots=2, max_seq_len=128, prefill_buckets=(16, 32, 64),
              prefill_chunk=64, n_pages=None)
    on = _port(tparams, prefix_cache=True, **kw)
    off = _port(tparams, **kw)
    head = [73] * 80
    tail = [(i * 11 + 3) % 250 for i in range(40)]
    on.generate([head], 4)
    [got] = on.generate([head + tail], NEW)
    [want] = off.generate([head + tail], NEW)
    [jwant] = _jax(params, prefix_cache=True, **kw).generate(
        [head + tail], NEW)
    assert got.cached_tokens == 80
    assert got.finish_reason != 'cache_full'
    assert got.output_tokens == want.output_tokens == jwant.output_tokens
    assert on.metrics()['preemptions'] == 0
    assert on.guard.check() > 0


def test_attach_rolls_back_when_the_chunk_defers(params):
    """A matching request attaches its cached prefix but its first chunk
    cannot extend (every free page taken, every cached page pinned by its
    own attach): the attach rolls back before the defer, and the tokens
    of it and of a later consumer of the prefix equal the cache off's."""
    _, _, tparams = params
    on = _port(tparams, prefix_cache=True)
    oracle = _port(tparams)
    head = [55] * 80
    b_prompt, c_prompt = head + [1, 2, 3, 4], head + [9, 8, 7]
    on.generate([head], 4)
    assert on.prefix.cached_pages == 5
    a = on.submit([66] * 100, max_new_tokens=24)
    while 100 not in (int(x) for x in on._slot_len):
        on.step()
    b = on.submit(b_prompt, max_new_tokens=6)
    hits = on.prefix.hits
    on.step()
    # B matched, could not extend, and rolled back: it holds a slot with
    # no page, at offset 0, and its hit is uncounted until the retry.
    slot = on._slots.index(b)
    assert on.allocator.pages_of(slot) == 0 and on._prefilling[slot] == 0
    assert slot not in on._attached_slots and on.prefix.hits == hits
    on.run_until_idle()
    assert on.prefix.hits > hits
    [c] = on.generate([c_prompt], 6)
    for got, (prompt, n) in ((a, ([66] * 100, 24)), (b, (b_prompt, 6)),
                             (c, (c_prompt, 6))):
        [want] = oracle.generate([prompt], n)
        assert got.output_tokens == want.output_tokens
    assert _conserved(on)
    assert on.guard.check() > 0


def test_submit_storm_conserves_pages(params):
    _, _, tparams = params
    rng = np.random.default_rng(42)
    on = _port(tparams, prefix_cache=True)
    off = _port(tparams)
    base = [int(x) for x in rng.integers(1, 250, size=64)]
    for _ in range(6):
        prompts = [base[:int(rng.integers(4, 64))]
                   + [int(x) for x in rng.integers(1, 250, size=4)]
                   for _ in range(3)]
        new = int(rng.integers(1, 7))
        reqs = on.generate(prompts, new)
        assert _outputs(reqs) == _outputs(off.generate(prompts, new))
        assert all(r.done for r in reqs) and _conserved(on)
    assert on.guard.check() > 0
    on.prefix.evict(on.allocator.n_pages)
    assert on.prefix.cached_pages == 0
    assert on.allocator.free_pages == on.allocator.n_pages - 1


@pytest.mark.parametrize('depth', [1, 0])
def test_speculation_and_fused_with_the_cache_equal_the_cache_off(
        params, runs, depth):
    """Speculation on (an oracle drafter, wrong at index 1 for half the
    prompts: the verify runs write over attached prefixes after their
    draft range is made private) and fused mixed steps, cache on, give
    the cache-off tokens (the JAX engine's, above)."""
    _, _, tparams = params
    want = runs[3][('off', depth)]
    spec = _port(tparams, prefix_cache=True, spec_k=4, pipeline_depth=depth)
    spec._drafter = OracleDrafter(WORKLOAD, want, wrong=PROMPTS[::2])
    assert _outputs(spec.generate(WORKLOAD, NEW)) == want
    m = spec.metrics()
    assert m['spec_accepted_tokens'] >= 1 and m['prefix_hits'] >= 1
    fused = _port(tparams, prefix_cache=True, fused_prefill=True,
                  pipeline_depth=depth)
    assert _outputs(fused.generate(WORKLOAD, NEW)) == want
    assert fused.metrics()['fused_steps'] >= 1
    assert fused.metrics()['prefix_hits'] >= 1
    for eng in (spec, fused):
        assert _conserved(eng)
        assert eng.guard.check() > 0
