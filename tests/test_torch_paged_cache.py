"""The port's host-side PageAllocator copy vs the JAX package's.

One scripted sequence of extend / free (plus the attach, cow and shrink
calls the copy carries along) runs on both allocators; after every call
the tables, free counts, refcounts, return values and ``version`` must be
identical. The device halves (init_paged_cache, free_slot, copy_page) are
checked for shape and effect.
"""
import numpy as np
import torch

from skypilot_tpu.infer import paged_cache as jpc
from skypilot_tpu_torch.infer import paged_cache as tpc

SCRIPT = [
    ('extend', 0, 20),     # 2 pages of 16
    ('extend', 1, 64),     # 4 pages
    ('extend', 0, 20),     # already covered: no-op, version unchanged
    ('extend', 2, 16 * 9),  # more than the pool holds: refused whole
    ('extend', 0, 33),     # grows by one page
    ('free', 1),
    ('extend', 2, 40),     # reuses the freed pages (stack order)
    ('attach', 1, 'pages_of_0'),
    ('cow', 1, 0),
    ('shrink', 0, 17),
    ('extend', 1, 16 * 9),  # beyond the per-slot ceiling: refused
    ('free', 0),
    ('free', 2),
    ('free', 1),
    ('free', 1),           # freeing an empty slot: no-op
]


def _apply(alloc, op):
    name, slot, arg = (op + (None,))[:3]
    if name == 'extend':
        return alloc.extend(slot, arg)
    if name == 'free':
        return alloc.free(slot)
    if name == 'attach':
        return alloc.attach(slot, alloc.owned_pages(0))
    if name == 'cow':
        return alloc.cow(slot, arg)
    if name == 'shrink':
        return alloc.shrink(slot, arg)
    raise AssertionError(name)


def _state(alloc):
    return (alloc.table().tolist(), alloc.free_pages, alloc.version,
            [alloc.refcount(p) for p in range(alloc.n_pages)],
            [alloc.owned_pages(s) for s in range(3)])


def test_allocator_matches_jax_over_a_scripted_sequence():
    args = dict(n_pages=12, page_size=16, n_slots=3, max_pages_per_slot=8)
    ja = jpc.PageAllocator(**args)
    ta = tpc.PageAllocator(**args)
    assert _state(ta) == _state(ja)
    for op in SCRIPT:
        assert _apply(ta, op) == _apply(ja, op), op
        assert _state(ta) == _state(ja), op
    # Page 0, the garbage sink, was never handed out.
    assert ta.refcount(0) == 0 and ta.free_pages == 11


def test_device_halves():
    cache = tpc.init_paged_cache(2, 3, 5, 4, 2, 8)
    assert tuple(cache.k_pages.shape) == (2, 2, 5, 4, 8)
    assert cache.k_pages.dtype == torch.bfloat16
    assert cache.lengths.dtype == torch.int32
    assert (cache.n_pages, cache.page_size) == (5, 4)
    cache.k_pages[:, :, 3] = 1.5
    cache.v_pages[:, :, 3] = -2.0
    tpc.copy_page(cache, 3, 1)
    assert torch.equal(cache.k_pages[:, :, 1], cache.k_pages[:, :, 3])
    assert torch.equal(cache.v_pages[:, :, 1], cache.v_pages[:, :, 3])
    cache.lengths[:] = torch.tensor([7, 9, 11], dtype=torch.int32)
    tpc.free_slot(cache, 1)
    np.testing.assert_array_equal(cache.lengths.numpy(), [7, 0, 11])
