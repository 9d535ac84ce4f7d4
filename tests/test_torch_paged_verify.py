"""The port's paged verify attention and run write vs the JAX reference.

- The plain verify version against JAX's ``paged_verify_attention`` run
  in interpret mode (as tests/unit_tests/test_infer_paged.py runs it on
  the CPU) and against JAX's reference, at that test's shapes (slots 4,
  hkv 2, group 4, hd 64, R 5, page 16; lengths across page and coverage
  edges): fp32, atol 2e-5 (online vs one-pass softmax; values O(1)).
- Query 0 of the plain verify equals the plain decode at lengths + 1
  (the property the kernels hold bitwise on the card).
- ``append_run_pages`` leaves page bytes identical to JAX's after the
  same run writes, the sink redirect past the table's coverage included.
- CPU wrappers run the plain version and launch nothing; the verify row
  count the CUDA kernel takes is checked.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from skypilot_tpu.ops import paged_attention as jpa
from skypilot_tpu_torch.ops import paged_attention as tpa

jax.config.update('jax_default_matmul_precision', 'highest')
torch.backends.cuda.matmul.allow_tf32 = False

ATOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _verify_inputs(seed=2, R=5, lengths=(13, 64, 1, 123)):
    rng = np.random.default_rng(seed)
    slots, hkv, group, hd = 4, 2, 4, 64
    page, P, maxp = 16, 32, 8
    q = rng.normal(size=(slots, R, hkv, group, hd)).astype(np.float32)
    k = rng.normal(size=(hkv, P, page, hd)).astype(np.float32)
    v = rng.normal(size=(hkv, P, page, hd)).astype(np.float32)
    ids = rng.permutation(np.arange(1, P))[:slots * maxp - slots]
    tables = np.zeros((slots, maxp), np.int32)
    tables.flat[:len(ids)] = ids
    return q, k, v, tables, np.asarray(lengths, np.int32)


@pytest.mark.parametrize('against', ['interpret_kernel', 'jax_reference'])
def test_verify_reference_matches_jax(against):
    """13+5 crosses a page, 64 starts a fresh one, 1 is nearly empty and
    123+5 reaches the table's last page (maxp * page = 128)."""
    args = _verify_inputs()
    jargs = [jnp.asarray(a) for a in args]
    if against == 'interpret_kernel':
        ref = jpa.paged_verify_attention(*jargs, interpret=True)
    else:
        ref = jpa.paged_verify_attention_reference(*jargs)
    out = tpa.paged_verify_attention_reference(*[_t(a) for a in args])
    assert out.dtype == torch.float32 and out.shape == (4, 5, 2, 4, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_verify_query0_is_decode_at_lengths_plus_one():
    q, k, v, tables, lengths = [_t(a) for a in _verify_inputs(
        3, R=4, lengths=(13, 64, 0, 100))]
    ver = tpa.paged_verify_attention_reference(q, k, v, tables, lengths)
    dec = tpa.paged_decode_attention_reference(q[:, 0], k, v, tables,
                                               lengths + 1)
    np.testing.assert_allclose(ver[:, 0].numpy(), dec.numpy(), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize('lengths', [(3, 7), (0, 5)])
def test_append_run_pages_byte_identical_to_jax(lengths):
    """Slot 0 at len 3: positions 3, 4, 5 land in page 3 row 3, then page
    4 rows 0 and 1. Slot 1 at len 7: position 7 is in its table column 1,
    which is the sink (0), and 8.. run past maxp * page, redirected to
    the sink too. (0, 5): slot 0 from an empty slot, slot 1 inside its
    second page."""
    hkv, hd, page, P, maxp, slots, R = 2, 8, 4, 6, 2, 2, 3
    tables = np.asarray([[3, 4], [5, 0]], np.int32)
    lengths = np.asarray(lengths, np.int32)
    rng = np.random.default_rng(6)
    kn = rng.normal(size=(slots, R, hkv, hd)).astype(np.float32)
    vn = rng.normal(size=(slots, R, hkv, hd)).astype(np.float32)
    jk = jnp.zeros((hkv, P, page, hd), jnp.float32)
    jv = jnp.zeros((hkv, P, page, hd), jnp.float32)
    jk, jv = jpa.append_run_pages(jk, jv, jnp.asarray(kn), jnp.asarray(vn),
                                  jnp.asarray(tables), jnp.asarray(lengths))
    tk = torch.zeros((hkv, P, page, hd))
    tv = torch.zeros((hkv, P, page, hd))
    out = tpa.append_run_pages(tk, tv, _t(kn), _t(vn), _t(tables),
                               _t(lengths))
    assert out[0] is tk and out[1] is tv    # updated in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if tuple(lengths) == (3, 7):
        np.testing.assert_array_equal(tk[:, 3, 3].numpy(), kn[0, 0])
        np.testing.assert_array_equal(tk[:, 4, 1].numpy(), kn[0, 2])
        assert tk[:, 0].abs().sum() > 0        # the sink took slot 1's run
        assert not tk[:, 5].any() and not tk[:, 1].any()


def test_cpu_verify_wrapper_runs_the_plain_version_and_launches_nothing():
    tpa.reset_launches()
    args = [_t(a) for a in _verify_inputs(4)]
    out = tpa.paged_verify_attention(*args)
    assert torch.equal(out, tpa.paged_verify_attention_reference(*args))
    assert not any(tpa.launches.values())


@pytest.mark.parametrize('r,group,ok', [(5, 4, True), (8, 8, True),
                                        (2, 1, True), (1, 4, True),
                                        (9, 1, False), (0, 4, False)])
def test_cuda_verify_row_count(r, group, ok):
    """R in 2..8 (spec_k 1..7) with R x group <= 64; R = 1 is decode."""
    if ok:
        tpa.check_cuda_shape(128, group, 64, r)
    else:
        with pytest.raises(ValueError, match='verify'):
            tpa.check_cuda_shape(128, group, 64, r)
