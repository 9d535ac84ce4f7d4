"""Every count of ``perfbench/flops.py`` against a value worked out by
hand."""
from __future__ import annotations

import json

import pytest

from perfbench import flops, peaks, spec, weights
from perfbench.weights import Dims

SMALL = Dims(vocab=10, d=8, ffn=16, layers=2, hq=2, hkv=1, hd=4, eps=1e-5,
             theta=1e4)


def test_flash_forward_causal_keeps_half_the_pairs():
    # b 1, s 3: the queries see 1 + 2 + 3 = 6 keys; 4 hd operations a
    # key a head; Q, O (2 heads) and K, V (1 head) of 3 x 4 bf16, lse fp32.
    ops, nbytes = flops.flash_fwd_work(SMALL, 1, 3)
    assert ops == 4 * 2 * 4 * 6
    assert nbytes == 3 * 4 * 2 * (2 + 2 + 1 + 1) + 2 * 3 * 4


def test_flash_backward_is_four_products_without_recompute():
    ops, nbytes = flops.flash_bwd_work(SMALL, 2, 3)
    assert ops == 2 * flops.flash_fwd_work(SMALL, 2, 3)[0]
    # Q, O, dO, dQ (2 heads) and K, V, dK, dV (1 head), lse.
    assert nbytes == 2 * 3 * 4 * 2 * (4 * 2 + 4 * 1) + 2 * 2 * 3 * 4


def test_paged_prefill_at_an_offset():
    # 2 queries at offset 5 see 6 and 7 keys: 13.
    ops, nbytes = flops.paged_prefill_work(SMALL, 5, 2)
    assert ops == 4 * 2 * 4 * 13
    assert nbytes == 2 * 2 * 2 * 4 * 2 + 2 * 7 * 1 * 4 * 2


def test_decode_at_given_lengths():
    ops, nbytes = flops.paged_decode_work(SMALL, [3, 10])
    assert ops == 4 * 2 * 4 * 13
    assert nbytes == (2 * 2 * 4 * 2) * 2 + 2 * 13 * 1 * 4 * 2


def test_model_step_counts():
    per_layer = 8 * 4 * (2 * 2 + 2 * 1) + 3 * 8 * 16
    assert weights.matmul_params(SMALL) == 2 * per_layer + 8 * 10
    assert flops.layer_matmul_flops_per_token(SMALL) == 2 * 2 * per_layer
    assert flops.decode_token_flops(SMALL, 7) == (
        4 * per_layer + 2 * 8 * 10 + 4 * 2 * 4 * 2 * 7)
    # A chunk of 3 at offset 2: keys 3 + 4 + 5; the head once, at the end.
    assert flops.prefill_chunk_flops(SMALL, 2, 3, True) == (
        3 * 4 * per_layer + 4 * 2 * 4 * 2 * 12 + 2 * 8 * 10)
    assert flops.prefill_chunk_flops(SMALL, 2, 3, False) == (
        3 * 4 * per_layer + 4 * 2 * 4 * 2 * 12)
    fwd = 2 * 3 * (4 * per_layer + 2 * 8 * 10) + 2 * 4 * 2 * 4 * 2 * 6
    assert flops.train_step_flops(SMALL, 2, 3) == 3 * fwd


def test_chunks_follow_the_engine_cap():
    assert list(flops.prefill_chunks(600)) == [(0, 256), (256, 256),
                                               (512, 88)]
    assert list(flops.prefill_chunks(256)) == [(0, 256)]


@pytest.mark.parametrize('name,params', [
    ('mistral-7b-v0.3-replica', 7_248_023_552),
    ('mistral-7b-v0.3-ft-stage', 3_758_231_552),
])
def test_mistral_parameter_counts(name, params):
    with open(spec.HERE / 'configs' / f'{name}.json') as f:
        dims = Dims.of(json.load(f))
    total = sum(n for n in (
        _numel(shape) for _, shape, _, _ in weights.leaf_specs(dims)))
    assert total == params


def _numel(shape):
    n = 1
    for x in shape:
        n *= x
    return n


def test_bound_is_the_larger_of_compute_and_bandwidth():
    assert peaks.bound_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(989e12, 6.7e12) == pytest.approx(2.0)
