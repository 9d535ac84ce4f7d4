"""The traffic generators: deterministic per seed, the stated lengths and
rates, the same work for every seed in another order."""
from __future__ import annotations

import collections

import pytest

from conftest import load_cell
from perfbench import traffic
from perfbench.traffic import closed, open as open_lib, steps


def _mix(name):
    cell = load_cell(name)
    return dict(cell.traffic, **cell.params.get('traffic', {}))


def _first_block(params, seed, seconds, vocab=32768):
    n = int(round(params['rate_per_s'] * seconds))
    it = open_lib.requests(params, seed, seconds, vocab)
    return [next(it) for _ in range(n)]


def test_open_deterministic_per_seed():
    params = _mix('serve-chat')
    a = _first_block(params, 2 ** 31 + 7, 10)
    b = _first_block(params, 2 ** 31 + 7, 10)
    c = _first_block(params, 2 ** 31 + 8, 10)
    assert a == b
    assert [q['prompt'] for q in a] != [q['prompt'] for q in c]


def test_open_lengths_rate_and_same_work_every_seed():
    params = _mix('serve-chat')
    seconds = 30
    blocks = [_first_block(params, s, seconds) for s in (1, 99, 2 ** 32)]
    n = int(round(params['rate_per_s'] * seconds))
    for block in blocks:
        assert len(block) == n and all(q['counted'] for q in block)
        assert block[0]['at'] == 0.0 and block[-1]['at'] < seconds
        for q in block:
            assert 64 <= len(q['prompt']) <= 1536
            assert 1 <= q['max_new'] <= 384
            assert len(q['prompt']) + q['max_new'] <= 2048
    # The same lengths and gaps, in another order.
    sizes = [collections.Counter((len(q['prompt'])) for q in b)
             for b in blocks]
    assert sizes[0] == sizes[1] == sizes[2]
    outs = [sorted(q['max_new'] for q in b) for b in blocks]
    assert outs[0] == outs[1] == outs[2]
    # The chat mix fixes the order; only the token ids follow the seed.
    assert [q['at'] for q in blocks[0]] == [q['at'] for q in blocks[1]]
    assert blocks[0][0]['prompt'] != blocks[1][0]['prompt']
    # Another order_seed orders the same lengths and gaps otherwise.
    a, b = (_first_block(dict(params, order_seed=o), 1, seconds)
            for o in (1, 2))
    assert [q['at'] for q in a] != [q['at'] for q in b]
    assert sorted(len(q['prompt']) for q in a) == sorted(
        len(q['prompt']) for q in b)
    gaps = [sorted(round(y['at'] - x['at'], 9) for x, y in zip(c, c[1:]))
            for c in (a, b)]
    assert sum(gaps[0]) == pytest.approx(sum(gaps[1]), abs=1.0)


def test_open_lengths_follow_the_distribution():
    lengths = traffic.quantiles({'dist': 'lognormal', 'median': 512,
                                 'sigma': 0.6, 'min': 64, 'max': 1536}, 1001)
    assert sorted(lengths)[500] == 512
    assert min(lengths) >= 64 and max(lengths) <= 1536
    uni = traffic.quantiles({'dist': 'uniform', 'min': 64, 'max': 256}, 4)
    assert uni == [88, 136, 184, 232]


def test_later_blocks_are_uncounted_and_follow_on():
    params = _mix('serve-chat')
    it = open_lib.requests(params, 5, 10, 32768)
    reqs = [next(it) for _ in range(200)]
    n = int(round(params['rate_per_s'] * 10))
    assert all(q['counted'] for q in reqs[:n])
    assert not any(q['counted'] for q in reqs[n:])
    assert all(x['at'] <= y['at'] for x, y in zip(reqs, reqs[1:]))


@pytest.mark.parametrize('name', ['serve-chat', 'serve-reasoning'])
def test_a_mix_without_order_seed_is_refused(name):
    params = {k: v for k, v in _mix(name).items() if k != 'order_seed'}
    with pytest.raises(ValueError, match='order_seed'):
        if name == 'serve-chat':
            _first_block(params, 1, 10)
        else:
            closed.requests(params, 1, 10, 32768)


def test_closed_deterministic_and_within_lengths():
    params = _mix('serve-reasoning')
    a = closed.requests(params, 11, 30, 32768)
    assert a == closed.requests(params, 11, 30, 32768)
    assert a != closed.requests(params, 12, 30, 32768)
    for q in a:
        assert 64 <= len(q['prompt']) <= 256
        assert 512 <= q['max_new'] <= 1536
    assert len(a) >= params['clients'] * 30 / (512 * 0.005)


def test_training_batches_deterministic_prefix_and_distinct_rows():
    import torch
    params = {'batch': 2, 'seq': 16}
    a = steps.batches(params, 7, 3, 512, 'cpu')
    b = steps.batches(params, 7, 5, 512, 'cpu')
    for x, y in zip(a, b):
        assert torch.equal(x['tokens'], y['tokens'])
        assert torch.equal(x['targets'], y['targets'])
    assert not torch.equal(a[0]['tokens'], a[1]['tokens'])
    assert torch.equal(a[0]['tokens'][:, 1:], a[0]['targets'][:, :-1])

