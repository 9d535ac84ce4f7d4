"""The port's drafter copy and ``speculative_accept`` vs the JAX package.

- ``PromptLookupDrafter.propose`` gives the JAX drafter's drafts for every
  prefix of random contexts, with and without a memo and with a small
  indexing budget; the five drafter cases of
  tests/unit_tests/test_infer_spec.py run on both drafters.
- ``speculative_accept`` gives JAX's emitted tokens and accepted counts
  on random greedy logits, drafts and draft lengths, draft length 0 and
  full acceptance included (identical integers, no tolerance).
"""
import random

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from skypilot_tpu.infer import drafter as jdrafter
from skypilot_tpu.infer import sampling as jsampling
from skypilot_tpu_torch.infer import drafter as tdrafter
from skypilot_tpu_torch.infer import sampling as tsampling


def _case_latest_match(lib):
    d = lib.PromptLookupDrafter(max_ngram=3)
    ctx = [1, 2, 3, 9, 9, 1, 2, 3, 4, 5, 6, 1, 2, 3]
    assert d.propose(ctx, 3) == [4, 5, 6]
    assert d.propose(ctx, 2) == [4, 5]


def _case_shorter_ngrams(lib):
    d = lib.PromptLookupDrafter(max_ngram=3, min_ngram=1)
    assert d.propose([7, 8, 9, 3, 9, 5], 4) == []
    assert d.propose([7, 8, 9, 3, 9], 4) == [3, 9, 3, 9]


def _case_memo_incremental(lib):
    d = lib.PromptLookupDrafter(max_ngram=3)
    rng = random.Random(5)
    ctx = [rng.randrange(6) for _ in range(40)]
    memo = {}
    for n in range(4, len(ctx) + 1):
        assert d.propose(ctx[:n], 5, memo=memo) == d.propose(ctx[:n], 5)


def _case_cached_context(lib):
    memo, prompt, out = {}, [1, 2, 3], []
    ctx = lib.cached_context(prompt, out, memo)
    assert ctx == [1, 2, 3]
    out.extend([7, 8])
    ctx2 = lib.cached_context(prompt, out, memo)
    assert ctx2 is ctx and ctx2 == [1, 2, 3, 7, 8]
    out.append(9)
    assert lib.cached_context(prompt, out, memo) == prompt + out


def _case_memo_reset(lib):
    d = lib.PromptLookupDrafter(max_ngram=2)
    memo = {}
    d.propose([1, 2, 1, 2, 1], 3, memo=memo)
    assert d.propose([4, 5, 6], 3, memo=memo) == []


@pytest.mark.parametrize('case', [_case_latest_match, _case_shorter_ngrams,
                                  _case_memo_incremental,
                                  _case_cached_context, _case_memo_reset])
@pytest.mark.parametrize('lib', [jdrafter, tdrafter],
                         ids=['jax', 'port'])
def test_reference_drafter_cases(case, lib):
    case(lib)


@pytest.mark.parametrize('seed,max_ngram,budget', [(0, 3, 1024), (1, 2, 4),
                                                   (2, 4, 5)])
def test_propose_identical_to_jax_for_every_prefix(seed, max_ngram, budget):
    rng = random.Random(seed)
    ctx = [rng.randrange(5) for _ in range(120)]
    kw = dict(max_ngram=max_ngram, max_index_per_call=budget)
    jd, td = jdrafter.PromptLookupDrafter(**kw), \
        tdrafter.PromptLookupDrafter(**kw)
    jmemo, tmemo = {}, {}
    for n in range(0, len(ctx) + 1):
        k = 1 + n % 7
        want = jd.propose(ctx[:n], k, memo=jmemo)
        assert td.propose(ctx[:n], k, memo=tmemo) == want, n
        assert td.propose(ctx[:n], k) == jd.propose(ctx[:n], k), n
    assert tmemo['indexed'] == jmemo['indexed']


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_speculative_accept_identical_to_jax(seed):
    rng = np.random.default_rng(seed)
    slots, K, vocab = 6, 4, 50
    logits = rng.normal(size=(slots, K + 1, vocab)).astype(np.float32)
    preds = logits.argmax(-1).astype(np.int32)
    drafts = preds[:, :K].copy()
    # Slot 0: full acceptance; slot 1: draft_len 0; the others wrong at
    # a random offset, with random draft lengths.
    draft_len = rng.integers(0, K + 1, size=slots).astype(np.int32)
    draft_len[0], draft_len[1] = K, 0
    for s in range(2, slots):
        j = rng.integers(0, K)
        drafts[s, j] = (drafts[s, j] + 1) % vocab
    temps = np.zeros((slots,), np.float32)
    je, ja = jsampling.speculative_accept(
        jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(draft_len),
        jax.random.PRNGKey(0), jnp.asarray(temps))
    te, ta = tsampling.speculative_accept(
        torch.from_numpy(logits), torch.from_numpy(drafts),
        torch.from_numpy(draft_len), None, torch.from_numpy(temps))
    assert te.dtype == ta.dtype == torch.int32
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert ta[0] == K and ta[1] == 0
    np.testing.assert_array_equal(te.numpy(), preds)
