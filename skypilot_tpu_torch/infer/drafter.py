"""Draft-free speculative drafting: n-gram / prompt-lookup (a copy of
``skypilot_tpu/infer/drafter.py``, which the port cannot import: the
JAX package's ``infer/__init__.py`` loads JAX).

The host side of self-speculative decoding (docs/serving.md
"Speculative decoding"): given a request's context (prompt + generated
suffix), propose up to ``k`` candidate continuation tokens by finding
the most recent earlier occurrence of the context's trailing n-gram
and replaying what followed it — "prompt lookup decoding" (the
ANPL/transformers trick; vLLM's ``ngram`` speculator is the same
idea). No draft model, no device work: drafting is a dict lookup, and
the fused ``verify`` program (infer/model.py) checks all candidates in
ONE device step, so a wrong draft costs one wasted verify lane, never
a wrong token.

Why it works on serving traffic: templated/JSON output, quoting the
prompt (RAG, summarization, code edits), and the repetition loops
greedy decoding falls into all make the trailing n-gram's continuation
an excellent predictor of the model's own next tokens.

The drafter is stateless; per-request incremental state (how much of
the context is already indexed) lives in a caller-owned ``memo`` dict
(the engine hangs it off the ``Request``), so a request keeps its
index across slot moves and preemptions and each new token costs O(1)
amortized indexing, not an O(context) rescan per step.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


def cached_context(prompt: Sequence[int], output: Sequence[int],
                   memo: Dict) -> List[int]:
    """Memo-cached ``prompt + output`` list, extended incrementally as
    the output grows — so the per-step drafting cost stays O(new
    tokens), never an O(context) list rebuild per step (a request's
    prompt is immutable and its output only appends)."""
    ctx = memo.get('ctx')
    if ctx is None or len(ctx) < len(prompt):
        ctx = memo['ctx'] = list(prompt)
    have = len(ctx) - len(prompt)
    if have < len(output):
        ctx.extend(output[have:])
    return ctx


class PromptLookupDrafter:
    """Longest-suffix n-gram matcher over a token sequence.

    ``propose(context, k, memo)`` returns up to ``k`` draft tokens: the
    tokens that followed the most recent PRIOR occurrence of the
    context's trailing ``n``-gram, trying ``max_ngram`` down to
    ``min_ngram`` (longer matches are stronger evidence). Returns
    ``[]`` when no trailing n-gram has occurred before — speculation
    is opportunistic; the engine just decodes normally that step.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 max_index_per_call: int = 1024) -> None:
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(
                f'need 1 <= min_ngram <= max_ngram, got '
                f'[{min_ngram}, {max_ngram}]')
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        # Per-call indexing budget: the FIRST propose() for a long
        # prompt would otherwise index the whole thing inline in the
        # engine step loop, stalling token emission for every
        # co-batched slot. Capped, the index catches up over the next
        # few steps instead (proposals just see a partial index
        # meanwhile — speculation is opportunistic, and the schedule
        # is a pure function of the call sequence, so drafts stay
        # deterministic).
        self.max_index_per_call = max(max_ngram + 1,
                                      int(max_index_per_call))

    def _index(self, context: Sequence[int],
               memo: Dict) -> Dict[Tuple[int, ...], int]:
        """Incrementally extend the memo's n-gram index, at most
        ``max_index_per_call`` new positions per call.

        ``index[(gram...)] = j`` maps each n-gram (every n in
        [min_ngram, max_ngram]) to the LATEST start position j with at
        least one following token (j + n <= len - 1) — i.e. every
        occurrence except a bare trailing one, which has no
        continuation to propose. Appending one token adds at most
        ``max_ngram`` entries, so a streaming request pays O(1)
        amortized per generated token."""
        index = memo.setdefault('index', {})
        done = memo.get('indexed', 0)
        limit = min(len(context), done + self.max_index_per_call)
        # Grams indexed so far END before the old frontier: an
        # occurrence starting at j is indexable once position j + n
        # exists. Walk only the new start positions up to the budget.
        for n in range(self.min_ngram, self.max_ngram + 1):
            lo = max(0, done - n)          # starts not yet indexed
            for j in range(lo, limit - n):
                index[tuple(context[j:j + n])] = j
        memo['indexed'] = limit
        return index

    def propose(self, context: Sequence[int], k: int,
                memo: Optional[Dict] = None) -> List[int]:
        """Up to ``k`` draft tokens continuing ``context``, or []."""
        if k <= 0 or len(context) < self.min_ngram + 1:
            return []
        if memo is None:
            memo = {}
        if memo.get('indexed', 0) > len(context):
            # Context shrank (a fresh request reusing a stale memo):
            # rebuild rather than serve ghosts.
            memo.clear()
        index = self._index(context, memo)
        for n in range(min(self.max_ngram, len(context) - 1),
                       self.min_ngram - 1, -1):
            tail = tuple(context[-n:])
            j = index.get(tail)
            if j is None or j == len(context) - n:
                continue          # only the tail itself occurs
            # Copy what followed the match. When the copy source runs
            # off the end of the context it continues INTO the draft
            # being built (conceptually reading the sequence
            # context+draft) — so a repetition loop of period p drafts
            # the full k tokens of its cycle instead of stopping at
            # the frontier after p-ish tokens. Greedy decoding falls
            # into exactly such loops, and they are the drafter's
            # richest vein.
            src = j + n
            draft: List[int] = []
            for m in range(k):
                idx = src + m
                draft.append(int(context[idx]) if idx < len(context)
                             else draft[idx - len(context)])
            return draft
        return []
