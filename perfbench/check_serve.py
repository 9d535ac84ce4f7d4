"""Whether the replica's answers are right: served tokens against the
plain reference.

After the window, with the replica stopped and its memory free, a
sample of the window's finished requests, drawn from the seed and with
the one that served the most tokens in it, is run through the plain
reference once each (prompt + served tokens, one causal pass in float32
on the device, over the same seeded weights made again). For every
served token the check reads by how much its reference logit lies below
the reference's best at that position; the worst of these is
``served_logit_gap``. Greedy decoding serves the program's own argmax, so
a sound replica parts from the reference's only at near-ties. The worst
gap catches a token altered where it is produced, but hardly a lower
precision: int8 weights widen the program's logit error by about 2x,
and the worst gap of some thousands of tokens by as much. The share of
served tokens whose gap exceeds the cell's ``tail_gap``
(``served_tail_share``, %) moves 5x or more, so it is the number that
holds the precision.

Besides: no request of the window may fail or go unanswered
(``failed``; a closed loop's requests cut at the window's end are not
failures), every finished one has to serve exactly the tokens it asked
for (``short``: the traffic sets no end-of-sequence token), and the
sample has to hold some hundreds of tokens (``tokens_checked``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from perfbench import traffic
from perfbench import weights as weights_lib


def sample(run, seed: int, n: int) -> List[Any]:
    """``n`` finished requests of the window: the one with the most
    served tokens, and ``n - 1`` more drawn from the seed."""
    done = [r for r in run.counted if r.finished]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.tokens), r.idx))
    rest = [r for r in done if r is not longest]
    r = traffic.rng(seed, 3)
    pick = sorted(r.choice(len(rest), size=min(n - 1, len(rest)),
                           replace=False).tolist()) if rest else []
    return [longest] + [rest[i] for i in pick]


def gaps(dims, tree, prompt: List[int], served: List[int],
         device) -> List[float]:
    """The reference's best logit minus the served token's, at every
    served position."""
    import torch
    from perfbench.reference import llama as ref
    ids = torch.tensor(prompt + served[:-1], dtype=torch.int64,
                       device=device)
    z = ref.logits(dims, tree, ids)
    rows = z[len(prompt) - 1:]
    got = rows.gather(1, torch.tensor(served, device=device)[:, None])[:, 0]
    return (rows.max(1).values - got).tolist()


def check(run, seed: int, device, n: int,
          detail: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
    """The compared numbers; ``detail``, when given, gets every checked
    token's gap (for looking into a reading)."""
    import torch
    from perfbench.reference import llama as ref
    ref.exact()
    picked = sample(run, seed, n)
    tree = weights_lib.make(run.dims, seed, torch.device(device))
    worst, count, every = 0.0, 0, []
    for r in picked:
        g = gaps(run.dims, tree, r.prompt, r.tokens, device)
        worst = max(worst, max(g))
        count += len(g)
        every.append(g)
    del tree
    if detail is not None:
        detail['gaps'] = every
    counted = run.counted
    tau = float(run.cell.params['check']['tail_gap'])
    tail = sum(1 for g in every for x in g if x > tau)
    return {
        'served_logit_gap': worst,
        'served_tail_share': 100.0 * tail / max(count, 1),
        'tokens_checked': count,
        'failed': sum(1 for r in counted if r.error is not None),
        'short': sum(1 for r in counted
                     if r.finished and len(r.tokens) != r.max_new),
    }
