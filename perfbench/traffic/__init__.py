"""Traffic: the general generator's shared pieces.

A mix is a data file, ``traffic/<mix>.json``, whose ``kind`` names the
module that drives it: ``open`` (open-loop arrivals on a schedule),
``closed`` (clients that each wait for their reply) or ``steps``
(training batches). A cell's own file adds what depends on the
deployment (a rate, a client count).

Every seed gets the same work: lengths and gaps are the distribution's
quantiles at evenly spaced points (stratified), shuffled into an order,
and the seed draws the token ids. The order is the mix's own: an
``open`` or ``closed`` mix fixes it with ``order_seed``, since under a
queue the order of long and short requests moves the tails far more
than anything a program change does.
"""
from __future__ import annotations

import math
import statistics
from typing import Any, Dict, List

import numpy as np

_NORMAL = statistics.NormalDist()


def quantiles(spec: Dict[str, Any], n: int) -> List[int]:
    """``n`` whole lengths at the quantiles (i + 0.5) / n of ``spec``:
    ``{"dist": "lognormal", "median", "sigma", "min", "max"}`` or
    ``{"dist": "uniform", "min", "max"}`` (both ends kept), clipped to
    [min, max]."""
    lo, hi = int(spec['min']), int(spec['max'])
    out = []
    for i in range(n):
        q = (i + 0.5) / n
        if spec['dist'] == 'lognormal':
            x = math.exp(math.log(spec['median'])
                         + spec['sigma'] * _NORMAL.inv_cdf(q))
        elif spec['dist'] == 'uniform':
            x = lo + q * (hi - lo)
        else:
            raise ValueError(f'unknown length distribution {spec["dist"]!r}')
        out.append(min(hi, max(lo, int(round(x)))))
    return out


def exponential_gaps(rate: float, n: int, span: float) -> List[float]:
    """``n`` gaps at the exponential's quantiles, scaled to sum to
    ``span`` (a Poisson process's gaps at rate about n / span)."""
    gaps = [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]
    scale = span / sum(gaps)
    return [g * scale for g in gaps]


def rng(seed: int, stream: int) -> np.random.Generator:
    """The seed's generator for one purpose (``stream``)."""
    return np.random.default_rng([int(seed) % (2 ** 63), stream])


def order_rng(params: Dict[str, Any], stream: int) -> np.random.Generator:
    """The generator that orders a mix's lengths and gaps: from the mix's
    ``order_seed``, which every ``open`` and ``closed`` mix has to give."""
    if 'order_seed' not in params:
        raise ValueError('the mix gives no order_seed')
    return rng(params['order_seed'], stream)


def token_ids(r: np.random.Generator, n: int, vocab: int) -> List[int]:
    return r.integers(0, vocab, size=n).tolist()
