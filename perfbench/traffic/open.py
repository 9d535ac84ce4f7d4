"""Open-loop traffic: independent users arriving on a schedule.

Parameters (mix file, then the cell's file over it): ``rate_per_s`` (the
mean arrival rate), ``prompt`` and ``output`` (length distributions, see
:func:`perfbench.traffic.quantiles`), ``max_total`` (prompt + output at
most), ``order_seed`` (see :func:`perfbench.traffic.order_rng`).

The window's requests are one block of round(rate x seconds) arrivals
whose gaps sum to the window; further blocks of the same make-up follow,
so the load goes on while the window's last requests finish. Only the
first block is counted. A request is sent on its own thread when due,
however many are in flight, so the client never holds one back.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Iterator, List

from perfbench import client as client_lib
from perfbench import traffic


def _block(params: Dict[str, Any], seed: int, block: int, seconds: float,
           vocab: int) -> List[Dict[str, Any]]:
    n = max(1, int(round(params['rate_per_s'] * seconds)))
    r = traffic.rng(seed, 1000 + block)
    prompts = traffic.quantiles(params['prompt'], n)
    outputs = traffic.quantiles(params['output'], n)
    gaps = traffic.exponential_gaps(params['rate_per_s'], n, seconds)
    order = traffic.order_rng(params, 1000 + block)
    for arr in (prompts, outputs, gaps):
        order.shuffle(arr)
    out, t = [], 0.0
    for i in range(n):
        prompt_len = prompts[i]
        max_new = min(outputs[i], params['max_total'] - prompt_len)
        out.append({'at': t, 'prompt': traffic.token_ids(r, prompt_len,
                                                         vocab),
                    'max_new': max_new})
        t += gaps[i]
    return out


def requests(params: Dict[str, Any], seed: int, seconds: float,
             vocab: int) -> Iterator[Dict[str, Any]]:
    """Every request with its offset from the window's start: the
    counted block, then uncounted blocks without end."""
    block = 0
    while True:
        for q in _block(params, seed, block, seconds, vocab):
            yield dict(q, at=q['at'] + block * seconds, counted=block == 0)
        block += 1


def run(port: int, params: Dict[str, Any], seed: int, seconds: float,
        vocab: int, t0: float, drain_wait_s: float
        ) -> List[client_lib.Record]:
    """Drive the schedule from ``t0`` (wall clock) until every counted
    request ended, or ``drain_wait_s`` past the window; then cut the
    uncounted ones still streaming. Returns every request sent."""
    sent: List[client_lib.Record] = []
    threads: List[threading.Thread] = []
    stop = threading.Event()
    n_counted = max(1, int(round(params['rate_per_s'] * seconds)))

    def dispatch() -> None:
        for i, q in enumerate(requests(params, seed, seconds, vocab)):
            rec = client_lib.Record(idx=i, prompt=q['prompt'],
                                    max_new=q['max_new'], due=t0 + q['at'],
                                    counted=q['counted'])
            wait = rec.due - time.time()
            if wait > 0 and stop.wait(wait):
                return
            if stop.is_set():
                return
            th = threading.Thread(target=client_lib.stream,
                                  args=(port, rec), daemon=True)
            sent.append(rec)
            threads.append(th)
            th.start()

    disp = threading.Thread(target=dispatch, daemon=True, name='dispatch')
    disp.start()
    deadline = t0 + seconds + drain_wait_s
    while time.time() < deadline:
        counted = [r for r in list(sent) if r.counted]
        if (len(counted) == n_counted and all(r.ended for r in counted)):
            break
        time.sleep(0.05)
    stop.set()
    disp.join(timeout=10)
    for rec in list(sent):
        if rec.counted and not rec.ended:
            rec.error = f'unanswered {drain_wait_s:g} s past the window'
        rec.cancel()
    for th in list(threads):
        th.join(timeout=10)
    return sent
