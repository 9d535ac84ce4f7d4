"""Closed-loop traffic: callers that each wait for their reply.

Parameters (mix file, then the cell's file over it): ``clients`` (how
many callers), ``prompt`` and ``output`` (length distributions, see
:func:`perfbench.traffic.quantiles`), ``max_total`` (prompt + output at
most), ``order_seed`` (see :func:`perfbench.traffic.order_rng`). Each client sends its next request
the moment its last one ended; the requests come from one sequence in
the order the clients take them. All clients start at the window's
start; when it closes, every request still streaming is cut (its tokens
inside the window count).
"""
from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List

from perfbench import client as client_lib
from perfbench import traffic


def requests(params: Dict[str, Any], seed: int, seconds: float,
             vocab: int) -> List[Dict[str, Any]]:
    """More requests than the window can take: every client could finish
    one of the shortest outputs every 5 ms a token."""
    most = params['clients'] * (
        2 + math.ceil(seconds / (params['output']['min'] * 0.005)))
    r = traffic.rng(seed, 2000)
    prompts = traffic.quantiles(params['prompt'], most)
    outputs = traffic.quantiles(params['output'], most)
    order = traffic.order_rng(params, 2000)
    order.shuffle(prompts)
    order.shuffle(outputs)
    return [{'prompt': traffic.token_ids(r, p, vocab),
             'max_new': min(o, params['max_total'] - p)}
            for p, o in zip(prompts, outputs)]


def run(port: int, params: Dict[str, Any], seed: int, seconds: float,
        vocab: int, t0: float, drain_wait_s: float
        ) -> List[client_lib.Record]:
    """Run the clients from ``t0`` to ``t0 + seconds``; returns every
    request sent."""
    del drain_wait_s
    pending = requests(params, seed, seconds, vocab)
    sent: List[client_lib.Record] = []
    lock = threading.Lock()
    end = t0 + seconds

    def client() -> None:
        while True:
            with lock:
                now = time.time()
                if now >= end or len(sent) == len(pending):
                    return
                q = pending[len(sent)]
                rec = client_lib.Record(idx=len(sent), prompt=q['prompt'],
                                        max_new=q['max_new'],
                                        due=max(now, t0))
                sent.append(rec)
            wait = rec.due - time.time()
            if wait > 0:
                time.sleep(wait)
            client_lib.stream(port, rec)

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(params['clients'])]
    for th in threads:
        th.start()
    while time.time() < end:
        time.sleep(min(0.05, max(0.0, end - time.time())))
    for rec in list(sent):
        rec.cancel()
    for th in threads:
        th.join(timeout=10)
    return sent
