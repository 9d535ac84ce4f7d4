"""ttft_p90_s: the 90th percentile of the time to first token over every
request due in the window, clocked by the client from when the request
was due under the schedule. A request that failed, or got no token
before the client stopped waiting (the window's end plus the drain
wait), counts as that whole wait: it misses any limit."""
from perfbench.client import percentile


def read(run):
    give_up = run.t1 + run.drain_wait_s
    ttfts = []
    for r in run.counted:
        t = r.ttft() if r.error is None else None
        ttfts.append(t if t is not None else give_up - r.due)
    return percentile(ttfts, 0.90) if ttfts else None
