"""itl_p99_ms: the 99th percentile of the gaps between streamed tokens,
over every gap of every request due in the window (tokens that arrive in
one line have no gap between them), in ms, clocked by the client."""
from perfbench.client import percentile


def read(run):
    gaps = [g for r in run.counted for g in r.gaps()]
    return percentile(gaps, 0.99) * 1e3 if gaps else None
