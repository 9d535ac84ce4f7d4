"""queue_wait_p90_ms: the 90th percentile, in ms, of the replica's own
queue wait (its done line's ``queue_wait_s``: submission to the first
prefill dispatch) over the window's finished requests due before the
profiled sub-window. Layer: the replica's front end and scheduler."""
from perfbench.client import percentile


def read(run):
    lo, hi = run.host_span
    waits = [r.done['queue_wait_s'] for r in run.counted
             if r.finished and r.done.get('queue_wait_s') is not None
             and lo <= r.due < hi]
    return percentile(waits, 0.90) * 1e3 if waits else None
