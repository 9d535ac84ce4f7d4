"""output_tokens_per_s: every token streamed to the clients inside the
window, divided by the window (client clock)."""


def read(run):
    n = sum(k for r in run.records for t, k in r.arrivals
            if run.t0 <= t < run.t1)
    return n / run.seconds
