"""step_host_ms.<kind>: the engine step loop's own host work a step, in
ms: the flight recorder's ``host_s`` + ``drain_s`` (scheduling, page and
slot bookkeeping, consuming the read-back pair; not the wait on the
device, ``readback_s``, nor the launches, ``dispatch_s``), the mean over
the window's steps before the profiled sub-window."""


def read(run):
    steps = run.window_steps()
    if not steps:
        return None
    return sum(s['host_s'] + s['drain_s'] for s in steps) / len(steps) * 1e3
