"""device_idle_share.<kind>: the share of the profiled span in which no
device operation ran, in %: 1 - (the union of every kernel's, copy's
and set's interval) / (the span), from the ``torch.profiler`` trace.
Overlapping kernels count once."""


def read(run):
    p = run.profile
    if not p or not p.get('window_s') or not p.get('busy_s'):
        return None
    return 100.0 * (1.0 - p['busy_s'] / p['window_s'])
