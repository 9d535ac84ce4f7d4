"""paged_prefill_roofline: ``paged_prefill.cu``'s share of its roofline
in the profiled sub-window, in %: the least time the chip needs for the
chunks reckoned to have run there (each layer's launch reads the chunk's
queries and its prefix's and its own keys and values, writes its
outputs, and does causal attention's operations; ``perfbench.flops``)
over the summed device time of the kernel's launches in the trace. The
chunks come from the benchmark's own prompts, spread over each request's
queue wait to first token: a reckoning, since the port counts no chunk
by time."""
from perfbench import flops, peaks


def read(run):
    fam = (run.profile or {}).get('families', {}).get('paged_prefill')
    if not fam or not run.profile_span:
        return None
    lo, hi = run.profile_span
    bound = sum(peaks.bound_s(*flops.paged_prefill_work(run.dims, off, n),
                              run.device_kind)
                for off, n, _ in run.prefill_chunks(lo, hi))
    bound *= run.dims.layers
    return 100.0 * bound / fam['seconds'] if bound else None
