"""paged_prefill_roofline_counted: ``paged_prefill.cu``'s share of its
roofline in the profiled sub-window, in %, as ``paged_prefill_roofline``
but with the chunks the port counted: every chunk (offset, true length)
of the program records whose start event lies in the sub-window (each
layer's launch reads the chunk's queries and its prefix's and its own
keys and values, writes its outputs, and does causal attention's
operations; ``perfbench.flops``) over the summed device time of the
kernel's launches in the trace."""
from perfbench import flops, peaks, programs


def read(run):
    fam = (run.profile or {}).get('families', {}).get('paged_prefill')
    if not fam or not run.profile_span:
        return None
    bound = sum(peaks.bound_s(*flops.paged_prefill_work(run.dims, off, n),
                              run.device_kind)
                for p in programs.records(run, *run.profile_span)
                for _, off, n in p['chunks'])
    bound *= run.dims.layers
    return 100.0 * bound / fam['seconds'] if bound else None
