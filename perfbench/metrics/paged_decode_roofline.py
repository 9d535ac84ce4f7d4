"""paged_decode_roofline: ``paged_decode.cu``'s share of its roofline in
the profiled sub-window, in %: the least time the chip needs for the
decoded tokens that reached the client in the sub-window (each layer's
launch reads each slot's query and the keys and values of its whole
context, and writes its output; bandwidth-bound) over the summed device
time of the kernel's launches in the trace. The contexts are reckoned
from the clients' token timelines (prompt + tokens so far), since the
port counts no KV bytes read."""
from perfbench import flops, peaks


def read(run):
    fam = (run.profile or {}).get('families', {}).get('paged_decode')
    if not fam or not run.profile_span:
        return None
    work, nbytes = flops.paged_decode_work(
        run.dims, run.decode_contexts(*run.profile_span))
    bound = run.dims.layers * peaks.bound_s(work, nbytes, run.device_kind)
    return 100.0 * bound / fam['seconds'] if bound else None
