"""prefill_mfu.<kind>: the standalone prefill-chunk programs' share of
the chip's bf16 peak, in %, over the window before the profiled
sub-window: the model operations of each chunk the port recorded
(``perfbench.flops.prefill_chunk_flops`` at its offset and true length,
the head where it ends its prompt) over the sum of those programs'
device times (CUDA events around each), at 989 TFLOP/s."""
from perfbench import flops, peaks, programs


def read(run):
    progs = [p for p in programs.records(run, *run.host_span)
             if p['kind'] == 'prefill']
    secs = sum(p['device_s'] for p in progs)
    if not secs:
        return None
    last = programs.last_chunks(run)
    work = sum(flops.prefill_chunk_flops(run.dims, off, n,
                                         (rid, off) in last)
               for p in progs for rid, off, n in p['chunks'])
    return 100.0 * work / secs / peaks.peak('bf16_flops', run.device_kind)
