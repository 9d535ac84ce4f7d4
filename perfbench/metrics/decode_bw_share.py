"""decode_bw_share.<kind>: the decode programs' share of the chip's HBM
bandwidth, in %, over the window before the profiled sub-window: the
least bytes of each decode program the port recorded (every weight
streamed once, the K/V of the keys it read, ``kv_tokens``, and the new
K/V rows it wrote, ``rows``; ``perfbench.programs.decode_bytes``) over
the sum of their device times (CUDA events around each program, its
read-back copy included), at 3.35 TB/s."""
from perfbench import peaks, programs


def read(run):
    progs = [p for p in programs.records(run, *run.host_span)
             if p['kind'] == 'decode']
    secs = sum(p['device_s'] for p in progs)
    if not secs:
        return None
    nbytes = sum(programs.decode_bytes(run.dims, p['rows'], p['kv_tokens'])
                 for p in progs)
    return 100.0 * nbytes / secs / peaks.peak('hbm_bytes', run.device_kind)
