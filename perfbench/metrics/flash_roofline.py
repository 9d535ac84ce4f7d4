"""flash_roofline: the flash attention kernels' share of their roofline
in the profiled step, in %: every ``flash_fwd`` launch's least time (a
causal forward's operations and bytes; the remat recompute's forwards are
launches too) plus every backward's (``flash_bwd_dq`` and
``flash_bwd_dkv`` together: dP, dQ, dK, dV), over the summed device time
of all their launches in the trace."""
from perfbench import flops, peaks


def read(run):
    fams = (run.profile or {}).get('families', {})
    fwd, dq = fams.get('flash_fwd'), fams.get('flash_bwd_dq')
    dkv = fams.get('flash_bwd_dkv')
    if not (fwd and dq and dkv):
        return None
    kind = run.device_kind
    bound = (fwd['launches'] * peaks.bound_s(
        *flops.flash_fwd_work(run.dims, run.batch, run.seq), kind)
        + dq['launches'] * peaks.bound_s(
            *flops.flash_bwd_work(run.dims, run.batch, run.seq), kind))
    spent = fwd['seconds'] + dq['seconds'] + dkv['seconds']
    return 100.0 * bound / spent
