"""program_gap_share.<kind>: the share of the window before the profiled
sub-window in which the device waited for the engine's next program, in
%: the sum of the program records' ``gap_before_s`` (from one program's
end event to the next one's start event; none after an idle engine
tick, when there was no work) over the span."""
from perfbench import programs


def read(run):
    lo, hi = run.host_span
    gaps = [p['gap_before_s'] for p in programs.records(run, lo, hi)
            if p['gap_before_s'] is not None]
    if not gaps or hi <= lo:
        return None
    return 100.0 * sum(gaps) / (hi - lo)
