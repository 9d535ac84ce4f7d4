"""serve_step_mfu.<kind>: the model step's share of the chip's bf16 peak,
in %: the model operations of the window's steps (each prompt token's
products, the head only where a first token's logits are needed, each
decoded token's products and head, causal attention over each token's
true context; ``perfbench.flops``) over the summed wall time of the
window's steps (the flight recorder's ``dur_s``) at 989 TFLOP/s, both
before the profiled sub-window. Which
chunks ran in the window is reckoned from each request's queue wait and
first token; decoded tokens are counted by when they reached the
client."""
from perfbench import flops, peaks


def read(run):
    steps = run.window_steps()
    busy = sum(s['dur_s'] for s in steps)
    if not busy:
        return None
    work = sum(flops.prefill_chunk_flops(run.dims, off, n, last)
               for off, n, last in run.prefill_chunks(*run.host_span))
    work += sum(flops.decode_token_flops(run.dims, c)
                for c in run.decode_contexts(*run.host_span))
    return 100.0 * work / busy / peaks.peak('bf16_flops', run.device_kind)
