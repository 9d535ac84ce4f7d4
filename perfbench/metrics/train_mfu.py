"""train_mfu: the train step's share of the chip's bf16 peak, in %: the
benchmark's model operations a step (``perfbench.flops.train_step_flops``:
3 x the forward's products and causal attention, no recompute, no
embedding lookup) times the window's steps, over the window, at 989
TFLOP/s."""
from perfbench import flops, peaks


def read(run):
    work = run.steps * flops.train_step_flops(run.dims, run.batch, run.seq)
    return 100.0 * work / run.seconds / peaks.peak('bf16_flops',
                                                   run.device_kind)
