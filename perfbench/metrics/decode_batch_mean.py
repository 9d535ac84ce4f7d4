"""decode_batch_mean: the mean number of decoding slots over the window's
decode steps before the profiled sub-window (the flight recorder's
``batch``). Layer: the engine and its
scheduler, which keep the slots full."""


def read(run):
    batches = [s['batch'] for s in run.window_steps()
               if s['kind'] == 'decode']
    return sum(batches) / len(batches) if batches else None
