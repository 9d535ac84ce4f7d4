"""train_tokens_per_s: the tokens of every step completed in the window,
divided by the window, which ends in a ``synchronize()`` (host clock)."""


def read(run):
    return run.steps * run.batch * run.seq / run.seconds
