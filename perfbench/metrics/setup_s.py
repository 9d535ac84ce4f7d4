"""setup_s: seconds from the run's process start to the window's first
request or step (host clock): starting the replica or building the train
state, making the weights, building and loading kernels, warming every
step program, and the warm-up request or steps."""


def read(run):
    return run.setup_s
