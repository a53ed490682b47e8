"""setup_s: seconds from the process's start to the window's: imports,
the kernels' build (in a checkout's first run), the model, weights, pool
and optimizer, the checked steps and the warm-up. Host clock."""


def read(run):
    return run.setup_s
