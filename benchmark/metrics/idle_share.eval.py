"""idle_share.eval: the share of the traced eval window in which no
operation ran on the device: 1 - (the union of kernel, copy and set
intervals in torch.profiler's trace) / (the window's seconds), in %."""


def read(run):
    if run.kind != "eval" or run.timeline is None or run.busy_s is None or run.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
