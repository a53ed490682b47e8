"""train_samples_per_s: samples of every train step dispatched in the
window, over the window's seconds, which end at the one synchronise after
the last step. Host clock."""


def read(run):
    if run.kind != "train" or run.steps == 0:
        return None
    return run.samples / run.window_s
