"""eval_samples_per_s: samples of every eval request served in the window
(each read to the host before the next is sent), over the window's
seconds. Host clock."""


def read(run):
    if run.kind != "eval" or run.steps == 0:
        return None
    return run.samples / run.window_s
