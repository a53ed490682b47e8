"""train_fwd_ms: mean ms per window step from the step's start to
`train_step`'s "forward" mark (the forward and the loss), by CUDA events
recorded at each."""


def read(run):
    parts = [m["forward"] for m in run.marks_ms if "forward" in m]
    return sum(parts) / len(parts) if run.kind == "train" and parts else None
