"""train_bwd_ms: mean ms per window step from `train_step`'s "forward" mark
to its "backward" mark (the backward), by CUDA events recorded at each."""


def read(run):
    parts = [m["backward"] for m in run.marks_ms if "backward" in m]
    return sum(parts) / len(parts) if run.kind == "train" and parts else None
