"""trunk_bwd_ms.train: mean device ms of the camera trunk's backward per
step in the profiled half of a traced train run: the port's
`trunk.backward` span (`utils/profiling.py`), by CUDA events from the
moment the gradient of the trunk's output has arrived to the moment every
gradient of its parameters has been produced. None where the port records
no such span (the port is imported inside `read`, so that the reader loads
without it)."""
SPAN = "trunk.backward"


def read(run):
    if run.kind != "train" or run.timeline is None:
        return None
    from lss2_multimodal_nu_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    ms = [dev for _, dev in profiling.spans(SPAN) if dev is not None]
    return sum(ms) / len(ms) if ms else None
