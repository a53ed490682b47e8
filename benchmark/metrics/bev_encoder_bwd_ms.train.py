"""bev_encoder_bwd_ms.train: mean device ms of the BEV encoder's backward
per step in the profiled half of a traced train run: the port's
`bev_encoder.backward` span (`utils/profiling.py`), by CUDA events from the
moment the gradients of the encoder's outputs have all arrived to the moment
every gradient of its parameters and of its input has been produced. None
where the port records no such span (the port is imported inside `read`, so that the reader loads
without it)."""
SPAN = "bev_encoder.backward"


def read(run):
    if run.kind != "train" or run.timeline is None:
        return None
    from lss2_multimodal_nu_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    ms = [dev for _, dev in profiling.spans(SPAN) if dev is not None]
    return sum(ms) / len(ms) if ms else None
