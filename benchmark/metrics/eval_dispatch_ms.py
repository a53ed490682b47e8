"""eval_dispatch_ms: mean host ms inside `eval_step` per request in the
profiled half of a traced eval run: the port's `eval_step` span
(`utils/profiling.py`), on the host's clock from the call to its return,
the time the host takes to dispatch a request's work (the answers are read
after it). None where the port records no such span (the port is imported inside `read`, so that the reader loads
without it)."""
SPAN = "eval_step"


def read(run):
    if run.kind != "eval" or run.timeline is None:
        return None
    from lss2_multimodal_nu_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    ms = [host for host, _ in profiling.spans(SPAN)]
    return sum(ms) / len(ms) if ms else None
