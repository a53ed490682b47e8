"""trunk_dispatch_ms.eval.host_paced: mean host ms inside the camera
trunk's forward per request in the profiled half of a traced eval run, in
the eval cells whose requests the host's dispatch paces: the port's `trunk`
span (`utils/profiling.py`), on the host's clock around the configuration's
`stages.trunk` submodule, the share of `eval_dispatch_ms.host_paced` that
the trunk's launches take. None where the port records no such span (the port is imported inside `read`, so that the reader loads
without it)."""
SPAN = "trunk"


def read(run):
    if run.kind != "eval" or run.timeline is None:
        return None
    from lss2_multimodal_nu_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    ms = [host for host, _ in profiling.spans(SPAN)]
    return sum(ms) / len(ms) if ms else None
