"""bev_encoder_fwd_ms.eval: mean ms of the BEV encoder's forward in the eval
window, by CUDA events that forward hooks record around the configuration's
`stages.bev_encoder` submodule."""
SPANS = ("bev_encoder",)


def read(run):
    spans = run.spans_ms.get("bev_encoder", [])
    return sum(spans) / len(spans) if run.kind == "eval" and spans else None
