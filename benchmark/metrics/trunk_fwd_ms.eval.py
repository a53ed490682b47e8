"""trunk_fwd_ms.eval: mean ms of the camera trunk's forward in the eval
window, by CUDA events that forward hooks record around the configuration's
`stages.trunk` submodule."""
SPANS = ("trunk",)


def read(run):
    spans = run.spans_ms.get("trunk", [])
    return sum(spans) / len(spans) if run.kind == "eval" and spans else None
