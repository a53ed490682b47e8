"""eval_latency_p95_ms: the 95th percentile of every request's latency in
the window, from its dispatch until its predictions and confusion matrix
are on the host (linear interpolation between order statistics). Host
clock. Needs 200 requests, so that ten lie beyond it."""
import numpy as np

MIN_REQUESTS = 200


def read(run):
    if run.kind != "eval" or len(run.latencies_s) < MIN_REQUESTS:
        return None
    return float(np.percentile(np.asarray(run.latencies_s), 95)) * 1e3
