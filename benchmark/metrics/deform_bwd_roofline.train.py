"""deform_bwd_roofline.train: the deformable-sampling backward's bound over
the device time of its own launches, in %. Its launches run on one stream
from the keys kernel to the query kernel: the keys, CUB's sort, the row
pointers, the long cells' pieces, dv and the query pass; every launch from
the first name below through the next launch of the last is the
backward's.

Bound of one call: the larger of its bytes over HBM's rate and its float32
operations over the card's float32 (non-tensor) rate; frozen copies of
`chip_smoke.py::backward_cases`' counts. Bytes: v and the cotangent g in,
dv out (each (BH, H*W, dh) in the value dtype), lx, ly and attn in and their
three gradients out ((BH, npts, N) float32), each once. Operations: per
(map, point, query, channel) and corner, an FMA for the corner's product
(2) and a multiply, a multiply and an add for dv (3). BH = batch x heads.
Peaks: NVIDIA H100 SXM data sheet, dense, at the card's 700 W power limit.
"""
HBM_BYTES_PER_S = 3.35e12
FLOAT32_OPS_PER_S = 67e12
FIRST, LAST = "deform_sample_bwd_keys", "deform_sample_bwd_query"


def bound_s(batch, heads, head_dim, points, n, elem_bytes=4):
    bh = batch * heads
    nbytes = 3 * bh * n * head_dim * elem_bytes + 6 * bh * points * n * 4
    ops = bh * n * points * head_dim * 4 * 5
    return max(nbytes / HBM_BYTES_PER_S, ops / FLOAT32_OPS_PER_S)


def read(run):
    if run.kind != "train" or run.timeline is None or "deformable" not in run.cfg:
        return None
    calls = run.timeline.segments(FIRST, LAST)
    if not calls:
        return None
    d = run.cfg["deformable"]
    bound = bound_s(run.batch, d["heads"], d["head_dim"], d["points"], d["queries"])
    return 100.0 * bound * len(calls) / sum(calls)
