"""deform_fwd_roofline.eval: the deformable-sampling forward kernel's bound
over the device time of its launches, in %.

Bound of one call: the larger of its bytes over HBM's rate and its float32
operations over the card's float32 (non-tensor) rate; frozen copies of
`chip_smoke.py::kernel_cases`' counts. Bytes: v in and the output out
(each (BH, N, dh) in the value dtype), lx, ly and attn in ((BH, npts, N)
float32), each once. Operations: 10 per (map, point, query, channel): four
corners' weights and products and the attention's sum. BH = batch x heads.
Peaks: NVIDIA H100 SXM data sheet, dense, at the card's 700 W power limit.
"""
HBM_BYTES_PER_S = 3.35e12
FLOAT32_OPS_PER_S = 67e12
KERNEL = "deform_sample_kernel"


def bound_s(batch, heads, head_dim, points, n, elem_bytes=4):
    bh = batch * heads
    nbytes = 2 * bh * n * head_dim * elem_bytes + 3 * bh * points * n * 4
    ops = bh * n * points * head_dim * 10
    return max(nbytes / HBM_BYTES_PER_S, ops / FLOAT32_OPS_PER_S)


def read(run):
    if run.kind != "eval" or run.timeline is None or "deformable" not in run.cfg:
        return None
    calls = run.timeline.segments(KERNEL, KERNEL)
    if not calls:
        return None
    d = run.cfg["deformable"]
    bound = bound_s(run.batch, d["heads"], d["head_dim"], d["points"], d["queries"])
    return 100.0 * bound * len(calls) / sum(calls)
