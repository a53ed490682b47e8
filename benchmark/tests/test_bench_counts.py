"""The yardstick's arithmetic at small shapes against hand counts: the
deformable kernels' bytes and operations, the FLOP count of a step, and
the readers that reduce a timeline (rooflines, idle share, gaps, MFU)."""
import math
import types

import pytest
import torch

from conftest import ROOT


def test_deformable_bounds_by_hand():
    from benchlib import manifest

    fwd = manifest.reader("deform_fwd_roofline.eval")
    bwd = manifest.reader("deform_bwd_roofline.train")
    # B=1, 2 heads, dh 4, 3 points, 10 queries: BH = 2
    f_bytes = 2 * 2 * 10 * 4 * 4 + 3 * 2 * 3 * 10 * 4  # v in, out, lx/ly/attn in
    f_ops = 2 * 10 * 3 * 4 * 10
    assert fwd.bound_s(1, 2, 4, 3, 10) == max(f_bytes / 3.35e12, f_ops / 67e12)
    b_bytes = 3 * 2 * 10 * 4 * 4 + 6 * 2 * 3 * 10 * 4  # v, g in, dv out; 3 in, 3 grads out
    b_ops = 2 * 10 * 3 * 4 * 4 * 5
    assert bwd.bound_s(1, 2, 4, 3, 10) == max(b_bytes / 3.35e12, b_ops / 67e12)
    # the flagship's train-v2 backward: 0.440 ms by bytes (chip_smoke's count)
    assert bwd.bound_s(8, 8, 32, 8, 40000) * 1e3 == pytest.approx(0.4401, abs=1e-4)


def _timeline(ops):
    from benchlib import trace

    t = trace.Timeline(None)
    t.ops = sorted(ops, key=lambda o: o[1])
    return t


def _view(kind, timeline, **kw):
    base = dict(kind=kind, cfg={"deformable": {"heads": 2, "head_dim": 4, "points": 3,
                                               "queries": 10}},
                batch=1, steps=4, window_s=1.0, timeline=timeline, flops=None)
    base.update(kw)
    v = types.SimpleNamespace(**base)
    v.busy_s = timeline.busy_us() / 1e6 if timeline is not None else None
    return v


def test_roofline_reads_the_calls_launches():
    from benchlib import manifest

    bwd = manifest.reader("deform_bwd_roofline.train")
    # two calls of 4 launches (keys, a sort, dv, query), 10 us each, with
    # another op between them that is not the backward's
    ops = []
    for c in range(2):
        t = c * 1000.0
        for i, n in enumerate(["void deform_sample_bwd_keys(float)", "cub::Onesweep",
                               "deform_sample_bwd_dv<float>", "deform_sample_bwd_query<float, 8>"]):
            ops.append((n, t + 10 * i, t + 10 * i + 10))
        ops.append(("other_kernel", t + 500, t + 600))
    tl = _timeline(ops)
    assert tl.segments("deform_sample_bwd_keys", "deform_sample_bwd_query") == \
        pytest.approx([40e-6, 40e-6])
    want = 100 * bwd.bound_s(1, 2, 4, 3, 10) * 2 / 80e-6
    assert bwd.read(_view("train", tl)) == pytest.approx(want)
    assert bwd.read(_view("eval", tl)) is None
    assert bwd.read(_view("train", _timeline([]))) is None  # nothing to read: no number


def test_idle_share_and_breakdown():
    from benchlib import manifest

    # busy 0-100 and 150-300 us (overlapping ops)
    tl = _timeline([("a", 0, 60), ("b", 40, 100), ("c", 150, 300)])
    assert tl.busy_us() == 250
    v = _view("eval", tl, window_s=500e-6)
    assert manifest.reader("idle_share.eval").read(v) == pytest.approx(50.0)
    assert manifest.reader("idle_share.train").read(v) is None
    gaps = tl.breakdown()["idle_gaps"]
    assert gaps == [["b -> c", pytest.approx(50e-6)]]
    ops = dict(tl.breakdown()["device_ops"])
    assert ops["c"] == pytest.approx(150e-6)


def test_eval_gap_spans_each_read():
    from benchlib import manifest

    # two requests: kernels to 100 us, the read's two copies, the next
    # request from 400 us; the last read has no request after it
    tl = _timeline([("k1", 0, 100), ("Memcpy DtoH (Device -> Pageable)", 150, 160),
                    ("Memcpy DtoH (Device -> Pageable)", 200, 210), ("k2", 400, 500),
                    ("Memcpy DtoH (Device -> Pageable)", 550, 560)])
    reader = manifest.reader("eval_gap_ms")
    assert reader.read(_view("eval", tl)) == pytest.approx(0.3)
    assert reader.read(_view("train", tl)) is None
    assert reader.read(_view("eval", _timeline([("k1", 0, 1)]))) is None


def test_mfu_by_hand():
    from benchlib import manifest

    v = _view("train", _timeline([("a", 0, 1)]), flops=495e12 / 8, steps=4, window_s=1.0)
    assert manifest.reader("mfu.train").read(v) == pytest.approx(50.0)


def test_step_flops_by_hand():
    """A conv, a depthwise conv and a linear, forward and backward, against
    2 multiply-adds per product; the depthwise weight gradient counted once
    (`FlopCounterMode`'s own formula counts it `groups` times over)."""
    from benchlib import session

    with torch.device("meta"):
        conv = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False)
        dw = torch.nn.Conv2d(8, 8, 3, padding=1, groups=8, bias=False)
        lin = torch.nn.Linear(8 * 16 * 16, 5)
        x = torch.empty(2, 3, 16, 16)
    from torch.utils.flop_counter import FlopCounterMode

    mapping = {torch.ops.aten.convolution_backward: session.conv_backward_flops}
    with FlopCounterMode(display=False, custom_mapping=mapping) as c:
        lin(dw(conv(x)).flatten(1)).sum().backward()
    f_conv = 2 * 2 * 16 * 16 * 8 * 3 * 9
    f_dw = 2 * 2 * 16 * 16 * 8 * 1 * 9
    f_lin = 2 * 2 * 8 * 16 * 16 * 5
    # conv: forward + weight grad (its input needs none); dw, lin: all three
    assert c.get_total_flops() == 2 * f_conv + 3 * f_dw + 3 * f_lin


def test_full_configs_count_three_times_forward_for_a_step():
    import json

    from benchlib import session

    cfg = json.loads((ROOT / "benchmark/configs/bevtxt_b4.json").read_text())
    b = 1
    batch = {"imgs": torch.empty(b, 6, 3, 128, 352), "rots": torch.empty(b, 6, 3, 3),
             "trans": torch.empty(b, 6, 3), "intrins": torch.empty(b, 6, 3, 3),
             "post_rots": torch.empty(b, 6, 3, 3), "post_trans": torch.empty(b, 6, 3),
             "binimg": torch.empty(b, 200, 200, dtype=torch.long), "act": torch.empty(b, 4),
             "desc": torch.empty(b, 8)}
    fwd = session.count_flops(cfg, batch, train=False)
    step = session.count_flops(cfg, batch, train=True)
    assert 2.9 < step / fwd < 3.0 and math.isfinite(fwd)
