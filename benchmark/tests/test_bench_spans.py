"""The readers of the port's own spans (`metrics/*` with `"source":
"program_span"` that read `utils/profiling.py`): None in an untraced run
(or on the CPU, where a traced run has no timeline) and with no row of
their span, else the mean of the rows in the span table.

On the card (marker `card`, skipped without one): the spans' host clock is
the profiler's (its own record of a span's range holds the span's stamps,
and the idle gap that a span around a sleep between two kernels makes
holds the span, each to 50 us); the flagship's `trunk` and `bev_encoder` spans time what the
benchmark's forward hooks time (within 2%, B=8 eval); and its trunk's and
BEV encoder's backward fit, step by step, between `train_step`'s
"forward" and "backward" marks."""
import json
import time

import pytest
import torch

from conftest import ROOT

NEW = {"trunk_bwd_ms.train": ("trunk.backward", "train", "device"),
       "bev_encoder_bwd_ms.train": ("bev_encoder.backward", "train", "device"),
       "eval_dispatch_ms": ("eval_step", "eval", "host"),
       "eval_dispatch_ms.host_paced": ("eval_step", "eval", "host"),
       "trunk_dispatch_ms.eval.host_paced": ("trunk", "eval", "host")}
SEED = 2 ** 31 + 1717


def _view(kind, timeline):
    from benchlib import session

    return session.RunView(kind=kind, cfg={}, traffic={}, batch=1, device="cuda", setup_s=0.0,
                           window_s=1.0, steps=1, latencies_s=[], peak_bytes=None,
                           timeline=timeline)


class _Event:
    def __init__(self, t_ms):
        self.t_ms = t_ms

    def elapsed_time(self, other):
        return other.t_ms - self.t_ms


@pytest.fixture
def table(monkeypatch):
    """The span table emptied, and no synchronise on the CPU."""
    from lss2_multimodal_nu_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_TABLE", profiling._Table(profiling.RING))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return profiling


def test_every_new_reader_has_its_entry():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in manifest["per_layer"]}
    for name in NEW:
        assert entries[name]["source"] == "program_span" and entries[name]["workloads"]


@pytest.mark.parametrize("metric", list(NEW))
def test_reader_is_none_untraced_or_with_no_row_else_the_mean(metric, table):
    from benchlib import manifest, trace

    span, kind, which = NEW[metric]
    read = manifest.reader(metric).read
    traced = trace.Timeline(None)
    assert read(_view(kind, None)) is None
    assert read(_view(kind, traced)) is None
    for start_ns, host_ms, dev_ms in ((0, 2.0, 5.0), (10 ** 7, 4.0, 7.0)):
        ev = (_Event(0.0), _Event(dev_ms))
        table._TABLE.rows.append(table.Row(span, None, start_ns, start_ns + int(host_ms * 1e6),
                                           ev))
        table._TABLE.rows.append(table.Row("other", None, start_ns, start_ns + 10 ** 9, ev))
    assert read(_view(kind, None)) is None
    assert read(_view(kind, traced)) == pytest.approx(6.0 if which == "device" else 3.0)
    assert read(_view("eval" if kind == "train" else "train", traced)) is None


# ---- on the card


@pytest.mark.card
def test_span_host_clock_is_the_device_timeline_clock(card):
    """A span around a sleep between two kernels, after a warm-up of the
    same inside the session, in sessions with and without host activity.
    One clock: the profiler's own record of the span's range holds the
    span's stamps, and on the device timeline as `profiling.device_ops`
    aligns it the idle gap holds the span, each to 50 us; and both lie
    within 10 ms of it (another clock is off by seconds or days:
    perf_counter's by days). How far the gap reaches past the span is the
    host's latency under the profiler, 0.06-2.5 ms on the H100's host."""
    from torch.profiler import ProfilerActivity, profile

    from lss2_multimodal_nu_tpu_torch.utils import profiling

    a = torch.randn(4096, 4096, device=card)
    b = torch.zeros(1, device=card)
    a @ a
    torch.cuda.synchronize()
    got = []
    for activities in ([ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]) * 3:
        with profile(activities=activities) as prof:
            for _ in range(3):
                a @ a
                torch.cuda.synchronize()
                with profiling.span("sleep"):
                    time.sleep(0.002)
                b.add_(1)
                torch.cuda.synchronize()
        row = [r for r in profiling.rows() if r.name == "sleep"][-1]
        ops = sorted(profiling.device_ops(prof))
        gap = [(x[1], y[0]) for x, y in zip(ops, ops[1:])
               if y[0] - x[1] > 1e6 and x[1] <= row.end_ns and y[0] >= row.start_ns][-1]
        host = [(e.start_ns() - row.start_ns, e.end_ns() - row.end_ns)
                for e in prof.profiler.kineto_results.events()
                if e.name() == "sleep" and e.device_type() == torch.autograd.DeviceType.CPU]
        got.append({"lead_us": (row.start_ns - gap[0]) / 1e3, "lag_us": (gap[1] - row.end_ns) / 1e3,
                    "range_us": [(s / 1e3, e / 1e3) for s, e in host[-1:]]})
    print(f"span against the device's gap and the profiler's range: {got}")
    for g in got:
        assert -50 <= g["lead_us"] <= 1e4 and -50 <= g["lag_us"] <= 1e4, got
        assert all(-1e4 <= s <= 50 and -50 <= e <= 1e4 for s, e in g["range_us"]), got
    assert any(g["range_us"] for g in got)


def _loop(cell, card):
    from benchlib import manifest, trace

    c = manifest.load_cell(ROOT, cell)
    rec = trace.Recorder(True)
    return c, manifest.loop(c.traffic).Loop(c, SEED, [card], rec), rec


@pytest.mark.card
def test_stage_spans_agree_with_the_benchmark_hooks(card):
    from torch.profiler import ProfilerActivity, profile

    from lss2_multimodal_nu_tpu_torch.utils import profiling

    c, loop, rec = _loop("flagship_v39.eval", card)
    rec.hook(loop.model, c.cfg["stages"])
    for _ in range(12):
        loop.request()
    rec.unhook()
    hooks = {k: sum(v[2:]) / len(v[2:]) for k, v in rec.spans_ms().items()}
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(12):
            loop.request()
    spans = {k: [d for _, d in profiling.spans(k)][2:] for k in hooks}
    spans = {k: sum(v) / len(v) for k, v in spans.items()}
    print(f"hooks {hooks} spans {spans}")
    assert set(hooks) == {"trunk", "bev_encoder"}
    for k in hooks:
        assert spans[k] == pytest.approx(hooks[k], rel=0.02), (k, hooks, spans)
    loop.free()


@pytest.mark.card
def test_stage_backwards_fit_between_the_marks(card):
    from torch.profiler import ProfilerActivity, profile

    from lss2_multimodal_nu_tpu_torch.utils import profiling

    _, loop, rec = _loop("flagship_v39.train", card)
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(4):
            rec.step_start()
            loop.once(mark=rec.mark)
    bwd = [m["backward"] for m in rec.marks_ms()]
    trunk = [d for _, d in profiling.spans("trunk.backward")]
    bev = [d for _, d in profiling.spans("bev_encoder.backward")]
    print(f"backward {bwd} trunk {trunk} bev_encoder {bev}")
    assert len(bwd) == len(trunk) == len(bev) == 4
    for b, t, e in zip(bwd, trunk, bev):
        assert 0 < t and 0 < e and t + e <= b
    loop.free()
