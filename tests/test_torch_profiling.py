"""`utils/profiling.py`, the port's tracer, on the CPU: with no profiler a
span makes no row, no CUDA event, no `record_function` range and no hook;
under a torch.profiler session spans nest, take positive host time, record
a CUDA event pair where asked (a stand-in Event counts them here), start
afresh with each session and keep at most `RING` rows; a train step of the
flagship and of LSS (whose stages BevTxt shares) at a tiny size records its
entry, stage and kernel spans, the trunk's and the BEV encoder's backward
among them, inside the step's backward and leaving no hook behind; an eval
step records no backward; and the idle gaps of a device timeline are put
down to the innermost span open when each began, on a device timeline moved
later where the profiler drew a kernel before its launch. No JAX."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lss2_multimodal_nu_tpu_torch.config import AugConfig, Config, GridConfig, ModelConfig, TrainConfig
from lss2_multimodal_nu_tpu_torch.models.factory import build_model
from lss2_multimodal_nu_tpu_torch.train import state as ts
from lss2_multimodal_nu_tpu_torch.train import steps as tsteps
from lss2_multimodal_nu_tpu_torch.utils import profiling

XB = (-8.0, 8.0, 0.5)  # a 32 x 32 BEV grid
FINAL_DIM = (32, 96)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


class _Counted:
    """Counts `record_function` ranges and stand-in CUDA events."""

    def __init__(self, monkeypatch):
        self.ranges = self.events = 0
        real = torch.profiler.record_function
        counted = self

        def record_function(name):
            counted.ranges += 1
            return real(name)

        class Event:
            def __init__(self, enable_timing=False):
                counted.events += 1

            def record(self):
                pass

            def elapsed_time(self, other):
                return 1.5

        monkeypatch.setattr(torch.profiler, "record_function", record_function)
        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


def _names():
    return [r.name for r in profiling.rows()]


def test_span_with_no_profiler_does_nothing(monkeypatch):
    with _profiled():
        with profiling.span("before"):
            pass
    before = profiling._TABLE.rows.copy()
    counted = _Counted(monkeypatch)
    lin = torch.nn.Linear(4, 4)
    assert profiling.span("a", device=True) is profiling.span("b", backward=True)
    with profiling.span("a", device=True, backward=True) as sp:
        y = sp.call(lin, torch.ones(2, 4, requires_grad=True))
    y.sum().backward()
    assert (counted.ranges, counted.events) == (0, 0)
    assert list(profiling._TABLE.rows) == list(before)
    assert not profiling._TABLE.pending
    assert not lin.weight._backward_hooks


def test_spans_nest_with_host_time_and_device_events(monkeypatch):
    counted = _Counted(monkeypatch)
    with _profiled():
        with profiling.span("outer", device=True):
            with profiling.span("inner"):
                torch.ones(256, 256).matmul(torch.ones(256, 256))
            with profiling.span("inner"):
                pass
    rows = profiling.rows()
    assert [(r.name, r.parent) for r in rows] == [("inner", "outer"), ("inner", "outer"),
                                                   ("outer", None)]
    outer = rows[-1]
    assert all(outer.start_ns <= r.start_ns < r.end_ns <= outer.end_ns for r in rows[:2])
    assert (counted.ranges, counted.events) == (3, 2)
    assert [d for _, d in profiling.spans("outer")] == [1.5]
    (host, dev), = profiling.spans("outer")
    assert host > 0
    assert [d for _, d in profiling.spans("inner")] == [None, None]


def test_each_session_starts_afresh():
    with _profiled():
        with profiling.span("first"):
            pass
    assert profiling.spans("first") and _names() == ["first"]
    with _profiled():  # read off between the sessions
        with profiling.span("second"):
            pass
    assert _names() == ["second"]
    with profiling.span("off"):
        pass
    with _profiled():  # a span asked for off between the sessions
        with profiling.span("third"):
            pass
    assert _names() == ["third"]


def test_the_table_is_a_bounded_ring():
    with _profiled():
        for i in range(profiling.RING + 5):
            with profiling.span(f"s{i}"):
                pass
    names = _names()
    assert len(names) == profiling.RING
    assert names[0] == "s5" and names[-1] == f"s{profiling.RING + 4}"


def _cfg(family: str) -> Config:
    model = dict(family=family)
    if family == "lss":
        model.update(effnet_variant="b0", cam_channels=64)
    return Config(model=ModelConfig(**model), grid=GridConfig(xbound=XB, ybound=XB),
                  aug=AugConfig(final_dim=FINAL_DIM),
                  train=TrainConfig(batch_size=1, use_schedule=False))


def _batch(cfg: Config, b: int = 1):
    rng = np.random.default_rng(0)
    n, (h, w) = cfg.aug.ncams, cfg.aug.final_dim
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    eye = np.broadcast_to(np.eye(3), (b, n, 3, 3))
    intr = np.broadcast_to([[1266.0, 0, 800.0], [0, 1266.0, 450.0], [0, 0, 1]], (b, n, 3, 3))
    post = eye * (w / 1600.0)
    post[..., 2, 2] = 1.0
    return dict(imgs=f(rng.normal(size=(b, n, 3, h, w))), rots=f(eye),
                trans=f(rng.normal(size=(b, n, 3))), intrins=f(intr), post_rots=f(post),
                post_trans=f(np.zeros((b, n, 3))),
                binimg=torch.from_numpy(rng.integers(0, 4, size=(b, 32, 32))).long(),
                act=f(rng.integers(0, 2, size=(b, 4))), desc=f(rng.integers(0, 2, size=(b, 8))))


STAGES = {"vovnet_transformer": ("backbone", "bev_encoder",
                                 ["op.deformable_sample", "op.deformable_sample_backward"]),
          "lss": ("encoder", "bevencode", [])}


@pytest.mark.parametrize("family", list(STAGES))
def test_train_step_records_stages_and_their_backward(family):
    cfg = _cfg(family)
    model = build_model(cfg, device="cpu").train()
    opt, sched = ts.build_optimizer(cfg, model)
    batch = _batch(cfg)
    with _profiled():
        tsteps.train_step(model, opt, sched, batch, 0)
    rows = {r.name: r for r in profiling.rows()}
    trunk, bev, ops = STAGES[family]
    want = {"train_step", "forward", "backward", "optimizer", "trunk", "depth", "lift_splat",
            "bev_encoder", "trunk.backward", "bev_encoder.backward", "op.lift_splat",
            "op.lift_splat_backward", *ops}
    assert want <= set(rows), sorted(rows)
    assert ("heads" in rows) == (family != "lss")
    parents = {n: r.parent for n, r in rows.items()}
    assert parents["train_step"] is None
    assert {parents[n] for n in ("forward", "backward", "optimizer")} == {"train_step"}
    assert {parents[n] for n in ("trunk", "depth", "lift_splat", "bev_encoder")} == {"forward"}
    assert parents["op.lift_splat"] == "lift_splat"
    assert parents["trunk.backward"] == parents["bev_encoder.backward"] == "backward"
    bwd, t_bwd, b_bwd = rows["backward"], rows["trunk.backward"], rows["bev_encoder.backward"]
    assert bwd.start_ns <= b_bwd.start_ns < b_bwd.end_ns <= t_bwd.start_ns < t_bwd.end_ns \
        <= bwd.end_ns
    assert all(r.end_ns > r.start_ns for r in rows.values())
    assert not profiling._TABLE.pending
    for sub in (trunk, bev):
        assert not any(p._backward_hooks for p in model.get_submodule(sub).parameters())


def test_stage_hooks_of_a_forward_with_no_backward_are_removed():
    lin = torch.nn.Linear(4, 4)
    x = torch.ones(2, 4)
    with _profiled():
        for _ in range(3):
            with profiling.span("stage", backward=True) as sp:
                sp.call(lin, x)
            assert sum(len(p._backward_hooks or {}) for p in lin.parameters()) == 2
        with profiling.span("stage", backward=True) as sp:
            sp.call(lin, x).sum().backward()
    assert not lin.weight._backward_hooks and not profiling._TABLE.pending
    assert _names().count("stage.backward") == 1


def test_eval_step_records_no_backward():
    cfg = _cfg("vovnet_transformer")
    model = build_model(cfg, device="cpu").eval()
    with _profiled():
        tsteps.eval_step(model, _batch(cfg), torch.zeros(4, 4, dtype=torch.int64))
    names = set(_names())
    assert {"eval_step", "trunk", "bev_encoder", "heads", "op.ffn_ln", "op.seg_head"} <= names
    assert not any(n.endswith(".backward") for n in names)
    assert {r.parent for r in profiling.rows() if r.name == "trunk"} == {"eval_step"}


def _row(name, parent, a, b):
    return profiling.Row(name, parent, a, b, None)


def test_idle_gaps_go_to_the_innermost_open_span():
    table = [_row("inner", "outer", 150, 300), _row("outer", None, 100, 500),
             _row("late", None, 700, 800)]
    ops = [(0, 120), (200, 250), (260, 400), (450, 460), (610, 620), (750, 760)]
    got = profiling.idle_by_span(ops, table)
    # gaps from 120 (inner starts at 150), 400 and 460 in outer, from 250 in inner, from
    # 620 in none (late starts at 700)
    assert list(got) == ["outer", profiling.NO_SPAN, "inner"]
    assert got["outer"] == {"gaps": 3, "ms": pytest.approx(280e-6)}
    assert got[profiling.NO_SPAN] == {"gaps": 1, "ms": pytest.approx(130e-6)}
    assert got["inner"] == {"gaps": 1, "ms": pytest.approx(10e-6)}
    assert profiling.idle_by_span([(0, 10), (5, 20)], table) == {}



class _Event:
    def __init__(self, name, cuda, corr, start, end, annotation=False):
        self.args = (name, cuda, corr, start, end, annotation)

    def name(self):
        return self.args[0]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self.args[1] else torch.autograd.DeviceType.CPU

    def correlation_id(self):
        return self.args[2]

    def start_ns(self):
        return self.args[3]

    def end_ns(self):
        return self.args[4]

    def is_user_annotation(self):
        return self.args[5]


def _profile(events):
    results = type("R", (), {"events": lambda self: events})()
    return type("P", (), {"profiler": type("K", (), {"kineto_results": results})()})()


@pytest.mark.parametrize("kernel_start,shift", [(120, 0), (90, 10)])
def test_device_ops_move_a_timeline_drawn_before_its_launches(kernel_start, shift):
    events = [_Event("cudaLaunchKernel", False, 7, 100, 110),
              _Event("aten::add", False, 8, 95, 130),
              _Event("cudaMemcpyAsync", False, 9, 200, 260),
              _Event("kernel", True, 7, kernel_start, kernel_start + 10),
              _Event("Memcpy DtoH", True, 9, 215, 250),
              _Event("a span's range", True, 0, 80, 300, annotation=True)]
    assert profiling.device_ops(_profile(events)) == [
        (kernel_start + shift, kernel_start + 10 + shift), (215 + shift, 250 + shift)]
