"""One run of one cell: set-up, the measured window, the check.

The loop that drives the window is the traffic mix's: `loops/<loop>.py`,
named by the mix's `loop` key, whose `Loop` subclasses `Loop` here. Set-up
(`Loop.__init__`) makes the pool of batches and the weights from the seed,
builds the port's model with `models/factory.py::build_model`, loads the
weights into it and, for training, builds `train/state.py::build_optimizer`'s
optimizer and schedule; the loop then runs what its mix needs before the
window (checked steps, warm-up). After the window the loop runs what the
check needs of the window's object (`after_window`), the port's state is
freed and the reference runs (`check.py`). Seconds that set-up spends in the
reference or in the check's own copies (`Loop.aside`) are left out of
`setup_s`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import math
import time
from typing import Dict, List, Optional

import torch

from reference import train as ref_train

from . import check, inputs, manifest, trace
from . import weights as weights_mod

PORT = "lss2_multimodal_nu_tpu_torch"


def port_config(cfg: dict, seed: int):
    """The port's `Config` of a configuration file, dropout seeded by `seed`."""
    c = importlib.import_module(f"{PORT}.config")
    t = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}  # noqa
    return c.Config(grid=c.GridConfig(**t(cfg["grid"])), aug=c.AugConfig(**t(cfg["aug"])),
                    model=c.ModelConfig(**t(cfg["model"])),
                    train=c.TrainConfig(**t(cfg["train"]), seed=seed))


class Program:
    """The port as the window drives it: its model, and for training its
    optimizer and schedule. Its entry points are looked up at each call, so
    that a test can put a broken one underneath."""

    def __init__(self, cfg: dict, seed: int, device, weights, train: bool, steps_per_epoch: int):
        factory = importlib.import_module(f"{PORT}.models.factory")
        self.steps = importlib.import_module(f"{PORT}.train.steps")
        self.cfg = port_config(cfg, seed)
        self.model = factory.build_model(self.cfg, device=device, seed=seed)
        self.model.load_state_dict(weights)
        self.opt = self.sched = None
        if train:
            state = importlib.import_module(f"{PORT}.train.state")
            self.opt, self.sched = state.build_optimizer(self.cfg, self.model.train(),
                                                         steps_per_epoch=steps_per_epoch)

    def train_step(self, batch, step, mark=None):
        return self.steps.train_step(self.model, self.opt, self.sched, batch, step, mark=mark)

    def eval_step(self, batch, confmat):
        return self.steps.eval_step(self.model, batch, confmat)

    def moments(self) -> Dict[str, tuple]:
        """{name: (exp_avg, exp_avg_sq, step count)} of Adam's state, copied
        to the host."""
        names = {p: n for n, p in self.model.named_parameters()}
        out = {}
        for group in self.opt.param_groups:
            for p in group["params"]:
                st = self.opt.state.get(p, {})
                if "exp_avg" in st:
                    out[names[p]] = (_host(st["exp_avg"]), _host(st["exp_avg_sq"]),
                                     int(st["step"]))
        return out

    def state(self) -> Dict[str, torch.Tensor]:
        """The model's state dict (weights and buffers), copied to the host."""
        return {k: _host(v) for k, v in self.model.state_dict().items()}

    def parameters(self) -> Dict[str, torch.Tensor]:
        return {n: _host(p) for n, p in self.model.named_parameters()}


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Window:
    """One measured window: its start on the host clock, seconds, steps or
    requests, each request's latency (closed loops), the profile or None."""
    t0: float
    seconds: float
    count: int
    latencies_s: List[float]
    prof: object = None


@dataclasses.dataclass
class RunView:
    """What the metric readers read. In a traced run `window_s`, `steps` and
    `timeline` are the profiled second half's, `spans_ms` and `marks_ms`
    the first half's."""
    kind: str  # the loop's kind: "train" or "eval"
    cfg: dict
    traffic: dict
    batch: int
    device: str
    setup_s: float
    window_s: float
    steps: int  # steps or requests in the window
    latencies_s: List[float]
    peak_bytes: Optional[int]
    flops: Optional[float] = None  # per step or request, counted on the reference
    timeline: Optional[trace.Timeline] = None
    spans_ms: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    marks_ms: List[Dict[str, float]] = dataclasses.field(default_factory=list)

    @property
    def samples(self) -> int:
        return self.steps * self.batch

    @property
    def busy_s(self) -> Optional[float]:
        return None if self.timeline is None else self.timeline.busy_us() / 1e6


def conv_backward_flops(grad_out_shape, x_shape, w_shape, *args, out_shape=None, **kwargs):
    """A convolution's backward: the forward's multiply-adds once for the
    input's gradient and once for the weight's, each where asked for.
    (`FlopCounterMode`'s own formula counts a grouped conv's weight gradient
    as if ungrouped: a depthwise conv's `groups` times over.)"""
    output_mask = kwargs.get("output_mask", args[7] if len(args) > 7 else (True, True))
    forward = 2 * grad_out_shape[0] * math.prod(grad_out_shape[2:]) * math.prod(w_shape)
    return forward * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def count_flops(cfg: dict, batch: dict, train: bool) -> float:
    """Model FLOPs of one step (forward, loss and backward) or one request
    (forward) at the batch's shapes: `FlopCounterMode` over the reference
    on the meta device, so nothing runs."""
    from torch.utils.flop_counter import FlopCounterMode

    model = ref_train.build(cfg, "meta")
    model.train(train)
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in batch.items()}
    mapping = {torch.ops.aten.convolution_backward: conv_backward_flops}
    with FlopCounterMode(display=False, custom_mapping=mapping) as counter:
        out = model(*(meta[k] for k in ref_train.MODEL_INPUTS))
        if train:
            ref_train.loss_of(cfg, out, meta).backward()
    return float(counter.get_total_flops())


def _stage_map(cfg: dict, readers) -> Dict[str, str]:
    """{stage: submodule} of the spans the cell's readers read."""
    stages = {}
    for r in readers.values():
        for stage in getattr(r, "SPANS", ()):
            stages[stage] = cfg["stages"][stage]
    return stages


class Loop:
    """Set-up common to the loops: the pool, the weights (an eval loop's with
    batch-norm statistics calibrated by the reference, `weights.calibrate`),
    the port's model and, for training, its optimizer. A loop module's
    `Loop` sets `KIND` ("train" or "eval": its check's kind), finishes its
    set-up in `__init__`, and gives `window`, `outputs` and, where the check
    needs more of the window's object, `after_window`."""
    KIND = ""

    def __init__(self, cell: manifest.Cell, seed: int, devices, rec: trace.Recorder):
        cfg, traffic = cell.cfg, cell.traffic
        self.cfg, self.traffic, self.seed, self.rec = cfg, traffic, seed, rec
        self.device = torch.device(devices[0])
        self.train = self.KIND == "train"
        self.pool_n = traffic["pool"]
        self.aside_s = 0.0
        self.batch = inputs.batch_size(cfg, traffic, self.train)
        self.pool = inputs.make_pool(cfg, traffic, self.batch, self.train, seed, self.device)
        weights = weights_mod.make(ref_train.build(cfg, "meta"), seed, self.device)
        self.overrides = {}
        if not self.train:
            with self.aside():
                self.overrides = weights_mod.calibrate(cfg, weights, self.pool[0])
            weights.update({k: v.to(self.device) for k, v in self.overrides.items()})
        self.prog = Program(cfg, seed, self.device, weights, self.train, self.pool_n)
        self.step = 0

    @contextlib.contextmanager
    def aside(self):
        """Seconds of set-up spent for the check alone, left out of setup_s."""
        t = time.perf_counter()
        try:
            yield
        finally:
            self.aside_s += time.perf_counter() - t

    @property
    def model(self) -> torch.nn.Module:
        return self.prog.model

    def window(self, seconds: float, profile: bool) -> Window:
        raise NotImplementedError

    def after_window(self) -> None:
        """What the check needs of the window's object, once it has closed."""

    def outputs(self, since: int):
        """(got, kept): what the check compares, on the host, and what the
        reference needs (`check.numbers`); for eval requests from request
        `since` on."""
        raise NotImplementedError

    def free(self) -> None:
        """Drop the port's model, optimizer and pool."""
        self.prog = self.pool = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run(cell: manifest.Cell, seed: int, seconds: float, traced: bool, devices,
        t_start: float) -> dict:
    """The run's result: {correct, attempted, failed, metrics, device,
    [breakdown], checks}."""
    device = torch.device(devices[0])
    entries = cell.per_layer if traced else cell.end_to_end
    readers = manifest.readers(entries)
    rec = trace.Recorder(traced and device.type == "cuda")
    loop = manifest.loop(cell.traffic).Loop(cell, seed, devices, rec)
    flops = None
    if any(getattr(r, "FLOPS", False) for r in readers.values()):
        with loop.aside():
            flops = count_flops(cell.cfg, loop.pool[0], loop.train)
    rec.hook(loop.model, _stage_map(cell.cfg, readers))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    first = loop.step
    # traced: CUDA-event spans over the first half, the profiler over the
    # second, so that neither perturbs the other's numbers
    w = loop.window(seconds / 2 if traced else seconds, False)
    setup_s, attempted = w.t0 - t_start - loop.aside_s, w.count
    rec.unhook()
    spans, marks = (rec.spans_ms(), rec.marks_ms()) if rec.enabled else ({}, [])
    if traced and device.type == "cuda":
        rec.enabled = False
        w = loop.window(seconds / 2, True)
        attempted += w.count
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    view = RunView(kind=loop.KIND, cfg=cell.cfg, traffic=cell.traffic, batch=loop.batch,
                   device=device.type, setup_s=setup_s, window_s=w.seconds, steps=w.count,
                   latencies_s=w.latencies_s, peak_bytes=peak, flops=flops,
                   timeline=trace.Timeline(w.prof) if w.prof is not None else None,
                   spans_ms=spans, marks_ms=marks)
    metrics = {}
    for entry in entries:
        value = readers[entry["name"]].read(view)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    loop.after_window()
    got, kept = loop.outputs(first)
    loop.free()
    nums = check.numbers(loop.KIND, cell.cfg, seed, got, kept, loop.pool_n, device,
                         loop.overrides)
    bad = check.verdict(nums, cell.limits)
    result = {"correct": not bad, "attempted": attempted, "failed": 0, "metrics": metrics,
              "device": device_info(device, cell.chips, peak, view if traced else None)}
    if view.timeline is not None:
        result["breakdown"] = view.timeline.breakdown()
    result["checks"] = {k: {"value": nums[k], "limit": cell.limits[k]} for k in cell.limits}
    return result


def device_info(device, chips: int, peak, view: Optional[RunView]) -> dict:
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": chips, "memory_peak_bytes": peak}
    if view is not None:
        info["busy_s"] = view.busy_s
        info["window_s"] = view.window_s
    return info
