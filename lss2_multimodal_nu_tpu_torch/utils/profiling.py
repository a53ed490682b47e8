"""The port's tracer, and NaN hunting.

A span (`span`) marks one piece of the port's work: a step at its entry
point (`train_step` and its forward, backward and optimizer; `eval_step`), a
model stage (trunk, depth, lift_splat, bev_encoder, heads), a kernel call
(`op.<kernel>`). Spans record while, and only while, a torch.profiler
session records (`torch.autograd._profiler_enabled()`): with no profiler a
span costs that one check and does nothing else, so a run that nobody
profiles pays nothing for them, and anyone who profiles the port sees them.

On, a span
* opens a `torch.profiler.record_function` range of its name, so that it
  shows in the profile over the device operations it launched;
* writes a row to the span table: its name, the span open around it, and
  its host start and end in ns on `time.time_ns`'s clock (CLOCK_REALTIME),
  the clock of the profiler's own host and device timestamps;
* with `device=True`, records a CUDA event on the current stream at each
  end, where CUDA has been initialised;
* with `backward=True`, through `call`, also records `<name>.backward`
  where grad is enabled: from the moment the gradients of the stage's
  outputs have all arrived to the moment every gradient of its parameters
  and inputs has been produced, with device events at both.

The table is a ring of `RING` rows, one per process, since the profiler is
one per process. It starts afresh with the first span recorded after one
was asked for with the profiler off (a new session), or when `spans` or
`rows` was read with it off; `trace` starts it afresh itself. `spans(name)`
reads it.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import json
import os
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

RING = 4096
NO_SPAN = "(no span)"


class Row(NamedTuple):
    name: str
    parent: Optional[str]
    start_ns: int
    end_ns: int
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]]


class _Table:
    """The rows of the current session, the spans open now (innermost last,
    shared by the threads of one process: the autograd engine's run while
    the caller waits in `backward`), and the handles of stage backwards
    whose hooks are still registered."""

    def __init__(self, size: int):
        self.rows: collections.deque = collections.deque(maxlen=size)
        self.open: List[str] = []
        self.stale = False
        self.pending: Dict[str, list] = {}

    def reset(self) -> None:
        self.rows.clear()
        self.open.clear()
        for handles in self.pending.values():
            _remove(handles)
        self.pending.clear()
        self.stale = False

    def begin(self) -> None:
        if self.stale:
            self.reset()


_TABLE = _Table(RING)


def _remove(handles) -> None:
    for h in handles:
        h.remove()


def _event() -> Optional[torch.cuda.Event]:
    if not torch.cuda.is_initialized():
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


class _Off:
    """The span while no profiler records: nothing but the call."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    @staticmethod
    def call(module, *args, **kwargs):
        return module(*args, **kwargs)


_OFF = _Off()


class _Span:
    __slots__ = ("name", "device", "backward", "parent", "range", "start_event", "start_ns")

    def __init__(self, name: str, device: bool, backward: bool):
        self.name, self.device, self.backward = name, device, backward

    def __enter__(self):
        _TABLE.begin()
        self.parent = _TABLE.open[-1] if _TABLE.open else None
        _TABLE.open.append(self.name)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.start_event = _event() if self.device else None
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        end_event = _event() if self.start_event is not None else None
        self.range.__exit__(*exc)
        if _TABLE.open and _TABLE.open[-1] == self.name:
            _TABLE.open.pop()
        elif self.name in _TABLE.open:
            _TABLE.open.remove(self.name)
        events = (self.start_event, end_event) if end_event is not None else None
        _TABLE.rows.append(Row(self.name, self.parent, self.start_ns, end_ns, events))
        return None

    def call(self, module: torch.nn.Module, *args, **kwargs):
        """module(*args, **kwargs); with `backward=True` and grad enabled,
        its backward recorded as `<name>.backward`."""
        out = module(*args, **kwargs)
        if self.backward and torch.is_grad_enabled():
            _watch_backward(self.name + ".backward", module, args, out)
        return out


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _watch_backward(name: str, module: torch.nn.Module, inputs, out) -> None:
    """Hooks that write the row `name` when `module`'s backward runs: it
    starts once the gradients of every output that needs one have arrived
    and ends once those of every parameter and input that needs one have
    been produced. The hooks of the stage's last call are removed here if
    its backward never ran, and by the row's end otherwise."""
    outs = [t for t in _tensors(out) if t.requires_grad]
    ins = [t for t in _tensors(inputs) if t.requires_grad]
    ins += [p for p in module.parameters() if p.requires_grad]
    if name in _TABLE.pending:
        _remove(_TABLE.pending.pop(name))
    if not outs or not ins:
        return
    start: list = []

    def started(_grads):
        start[:] = [_TABLE.open[-1] if _TABLE.open else None, time.time_ns(), _event()]

    def ended(_grads):
        if not start:
            return
        end_ns, end_event = time.time_ns(), _event()
        parent, start_ns, start_event = start
        start.clear()
        events = (start_event, end_event) if end_event is not None else None
        _TABLE.rows.append(Row(name, parent, start_ns, end_ns, events))
        if _TABLE.pending.get(name) is handles:
            _remove(_TABLE.pending.pop(name))

    graph = torch.autograd.graph
    handles = [graph.register_multi_grad_hook(outs, started),
               graph.register_multi_grad_hook(ins, ended)]
    _TABLE.pending[name] = handles


def span(name: str, device: bool = False, backward: bool = False):
    """A context manager over one piece of work, recorded while a
    torch.profiler session records (the module's docstring). Its value's
    `call(module, *args)` calls the module; with `backward=True` it also
    records the module's backward."""
    if not torch.autograd._profiler_enabled():
        _TABLE.stale = True
        return _OFF
    return _Span(name, device, backward)


def op(name: str):
    """Decorator: each call of the function in a span `name` of host time
    alone (the kernels' entry points, `op.<kernel>`)."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned
    return wrap


def rows() -> List[Row]:
    """The span table of the current session, in the order the spans
    ended."""
    if not torch.autograd._profiler_enabled():
        _TABLE.stale = True
    return list(_TABLE.rows)


def spans(name: str) -> List[Tuple[float, Optional[float]]]:
    """[(host ms, device ms or None), ...] of the current session's spans
    named `name`, after one synchronise where any has device events."""
    mine = [r for r in rows() if r.name == name]
    if any(r.events is not None for r in mine):
        torch.cuda.synchronize()
    return [((r.end_ns - r.start_ns) / 1e6,
             r.events[0].elapsed_time(r.events[1]) if r.events is not None else None)
            for r in mine]


def idle_by_span(device_ops: List[Tuple[int, int]], table: List[Row]) -> Dict[str, dict]:
    """Each idle gap between the device operations (start, end) in ns,
    put down to the innermost span open on the host when the gap began (of
    those open then, the one that started last), summed by span name:
    {name: {"gaps": count, "ms": total}}, the most idle first; gaps that
    began outside every span under NO_SPAN."""
    by_start = sorted(table, key=lambda r: r.start_ns)
    starts = [r.start_ns for r in by_start]
    out: Dict[str, dict] = {}
    end = None
    for a, b in sorted(device_ops):
        if end is not None and a > end:
            owner = NO_SPAN
            for r in reversed(by_start[:bisect.bisect_right(starts, end)]):
                if r.end_ns > end:
                    owner = r.name
                    break
            acc = out.setdefault(owner, {"gaps": 0, "ms": 0.0})
            acc["gaps"] += 1
            acc["ms"] += (a - end) / 1e6
        end = b if end is None else max(end, b)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["ms"]))


def device_ops(prof) -> List[Tuple[int, int]]:
    """(start, end) in ns of each device operation of a profile (kernels,
    copies, sets; not the ranges of `record_function` drawn on the device),
    on the host's clock. The profiler puts the device's timestamps on that
    clock only to some hundreds of us: where it draws an operation starting
    before the runtime call that launched it (`cuda*`/`cu*`, matched by
    correlation id), the whole timeline is moved later by the largest such
    lead."""
    dev, launched = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append(e)
        elif e.name().startswith("cu"):
            launched[e.correlation_id()] = e.start_ns()
    leads = [launched[e.correlation_id()] - e.start_ns() for e in dev
             if e.correlation_id() in launched]
    shift = max([0, *leads])
    return [(e.start_ns() + shift, e.end_ns() + shift) for e in dev]


@contextlib.contextmanager
def trace(logdir: str = "./trace"):
    """torch.profiler over the block (the host and, on a card, CUDA
    activity), with the port's spans in it. When the block ends it writes
    the Chrome trace to `logdir/trace.json`, and to
    `logdir/idle_by_span.json` each idle gap of the device put down to the
    span the host was in when it began (`idle_by_span`). Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        _TABLE.reset()
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "idle_by_span.json"), "w") as f:
        json.dump(idle_by_span(device_ops(prof), list(_TABLE.rows)), f, indent=1)


def enable_nan_debugging() -> None:
    """Opt-in NaN hunting: autograd's anomaly mode, which raises at the
    backward of the operation that produced a NaN."""
    torch.autograd.set_detect_anomaly(True)
