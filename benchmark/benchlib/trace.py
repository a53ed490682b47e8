"""What a traced run records, from the benchmark's own files: CUDA events
around the stages the cell's metrics name (forward hooks on the config's
submodules) and at the parts that `train_step` marks, and the device
timeline of torch.profiler over the window. The profiler records device
activity alone: recording every host op as well cost a host-paced cell
half its steps.

`Timeline` reduces the profile to what the readers use: every device
operation (kernels, copies, sets) as (name, start, end) in microseconds,
the device's busy time (the union of the operations' intervals) and a
breakdown: the operations that took most time and the longest idle gaps,
each named by the operations on either side.
"""
from __future__ import annotations

import collections
from contextlib import contextmanager
from typing import Dict, List, Tuple

import torch


class Recorder:
    """CUDA-event spans by name. Disabled, every method does nothing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.spans: Dict[str, List[Tuple[torch.cuda.Event, torch.cuda.Event]]] = \
            collections.defaultdict(list)
        self.marks: List[Dict[str, torch.cuda.Event]] = []
        self._open: Dict[str, torch.cuda.Event] = {}
        self._handles = []

    def _event(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def hook(self, model: torch.nn.Module, stages: Dict[str, str]) -> None:
        """A span named `stage` over each call of model's submodule
        stages[stage]."""
        if not self.enabled:
            return
        for stage, path in stages.items():
            sub = model.get_submodule(path)

            def pre(_m, _a, stage=stage):
                self._open[stage] = self._event()

            def post(_m, _a, _o, stage=stage):
                self.spans[stage].append((self._open.pop(stage), self._event()))

            self._handles += [sub.register_forward_pre_hook(pre), sub.register_forward_hook(post)]

    def unhook(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []

    def step_start(self) -> None:
        if self.enabled:
            self.marks.append({"start": self._event()})

    def mark(self, part: str) -> None:
        """`train_step`'s hook: an event where each part ends."""
        if self.enabled:
            self.marks[-1][part] = self._event()

    def spans_ms(self) -> Dict[str, List[float]]:
        return {k: [a.elapsed_time(b) for a, b in v] for k, v in self.spans.items()}

    def marks_ms(self) -> List[Dict[str, float]]:
        """Per step, the ms of each marked part since the previous mark."""
        out = []
        for m in self.marks:
            keys = list(m)
            out.append({k: m[p].elapsed_time(m[k]) for p, k in zip(keys, keys[1:])})
        return out


@contextmanager
def profiled(enabled: bool):
    """torch.profiler over the block (device activity), yielding a holder
    whose `.prof` is the profile once the block has ended."""
    holder = type("Profile", (), {"prof": None})()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield holder
    holder.prof = prof


def _ns(e, which: str) -> int:
    if hasattr(e, f"{which}_ns"):
        return getattr(e, f"{which}_ns")()
    return int(getattr(e, f"{which}_us")() * 1000)


class Timeline:
    """The device operations of one profile, in us from its first."""

    def __init__(self, prof):
        raw = prof.profiler.kineto_results.events() if prof is not None else []
        dev = [(e.name(), _ns(e, "start"), _ns(e, "end")) for e in raw
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", lambda: False)()]
        t0 = min([d[1] for d in dev] or [0])
        self.ops = sorted(((n, (a - t0) / 1e3, (b - t0) / 1e3) for n, a, b in dev),
                          key=lambda o: o[1])

    def busy_us(self) -> float:
        busy, end = 0.0, float("-inf")
        for _, a, b in self.ops:
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        return busy

    def segments(self, first: str, last: str) -> List[float]:
        """Seconds of device time of each call whose launches run from an
        operation named with `first` through the next named with `last`
        (the same operation where the two are one)."""
        out, acc = [], None
        for name, a, b in self.ops:
            if acc is None and first in name:
                acc = 0.0
            if acc is not None:
                acc += (b - a) / 1e6
                if last in name:
                    out.append(acc)
                    acc = None
        return out

    def gaps(self) -> List[Tuple[float, float, int]]:
        """(start, end, index of the op that ends it) of every idle gap
        between device operations."""
        out, end = [], None
        for i, (_, a, b) in enumerate(self.ops):
            if end is not None and a > end:
                out.append((end, a, i))
            end = b if end is None else max(end, b)
        return out

    def breakdown(self, top: int = 10) -> dict:
        by_name = collections.defaultdict(float)
        for n, a, b in self.ops:
            by_name[n] += (b - a) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        idle = [[f"{self.ops[i - 1][0][:56]} -> {self.ops[i][0][:56]}", (b - a) / 1e6]
                for a, b, i in gaps]
        return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": idle}
