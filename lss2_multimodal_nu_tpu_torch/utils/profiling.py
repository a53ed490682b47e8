"""Step timing, tracing and NaN hunting (the JAX package's
`utils/profiling.py` in PyTorch)."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


class StepTimer:
    """Host-clock step timing with a percentile summary and a frames/s
    meter. On a card the clock is read between `torch.cuda.synchronize()`
    calls, so a step's time is the card's work, not its enqueue."""

    def __init__(self, frames_per_step: int = 1, device="cuda"):
        self.frames_per_step = frames_per_step
        self.device = torch.device(device)
        self.durations: List[float] = []
        self._t0: Optional[float] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        self._sync()
        dt = time.perf_counter() - self._t0
        self.durations.append(dt)
        return dt

    @contextlib.contextmanager
    def step(self):
        self.start()
        yield
        self.stop()

    def summary(self) -> Dict[str, float]:
        """steps, and mean / median / 90th percentile ms and frames/s over
        the steps after the first (the warm-up)."""
        d = np.asarray(self.durations[1:] or self.durations)
        return {
            "steps": len(self.durations),
            "mean_ms": float(d.mean() * 1e3),
            "p50_ms": float(np.percentile(d, 50) * 1e3),
            "p90_ms": float(np.percentile(d, 90) * 1e3),
            "frames_per_sec": float(self.frames_per_step / d.mean()),
        }


@contextlib.contextmanager
def trace(logdir: str = "./trace"):
    """torch.profiler over the block (the host and, on a card, CUDA
    activity); its Chrome trace is written to `logdir/trace.json` when the
    block ends. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def enable_nan_debugging() -> None:
    """Opt-in NaN hunting: autograd's anomaly mode, which raises at the
    backward of the operation that produced a NaN."""
    torch.autograd.set_detect_anomaly(True)
