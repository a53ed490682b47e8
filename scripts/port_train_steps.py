"""The four training paths' train steps of one checkout of the port, on one
CUDA card.

    python3 scripts/port_train_steps.py [--root DIR] [--paths LABEL ...]
                                        [--cudnn-pin on|off] [--profile]

Imports `lss2_multimodal_nu_tpu_torch` from DIR (default: this checkout), so
that two versions of the port can be set against each other on one card,
one process each, in turns (parent, change, change, parent). The paths are
built by this checkout's `chip_smoke.py::train_path` (the flagship bf16
B=8, BevTxt b4 f32 B=6, pretrain-v2 f32 B=12, train-v2's flagship f32 B=8).
For each: 3 train steps to warm up, then the host-clock median of 10 steps
each ended by `torch.cuda.synchronize()`, and the forward / backward /
optimizer split (CUDA events, median of 5; `chip_smoke.py::split_step_ms`).
Prints one JSON line a path with the root, the path, its median ms, the
range, samples/s and the split, then the card's name and power limit. DIR's
kernels build into DIR/build/kernels. Needs one CUDA card; imports no JAX.

`--cudnn-pin off` runs the steps without `train_step`'s hold on cuDNN's
deterministic algorithms (`ops/_precision.py::deterministic_cudnn`), full
float32 still pinned: a measurement of what that hold costs, never a way to
train. `--profile` adds each path's busiest kernels in one profiled step
(torch.profiler, device ms and launches by kernel name, top 25;
`chip_smoke.py::device_profile`) and the device busy ms.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--paths", nargs="+", default=list(smoke.TRAIN_PATHS),
                    choices=smoke.TRAIN_PATHS)
    ap.add_argument("--cudnn-pin", default="on", choices=("on", "off"))
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_train_steps: needs a CUDA card", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from lss2_multimodal_nu_tpu_torch.ops import _build
    from lss2_multimodal_nu_tpu_torch.ops._precision import full_float32
    from lss2_multimodal_nu_tpu_torch.train import steps

    if not Path(_build.__file__).resolve().is_relative_to(root):
        print(f"port_train_steps: the port imported from {_build.__file__}, not {root}",
              file=sys.stderr)
        return 1
    _build.build_all()
    if args.cudnn_pin == "off":  # the step's own function, under the float32 pin alone
        steps.train_step = full_float32()(inspect.unwrap(steps.train_step))
    train_step = steps.train_step  # also what `split_step_ms` imports
    dev = torch.device("cuda", 0)
    for label in args.paths:
        model, opt, sched, batch = smoke.train_path(dev, label)
        b = batch["imgs"].shape[0]
        for step in range(3):
            train_step(model, opt, sched, batch, step)
        times = []
        for step in range(3, 13):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(model, opt, sched, batch, step)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        times.sort()
        split = smoke.split_step_ms(model, opt, sched, batch, 13)
        median = times[len(times) // 2]
        line = {"root": str(root), "path": label, "cudnn_pin": args.cudnn_pin, "batch": b,
                "median_ms": median, "min_ms": times[0], "max_ms": times[-1],
                "samples_per_s": b / median * 1e3, "split_ms": split}
        if args.profile:
            busy, _, top, _ = smoke.device_profile(
                lambda: train_step(model, opt, sched, batch, 18), top=25)
            line.update(device_busy_ms=busy, kernels=[[n, ms, c] for n, ms, c in top[:25]])
        print(json.dumps(line), flush=True)
        del model, opt, sched, batch
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi unavailable")
    return 0


if __name__ == "__main__":
    sys.exit(main())
