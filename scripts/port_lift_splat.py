"""Where the time of the port's lift-splat goes, on one CUDA card.

    python3 scripts/port_lift_splat.py

At the flagship's shapes (the forward at B=6, the backward at train-v2's
B=8; the frustum geometry and inputs of `chip_smoke.py::lift_inputs`), in
float32 and bfloat16: the forward wrapper and its index preparation alone
(`ops/lift_splat.py::sort_points`); its plain version in PyTorch calls
(`sort_points_plain`: `torch.sort(stable=True)`, `torch.searchsorted`), the
yardstick it replaced; `zero_()` of a tensor of the output's size, the
card's rate for writing it; the backward wrapper on the cached CSR over the
frustum's fidx; each as the mean of back-to-back calls between CUDA events
(`chip_smoke.py::time_ms`); the host's time per call (`host_ms`), and for
the forward under inference mode the direct call against the autograd
Function (`direct_against_function`); the device's busy time in one call (the union of its kernels' intervals,
`chip_smoke.py::device_profile`) and each kernel's device time
(torch.profiler); and how many output rows have points, and the longest
run. Prints one JSON line per measurement, then the card's
name and power limit. Needs one CUDA card; imports no JAX.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def kernel_times(fn):
    """{kernel name (cut to 60 characters): device ms} of one call of fn."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:60]: round(e.self_device_time_total / 1e3, 4) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


def host_ms(fn, reps=50):
    """Host time of one call: the host clock around `reps` calls that do not
    wait for the card (the launches queue up), divided by `reps`."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def direct_against_function(ls, feat, depth, seg, fidx, nv, rounds=5):
    """Host ms of one forward under `torch.inference_mode()`, as the eval
    forward calls it: `fused_lift_splat` (which calls the forward directly
    when autograd records nothing) against `_FusedLiftSplat.apply` on the
    same inputs; the least of `rounds` alternating readings of `host_ms`
    each, and their difference."""
    import torch

    direct, function = [], []
    with torch.inference_mode():
        for _ in range(rounds):
            direct.append(host_ms(lambda: ls.fused_lift_splat(feat, depth, seg, fidx, nv)))
            function.append(host_ms(
                lambda: ls._FusedLiftSplat.apply(feat, depth, seg, fidx, nv, None)))
    return dict(inference_direct_host_ms=min(direct), inference_function_host_ms=min(function),
                function_minus_direct_host_ms=min(function) - min(direct))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_lift_splat: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from lss2_multimodal_nu_tpu_torch.ops import _build
    from lss2_multimodal_nu_tpu_torch.ops import lift_splat as ls

    dev = torch.device("cuda", 0)
    _build.build_all()
    out = []
    feat, depth, seg, fidx, nv, n_valid, _ = smoke.lift_inputs(dev, smoke.B)
    b = feat.shape[0]
    for dt in (torch.float32, torch.bfloat16):
        fd = feat.to(dt)
        order, rowptr = ls.sort_points(seg, depth, nv)
        t_order, t_rowptr = ls.sort_points_plain(seg, depth, nv)
        same_csr = bool(torch.equal(t_order.int(), order)) and bool(torch.equal(t_rowptr, rowptr))
        runs = rowptr[1:] - rowptr[:-1]
        fill = torch.empty(b, nv, feat.shape[2], dtype=dt, device=dev)
        out.append(dict(
            what="forward", batch=b, dtype=str(dt).split(".")[1], points=b * depth.shape[1],
            live_points=n_valid, rows=b * nv, nonempty_rows=int((runs > 0).sum()),
            longest_run=int(runs.max()),
            fill_output_ms=smoke.time_ms(fill.zero_),
            wrapper_ms=smoke.time_ms(lambda fd=fd: ls.fused_lift_splat(fd, depth, seg, fidx, nv)),
            wrapper_host_ms=host_ms(lambda fd=fd: ls.fused_lift_splat(fd, depth, seg, fidx, nv)),
            wrapper_device_busy_ms=smoke.device_profile(
                lambda fd=fd: ls.fused_lift_splat(fd, depth, seg, fidx, nv))[0],
            sort_points_ms=smoke.time_ms(lambda: ls.sort_points(seg, depth, nv)),
            torch_sort_prep_ms=smoke.time_ms(lambda: ls.sort_points_plain(seg, depth, nv)),
            torch_sort_prep_same_csr=same_csr,
            wrapper_kernels=kernel_times(lambda fd=fd: ls.fused_lift_splat(fd, depth, seg, fidx,
                                                                          nv)),
            torch_sort_prep_kernels=kernel_times(lambda: ls.sort_points_plain(seg, depth, nv)),
            **direct_against_function(ls, fd, depth, seg, fidx, nv),
        ))
        print(json.dumps(out[-1]))
    for case in smoke.lift_backward_cases(dev):
        out.append(dict(
            what="backward", batch=smoke.TRAIN_B, dtype=case["dtype"],
            wrapper_ms=smoke.time_ms(case["kernel"]),
            wrapper_host_ms=host_ms(case["kernel"]),
            plain_ms=smoke.time_ms(case["plain"], reps=10, warmup=1),
            bound_ms=case["bytes"] / smoke.HBM_BYTES_PER_S * 1e3,
            wrapper_kernels=kernel_times(case["kernel"]),
        ))
        print(json.dumps(out[-1]))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
