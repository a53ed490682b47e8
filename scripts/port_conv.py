"""Kernel 8 (`ops/conv.py::conv2d_tf32x3`) at every conv of the VoVNet-39
trunk on one CUDA card, against cuDNN in float32 and float64.

    python3 scripts/port_conv.py [--batch 48] [--reps 20] [--only-check]

For each distinct conv that the flagship's trunk runs on kernel 8 (the
stem's last two, stages 1-4's OSA and concat convs; 48 images of 128 x 352,
B=8 x 6 cameras): inputs from a numpy seed (ReLU'd normals, as the trunk's
activations are), He-normal weights, a bias; the kernel's eval form (bias
and ReLU in the epilogue) and train form (the raw conv) against the same
conv in float64 (cuDNN), beside cuDNN's float32 conv under the port's pin
(`full_float32`): max |diff| over max |float64|, for each; the kernel's
may be at most twice cuDNN's (the card test's limit,
`tests/test_torch_kernels_cuda.py::test_conv_kernel_trunk_shapes`). Two
calls of the kernel compared bit for bit. Then, unless `--only-check`, CUDA events over
back-to-back calls (`chip_smoke.py::time_ms`): the kernel with its weight
split, cuDNN float32 under the pin, and the bound, the conv's FLOPs at
495/3 TFLOP/s (three TF32 passes). One JSON line a conv, then the sums over
the eval trunk's 26 convs and the train trunk's 38, then the card's name and
power limit. Exit 1 if any check fails. Needs one CUDA card; imports no
JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PEAK_TF32 = 495e12


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only-check", action="store_true")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from lss2_multimodal_nu_tpu_torch.ops import _build, conv
    from lss2_multimodal_nu_tpu_torch.ops._precision import full_float32

    smoke = _smoke()
    dev = torch.device("cuda", 0)
    _build.build_all()
    for lib, kernel, spill, used in smoke.ptxas_lines():
        if lib == "conv_tf32x3":
            print(f"ptxas {kernel}: {spill}; {used}", flush=True)
    convs = smoke.trunk_convs()
    count = Counter(c[:6] for c in convs)
    eval_count = Counter(c[:6] for c in convs if c[6] < 4)
    failed, rows = [], {}
    for key in dict.fromkeys(c[:6] for c in convs):
        cin, h, w, cout, k, s = key
        b = args.batch
        x, wt, bias = smoke.conv_inputs(dev, b, cin, h, w, cout, k, seed=cin * 7 + h + cout)
        p = conv.plan(b, cin, h, w, cout, k, s, _build.sm_count(dev))
        row = {"conv": f"{cin}->{cout} k{k} s{s} at {h}x{w}",
               "stage": next(c[6] for c in convs if c[:6] == key),
               "calls_eval": eval_count[key], "calls_train": count[key],
               "plan": {f: getattr(p, f) for f in ("mt", "n", "th", "tw", "m_tiles", "n_tiles",
                                                   "b_stages")}}
        with torch.inference_mode():
            for form, (bb, relu) in {"eval": (bias, True), "train": (None, False)}.items():
                want = F.conv2d(x.double(), wt.double(), None if bb is None else bb.double(), s,
                                k // 2)
                want = F.relu(want) if relu else want
                scale = float(want.abs().max())
                y1 = conv.conv2d_tf32x3(x, wt, bb, s, k // 2, relu=relu)
                y2 = conv.conv2d_tf32x3(x, wt, bb, s, k // 2, relu=relu)
                torch.cuda.synchronize()
                with full_float32():
                    ref = F.conv2d(x, wt, bb, s, k // 2)
                    ref = F.relu(ref) if relu else ref
                err = float((y1.double() - want).abs().max()) / scale
                err_cudnn = float((ref.double() - want).abs().max()) / scale
                repeat = bool(torch.equal(y1, y2))
                row[form] = {"err": err, "err_cudnn_f32": err_cudnn, "repeat": repeat,
                             "finite": bool(torch.isfinite(y1).all())}
                if not (repeat and row[form]["finite"] and err <= 2 * err_cudnn):
                    failed.append(f"{row['conv']} {form}: {row[form]}")
                del want, y1, y2, ref
            if not args.only_check:
                flops = 2.0 * b * conv.out_size(h, k, s) * conv.out_size(w, k, s) * cout * cin * k**2
                row["gflop"] = flops / 1e9
                row["bound_ms"] = flops / (PEAK_TF32 / 3) * 1e3
                row["kernel_ms"] = smoke.time_ms(
                    lambda: conv.conv2d_tf32x3(x, wt, bias, s, k // 2, relu=True), reps=args.reps)
                with full_float32():
                    row["cudnn_f32_ms"] = smoke.time_ms(
                        lambda: F.relu(F.conv2d(x, wt, bias, s, k // 2)), reps=args.reps)
                row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
        rows[key] = row
        print(json.dumps(row), flush=True)
        del x, wt, bias
        torch.cuda.empty_cache()
    if not args.only_check:
        for name, cnt in (("eval", eval_count), ("train", count)):
            tot = {f: sum(rows[k][f] * n for k, n in cnt.items())
                   for f in ("gflop", "bound_ms", "kernel_ms", "cudnn_f32_ms")}
            tot["share_of_bound"] = tot["bound_ms"] / tot["kernel_ms"]
            print(json.dumps({"trunk": name, "convs": sum(cnt.values()), **tot}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}")
    if failed:
        print("FAILED:\n" + "\n".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
