"""Where the time of Stack A's float32 forward goes, conv by conv, on one
CUDA card.

    python3 scripts/port_stack_a_convs.py [--batch 1 6]

Builds BevTxt (EfficientNet-b4, cam_channels 64, float32, the 200x200 grid;
weights as `chip_smoke.py::stack_a_models` makes them) and records every
`F.conv2d` of one forward: its input and weight shapes, stride, padding,
dilation and groups. Each distinct conv is then timed alone (CUDA events
around back-to-back calls, `chip_smoke.py::time_ms`) under the port's
float32 pin (`ops/_precision.py::full_float32`: cuDNN's TF32 off) in five
ways: as the port calls it (NCHW, cuDNN's heuristic choice of algorithm);
with input and weight in channels-last memory format; with
`cudnn.benchmark` on over every algorithm (cuDNN times them and keeps the
fastest); with cuDNN's deterministic algorithms only; and with cuDNN off
(PyTorch's own im2col and cuBLAS). Each variant's largest error against
the same conv in float64 (max |diff| over max |reference|) is printed
beside its time. Then the whole forward is timed with each variant applied
to every conv, and its BEV logits compared with the CPU's. Prints one JSON
line per measurement (the slowest convs first), then the card's name and
power limit. Needs one CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


VARIANTS = ("nchw", "channels_last", "benchmark", "deterministic", "no_cudnn")


def _variant(name):
    """A context manager under which F.conv2d runs the variant."""
    import torch
    import torch.nn.functional as F

    if name == "nchw":
        return contextlib.nullcontext()
    if name == "benchmark":
        return torch.backends.cudnn.flags(enabled=True, benchmark=True, benchmark_limit=0,
                                          deterministic=False, allow_tf32=False)
    if name == "deterministic":
        return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                          allow_tf32=False)
    if name == "no_cudnn":
        return torch.backends.cudnn.flags(enabled=False, benchmark=False, deterministic=False,
                                          allow_tf32=False)

    @contextlib.contextmanager
    def channels_last():
        orig = F.conv2d
        cl = torch.channels_last

        def conv(x, w, *a, **k):
            return orig(x.contiguous(memory_format=cl), w.contiguous(memory_format=cl), *a, **k)

        F.conv2d = conv
        try:
            yield
        finally:
            F.conv2d = orig

    return channels_last()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 6])
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from lss2_multimodal_nu_tpu_torch.ops._precision import full_float32

    smoke = _smoke()
    dev = torch.device("cuda", 0)
    one = [torch.from_numpy(a).to(dev) for a in smoke.fake_inputs(1, seed=3)]
    model, cpu_model = smoke.stack_a_models(dev, "bev_txt", one)
    for b in args.batch:
        inputs = [torch.from_numpy(a).to(dev) for a in smoke.fake_inputs(b, seed=4)]
        calls, orig = [], F.conv2d

        def recording(x, w, bias=None, stride=1, padding=0, dilation=1, groups=1):
            calls.append((tuple(x.shape), tuple(w.shape), bias is not None, stride, padding,
                          dilation, groups))
            return orig(x, w, bias, stride, padding, dilation, groups)

        F.conv2d = recording
        try:
            with torch.inference_mode():
                model(*inputs)
        finally:
            F.conv2d = orig
        rows = []
        with torch.inference_mode(), full_float32():
            for spec in dict.fromkeys(calls):
                xs, ws, has_bias, stride, padding, dilation, groups = spec
                x = torch.randn(xs, device=dev)
                w = torch.randn(ws, device=dev) * (2.0 / (ws[1] * ws[2] * ws[3])) ** 0.5
                bias = torch.randn(ws[0], device=dev) if has_bias else None
                row = dict(batch=b, x=xs, w=ws, stride=stride, padding=padding,
                           dilation=dilation, groups=groups, count=calls.count(spec))
                ref = F.conv2d(x.double(), w.double(), None if bias is None else bias.double(),
                               stride, padding, dilation, groups)
                scale = float(ref.abs().max())
                for v in VARIANTS:
                    with _variant(v):
                        fn = lambda: F.conv2d(x, w, bias, stride, padding, dilation, groups)
                        out = fn()
                        row[f"{v}_ms"] = smoke.time_ms(fn, reps=5, warmup=2)
                    row[f"{v}_rel_err"] = float((out.double() - ref).abs().max()) / scale
                rows.append(row)
        rows.sort(key=lambda r: -r["nchw_ms"] * r["count"])
        for row in rows:
            print("conv " + json.dumps(row))
        with torch.inference_mode():
            want = cpu_model(*[t.cpu() for t in inputs])[0] if b == 1 else None
            for v in VARIANTS:
                with _variant(v):
                    bev = model(*inputs)[0]
                    fwd = smoke.time_ms(lambda: model(*inputs), reps=5, warmup=2)
                row = dict(batch=b, variant=v, ms=fwd)
                if want is not None:
                    row["bev_max_abs_diff_vs_cpu"] = float((bev.cpu() - want).abs().max())
                print("forward " + json.dumps(row))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
