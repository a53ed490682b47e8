"""The flagship's train-mode seg head convs in float32 on one CUDA card,
with cuDNN and without.

    python3 scripts/port_seg_head_train_conv.py [--batch 8 12]

In training, `nn/fusion.py::BEVEncoderTransformer` runs its seg head op by
op (kernel 5 serves eval only): a 3x3 conv 256 -> 128 on the refined BEV
tokens seen as (B, 256, 200, 200) through a permuted view (channels-last
memory), train batch norm and ReLU, then a 3x3 conv 128 -> 64 on that
output. cuDNN took 151-401 ms for a 3x3 256 -> 128 float32 conv at 200x200
with TF32 off in Stack A (FFT tiling, `scripts/port_stack_a_convs.py`).
This script times both convs at the stages' batches (train-v2's 8,
pretrain-v2's 12) in the layouts the train path gives them, forward and
backward (the input's and the weight's gradients), under the port's float32
pin (`ops/_precision.py::full_float32`) with cuDNN's heuristic algorithm,
with `cudnn.benchmark` over every algorithm, with cuDNN off (PyTorch's
im2col and cuBLAS), and as the port runs the first conv: the forward with
cuDNN off and the backward, which picks its backend when it runs, with
cuDNN (`nn/layers.py::cudnn_off_for_float32`); CUDA events around
back-to-back calls
(`chip_smoke.py::time_ms`). Each variant's forward is checked against the
same conv in float64 (max |diff| over max |reference|) and the number of
cuDNN FFT kernel launches in one forward and backward is counted with
torch.profiler. Prints one JSON line per conv and variant, then the card's
name and power limit. Needs one CUDA card; imports no JAX.
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


def _flags(name):
    """A context manager under which a conv runs as `name` says."""
    import torch

    if name == "cudnn":
        return contextlib.nullcontext()
    if name == "benchmark":
        return torch.backends.cudnn.flags(enabled=True, benchmark=True, benchmark_limit=0,
                                          deterministic=False, allow_tf32=False)
    return torch.backends.cudnn.flags(enabled=False, benchmark=False, deterministic=False,
                                      allow_tf32=False)


# variant -> (the forward's flags, the backward's)
VARIANTS = {"cudnn": ("cudnn", "cudnn"), "benchmark": ("benchmark", "benchmark"),
            "no_cudnn": ("no_cudnn", "no_cudnn"), "forward_off_cudnn": ("no_cudnn", "cudnn")}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 12])
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from lss2_multimodal_nu_tpu_torch.ops._precision import full_float32

    smoke = _smoke()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for b in args.batch:
        tokens = torch.randn(b, 200 * 200, 256, device=dev, generator=gen)
        x0 = tokens.view(b, 200, 200, 256).permute(0, 3, 1, 2)  # the train path's view
        w0 = torch.randn(128, 256, 3, 3, device=dev, generator=gen) * (2 / (256 * 9)) ** 0.5
        w1 = torch.randn(64, 128, 3, 3, device=dev, generator=gen) * (2 / (128 * 9)) ** 0.5
        bias0 = torch.randn(128, device=dev, generator=gen) * 0.1
        bias1 = torch.randn(64, device=dev, generator=gen) * 0.1
        with full_float32():
            x1 = F.relu(F.conv2d(x0, w0, bias0, padding=1))  # conv 1's input, in its layout
        for conv, x, w, bias in (("3x3 256->128", x0, w0, bias0), ("3x3 128->64", x1, w1, bias1)):
            with torch.no_grad():
                ref = F.conv2d(x.double(), w.double(), bias.double(), padding=1)
            scale = float(ref.abs().max())
            xg, wg = x.detach().requires_grad_(), w.detach().requires_grad_()
            for v, (f_flags, b_flags) in VARIANTS.items():
                with full_float32():
                    with torch.no_grad(), _flags(f_flags):
                        fwd = lambda: F.conv2d(x, w, bias, padding=1)
                        out = fwd()
                        err = float((out.double() - ref).abs().max()) / scale
                        fwd_ms = smoke.time_ms(fwd, reps=3, warmup=1)
                    g = torch.randn_like(out)

                    def fwd_bwd():
                        with _flags(f_flags):
                            y = F.conv2d(xg, wg, bias, padding=1)
                        with _flags(b_flags):
                            torch.autograd.grad(y, (xg, wg), g)

                    fwd_bwd_ms = smoke.time_ms(fwd_bwd, reps=3, warmup=1)
                    with _flags(f_flags):
                        y = F.conv2d(xg, wg, bias, padding=1)
                    with _flags(b_flags):
                        bwd_ms = smoke.time_ms(
                            lambda: torch.autograd.grad(y, (xg, wg), g, retain_graph=True),
                            reps=3, warmup=1)
                    del y
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        fwd_bwd()
                        torch.cuda.synchronize()
                fft = sum(e.count for e in prof.key_averages() if smoke.is_fft_kernel(e.key))
                print("seg_head_train_conv " + json.dumps(dict(
                    batch=b, conv=conv, variant=v, input_layout=(
                        "channels_last" if x.is_contiguous(memory_format=torch.channels_last)
                        else "nchw" if x.is_contiguous() else "strided"),
                    forward_ms=fwd_ms, backward_ms=bwd_ms,
                    forward_backward_ms=fwd_bwd_ms, fft_launches=fft, rel_err=err)), flush=True)
        del tokens, x0, x1
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
