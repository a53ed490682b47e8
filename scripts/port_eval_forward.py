"""The flagship's B=6 eval forward of one checkout of the port, on one CUDA card.

    python3 scripts/port_eval_forward.py [--root DIR] [--dtype float32|bfloat16]

Imports `lss2_multimodal_nu_tpu_torch` from DIR (default: this checkout), so
that two versions of the port can be set against each other on one card,
one process each, in turns (parent, change, change, parent). Runs
`chip_smoke.py::eval_forward` of this checkout on them: every kernel's
launches, the host-clock median of 10 forwards, the stages, device busy
and idle share, the busiest kernels. Prints one JSON line with the root,
dtype, the forward's median ms, device busy ms, idle share and stages, then
the card's name and power limit. DIR's kernels build into DIR/build/kernels. Needs one CUDA
card; imports no JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_eval_forward: needs a CUDA card", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from lss2_multimodal_nu_tpu_torch.ops import _build
    from lss2_multimodal_nu_tpu_torch.ops import deformable_sampling as ds
    from lss2_multimodal_nu_tpu_torch.ops import ffn
    from lss2_multimodal_nu_tpu_torch.ops import lift_splat as ls
    from lss2_multimodal_nu_tpu_torch.ops import seg_head as sh

    if not Path(_build.__file__).resolve().is_relative_to(root):
        print(f"port_eval_forward: the port imported from {_build.__file__}, not {root}",
              file=sys.stderr)
        return 1
    # a checkout from before the port pinned its own float32 precision needs
    # the flags set process-wide to compute the same function
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    wrappers = {"deformable_sample": ds.deformable_sample_combine_xy,
                "deformable_sample_backward": ds.deformable_sample_combine_xy_backward,
                "lift_splat": ls.fused_lift_splat,
                "lift_splat_backward": ls.fused_lift_splat_backward,
                "ffn_ln": ffn.fused_ffn_ln, "seg_head": sh.fused_seg_head}
    _, err, numbers = smoke.eval_forward(torch.device("cuda", 0), args.dtype, "3", wrappers)
    if err:
        print(f"port_eval_forward: {err}", file=sys.stderr)
        return 1
    print(json.dumps(dict(root=str(root), dtype=args.dtype, **numbers)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
