"""Which operations of the port's train steps torch itself knows to have no
deterministic implementation, on one CUDA card.

    python3 scripts/port_determinism.py

Starts itself again as a child process with `CUBLAS_WORKSPACE_CONFIG=:4096:8`
in its environment, so that the setting and the flag reach that process
alone. The child calls `torch.use_deterministic_algorithms(True,
warn_only=True)`, runs one train step of the flagship in bfloat16 at B=8
and one of train-v2's flagship in float32 at B=8 (`chip_smoke.py::
train_path`, `train/steps.py::train_step`), and records every warning torch
gives for an operation it knows to be nondeterministic (an operation with a
deterministic alternative takes it silently under the flag; cuDNN is held
to deterministic algorithms by the step itself). The port's own kernels are
outside torch's list: `chip_smoke.py`'s "train steps repeat" checks them.
Prints one JSON line, {"paths": {path: [warnings]}, "flagged": n}, and the
card's name and power limit; exits 1 where an operation was flagged. Needs
one CUDA card; imports no JAX.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PATHS = ("flagship bf16", "train-v2 flagship f32")


def child() -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from lss2_multimodal_nu_tpu_torch.ops import _build
    from lss2_multimodal_nu_tpu_torch.train.steps import train_step

    _build.build_all()
    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device("cuda", 0)
    found = {}
    for label in PATHS:
        model, opt, sched, batch = smoke.train_path(dev, label)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            metrics = train_step(model, opt, sched, batch, 0)
            torch.cuda.synchronize()
        if not torch.isfinite(metrics["loss"]):
            print(f"port_determinism: the {label} step's loss is not finite", file=sys.stderr)
            return 2
        found[label] = sorted({str(w.message).splitlines()[0] for w in caught
                               if "deterministic" in str(w.message)})
        del model, opt, sched, batch
        torch.cuda.empty_cache()
    print(json.dumps({"paths": found, "flagged": sum(len(v) for v in found.values())}))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_determinism: needs a CUDA card", file=sys.stderr)
        return 1
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    run = subprocess.run([sys.executable, __file__, "--child"], env=env, capture_output=True,
                         text=True, timeout=900)
    sys.stderr.write(run.stderr[-4000:])
    lines = run.stdout.strip().splitlines()
    if run.returncode != 0 or not lines:
        print(f"port_determinism: the child exited with {run.returncode}", file=sys.stderr)
        return 2
    print(lines[-1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi unavailable")
    return 1 if json.loads(lines[-1])["flagged"] else 0


if __name__ == "__main__":
    sys.exit(child() if sys.argv[1:] == ["--child"] else main())
