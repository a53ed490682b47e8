"""The benchmark of the PyTorch/CUDA port on one run of one cell:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic, metrics
and limits are found by name from `BENCHMARK.json` (`benchlib/manifest.py`).
With --trace 0 the result's metrics are the cell's end-to-end metrics, with
--trace 1 its per-layer ones, read from a profile of the window. The last
line of standard output is the result as one JSON object; the numbers of
the correctness check and their limits are the last lines of standard
error. Exits non-zero, printing no result, without as many CUDA cards as the
cell asks for, or if jax, jaxlib, flax or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lss2_multimodal_nu_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # build and kernel caches of anything that compiles stay in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]
    import torch

    from benchlib import manifest, session

    cell = manifest.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: the cell needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    devices = [f"cuda:{i}" for i in range(cell.chips)]
    result = session.run(cell, args.seed, args.seconds, bool(args.trace), devices, T_START)
    found = forbidden_modules()
    if found:
        print(f"run.py: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    bad = [v for m in result["metrics"].values() for v in [m["value"]]
           if not isinstance(v, (int, float)) or not math.isfinite(v)]
    if bad:
        print(f"run.py: a metric is not a finite number: {result['metrics']}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
