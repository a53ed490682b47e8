"""The readings that the limits of `limits/<cell>.json` are set from, for
one cell on many seeds in one process:

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 3 ... \
        [--seconds S] [--control 3] [--fault 3]

For each seed, the port set up as a run sets it up, driven by the cell's
loop through a window of S seconds (BENCHMARK.json's `run_seconds` where
left out), and the check's own steps after it, against the reference in
full float32: the lower readings. For the first `--control` seeds the
control: the reference computed with TF32 on, the precision below the
configuration's float32, in the port's place. For a train cell's first
`--fault` seeds the fault: the port's train step given half of each batch
(the mean taken over the rest), set-up and window included. Prints one
JSON line per reading; needs a CUDA card.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = "lss2_multimodal_nu_tpu_torch"


def half_batch(train_step):
    """The port's train step given the first half of every batch."""
    def broken(model, opt, sched, batch, step, mark=None):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return train_step(model, opt, sched, half, step, mark=mark)
    return broken


def program(cell, seed, device, seconds):
    """(loop, got, kept): the port driven through a window and the check's
    steps after it, its state freed."""
    from benchlib import manifest, trace

    loop = manifest.loop(cell.traffic).Loop(cell, seed, [device], trace.Recorder(False))
    first = loop.step
    loop.window(seconds, False)
    loop.after_window()
    got, kept = loop.outputs(first)
    loop.free()
    return loop, got, kept


def control(cell, seed, loop, kept, device):
    """The control's outputs in the form of the port's: the reference with
    TF32 on, in the port's place."""
    from benchlib import check

    ref = check.reference(loop.KIND, cell.cfg, seed, kept, loop.pool_n, device, loop.overrides,
                          "tf32")
    return check.as_program(loop.KIND, cell.cfg, ref, kept)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--fault", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]
    import torch

    from benchlib import check, manifest

    cell = manifest.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("readings.py: needs a CUDA card", file=sys.stderr)
        return 2
    seconds = args.seconds or json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    dev = torch.device("cuda:0")

    def emit(kind, seed, loop, got, kept, t0):
        nums = check.numbers(loop.KIND, cell.cfg, seed, got, kept, loop.pool_n, dev,
                             loop.overrides)
        print(json.dumps({"cell": cell.name, "kind": kind, "seed": seed, "steps": loop.step,
                          "seconds": round(time.perf_counter() - t0, 2), **nums}), flush=True)

    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        loop, got, kept = program(cell, seed, dev, seconds)
        emit("program", seed, loop, got, kept, t0)
        if i < args.control:
            t0 = time.perf_counter()
            emit("control_tf32", seed, loop, control(cell, seed, loop, kept, dev), kept, t0)
        if loop.KIND == "train" and i < args.fault:
            t0 = time.perf_counter()
            steps = importlib.import_module(f"{PORT}.train.steps")
            original = steps.train_step
            steps.train_step = half_batch(original)
            try:
                loop, got, kept = program(cell, seed, dev, seconds)
            finally:
                steps.train_step = original
            emit("fault_half_batch", seed, loop, got, kept, t0)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
