"""Kernels 6 and 7 (the data slice's JPEG IDCT and augmentation) of one
checkout of the port at train-v2's batch, on one CUDA card.

    python3 scripts/port_data_kernels.py [--root DIR] [--reps 10] [--profile]
                                         [--loader-step FIXTURE]

Imports `lss2_multimodal_nu_tpu_torch` from DIR (default: this checkout), so
that two versions of the port can be set against each other on one card,
one process each, in turns (parent, change, change, parent). The batch: 48
4:2:0 images of 900x1600 (8 samples of 6 cameras) of random quantised
coefficients (seed 0; the kernels' work does not depend on the values), the
train draws of `AugConfig(rand_flip=True)`. Each kernel's call is timed
alone between CUDA events after a write of 256 MB has flushed the 50 MB L2
(the loader's device stage finds its inputs cold), mean of `--reps` after
one warm-up call, with its launches per call. The bounds are this
checkout's `bound` functions (bytes, and integer operations by pipe from the
SASS of this checkout's probes, built into its build/kernels), whichever
port is timed, over the published rates `chip_smoke.py` states. Also
printed: every kernel's ptxas
registers and spills from DIR's build logs, and the card's name and power
limit. One JSON line a kernel. DIR's kernels build into DIR/build/kernels.
`--profile` adds, for each wrapper, its CUDA kernels' device ms a call by
name over `--reps` calls (torch.profiler; `chip_smoke.py::device_profile`).

`--loader-step FIXTURE` adds `chip_smoke.py`'s phase 10d with DIR's port
(train-v2's flagship f32 B=8 fed by the loader, 4 worker threads: the
step's mean, median and idle share over 20 steps beside a preloaded batch),
on the phase-10 fixture at FIXTURE (made there first if it is missing).
Needs one CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import inspect
import json
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--loader-step", default=None)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("port_data_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    # this checkout's bounds, whichever port is timed: its `ops` as a package
    # of another name
    here = types.ModuleType("_here_ops")
    here.__path__ = [str(ROOT / "lss2_multimodal_nu_tpu_torch" / "ops")]
    sys.modules["_here_ops"] = here
    for name in ("_build", "jpeg_idct", "img_aug"):
        setattr(here, name, importlib.import_module(f"_here_ops.{name}"))
    here._build.build_all()
    per = smoke.data_ops_per_unit(here)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from lss2_multimodal_nu_tpu_torch.config import AugConfig
    from lss2_multimodal_nu_tpu_torch.core.augment import sample_augmentation
    from lss2_multimodal_nu_tpu_torch.ops import _build, img_aug, jpeg_idct

    if not Path(_build.__file__).resolve().is_relative_to(root):
        print(f"port_data_kernels: the port imported from {_build.__file__}, not {root}",
              file=sys.stderr)
        return 1
    _build.build_all()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    n, h, w = 8 * 6, 900, 1600
    images = [smoke.random_coefficients(rng, h, w, 3, (2, 2)) for _ in range(n)]
    coefs, quant, meta, _, _ = jpeg_idct.pack(images)
    c, q, m = (torch.from_numpy(a).to(dev) for a in (coefs, quant, meta))
    # the parent's wrapper also takes the most blocks of one image
    extra = (int(np.diff(np.append(meta[:, 0], coefs.shape[0])).max()),) \
        if "max_blocks" in inspect.signature(jpeg_idct.decode).parameters else ()
    conf = AugConfig(rand_flip=True)
    draws = [sample_augmentation(conf, True, rng) for _ in range(n)]
    params, htab, vtab, rows = img_aug.plan(draws, h, w, conf.final_dim)
    pt, ht, vt = (torch.from_numpy(a).to(dev) for a in (params, htab, vtab))
    rgb = jpeg_idct.decode(c, q, m, h, w, *extra)
    calls = {
        "jpeg_idct": (jpeg_idct.decode, lambda: jpeg_idct.decode(c, q, m, h, w, *extra)),
        "img_aug": (img_aug.augment,
                    lambda: img_aug.augment(rgb, pt, ht, vt, conf.final_dim, rows)),
    }
    work = {"jpeg_idct": here.jpeg_idct.bound(meta, coefs.shape[0], h, w, per["jpeg_idct"]),
            "img_aug": here.img_aug.bound(params, htab, vtab, h, w, conf.final_dim,
                                          per["img_aug"])}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    for name, (wrapper, call) in calls.items():
        call()
        before = wrapper.launches
        call()
        launches = wrapper.launches - before
        times = []
        for _ in range(args.reps):
            flush.fill_(1)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            call()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        nbytes, ops = work[name]
        bound_ms, by = smoke.data_bound(nbytes, ops)
        mean = sum(times) / len(times)
        print(json.dumps(dict(root=str(root), kernel=name, ms=mean, ms_min=min(times),
                              ms_max=max(times), reps=args.reps, launches_per_call=launches,
                              bytes=nbytes, int_ops=ops, ops_per_unit=per[name],
                              bytes_ms=nbytes / smoke.HBM_BYTES_PER_S * 1e3,
                              ops_ms=smoke.int_ops_ms(ops), bound_ms=bound_ms,
                              bound_by=by, share=bound_ms / mean, images=n, hw=[h, w])))
        if args.profile:
            def flushed_calls():
                for _ in range(args.reps):
                    flush.fill_(1)
                    call()
            _, _, by_name, _ = smoke.device_profile(flushed_calls, top=8)
            print(json.dumps(dict(root=str(root), kernel=name, profile_ms_a_call={
                k: ms / args.reps for k, ms, _ in by_name if "fill" not in k.lower()})))
    for lib, kernel, spill, regs in smoke.ptxas_lines():
        if lib in ("jpeg_idct", "img_aug"):
            print(f"ptxas {root.name or root} {lib} {kernel}: {regs}; {spill}")
    if args.loader_step:
        fixture = Path(args.loader_step).resolve()
        if not (fixture / "samples").is_dir():
            smoke.data_fixture(fixture)
        launches, err = smoke.data_train(dev, fixture, smoke.port_wrappers())
        if err:
            print(f"port_data_kernels: {err}", file=sys.stderr)
            return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
