"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. setup: versions, the card's name and power limit, the precision flags
     each phase runs under, build the
     CUDA kernels of `lss2_multimodal_nu_tpu_torch/csrc/` with nvcc (timed),
     each kernel's registers and spills (ptxas) and the TF32 tensor-core
     instructions (HGMMA) in the libraries (cuobjdump);
  2. every forward kernel against its plain PyTorch version at the
     flagship's B=6 shapes, in float32 and bfloat16: max errors against the
     stated tolerances, kernel / plain / library times (CUDA events around
     back-to-back calls), and the least time the card could take (bound;
     the float32 FFN tail and seg head run as three TF32 passes, beside the
     SIMT float32 bound); the float32 weights' TF32 split against
     `ops/_tf32.py` bit for bit; the deformable sampling at uniform
     locations and at the main path's local ones, beside its composite
     yardstick (`grid_sample` and a weighted sum, two PyTorch calls); the
     lift-splat wrapper with its index preparation, which is also timed
     alone, and its output repeated bit for bit;
  2b. the two backward kernels against their plain versions at the
     train-v2 shapes (B=8), in float32 and bfloat16, every output checked:
     the deformable sampling's at both kinds of locations, beside autograd
     through the composite yardstick; lift-splat's (the plain version is
     its composite), repeated bit for bit;
  3. the flagship eval forward (VoVNetBEVTransformer, vovnet39, LSS v2, V3,
     6 cameras at 128x352 into a 200x200 BEV, B=6, bfloat16) through
     `build_model`, with every kernel's launch count checked, then timed;
     one forward must make no host sync (profiler);
  3b. the same in float32, the models' and the JAX CLI's default precision;
  4. the same weights and inputs in float32 at B=1 on the card (kernels)
     against the CPU (plain versions), under torch's defaults and again with
     float32 matrix products at "high", each bit for bit equal to the card's
     forward with TF32 turned off by the caller (the forward pins it);
  5. the flagship train step (train-v2's batch, rate, decay, clip and
     schedule: B=8, lr 1e-4, wd 1e-8, clip 10, warmup-cosine; but bfloat16
     and LSS v2, where the CLI defaults to float32 and v1) through
     `train/steps.py::train_step`, with every kernel's launch count checked,
     5 steps on one batch that must move the loss, then timed and profiled,
     with no `cudaStreamSynchronize` or `cudaMemcpy` in a step;
  6. one float32 train step at B=1, dropout off, on the card against the
     CPU: loss, grad_norm and the gradients upstream of both sampling
     kernels, printed beside the card's own spread from weights moved by
     1e-7, the yardstick of their limits; and the card's step under torch's
     defaults and under matmul "high" against its step with TF32 turned off
     by the caller (the step pins it): the loss bit for bit, the gradients
     within PIN_GRAD_TOL;
  2c. (run with phase 2) kernels 3 and 3b at Stack A's width, C=64, in
     float32 and bfloat16: the forward at B=6 and B=1, the backward at B=6,
     against their plain versions with phase 2's limits, repeated bit for
     bit, timed beside their bounds and `index_add_`;
  7. Stack A: BevTxt, the published model (EfficientNet-b4, C=64, float32,
     the JAX CLI's defaults), its eval forward at B=1 (predict) and B=6
     through `build_model`: one lift-splat launch and no host sync a forward,
     timed with its stages; at B=1 BevTxt, LSS and BevTxtOnlyBev on the card
     against the CPU, and BevTxt bit for bit against TF32 turned off by the
     caller;
  8. BevTxt's train step at the CLI's `train` defaults (B=6, float32, lr
     1e-4, wd 1e-8, clip 5.0, one group, no schedule): one lift-splat forward
     and backward launch a step, no host sync, 5 steps that move the loss,
     timed and split; one B=1 step on the card against the CPU beside the
     card's own spread from weights moved by 1e-7;
  9. Stack B's stage-1 -> stage-2 chain at the CLI's defaults, float32,
     LSS v1, checkpoints in the original repo's `.pt` formats
     (`train/checkpoint.py`): 9a. pretrain-v2 (VoVNetPreTrain, B=12, clip
     5.0, one group, warmup-cosine) on labels with pixels at 255: launches
     of kernels 1, 2, 3 and 3b, no host sync, 5 steps that move the loss,
     timed, split and profiled (cuDNN's FFT kernels counted), what the
     repair of ROADMAP fault 7 saves (stage 4 no longer computed at v1), one
     B=12 eval step (kernels 1, 3, 4, 5), and at B=1 the card against the
     CPU (forward, the pin bit for bit, a train step's gradients beside the
     card's own spread); 9b. its components saved as `best_pretrained.pth`
     and loaded into train-v2's flagship (B=8, clip 10, two groups) with
     `restore_loose`, the four components bit for bit and the rest at init,
     the flagship's float32 train step timed as in 9a, and a v2 pretrain's
     file into the v1 flagship dropping `depth_net` whole; 9c.
     `state_latest.pth` saved and restored into fresh objects, the state
     bit for bit and the next step's loss bit for bit.

Phases 2, 2b and 2c run kernels, plain versions and yardsticks in full
float32 (`ops/_precision.py::full_float32`); phases 3 to 8 run under
torch's default flags, as a user's program would, and the port's entry
points pin full float32 themselves. The last lines are the card
(nvidia-smi), one JSON object with every kernel's numbers (the deformable
kernels' at uniform locations; lift-splat at C=64 as entries of their own),
and `{"ok": true, "device": {...}}`. Needs
one CUDA card; imports no JAX.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and op/s by type.
# The float32 tensor-core kernels run each product as three TF32 passes.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3}

B, NCAM, IMG_H, IMG_W = 6, 6, 128, 352
NH, DH, NPTS, GRID = 8, 32, 8, 200
# train-v2 (the JAX package's `cli.py` defaults): batch 8, lr 1e-4, wd 1e-8,
# clip 10, 60 epochs with 5 of warmup. One epoch counts as one step here, so
# that the smoke's few steps climb the warmup and the loss can move (with a
# dataset's thousands of batches per epoch the rate would stay near 0).
TRAIN_B, STEPS_PER_EPOCH = 8, 1
# phase 6: a float32 gradient on the card against the CPU's, per leaf. At
# random weights the float32 gradient is chaotic: round-off in another order
# flips ReLUs and bilinear cells. Phase 6 measures that on the card alone,
# from weights moved by 1e-7 (H100): max |diff| over the leaf's max |grad|
# up to 0.086 (a depth-net conv), norm of diff over norm up to 0.019 (the
# stem); the card against the CPU differs as much. Limits, about 2.5 times
# those: GRAD_TOL 0.2 on the max and GRAD_NORM_TOL 0.05 on the norm, so a
# leaf scaled wrongly by 5% or more fails. The leaves that reach a kernel only
# through its linear path (cam_encode into lift-splat, value_proj into the
# sampling) moved by at most 6.4e-4 in the control: GRAD_TOL_LINEAR 1e-2. A
# gradient that is cut off is off by 1.
GRAD_TOL, GRAD_NORM_TOL, GRAD_TOL_LINEAR = 0.2, 0.05, 1e-2
# Phase 6's card step under torch's defaults, and again with matmul "high",
# against the same step with TF32 turned off by the caller (the step pins full
# float32 itself, its backward too): the loss bit for bit, and each leaf's
# gradient within PIN_GRAD_TOL in norm. Pinned, they differed by at most
# 1.6e-6 (the deformable backward's atomics add in varying order); with the
# pin taken out of the forward and the step, by 0.47 on the stem conv
# (scripts/port_precision.py, NVIDIA H100 80GB HBM3, 700.00 W).
PIN_GRAD_TOL = 1e-4
# Stack A (phases 2c, 7, 8): the lift-splat width (`cam_channels`), train's
# batch (the JAX CLI's `train` default) and predict's batch
STACK_A_C, STACK_A_B, PREDICT_B = 64, 6, 1
# phase 8's leaves: the depth net, which reaches the loss only through the
# lift-splat kernels (linear in its features), the encoder's Up and stem
# upstream of it, and the BEV decoder's first conv, which reads the kernel's
# output
STACK_A_LEAVES = ("camencode.depthnet.weight", "camencode.depthnet.bias",
                  "encoder.up1.conv.0.weight", "encoder.trunk._conv_stem.weight",
                  "bevencode.conv1.weight")
# Phase 8's limits are phase 6's but for the depth net's, which the control
# (the card against itself from weights moved by 1e-7, B=1, dropout off)
# moved by up to 1.45e-2 in max |diff| over max |grad| (NVIDIA H100 80GB
# HBM3, 700.00 W; the card against the CPU 1.9e-3): the B=1 step's train-mode
# batch norm on the 100x100 BEV maps flips ReLUs under round-off. 0.04 is
# 2.8 times that spread, as phase 6's limits are to theirs.
STACK_A_GRAD_TOL_LINEAR = 0.04
# the stage-1 -> stage-2 chain (phase 9): pretrain-v2's batch (the JAX CLI's
# default, `cli.py:724-727`); train-v2's is TRAIN_B
PRETRAIN_B = 12
# phase 9a's limits are phase 6's but for the linear paths' (cam_encode,
# value_proj), which the pretrain's control (the card against itself from
# weights moved by 1e-7, B=1, dropout off) moved by up to 5.2e-3 in max |diff|
# over max |grad| (cam_encode; the card against the CPU 3.0e-3), half phase
# 6's 1e-2 (NVIDIA H100 80GB HBM3, 700.00 W). 0.015 is 2.9 times that spread,
# as phase 8's limit is to its own; the other leaves' control spread is at
# most 3.6e-2 in max and 1.8e-2 in norm, under phase 6's 0.2 and 0.05.
PRETRAIN_GRAD_TOL_LINEAR = 0.015


def ptxas_lines():
    """(library, kernel, spill line, registers line) of every kernel in the
    build logs of `ops/_build.py` (nvcc -Xptxas -v); a kernel's C++ name is
    cut from its mangled one."""
    import re

    from lss2_multimodal_nu_tpu_torch.ops import _build

    out = []
    for log in sorted(_build.BUILD_DIR.glob("*.log")):
        kernel = spill = None
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = _kernel_name(m.group(1))
            elif "spill" in line:
                spill = line.strip()
            elif "Used" in line and kernel is not None:
                out.append((log.stem, kernel, spill, line.split(":", 1)[1].strip()))
            elif "error" in line.lower():
                out.append((log.stem, "error", line.strip(), ""))
    return out


def _kernel_name(mangled):
    """The first length-prefixed name ending in `_kernel` of a mangled C++
    name, with its template's integer arguments."""
    import re

    i = 0
    while i < len(mangled):
        m = re.match(r"\d+", mangled[i:])
        if not m:
            i += 1
            continue
        start = i + len(m.group())
        name = mangled[start:start + int(m.group())]
        if name.endswith("_kernel"):
            tail = mangled[start + len(name):]
            args = re.findall(r"L[ib](\d+)E", tail[:tail.find("EEv") + 1])
            return name + (f"<{', '.join(args)}>" if args else "")
        i = start + len(name)
    return mangled


def tf32_hgmma_count(lib):
    """Number of TF32 warpgroup MMA instructions in a built library's SASS."""
    cuobjdump = Path("/usr/local/cuda/bin/cuobjdump")
    if not cuobjdump.exists():
        return "not measured (no cuobjdump)"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120).stdout
    return sum(1 for line in sass.splitlines() if "HGMMA" in line and "TF32" in line)


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def fake_inputs(b, n=NCAM, h=IMG_H, w=IMG_W, seed=0):
    """Camera images (B, N, 3, H, W) and calibration, made with numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(b, n, h, w, 3)).astype(np.float32).transpose(0, 1, 4, 2, 3)
    rots = np.broadcast_to(np.eye(3, dtype=np.float32), (b, n, 3, 3)).copy()
    trans = rng.normal(0, 1, (b, n, 3)).astype(np.float32)
    intr = np.broadcast_to(
        np.array([[1266.0, 0, 800.0], [0, 1266.0, 450.0], [0, 0, 1.0]], np.float32),
        (b, n, 3, 3),
    ).copy()
    post_r = np.broadcast_to(np.eye(3, dtype=np.float32) * (w / 1600.0), (b, n, 3, 3)).copy()
    post_r[..., 2, 2] = 1.0
    post_t = np.zeros((b, n, 3), np.float32)
    return [np.ascontiguousarray(a) for a in (imgs, rots, trans, intr, post_r, post_t)]


def perturb(model, seed):
    """Random batch-norm statistics and small noise on the zero-initialised
    attention projections, so the checks see non-trivial values."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(t(rng.uniform(0.5, 1.5, n)))
                m.bias.copy_(t(rng.normal(0, 0.1, n)))
                m.running_mean.copy_(t(rng.normal(0, 0.1, n)))
                m.running_var.copy_(t(rng.uniform(0.5, 1.5, n)))
        for name, p in model.named_parameters():
            if "sampling_offsets.weight" in name or "attention_weights.weight" in name:
                p.copy_(t(rng.normal(0, 0.02, tuple(p.shape))))


def time_ms(fn, reps=20, warmup=3):
    """Mean time of `reps` calls made back to back after `warmup` calls: CUDA
    events around the whole run, so the host's work for one call overlaps
    the card's work for the one before, as in a forward."""
    import torch

    for _ in range(warmup):
        fn()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


# substrings of the port's own kernel names, as the profiler lists them
PORT_KERNEL_NAMES = ("deform_sample", "lift_splat", "keys_kernel", "rowptr_kernel",
                     "DeviceRadixSortOnesweep", "ffn_ln", "conv3x3", "split_tf32")
# host-side CUDA calls that make the host wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaMemcpy", "cudaDeviceSynchronize")
# substrings of the kernels of cuDNN's FFT convolutions (for one float32
# conv at 200x200 a complex float32 gemm, `sm80_xmma_gemm_cf32cf32_...`, ran
# 33024 times on an H100)
FFT_KERNEL_NAMES = ("fft", "complex", "_cf32")


def is_fft_kernel(name):
    return any(k in name.lower() for k in FFT_KERNEL_NAMES)


def device_profile(fn, top=12):
    """Device time over one call of `fn` under torch.profiler (CUPTI): busy
    ms, the length of the union of the kernels' and copies' intervals (cuDNN
    may run kernels side by side, so their sum can exceed the call), and by
    kernel name the busiest ones and every kernel of the port's own, as
    (name, summed ms, count), cuDNN's FFT kernels among them; and the calls
    of `SYNC_CALLS` that `fn` made
    (the profile's own closing `cudaDeviceSynchronize` not counted). Ranges
    that annotate the device timeline (`Optimizer.step#Adam.step`) are not
    work of their own and are left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    work = lambda e: (e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False))
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted((e.time_range.start, e.time_range.end) for e in prof.events() if work(e)):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    rows = sorted(((e.key[:90], e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages() if work(e)), key=lambda r: -r[1])
    shown = [r for i, r in enumerate(rows)
             if i < top or any(k in r[0] for k in PORT_KERNEL_NAMES) or is_fft_kernel(r[0])]
    syncs = {k: sum(1 for e in prof.events() if e.name == k) for k in SYNC_CALLS}
    syncs["cudaDeviceSynchronize"] -= 1
    return busy / 1e3, sum(r[1] for r in rows), shown, syncs


def lift_inputs(dev, b, seed=7, c=128):
    """Lift-splat operands at batch b: the real frustum geometry of the
    flagship inputs (Stack A's is the same), softmax depth weights, feature
    rows of width c (the flagship's 128, Stack A's 64) from a numpy seed,
    and the frustum's constant fidx with the CSR over it that the main path
    caches. Returns (feat (B, R, c) float32, depth, seg, fidx, n_voxels,
    n_valid, fidx_csr)."""
    import numpy as np
    import torch

    from lss2_multimodal_nu_tpu_torch.config import GridConfig
    from lss2_multimodal_nu_tpu_torch.core.frustum import create_frustum
    from lss2_multimodal_nu_tpu_torch.core.geometry import get_geometry, voxel_indices
    from lss2_multimodal_nu_tpu_torch.core.grid import gen_dx_bx
    from lss2_multimodal_nu_tpu_torch.ops import lift_splat as ls

    rng = np.random.default_rng(seed)
    grid = GridConfig()
    dx, bx, nx = gen_dx_bx(grid.xbound, grid.ybound, grid.zbound)
    frustum = torch.from_numpy(create_frustum((IMG_H, IMG_W), grid.dbound, 16)).to(dev)
    _, rots, trans, intr, post_r, post_t = (torch.from_numpy(a).to(dev) for a in fake_inputs(b))
    idx, valid = voxel_indices(get_geometry(frustum, rots, trans, intr, post_r, post_t), dx, bx, nx)
    d, fh, fw = frustum.shape[:3]
    p = NCAM * d * fh * fw
    idx_f, valid_f = idx.reshape(b, p, 3), valid.reshape(b, p)
    seg = torch.where(valid_f, (idx_f[..., 2] * GRID + idx_f[..., 0]) * GRID + idx_f[..., 1], 0)
    logits = torch.from_numpy(rng.normal(size=(b, NCAM, d, fh, fw)).astype(np.float32)).to(dev)
    depth = torch.where(valid_f, torch.softmax(logits, 2).reshape(b, p), 0.0)
    fidx, csr = ls._feature_rows_on(NCAM, d, fh, fw, b, dev)
    feat = torch.from_numpy(rng.normal(size=(b, NCAM * fh * fw, c)).astype(np.float32)).to(dev)
    return (feat, depth, seg.to(torch.int32), fidx, GRID * GRID, int(valid_f.sum()), csr)


def rows_read(idx, n_rows, live=None):
    """How many distinct rows (b, idx[b, p]) the points read, over the
    points where `live` (every point where it is None): the bytes a gather
    through idx must move are these rows, each read once."""
    import torch

    keys = idx.long() + torch.arange(idx.shape[0], device=idx.device)[:, None] * n_rows
    return int(torch.unique(keys if live is None else keys[live]).numel())


def deform_inputs(dev, bh, seed=7, locations="uniform"):
    """Sampling operands for bh value maps of the 200x200 grid: v, locations
    in [0, 1], softmax weights, from a numpy seed. Locations "uniform" are
    drawn over the whole map with 5% clamped to the edges; "local" are the
    main path's kind, each query's own cell (the reference grid of
    `nn/transformer.py`) plus Gaussian offsets of 4 cells, clamped to
    [0, 1] (the offsets' init puts point k at k+1 cells)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n = GRID * GRID
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    v = t(rng.normal(size=(bh, n, DH)))
    if locations == "uniform":
        lx = torch.clamp(t(rng.uniform(0, 1, size=(bh, NPTS, n))) * 1.1 - 0.05, 0, 1)
        ly = torch.clamp(t(rng.uniform(0, 1, size=(bh, NPTS, n))) * 1.1 - 0.05, 0, 1)
    else:
        cells = np.linspace(0, 1, GRID, dtype=np.float32)
        ref_y, ref_x = (a.reshape(n) for a in np.meshgrid(cells, cells, indexing="ij"))
        lx = t(np.clip(ref_x + rng.normal(0, 4, (bh, NPTS, n)) / GRID, 0, 1))
        ly = t(np.clip(ref_y + rng.normal(0, 4, (bh, NPTS, n)) / GRID, 0, 1))
    attn = torch.softmax(t(rng.normal(size=(bh, NPTS, n))), dim=1)
    return v, lx, ly, attn


def deform_composite(v, lx, ly, attn, g=None):
    """The deformable kernels' yardstick, never called by the port: the
    original repo's formulation in two PyTorch calls, `F.grid_sample`
    (align_corners=False, zero padding) on v as (BH, dh, H, W) at the grid
    (BH, N, npts, 2) = 2 (lx, ly) - 1, then the attention-weighted sum over
    the points, all in v's dtype (`grid_sample` takes bfloat16 on the card,
    so in bfloat16 the grid is rounded to bfloat16 too). Returns the forward
    as a function giving (BH, N, dh); with a cotangent g (BH, N, dh), the
    backward instead: autograd through the same two calls, from a forward
    run once here."""
    import torch

    bh, n, dh, dt = v.shape[0], lx.shape[2], v.shape[2], v.dtype
    vimg = v.transpose(1, 2).reshape(bh, dh, GRID, GRID).contiguous()
    grid = (torch.stack([lx, ly], -1).permute(0, 2, 1, 3) * 2 - 1).to(dt).contiguous()
    at = attn.permute(0, 2, 1).to(dt).contiguous()

    def forward():
        s = torch.nn.functional.grid_sample(vimg, grid, mode="bilinear", padding_mode="zeros",
                                            align_corners=False)  # (BH, dh, N, npts)
        return (s * at[:, None]).sum(-1).transpose(1, 2)

    if g is None:
        return forward
    leaves = [t.requires_grad_() for t in (vimg, grid, at)]
    out = forward()
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def kernel_cases(dev):
    """(name, dtype, kernel_fn, plain_fn, library_fn or None, bytes, ops and
    the type they run in, tolerance) at the flagship's B=6 shapes, inputs
    from a numpy seed; the deformable sampling also at its two kinds of
    locations, with its composite yardstick. Bytes count each input read
    once and each output written once; the gathers and the scatter do
    float32 arithmetic whatever the storage type, the matrix products run in
    the storage type (float32 as three TF32 passes)."""
    import numpy as np
    import torch

    from lss2_multimodal_nu_tpu_torch.ops import deformable_sampling as ds
    from lss2_multimodal_nu_tpu_torch.ops import ffn
    from lss2_multimodal_nu_tpu_torch.ops import lift_splat as ls
    from lss2_multimodal_nu_tpu_torch.ops import seg_head as sh

    rng = np.random.default_rng(7)
    g = lambda *s, scale=1.0: torch.from_numpy(
        (rng.normal(size=s) * scale).astype(np.float32)).to(dev)
    cases = []
    n = GRID * GRID
    bh = B * NH

    # 1. deformable sampling at both kinds of locations, 2. lift-splat
    deform = {kind: deform_inputs(dev, bh, locations=kind) for kind in ("uniform", "local")}
    feat, depth, seg, fidx, _, n_valid, _ = lift_inputs(dev, B)
    p = depth.shape[1]
    # the feature rows that live points read (the forward skips depth-0 points)
    feat_rows = rows_read(fidx, feat.shape[1], depth != 0)
    # 4. FFN tail and 5. seg head
    tok = g(B, n, 256)
    fw_ = dict(w1=g(256, 1024, scale=0.05), b1=g(1024, scale=0.1), w2=g(1024, 256, scale=0.05),
               b2=g(256, scale=0.1), s1=1 + g(256, scale=0.1), o1=g(256, scale=0.1),
               s2=1 + g(256, scale=0.1), o2=g(256, scale=0.1))
    sw = (g(3, 3, 256, 128, scale=0.03), g(128, scale=0.1), g(3, 3, 128, 64, scale=0.04),
          g(64, scale=0.1), g(64, 4, scale=0.1), g(4, scale=0.1))

    for dt, name_dt in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        es = 4 if dt == torch.float32 else 2
        # bfloat16 outputs are rounded once at the end: an order-of-summation
        # difference may flip that rounding, one bf16 ulp (2^-7 relative)
        bf = dt == torch.bfloat16

        for kind, (v, lx, ly, attn) in deform.items():
            a = (v.to(dt), lx, ly, attn)
            cases.append(dict(
                name="deformable_sample", dtype=name_dt, locations=kind,
                kernel=lambda a=a: ds.deformable_sample_combine_xy(*a, GRID, GRID),
                plain=lambda a=a: ds.deformable_sample_combine_xy_plain(*a, GRID, GRID),
                library=None, composite=deform_composite(*a),
                bytes=bh * n * DH * es * 2 + 3 * bh * NPTS * n * 4,
                ops=bh * n * NPTS * DH * 10, op_dtype="float32",
                rel_tol=2 ** -7 if bf else 1e-5,
            ))
        fd = feat.to(dt)
        lifted = (torch.gather(fd.float(), 1, fidx.long()[..., None].expand(-1, -1, 128))
                  * depth[..., None]).reshape(-1, 128)
        segflat = (seg.long() + torch.arange(B, device=dev)[:, None] * n).reshape(-1)
        acc = torch.zeros(B * n, 128, device=dev)
        cases.append(dict(
            name="lift_splat", dtype=name_dt,
            kernel=lambda fd=fd: ls.fused_lift_splat(fd, depth, seg, fidx, n),
            plain=lambda fd=fd: ls.fused_lift_splat_plain(fd, depth, seg, fidx, n),
            library=lambda lifted=lifted, segflat=segflat, acc=acc: acc.zero_().index_add_(
                0, segflat, lifted),
            bytes=feat_rows * 128 * es + 3 * B * p * 4 + B * n * 128 * es,
            ops=2 * n_valid * 128, op_dtype="float32",
            # the kernel sums in sorted order, the plain version in index_add_'s
            rel_tol=2 ** -7 if bf else 1e-5,
            prep=lambda: ls.sort_points(seg, depth, n), repeat=True,
        ))
        td = tok.to(dt)
        args = (fw_["w1"], fw_["b1"], fw_["w2"], fw_["b2"], fw_["s1"], fw_["o1"], fw_["s2"], fw_["o2"])
        # the yardstick: the same tail as PyTorch's own ops in the working dtype
        lw = {k: v.to(dt) for k, v in fw_.items()}
        lw["w1"], lw["w2"] = lw["w1"].t().contiguous(), lw["w2"].t().contiguous()

        def ffn_library(td=td, lw=lw):
            F_ = torch.nn.functional
            s = F_.layer_norm(td, (256,), lw["s1"], lw["o1"], 1e-6)
            y = F_.linear(F_.gelu(F_.linear(s, lw["w1"], lw["b1"])), lw["w2"], lw["b2"])
            return F_.layer_norm(s + y, (256,), lw["s2"], lw["o2"], 1e-6)

        cases.append(dict(
            name="ffn_ln", dtype=name_dt,
            kernel=lambda td=td, dt=dt: ffn.fused_ffn_ln(td, *args, eps=1e-6, compute_dtype=dt),
            plain=lambda td=td, dt=dt: ffn.fused_ffn_ln_plain(td, *args, eps=1e-6, compute_dtype=dt),
            library=ffn_library,
            bytes=2 * B * n * 256 * es + 2 * 256 * 1024 * es,
            ops=4 * B * n * 256 * 1024, op_dtype="bfloat16" if bf else "tf32x3",
            # bf16: LN1 and GELU outputs are rounded to bf16 inside; one flipped
            # rounding moves an output by about a bf16 ulp
            rel_tol=2 ** -6 if bf else 1e-4,
        ))
        ximg = td.view(B, GRID, GRID, 256).permute(0, 3, 1, 2)
        cw = [sw[0].permute(3, 2, 0, 1).to(dt).contiguous(),
              sw[2].permute(3, 2, 0, 1).to(dt).contiguous(),
              sw[4].t()[:, :, None, None].to(dt).contiguous()]
        cb = [sw[1].to(dt), sw[3].to(dt), sw[5].to(dt)]

        def cudnn(ximg=ximg, cw=cw, cb=cb):
            y = torch.relu(torch.nn.functional.conv2d(ximg, cw[0], cb[0], padding=1))
            y = torch.relu(torch.nn.functional.conv2d(y, cw[1], cb[1], padding=1))
            return torch.nn.functional.conv2d(y, cw[2], cb[2])

        cases.append(dict(
            name="seg_head", dtype=name_dt,
            kernel=lambda td=td: sh.fused_seg_head(td, *sw, GRID, GRID),
            plain=lambda td=td: sh.fused_seg_head_plain(td, *sw, GRID, GRID),
            # cuDNN on the token layout's strided view, and on a contiguous
            # NCHW copy (made here, outside the timed window) with
            # `cudnn.benchmark` on for its timing only; the faster counts
            library=cudnn,
            library_alt=dict(name="cuDNN, contiguous NCHW, benchmark",
                             fn=lambda x=ximg.contiguous(), cw=cw, cb=cb: cudnn(x, cw, cb)),
            bytes=B * n * 256 * es + B * n * 4 * 4,
            ops=2 * B * n * (9 * 256 * 128 + 9 * 128 * 64 + 64 * 4),
            op_dtype="bfloat16" if bf else "tf32x3",
            # conv0's output crosses memory in bf16 and may round differently
            rel_tol=2 ** -6 if bf else 1e-4,
        ))
    return cases


def backward_cases(dev):
    """The deformable-sampling backward at the train-v2 shapes (B=8: 64 value
    maps of 200x200x32, 8 points), at uniform and local locations: (dtype,
    locations, kernel_fn, plain_fn, composite yardstick, bytes, ops,
    tolerances per output). Bytes: v and g in, lx/ly/attn in, dv in v's
    dtype and the three float32 small gradients out, each once (the float32
    buffer that the kernel sums dv in is its own scratch, not an output of
    the function). Ops: per (map, point, query, channel) and corner, an FMA
    for rc (2) and a multiply, a multiply and an add for dv (3), in
    float32."""
    import numpy as np
    import torch

    from lss2_multimodal_nu_tpu_torch.ops import deformable_sampling as ds

    bh, n = TRAIN_B * NH, GRID * GRID
    g = torch.from_numpy(np.random.default_rng(12).normal(size=(bh, n, DH)).astype(np.float32)).to(dev)
    inputs = {kind: deform_inputs(dev, bh, seed=11, locations=kind) for kind in ("uniform", "local")}
    cases = []
    for dt, name_dt in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        es = 4 if dt == torch.float32 else 2
        for kind, (v, lx, ly, attn) in inputs.items():
            a = (v.to(dt), lx, ly, attn, g.to(dt))
            cases.append(dict(
                dtype=name_dt, locations=kind,
                kernel=lambda a=a: ds.deformable_sample_combine_xy_backward(*a, GRID, GRID),
                plain=lambda a=a: ds.deformable_sample_combine_xy_backward_plain(*a, GRID, GRID),
                composite=lambda a=a: deform_composite(*a[:4], g=a[4]),
                bytes=3 * bh * n * DH * es + 6 * bh * NPTS * n * 4,
                ops=bh * n * NPTS * DH * 4 * 5,
                # Ten times the errors measured on the H100 or more: dv 3.9e-6
                # in float32 (atomics add in a varying order) and 1.6e-3 in
                # bfloat16 (dv is rounded once at the end, and the order may
                # flip that rounding); dlx/dly/dattn are float32 in both
                # dtypes, 8.1e-6, where rc_01 - rc_00 cancels.
                tol={"dv": 2 ** -6 if dt == torch.bfloat16 else 5e-5,
                     "dlx": 1e-4, "dly": 1e-4, "dattn": 1e-4},
            ))
    return cases


def lift_backward_cases(dev):
    """The lift-splat backward at the train-v2 shapes (B=8, the flagship's
    frustum, the cached CSR over its constant fidx, as the main path calls
    it), in float32 and bfloat16: (dtype, kernel_fn, plain_fn, bytes, ops,
    tolerances per output). Bytes: the rows of g that the points read
    (g[b, seg[p]] for every point, row 0 for the depth-0 ones: a few hundred
    of each batch element's 40000), feat read and dfeat written, depth, seg
    and fidx read and the float32 ddepth written, each once. Ops: a dot of
    128 for every point and an FMA of 128 for each point of non-zero depth,
    in float32."""
    import numpy as np
    import torch

    from lss2_multimodal_nu_tpu_torch.ops import lift_splat as ls

    feat, depth, seg, fidx, n_vox, n_valid, csr = lift_inputs(dev, TRAIN_B, seed=9)
    g = torch.from_numpy(np.random.default_rng(14).normal(size=(TRAIN_B, n_vox, 128))
                         .astype(np.float32)).to(dev)
    b, p = depth.shape
    r = feat.shape[1]
    g_rows = rows_read(seg, n_vox)
    print(f"lift-splat backward at B={b}: the points read {g_rows} of g's {b * n_vox} rows")
    cases = []
    for dt, name_dt in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        es = 4 if dt == torch.float32 else 2
        a = (feat.to(dt), depth, seg, fidx, g.to(dt))
        cases.append(dict(
            dtype=name_dt,
            kernel=lambda a=a: ls.fused_lift_splat_backward(*a, _fidx_csr=csr),
            plain=lambda a=a: ls.fused_lift_splat_backward_plain(*a),
            bytes=g_rows * 128 * es + 2 * b * r * 128 * es + 3 * b * p * 4 + b * p * 4,
            ops=2 * 128 * (b * p + n_valid),
            # dfeat: sums of up to 41 points in another order, rounded once
            # to bf16 at the end (one ulp, 2^-7, where the order flips the
            # rounding); ddepth: a float32 dot of 128 in another order
            tol={"dfeat": 2 ** -7 if dt == torch.bfloat16 else 1e-5, "ddepth": 1e-5},
        ))
    return cases


# kernel -> (source, the TPU kernel it replaces, launches per eval forward,
# launches per train step). The `kernels` line's `launches` is the count in
# the first path that runs the kernel: the eval forward for the four forward
# kernels (its meaning since they were ported), the train step for the
# backwards, which only training runs.
KERNELS = {
    "deformable_sample": ("lss2_multimodal_nu_tpu_torch/csrc/deformable_sample.cu",
                          "lss2_multimodal_nu_tpu/ops/deformable_pallas.py:341", 1, 1),
    "deformable_sample_backward": (
        "lss2_multimodal_nu_tpu_torch/csrc/deformable_sample_backward.cu",
        "lss2_multimodal_nu_tpu/ops/deformable_pallas.py:484", 0, 1),
    "lift_splat": ("lss2_multimodal_nu_tpu_torch/csrc/lift_splat.cu",
                   "lss2_multimodal_nu_tpu/ops/lift_splat_pallas.py:50", 1, 1),
    # the backward of kernel 3, which the JAX package leaves to XLA
    "lift_splat_backward": ("lss2_multimodal_nu_tpu_torch/csrc/lift_splat_backward.cu",
                            "lss2_multimodal_nu_tpu/ops/lift_splat.py:97", 0, 1),
    "ffn_ln": ("lss2_multimodal_nu_tpu_torch/csrc/ffn_ln.cu",
               "lss2_multimodal_nu_tpu/ops/ffn_pallas.py:87", 1, 0),
    "seg_head": ("lss2_multimodal_nu_tpu_torch/csrc/seg_head.cu",
                 "lss2_multimodal_nu_tpu/ops/seg_head_pallas.py:63", 2, 0),
}


def train_batch(dev, b, seed):
    """A train-v2 batch: fake_inputs plus BEV labels and action/description
    targets from a numpy seed."""
    import numpy as np
    import torch

    from lss2_multimodal_nu_tpu_torch.train.steps import MODEL_INPUTS

    rng = np.random.default_rng(seed + 100)
    batch = dict(zip(MODEL_INPUTS, (torch.from_numpy(a).to(dev) for a in fake_inputs(b, seed=seed))))
    batch["binimg"] = torch.from_numpy(rng.integers(0, 4, size=(b, GRID, GRID))).to(dev)
    batch["act"] = torch.from_numpy((rng.random((b, 4)) < 0.4).astype(np.float32)).to(dev)
    batch["desc"] = torch.from_numpy((rng.random((b, 8)) < 0.4).astype(np.float32)).to(dev)
    return batch


def train_setup(dev, dtype, seed=0):
    """(model in training mode, optimizer, scheduler) of the flagship under
    train-v2, weights from `seed` plus `perturb`."""
    from lss2_multimodal_nu_tpu_torch.config import Config, ModelConfig, TrainConfig
    from lss2_multimodal_nu_tpu_torch.models.factory import build_model
    from lss2_multimodal_nu_tpu_torch.train.state import build_optimizer

    cfg = Config(model=ModelConfig(family="vovnet_transformer", vovnet_type="vovnet39",
                                   lss_version="v2", compute_dtype=dtype),
                 train=TrainConfig(batch_size=TRAIN_B, lr=1e-4, weight_decay=1e-8,
                                   max_grad_norm=10.0, num_epochs=60, use_schedule=True))
    model = build_model(cfg, device=dev, seed=seed)
    perturb(model, seed=seed + 1)
    opt, sched = build_optimizer(cfg, model.train(), steps_per_epoch=STEPS_PER_EPOCH)
    return model, opt, sched


def split_step_ms(model, opt, sched, batch, step, reps=5):
    """Medians over `reps` train steps (from `step` on) of forward with the
    loss, backward, and clip + Adam + schedule: CUDA events recorded where
    `train_step` marks the end of each part."""
    import torch

    from lss2_multimodal_nu_tpu_torch.train.steps import train_step, train_without_dropout

    parts = {"forward": [], "backward": [], "optimizer": []}
    for i in range(reps):
        ev = [torch.cuda.Event(enable_timing=True)]
        ev[0].record()

        def mark(part):
            ev.append(torch.cuda.Event(enable_timing=True))
            ev[-1].record()

        train_step(model, opt, sched, batch, step + i, mark=mark)
        ev[-1].synchronize()
        for k, a, b in zip(parts, ev, ev[1:]):
            parts[k].append(a.elapsed_time(b))
    return {k: sorted(v)[len(v) // 2] for k, v in parts.items()}


def grad_diffs(got, want, names):
    """{leaf: (max |diff| / max |want|, norm of diff / norm of want,
    max |want|)} of two models' gradients."""
    gp, wp = dict(got.named_parameters()), dict(want.named_parameters())
    out = {}
    for n in names:
        a, b = gp[n].grad.cpu(), wp[n].grad.cpu()
        scale = float(b.abs().max())
        out[n] = (float((a - b).abs().max()) / max(scale, 1e-30),
                  float((a - b).norm() / max(float(b.norm()), 1e-30)), scale)
    return out


def upstream_leaves(model):
    """Phase 6's leaves: those upstream of both sampling kernels, which a
    cut-off autograd would zero (the camera encoder's head, the depth net,
    the stem conv, the deformable attention's projections)."""
    return [n for n, _ in model.named_parameters()
            if n.split(".")[0] in ("cam_encode", "depth_net")
            or n in ("backbone.backbone.stem.0.conv.weight",
                     *(f"bev_encoder.transformer.encoder.self_attn.{m}.weight"
                       for m in ("sampling_offsets", "attention_weights", "value_proj")))]


def eval_forward(dev, dtype, phase, wrappers):
    """Phase 3 (bfloat16) or 3b (float32): the flagship eval forward at B=6
    through `build_model`: every kernel's launches (counts set to 0 just
    before one forward, read just after) against `KERNELS`, the outputs'
    shapes and finiteness, the host-clock median of 10 forwards, the stages
    (CUDA events), device busy time, idle share and the busiest kernels
    (torch.profiler). Returns (launches, failure message or None, the
    numbers: forward ms, busy ms, idle share, stages, host syncs)."""
    import torch

    import contextlib

    from lss2_multimodal_nu_tpu_torch.config import Config, ModelConfig
    from lss2_multimodal_nu_tpu_torch.models.factory import build_model

    try:
        from lss2_multimodal_nu_tpu_torch.ops._precision import full_float32
    except ImportError:  # an older checkout (scripts/port_eval_forward.py --root) sets the flags
        full_float32 = contextlib.nullcontext

    short = {"bfloat16": "bf16", "float32": "f32"}[dtype]
    cfg = Config(model=ModelConfig(family="vovnet_transformer", vovnet_type="vovnet39",
                                   lss_version="v2", compute_dtype=dtype))
    model = build_model(cfg, device=dev, seed=0)
    perturb(model, seed=1)
    inputs = [torch.from_numpy(a).to(dev) for a in fake_inputs(B)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        model(*inputs)  # warm-up (cuDNN autotune, allocator)
        torch.cuda.synchronize()
        for f in wrappers.values():
            f.launches = 0
        seg, action, desc = model(*inputs)
        torch.cuda.synchronize()
        launches = {name: f.launches for name, f in wrappers.items()}
        expected = {name: k[2] for name, k in KERNELS.items()}
        print(f"main path launches, {short} forward: {launches}")
        if launches != expected:
            return launches, f"{short} launch counts {launches}, expected {expected}", None
        shapes = (tuple(seg.shape), tuple(action.shape), tuple(desc.shape))
        if shapes != ((B, 4, GRID, GRID), (B, 4), (B, 8)):
            return launches, f"{short} output shapes {shapes}", None
        if not all(bool(torch.isfinite(t).all()) for t in (seg, action, desc)):
            return launches, f"non-finite {short} output", None
        fwd = []
        for _ in range(10):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            model(*inputs)
            torch.cuda.synchronize()
            fwd.append((time.perf_counter() - t1) * 1e3)
        fwd.sort()
        fwd_ms = fwd[len(fwd) // 2]
        # stage breakdown through the model's own stage methods, in the
        # precision that the forward pins around them
        with full_float32():
            c3, c4 = model.encode_cameras(inputs[0])
            bev = model.lift_to_bev(c3, c4, *inputs[1:])
            _, refined = model.bev_encoder(bev)
            stages = {
                "encode_cameras": time_ms(lambda: model.encode_cameras(inputs[0]), reps=10),
                "lift_to_bev": time_ms(lambda: model.lift_to_bev(c3, c4, *inputs[1:]), reps=10),
                "bev_encoder": time_ms(lambda: model.bev_encoder(bev), reps=10),
                "txt_branch": time_ms(lambda: model.txt_branch(c3, refined), reps=10),
            }
        busy_ms, summed_ms, top, syncs = device_profile(lambda: model(*inputs))
    print(f"forward B={B} {short}: {fwd_ms:.3f} ms median of 10 ({fwd[0]:.3f}-{fwd[-1]:.3f}), "
          f"{B / fwd_ms * 1e3:.2f} samples/s (a sample is {NCAM} cameras)")
    print(f"stages, {short} (ms, CUDA events): {json.dumps(stages)}")
    idle = 1 - busy_ms / fwd_ms if busy_ms else None
    print(f"profiled {short} forward: device busy {busy_ms:.3f} ms (kernel times summed "
          f"{summed_ms:.3f}), idle share of the timed forward "
          f"{'not measured' if idle is None else f'{idle:.3f}'}")
    for name, ms, count in top:
        print(f"  {ms:9.3f} ms {count:4d}x {name}")
    print(f"host syncs in one {short} forward (profiler): {json.dumps(syncs)}")
    print(f"peak device memory in phase {phase}: {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return launches, None, dict(forward_ms=fwd_ms, busy_ms=busy_ms, idle_share=idle, stages=stages,
                                syncs=syncs)


def split_checks(dev):
    """The float32 kernels' TF32 split of their weights on the card (the
    launch each float32 call makes first) against `ops/_tf32.py`, bit for
    bit, at the flagship's weight shapes from a numpy seed. Returns the names
    of the kernels whose split differs."""
    import numpy as np
    import torch

    from lss2_multimodal_nu_tpu_torch.ops import ffn
    from lss2_multimodal_nu_tpu_torch.ops import seg_head as sh

    rng = np.random.default_rng(13)
    g = lambda *s: torch.from_numpy((rng.normal(size=s) * 0.05).astype(np.float32)).to(dev)
    bad = []
    for name, mod, ws in (("ffn_ln", ffn, (g(256, 1024), g(1024, 256))),
                          ("seg_head", sh, (g(3, 3, 256, 128), g(3, 3, 128, 64)))):
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(mod.tf32_split_weights(*ws), mod.tf32_split_weights_plain(*ws)))
        print(f"TF32 split of the {name} weights, card against ops/_tf32.py: "
              f"{'bit for bit equal' if same else 'DIFFERS'}")
        if not same:
            bad.append(name)
    return bad


def check_kernels(dev):
    """Phases 2 and 2b: every kernel against its plain version, timed beside
    its bound and yardstick; prints a `kernel_check` line each. Returns
    (forward rows, backward rows, failure message or None), keyed by (name,
    dtype, locations) and (output, dtype, locations)."""
    import torch

    # ---- 2. kernels against their plain versions
    rows = {}
    ok = True
    for c in kernel_cases(dev):
        got = c["kernel"]().float()
        ref = c["plain"]().float()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        rel = err / max(scale, 1e-30)
        passed = bool(torch.isfinite(got).all()) and rel <= c["rel_tol"]
        ok &= passed
        kms = time_ms(c["kernel"])
        pms = time_ms(c["plain"], reps=20, warmup=1)
        lms = time_ms(c["library"]) if c["library"] is not None else None
        lib_which = "strided view" if "library_alt" in c else None
        if "library_alt" in c:
            bench, torch.backends.cudnn.benchmark = torch.backends.cudnn.benchmark, True
            try:
                alt_ms = time_ms(c["library_alt"]["fn"])
            finally:
                torch.backends.cudnn.benchmark = bench
            if alt_ms < lms:
                lms, lib_which = alt_ms, c["library_alt"]["name"]
        peak = PEAK_OPS[c["op_dtype"]]
        t_bytes, t_ops = c["bytes"] / HBM_BYTES_PER_S * 1e3, c["ops"] / peak * 1e3
        row = dict(name=c["name"], dtype=c["dtype"], max_abs_err=err, max_rel_err=rel,
                   rel_tol=c["rel_tol"], passed=passed, ms=kms, plain_ms=pms, library_ms=lms,
                   bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=c["bytes"], ops=c["ops"], op_type=c["op_dtype"])
        if c["op_dtype"] == "tf32x3":
            row["simt_float32_bound_ms"] = max(t_bytes, c["ops"] / PEAK_OPS["float32"] * 1e3)
        if lib_which is not None:
            row["library_is"] = lib_which
        if "locations" in c:
            comp = c["composite"]().float()
            row.update(locations=c["locations"], composite_ms=time_ms(c["composite"]),
                       composite_max_rel_err=float((comp - ref).abs().max()) / max(scale, 1e-30))
            del comp
        if "prep" in c:
            row["prep_ms"] = time_ms(c["prep"])
            row["device_busy_ms"] = device_profile(c["kernel"])[0]
            row["prep_device_busy_ms"] = device_profile(c["prep"])[0]
            print(f"lift-splat index preparation (keys kernel, stable radix sort, row offsets), "
                  f"B={B} {c['dtype']}: {row['prep_ms']:.4f} ms of the wrapper's {kms:.4f} ms; "
                  f"device busy {row['prep_device_busy_ms']:.4f} of "
                  f"{row['device_busy_ms']:.4f} ms in one call (profiler)")
        if c.get("repeat"):
            row["repeats_bit_for_bit"] = bool(torch.equal(c["kernel"](), c["kernel"]()))
            row["passed"] = passed = passed and row["repeats_bit_for_bit"]
            ok &= passed
        print("kernel_check " + json.dumps(row))
        rows[(c["name"], c["dtype"], c.get("locations", "uniform"))] = row
    if not ok:
        return None, None, "a kernel disagrees with its plain version"
    bad = split_checks(dev)
    if bad:
        return None, None, f"the TF32 split of {bad} differs from ops/_tf32.py"

    # ---- 2b. the two backward kernels at the train-v2 shapes
    bwd_rows = {}
    for c in backward_cases(dev):
        got, ref = c["kernel"](), c["plain"]()
        torch.cuda.synchronize()
        kms = time_ms(c["kernel"])
        pms = time_ms(c["plain"], reps=5, warmup=1)
        composite = c["composite"]()
        cms = time_ms(composite, reps=10)
        del composite
        t_bytes, t_ops = c["bytes"] / HBM_BYTES_PER_S * 1e3, c["ops"] / PEAK_OPS["float32"] * 1e3
        for out, a, b in zip(("dv", "dlx", "dly", "dattn"), got, ref):
            a, b = a.float(), b.float()
            err = float((a - b).abs().max())
            rel = err / max(float(b.abs().max()), 1e-30)
            passed = bool(torch.isfinite(a).all()) and rel <= c["tol"][out]
            ok &= passed
            row = dict(name="deformable_sample_backward", output=out, dtype=c["dtype"],
                       max_abs_err=err, max_rel_err=rel, rel_tol=c["tol"][out], passed=passed,
                       ms=kms, plain_ms=pms, library_ms=None, bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       bytes=c["bytes"], ops=c["ops"], locations=c["locations"],
                       composite_ms=cms)
            print("kernel_check " + json.dumps(row))
            bwd_rows[(out, c["dtype"], c["locations"])] = row
        del got, ref
    for c in lift_backward_cases(dev):
        got, ref = c["kernel"](), c["plain"]()
        again = c["kernel"]()
        torch.cuda.synchronize()
        repeats = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
        kms = time_ms(c["kernel"])
        pms = time_ms(c["plain"], reps=10, warmup=1)
        t_bytes, t_ops = c["bytes"] / HBM_BYTES_PER_S * 1e3, c["ops"] / PEAK_OPS["float32"] * 1e3
        for out, a, b in zip(("dfeat", "ddepth"), got, ref):
            a, b = a.float(), b.float()
            err = float((a - b).abs().max())
            rel = err / max(float(b.abs().max()), 1e-30)
            passed = bool(torch.isfinite(a).all()) and rel <= c["tol"][out] and repeats
            ok &= passed
            row = dict(name="lift_splat_backward", output=out, dtype=c["dtype"],
                       max_abs_err=err, max_rel_err=rel, rel_tol=c["tol"][out], passed=passed,
                       repeats_bit_for_bit=repeats, ms=kms, plain_ms=pms, library_ms=None,
                       composite_ms=pms, bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       bytes=c["bytes"], ops=c["ops"])
            print("kernel_check " + json.dumps(row))
            bwd_rows[(out, c["dtype"], "uniform")] = row
        del got, ref, again
    if not ok:
        return None, None, "a backward kernel disagrees with its plain version"
    return rows, bwd_rows, None


def lift_c64_checks(dev):
    """Phase 2c: kernels 3 and 3b at Stack A's width, C=64 (rows of 128
    bytes in bfloat16 and 256 in float32: lane groups of 8 and 16 slices), in
    float32 and bfloat16; the forward at B=6 (train's batch) and B=1
    (predict's), the backward at B=6. Each against its plain version with
    phase 2's limits, repeated bit for bit, and timed as the C=128 rows are:
    the wrapper's clock (CUDA events around back-to-back calls), device busy
    time a call (profiler), the bound over the rows that live points read,
    and `index_add_` as the forward's yardstick (the backward's is its plain
    composite). Prints a `kernel_check` line each; returns (rows keyed by
    (name, dtype, batch, output), failure message or None)."""
    import numpy as np
    import torch

    from lss2_multimodal_nu_tpu_torch.ops import lift_splat as ls

    c, rows, ok = STACK_A_C, {}, True

    def busy_ms(fn, calls=20):
        """Device busy time of one call, from a profile of `calls` calls back
        to back (one profiled call alone at times lists none of its
        kernels); None where the profile shows no device work."""
        busy = device_profile(lambda: [fn() for _ in range(calls)])[0] / calls
        return busy if busy > 0 else None

    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS["float32"] * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    for b in (STACK_A_B, PREDICT_B):
        feat, depth, seg, fidx, n, n_valid, csr = lift_inputs(dev, b, seed=17 + b, c=c)
        p, r = depth.shape[1], feat.shape[1]
        feat_rows = rows_read(fidx, r, depth != 0)
        segflat = (seg.long() + torch.arange(b, device=dev)[:, None] * n).reshape(-1)
        for dt, name_dt in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
            es, bf = (4, False) if dt == torch.float32 else (2, True)
            fd = feat.to(dt)
            kernel = lambda fd=fd: ls.fused_lift_splat(fd, depth, seg, fidx, n)
            plain = lambda fd=fd: ls.fused_lift_splat_plain(fd, depth, seg, fidx, n)
            lifted = (torch.gather(fd.float(), 1, fidx.long()[..., None].expand(-1, -1, c))
                      * depth[..., None]).reshape(-1, c)
            acc = torch.zeros(b * n, c, device=dev)
            got, ref, again = kernel().float(), plain().float(), kernel().float()
            err = float((got - ref).abs().max())
            rel = err / max(float(ref.abs().max()), 1e-30)
            repeats = bool(torch.equal(got, again))
            tol = 2 ** -7 if bf else 1e-5
            passed = bool(torch.isfinite(got).all()) and rel <= tol and repeats
            ok &= passed
            bms, by = bound(feat_rows * c * es + 3 * b * p * 4 + b * n * c * es, 2 * n_valid * c)
            row = dict(name="lift_splat_c64", dtype=name_dt, batch=b, c=c, max_abs_err=err,
                       max_rel_err=rel, rel_tol=tol, passed=passed, repeats_bit_for_bit=repeats,
                       ms=time_ms(kernel, reps=50, warmup=10), device_busy_ms=busy_ms(kernel),
                       plain_ms=time_ms(plain, reps=10, warmup=1),
                       library_ms=time_ms(lambda: acc.zero_().index_add_(0, segflat, lifted)),
                       bound_ms=bms, bound_by=by, rows_read=feat_rows, live_points=n_valid)
            print("kernel_check " + json.dumps(row))
            rows[("lift_splat_c64", name_dt, b, "out")] = row
            del got, ref, again, lifted, acc
    # the backward at B=6 over the cached CSR of the frustum's fidx
    feat, depth, seg, fidx, n, n_valid, csr = lift_inputs(dev, STACK_A_B, seed=29, c=c)
    b, p = depth.shape
    r = feat.shape[1]
    g = torch.from_numpy(np.random.default_rng(31).normal(size=(b, n, c)).astype(np.float32)).to(dev)
    g_rows = rows_read(seg, n)
    for dt, name_dt in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        es, bf = (4, False) if dt == torch.float32 else (2, True)
        a = (feat.to(dt), depth, seg, fidx, g.to(dt))
        kernel = lambda a=a: ls.fused_lift_splat_backward(*a, _fidx_csr=csr)
        plain = lambda a=a: ls.fused_lift_splat_backward_plain(*a)
        got, ref, again = kernel(), plain(), kernel()
        repeats = all(bool(torch.equal(x, y)) for x, y in zip(got, again))
        kms, busy = time_ms(kernel, reps=50, warmup=10), busy_ms(kernel)
        pms = time_ms(plain, reps=10, warmup=1)
        bms, by = bound(g_rows * c * es + 2 * b * r * c * es + 4 * b * p * 4,
                        2 * c * (b * p + n_valid))
        for out, x, y, tol in (("dfeat", got[0], ref[0], 2 ** -7 if bf else 1e-5),
                               ("ddepth", got[1], ref[1], 1e-5)):
            x, y = x.float(), y.float()
            err = float((x - y).abs().max())
            rel = err / max(float(y.abs().max()), 1e-30)
            passed = bool(torch.isfinite(x).all()) and rel <= tol and repeats
            ok &= passed
            row = dict(name="lift_splat_backward_c64", output=out, dtype=name_dt, batch=b, c=c,
                       max_abs_err=err, max_rel_err=rel, rel_tol=tol, passed=passed,
                       repeats_bit_for_bit=repeats, ms=kms, device_busy_ms=busy, plain_ms=pms,
                       library_ms=None, composite_ms=pms, bound_ms=bms, bound_by=by,
                       rows_read=g_rows)
            print("kernel_check " + json.dumps(row))
            rows[("lift_splat_backward_c64", name_dt, b, out)] = row
        del got, ref, again
    return rows, None if ok else "a lift-splat kernel at C=64 disagrees with its plain version"


def stack_a_config(family, **train):
    """Stack A at the JAX CLI's defaults: EfficientNet-b4, cam_channels 64,
    float32 (`cli.py:663`), 6 cameras at 128x352 into the 200x200 grid."""
    from lss2_multimodal_nu_tpu_torch.config import Config, ModelConfig, TrainConfig

    return Config(model=ModelConfig(family=family, effnet_variant="b4", cam_channels=STACK_A_C,
                                    compute_dtype="float32"),
                  train=TrainConfig(**train))


def calibrate(model, inputs):
    """Every batch norm's running statistics set to its batch statistics on
    `inputs` (one train forward with momentum 1, dropout and drop-connect
    off), then eval mode. After `perturb`, random weights then give
    activations of order 1 throughout, as a trained model's do: with raw
    random statistics they grow through the trunk and the ResNet body to BEV
    logits of order 1e3, where float32's round-off alone would exceed the
    card-against-CPU limits."""
    import torch

    from lss2_multimodal_nu_tpu_torch.train.steps import train_without_dropout

    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    saved = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 1.0
    train_without_dropout(model)
    with torch.no_grad():
        model(*inputs)
    for m, mom in zip(bns, saved):
        m.momentum = mom
    return model.eval()


def stack_a_models(dev, family, calib_inputs, seed=0, **train):
    """(card model, CPU model) of a Stack A family with the same weights:
    seeded, `perturb`ed, and calibrated on the card on `calib_inputs`."""
    from lss2_multimodal_nu_tpu_torch.models.factory import build_model

    cfg = stack_a_config(family, **train)
    card = build_model(cfg, device=dev, seed=seed)
    perturb(card, seed=seed + 1)
    calibrate(card, calib_inputs)
    cpu = build_model(cfg, device="cpu", seed=seed)
    cpu.load_state_dict(card.state_dict())
    return card, cpu


def stack_a_eval(dev, wrappers):
    """Phase 7: BevTxt's eval forward at full width (b4, C=64, float32) at
    B=1 (predict's batch) and B=6, through `build_model`: one lift-splat
    launch and nothing else of the port's kernels per forward, finite outputs
    of the right shapes, no `cudaStreamSynchronize`; host-clock median of 10,
    device busy, idle share, the stages (`encoder`, `lift_to_bev`,
    `bevencode`, `txt_branch`) and peak memory. Then at B=1 the card's f32
    forward of BevTxt, LSS and BevTxtOnlyBev against the CPU's (2e-3 on the
    BEV, 1e-3 on act/desc), and BevTxt's bit for bit against a forward with
    TF32 turned off by the caller. Returns (launches of the B=6 forward,
    failure message or None)."""
    import torch

    from lss2_multimodal_nu_tpu_torch.ops._precision import full_float32

    one = [torch.from_numpy(a).to(dev) for a in fake_inputs(PREDICT_B, seed=3)]
    model, cpu_model = stack_a_models(dev, "bev_txt", one)
    expected = {name: int(name == "lift_splat") for name in wrappers}
    for b in (PREDICT_B, STACK_A_B):
        inputs = [torch.from_numpy(a).to(dev) for a in fake_inputs(b, seed=4)]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            model(*inputs)  # warm-up
            torch.cuda.synchronize()
            for f in wrappers.values():
                f.launches = 0
            bev, act, desc = model(*inputs)
            torch.cuda.synchronize()
            launches = {name: f.launches for name, f in wrappers.items()}
            print(f"main path launches, Stack A BevTxt f32 forward B={b}: {launches}")
            if launches != expected:
                return launches, f"BevTxt B={b} launch counts {launches}, expected {expected}"
            shapes = tuple(tuple(t.shape) for t in (bev, act, desc))
            if shapes != ((b, 4, GRID, GRID), (b, 4), (b, 8)):
                return launches, f"BevTxt B={b} output shapes {shapes}"
            if not all(bool(torch.isfinite(t).all()) for t in (bev, act, desc)):
                return launches, f"non-finite BevTxt B={b} output"
            fwd = []
            for _ in range(10):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                model(*inputs)
                torch.cuda.synchronize()
                fwd.append((time.perf_counter() - t1) * 1e3)
            fwd.sort()
            fwd_ms = fwd[len(fwd) // 2]
            with full_float32():
                cam = model.encode_cameras(inputs[0])
                vox = model.lift_to_bev(cam, *inputs[1:])
                bev = model.bevencode(vox)
                stages = {
                    "encoder": time_ms(lambda: model.encode_cameras(inputs[0]), reps=10),
                    "lift_to_bev": time_ms(lambda: model.lift_to_bev(cam, *inputs[1:]), reps=10),
                    "bevencode": time_ms(lambda: model.bevencode(vox), reps=10),
                    "txt_branch": time_ms(lambda: model.txt_branch(bev, cam), reps=10),
                }
            busy_ms, summed_ms, top, syncs = device_profile(lambda: model(*inputs))
        peak = torch.cuda.max_memory_allocated() / 1e9
        idle = 1 - busy_ms / fwd_ms
        print(f"Stack A BevTxt forward B={b} f32: {fwd_ms:.3f} ms median of 10 "
              f"({fwd[0]:.3f}-{fwd[-1]:.3f}), {b / fwd_ms * 1e3:.2f} samples/s")
        print(f"stages, BevTxt B={b} (ms, CUDA events): {json.dumps(stages)}")
        print(f"profiled BevTxt B={b} forward: device busy {busy_ms:.3f} ms (kernel times summed "
              f"{summed_ms:.3f}), idle share of the timed forward {idle:.3f}")
        for name, ms, count in top:
            print(f"  {ms:9.3f} ms {count:4d}x {name}")
        print(f"host syncs in one BevTxt B={b} forward (profiler): {json.dumps(syncs)}")
        print(f"peak device memory in phase 7, B={b}: {peak:.2f} GB")
        if syncs["cudaStreamSynchronize"] or syncs["cudaMemcpy"]:
            return launches, f"the BevTxt B={b} forward makes host syncs: {syncs}"
        del inputs, cam, vox, bev, act, desc

    tol = (2e-3, 1e-3, 1e-3)
    cpu_one = [t.cpu() for t in one]
    for family in ("bev_txt", "lss", "bev_txt_onlybev"):
        if family != "bev_txt":
            model, cpu_model = stack_a_models(dev, family, one)
        with torch.inference_mode():
            want = cpu_model(*cpu_one)
            for f in wrappers.values():
                f.launches = 0
            got = model(*one)
            n_launch = wrappers["lift_splat"].launches
        want, got = ((want,), (got,)) if family == "lss" else (want, got)
        got = [t.cpu() for t in got]
        for name, a, b_, atol in zip(("bev", "act", "desc"), got, want, tol):
            diff = float((a - b_).abs().max())
            print(f"gpu vs cpu f32 {family} {name} B=1: max abs diff {diff:.3e} (atol {atol}), "
                  f"max |cpu| {float(b_.abs().max()):.3e}")
            if not diff <= atol:
                return launches, f"GPU and CPU {family} forwards disagree on {name}"
        if n_launch != 1:
            return launches, f"{family} made {n_launch} lift-splat launches, not 1"
        if family == "bev_txt":
            matmul, cudnn_tf32 = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
            try:
                with torch.inference_mode():
                    off = [t.cpu() for t in model(*one)]
            finally:
                torch.backends.cudnn.allow_tf32 = cudnn_tf32
                torch.set_float32_matmul_precision(matmul)
            same = all(torch.equal(a, b_) for a, b_ in zip(got, off))
            print(f"card f32 BevTxt forward under {precision_flags()}: bit for bit equal to the "
                  f"forward with TF32 turned off by the caller: {same}")
            if not same:
                return launches, "the BevTxt forward does not pin full float32"
        del model, cpu_model
    return launches, None


def stack_a_train(dev, wrappers):
    """Phase 8: BevTxt's train step at the JAX CLI's `train` defaults (B=6,
    float32, lr 1e-4, wd 1e-8, clip 5.0, one parameter group, no schedule):
    one lift-splat forward and one backward launch a step and nothing else
    of the port's kernels; 5 steps on one batch that must move the loss by
    more than 1e-3, everything finite; the median of 10 steps after 3 more,
    its forward / backward / optimizer split, device busy and peak memory;
    no `cudaStreamSynchronize` or `cudaMemcpy` in a profiled step. Then one
    step at B=1, dropout and drop-connect off, on the card against the CPU:
    loss, grad_norm and the gradients of the leaves around the kernel,
    beside the card's own spread from weights moved by 1e-7. Returns
    (launches of one step, failure message or None)."""
    import torch

    from lss2_multimodal_nu_tpu_torch.models.factory import build_model
    from lss2_multimodal_nu_tpu_torch.train.state import build_optimizer
    from lss2_multimodal_nu_tpu_torch.train.steps import train_step, train_without_dropout

    train = dict(batch_size=STACK_A_B, lr=1e-4, weight_decay=1e-8, max_grad_norm=5.0)
    torch.cuda.empty_cache()
    batch = train_batch(dev, STACK_A_B, seed=5)
    inputs = [batch[k] for k in ("imgs", "rots", "trans", "intrins", "post_rots", "post_trans")]
    model, _ = stack_a_models(dev, "bev_txt", inputs, **train)
    opt, sched = build_optimizer(model.cfg, model.train())
    if len(opt.param_groups) != 1 or sched.get_last_lr() != [1e-4]:
        return None, f"BevTxt trains in {len(opt.param_groups)} groups at {sched.get_last_lr()}"
    expected = {name: int(name in ("lift_splat", "lift_splat_backward")) for name in wrappers}
    launches, _, err = drive_train("BevTxt f32", model, opt, sched, batch, wrappers, expected)
    if err:
        return launches, err
    del model, opt, sched, batch, inputs
    torch.cuda.empty_cache()

    # one step at B=1, dropout and drop-connect off: the card against the CPU,
    # and against itself from weights moved by 1e-7 of each tensor's mean |value|
    cpu_batch = train_batch("cpu", 1, seed=3)
    gpu_batch = {k: v.to(dev) for k, v in cpu_batch.items()}
    calib = [gpu_batch[k] for k in ("imgs", "rots", "trans", "intrins", "post_rots", "post_trans")]
    gpu_model, cpu_model = stack_a_models(dev, "bev_txt", calib, **train)
    ctl_model = build_model(gpu_model.cfg, device=dev)
    ctl_model.load_state_dict(gpu_model.state_dict())
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in ctl_model.parameters():
            p.add_(1e-7 * p.abs().mean() * torch.randn(p.shape, generator=gen).to(dev))
    out = {}
    for label, m, b_ in (("cpu", cpu_model, cpu_batch), ("gpu", gpu_model, gpu_batch),
                         ("ctl", ctl_model, gpu_batch)):
        o, s = build_optimizer(m.cfg, train_without_dropout(m))
        out[label] = train_step(m, o, s, b_, 0)
    for k, rtol in (("loss", 1e-5), ("grad_norm", 2e-3)):
        a, b_ = float(out["gpu"][k]), float(out["cpu"][k])
        c_ = float(out["ctl"][k])
        print(f"gpu vs cpu f32 BevTxt train {k}: {a:.6f} vs {b_:.6f}, rel diff "
              f"{abs(a - b_) / abs(b_):.3e} (rtol {rtol}); moved card {abs(c_ - a) / abs(a):.3e}")
        if not abs(a - b_) <= rtol * abs(b_):
            return launches, f"GPU and CPU BevTxt train steps disagree on {k}"
    leaves = [n for n, _ in cpu_model.named_parameters() if n in STACK_A_LEAVES]
    vs_cpu = grad_diffs(gpu_model, cpu_model, leaves)
    control = grad_diffs(ctl_model, gpu_model, leaves)
    bad = []
    for n in leaves:
        (rel, nrel, scale), (crel, cnrel, _) = vs_cpu[n], control[n]
        tol = STACK_A_GRAD_TOL_LINEAR if n.startswith("camencode") else GRAD_TOL
        print(f"gpu vs cpu f32 BevTxt grad {n}: max |cpu| {scale:.3e}, max diff / max |cpu| "
              f"{rel:.3e} (tol {tol}), norm of diff / norm {nrel:.3e} (tol {GRAD_NORM_TOL}); "
              f"moved card vs card {crel:.3e}, {cnrel:.3e}")
        if not (rel <= tol and nrel <= GRAD_NORM_TOL):
            bad.append(n)
    if bad:
        return launches, f"GPU and CPU BevTxt gradients disagree on {bad}"
    return launches, None


def check_grads(label, got, want, leaves, linear_tol, control=None):
    """Phase 6's per-leaf check of two models' gradients (with `control`,
    the card's own spread from moved weights printed beside): a leaf whose
    gradient is zero in exact arithmetic (at most 1e-4 of the largest) must
    stay below 1e-3 of the largest; every other within GRAD_TOL in max
    (`linear_tol` on the leaves that reach a kernel only through its linear
    path: cam_encode, value_proj) and GRAD_NORM_TOL in norm. Returns the
    leaves that fail."""
    diffs = grad_diffs(got, want, leaves)
    ctl = grad_diffs(control, got, leaves) if control is not None else {}
    top = max(d[2] for d in diffs.values())
    bad = []
    for n in leaves:
        rel, nrel, scale = diffs[n]
        if scale <= 1e-4 * top:
            gmax = float(dict(got.named_parameters())[n].grad.abs().max())
            print(f"{label} grad {n}: zero up to round-off, max |want| {scale:.3e}, max |got| "
                  f"{gmax:.3e}")
            if not gmax <= 1e-3 * top:
                bad.append(n)
            continue
        tol = linear_tol if n.startswith("cam_encode") or ".value_proj." in n else GRAD_TOL
        moved = (f"; moved card vs card {ctl[n][0]:.3e}, {ctl[n][1]:.3e}" if n in ctl else "")
        print(f"{label} grad {n}: max |want| {scale:.3e}, max diff / max {rel:.3e} (tol {tol}), "
              f"norm of diff / norm {nrel:.3e} (tol {GRAD_NORM_TOL}){moved}")
        if not (rel <= tol and nrel <= GRAD_NORM_TOL):
            bad.append(n)
    return bad


def chain_config(family, lss_version="v1", **train):
    """Stack B at the JAX CLI's defaults (`cli.py`): vovnet39, LSS v1 (both
    stages' default), float32, 6 cameras at 128x352 into the 200x200 grid;
    V3 for the flagship; `train` as the stage's defaults give it."""
    from lss2_multimodal_nu_tpu_torch.config import Config, ModelConfig, TrainConfig

    return Config(model=ModelConfig(family=family, vovnet_type="vovnet39", lss_version=lss_version,
                                    compute_dtype="float32"),
                  train=TrainConfig(**train))


def pretrain_batch(dev, b, seed):
    """fake_inputs plus BEV labels from a numpy seed, a fifth of the pixels
    at the ignore index 255."""
    import numpy as np
    import torch

    from lss2_multimodal_nu_tpu_torch.train.steps import MODEL_INPUTS

    rng = np.random.default_rng(seed + 100)
    batch = dict(zip(MODEL_INPUTS, (torch.from_numpy(a).to(dev) for a in fake_inputs(b, seed=seed))))
    labels = rng.integers(0, 4, size=(b, GRID, GRID))
    labels[rng.random((b, GRID, GRID)) < 0.2] = 255
    batch["binimg"] = torch.from_numpy(labels).to(dev)
    return batch


def drive_train(label, model, opt, sched, batch, wrappers, expected):
    """A main path's train step through `train_step`: every count set to 0
    just before the first step and read just after, against `expected`; 5
    steps on one batch that must move the loss by more than 1e-3, everything
    finite; the median of 10 steps after 3 more on the host clock, the
    forward / backward / optimizer split (CUDA events), device busy, idle
    share, the busiest kernels (cuDNN's FFT kernels among them), host syncs
    (none allowed) and peak memory. Returns (launches, the next step's
    index, failure message or None)."""
    import torch

    from lss2_multimodal_nu_tpu_torch.train.steps import train_step

    b = batch["imgs"].shape[0]
    torch.cuda.reset_peak_memory_stats()
    for f in wrappers.values():
        f.launches = 0
    metrics = [train_step(model, opt, sched, batch, 0)]
    torch.cuda.synchronize()
    launches = {name: f.launches for name, f in wrappers.items()}
    print(f"{label} train step launches: {launches}")
    if launches != expected:
        return launches, 1, f"{label} train launch counts {launches}, expected {expected}"
    for step in range(1, 5):
        metrics.append(train_step(model, opt, sched, batch, step))
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    print(f"{label} train B={b}, 5 steps on one batch: loss {losses}, grad_norm {norms}, lr now "
          f"{[g['lr'] for g in opt.param_groups]}")
    if not all(math.isfinite(x) for x in losses + norms):
        return launches, 5, f"non-finite loss or grad_norm in the {label} train step"
    if not abs(losses[-1] - losses[0]) > 1e-3:
        return launches, 5, f"the {label} loss did not move in 5 steps: {losses}"
    if not all(bool(torch.isfinite(p).all()) for p in model.parameters()):
        return launches, 5, f"non-finite {label} weights after 5 steps"
    step = 5
    for _ in range(3):
        train_step(model, opt, sched, batch, step)
        step += 1
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        train_step(model, opt, sched, batch, step)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        step += 1
    times.sort()
    step_ms = times[len(times) // 2]
    split = split_step_ms(model, opt, sched, batch, step)
    step += 5
    busy_ms, summed_ms, top, syncs = device_profile(
        lambda: train_step(model, opt, sched, batch, step), top=15)
    step += 1
    peak = torch.cuda.max_memory_allocated() / 1e9
    fft = [r for r in top if is_fft_kernel(r[0])]
    print(f"{label} train step B={b}: {step_ms:.3f} ms median of 10 "
          f"({times[0]:.3f}-{times[-1]:.3f}), {b / step_ms * 1e3:.2f} samples/s")
    print(f"{label} train step split (ms, CUDA events, median of 5): {json.dumps(split)}")
    print(f"profiled {label} train step: device busy {busy_ms:.3f} ms (kernel times summed "
          f"{summed_ms:.3f}), idle share of the timed step {1 - busy_ms / step_ms:.3f}")
    for name, ms, count in top:
        print(f"  {ms:9.3f} ms {count:5d}x {name}")
    print(f"cuDNN FFT kernels in the {label} train step: {sum(r[2] for r in fft)} launches, "
          f"{sum(r[1] for r in fft):.3f} ms")
    print(f"host syncs in one {label} train step (profiler): {json.dumps(syncs)}")
    print(f"peak device memory, {label} train: {peak:.2f} GB")
    if syncs["cudaStreamSynchronize"] or syncs["cudaMemcpy"]:
        return launches, step, f"the {label} train step makes host syncs: {syncs}"
    return launches, step, None


def stage4_saving(label, model, opt, sched, batch, step):
    """What fault 7's repair saves in a train step at LSS v1: the step as it
    runs (the trunk stops after stage 3) against the step with stage 4
    computed and thrown away, as before the repair, 5 steps each in turns
    (repaired, unrepaired, unrepaired, repaired), host-clock medians; and
    stage 4's forward alone on c3 (CUDA events). Returns the next step's
    index."""
    import torch

    from lss2_multimodal_nu_tpu_torch.ops._precision import full_float32
    from lss2_multimodal_nu_tpu_torch.train.steps import train_step

    def unrepaired(imgs):
        b, n = imgs.shape[:2]
        feats = model.backbone(imgs.reshape(b * n, *imgs.shape[2:]).to(model.dtype), True)
        return feats["c3"], feats["c4"]

    times = {"repaired": [], "unrepaired": []}
    for kind in ("repaired", "unrepaired", "unrepaired", "repaired"):
        if kind == "unrepaired":
            model.encode_cameras = unrepaired
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            train_step(model, opt, sched, batch, step)
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t1) * 1e3)
            step += 1
        model.__dict__.pop("encode_cameras", None)
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    imgs = batch["imgs"]
    with torch.no_grad(), full_float32():
        c3 = model.backbone(imgs.reshape(-1, *imgs.shape[2:]), False)["c3"]
        stage4 = time_ms(lambda: model.backbone.backbone.stages[3](c3), reps=10)
    print(f"fault 7, {label} train step B={imgs.shape[0]}: repaired {med['repaired']:.3f} ms, with "
          f"stage 4 computed {med['unrepaired']:.3f} ms (host-clock medians of 10 in turns), "
          f"saved {med['unrepaired'] - med['repaired']:.3f} ms; stage 4's train forward alone "
          f"{stage4:.3f} ms (CUDA events)")
    return step


def pretrain_phase(dev, wrappers):
    """Phase 9a: pretrain-v2 at its CLI defaults (VoVNetPreTrain, vovnet39,
    LSS v1, float32, B=12, lr 1e-4, wd 1e-8, clip 5.0, one group,
    warmup-cosine, 5 of 60 epochs of warmup, one step counting as one
    epoch) on labels with pixels at 255, through `drive_train`; what fault
    7's repair saves; one eval step at B=12 (kernels 1, 3, 4 and 5, one call
    each) whose confusion matrix counts every pixel not at 255. Then at B=1,
    seeded and `perturb`ed weights, the card against the CPU: the float32
    eval forward (2e-3 on the BEV), bit for bit against the forward with
    TF32 turned off by the caller under torch's defaults and under matmul
    "high", and one train step (dropout off): loss, grad_norm and the
    gradients upstream of the kernels, beside the card's own spread from
    weights moved by 1e-7. Returns (the trained model, launches of the train
    step, of the eval step, failure message or None)."""
    import torch

    from lss2_multimodal_nu_tpu_torch.models.factory import build_model
    from lss2_multimodal_nu_tpu_torch.train.state import build_optimizer
    from lss2_multimodal_nu_tpu_torch.train.steps import eval_step, train_step, train_without_dropout

    cfg = chain_config("vovnet_pretrain", batch_size=PRETRAIN_B, lr=1e-4, weight_decay=1e-8,
                       max_grad_norm=5.0, num_epochs=60, warmup_epochs=5, use_schedule=True)
    torch.cuda.empty_cache()
    model = build_model(cfg, device=dev, seed=0)
    perturb(model, seed=1)
    opt, sched = build_optimizer(cfg, model.train(), steps_per_epoch=STEPS_PER_EPOCH)
    if len(opt.param_groups) != 1 or sched.get_last_lr() != [0.0]:
        return model, None, None, (f"the pretrain trains in {len(opt.param_groups)} groups from "
                                   f"{sched.get_last_lr()}")
    batch = pretrain_batch(dev, PRETRAIN_B, seed=11)
    expected = {name: k[3] for name, k in KERNELS.items()}
    launches, step, err = drive_train("pretrain-v2 f32", model, opt, sched, batch,
                                               wrappers, expected)
    if err:
        return model, launches, None, err
    step = stage4_saving("pretrain-v2", model, opt, sched, batch, step)

    model.eval()
    confmat = torch.zeros(4, 4, dtype=torch.int64, device=dev)
    for f in wrappers.values():
        f.launches = 0
    res = eval_step(model, batch, confmat)
    torch.cuda.synchronize()
    eval_launches = {name: f.launches for name, f in wrappers.items()}
    expected = {name: k[2] for name, k in KERNELS.items()}
    counted, labelled = int(res["confmat"].sum()), int((batch["binimg"] != 255).sum())
    print(f"pretrain-v2 eval step B={PRETRAIN_B} launches: {eval_launches}; loss "
          f"{float(res['loss']):.6f}; confusion matrix counts {counted} of {labelled} labelled "
          "pixels")
    if eval_launches != expected:
        return model, launches, eval_launches, (f"pretrain eval launch counts {eval_launches}, "
                                                f"expected {expected}")
    if counted != labelled or not math.isfinite(float(res["loss"])) or set(res) != {
            "confmat", "loss", "bsize"}:
        return model, launches, eval_launches, f"the pretrain eval step is wrong: {res}"
    del batch, res

    # B=1: the card against the CPU
    cpu_model = build_model(cfg, device="cpu", seed=0)
    perturb(cpu_model, seed=1)
    gpu_model = build_model(cfg, device=dev, seed=0)
    gpu_model.load_state_dict(cpu_model.state_dict())
    one = fake_inputs(1, seed=3)
    with torch.inference_mode():
        want = cpu_model(*[torch.from_numpy(a) for a in one])

    def card_forward():
        with torch.inference_mode():
            return gpu_model(*[torch.from_numpy(a).to(dev) for a in one]).cpu()

    matmul, cudnn_tf32 = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    off = card_forward()
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    torch.set_float32_matmul_precision(matmul)
    for precision in (matmul, "high"):
        torch.set_float32_matmul_precision(precision)
        before = precision_flags()
        got = card_forward()
        torch.set_float32_matmul_precision(matmul)
        diff = float((got - want).abs().max())
        same = torch.equal(got, off)
        print(f"gpu vs cpu f32 pretrain bev B=1 under {before}: max abs diff {diff:.3e} (atol "
              f"2e-3), max |cpu| {float(want.abs().max()):.3e}; bit for bit equal to the "
              f"forward with TF32 turned off by the caller: {same}")
        if not diff <= 2e-3:
            return model, launches, eval_launches, "GPU and CPU pretrain forwards disagree"
        if not same:
            return model, launches, eval_launches, (f"the pretrain forward under {before} does "
                                                    "not pin full float32")

    ctl_model = build_model(cfg, device=dev, seed=0)
    ctl_model.load_state_dict(cpu_model.state_dict())
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in ctl_model.parameters():
            p.add_(1e-7 * p.abs().mean() * torch.randn(p.shape, generator=gen).to(dev))
    cpu_batch = pretrain_batch("cpu", 1, seed=3)
    gpu_batch = {k: v.to(dev) for k, v in cpu_batch.items()}
    out = {}
    for name, m, b_ in (("cpu", cpu_model, cpu_batch), ("gpu", gpu_model, gpu_batch),
                        ("ctl", ctl_model, gpu_batch)):
        o, s = build_optimizer(cfg, train_without_dropout(m), steps_per_epoch=STEPS_PER_EPOCH)
        out[name] = train_step(m, o, s, b_, 0)
    for k, rtol in (("loss", 1e-5), ("grad_norm", 2e-3)):
        a, b_, c_ = (float(out[n][k]) for n in ("gpu", "cpu", "ctl"))
        print(f"gpu vs cpu f32 pretrain train {k}: {a:.6f} vs {b_:.6f}, rel diff "
              f"{abs(a - b_) / abs(b_):.3e} (rtol {rtol}); moved card {abs(c_ - a) / abs(a):.3e}")
        if not abs(a - b_) <= rtol * abs(b_):
            return model, launches, eval_launches, f"GPU and CPU pretrain train steps disagree on {k}"
    bad = check_grads("gpu vs cpu f32 pretrain", gpu_model, cpu_model,
                      upstream_leaves(cpu_model), PRETRAIN_GRAD_TOL_LINEAR, control=ctl_model)
    if bad:
        return model, launches, eval_launches, f"GPU and CPU pretrain gradients disagree on {bad}"
    return model, launches, eval_launches, None


def flagship_chain_phase(dev, wrappers, pretrain):
    """Phases 9b and 9c: stage 2 of the chain. The trained pretrain's
    components saved as `best_pretrained.pth` on the card; the flagship at
    train-v2's defaults (vovnet39, LSS v1, V3, float32, B=8, lr 1e-4, wd
    1e-8, clip 10, two groups, warmup-cosine) warm-started from it with
    `restore_loose`: the four components equal the pretrain's bit for bit,
    every other tensor its init. Its float32 train step through
    `drive_train`, and what fault 7's repair saves. A v2 pretrain's file into
    a v1 flagship drops `depth_net` whole and loads the other three. Then
    resume: `state_latest` saved, restored into a model, optimizer and
    scheduler made afresh; parameters, buffers, Adam's moments and the
    scheduler equal the saved ones bit for bit, and the next step's loss
    equals the uninterrupted run's bit for bit, its gradients upstream of
    the kernels within phase 6's limits (the deformable backward's dv
    atomics add in varying order, ROADMAP fault 2). Returns (launches of the
    train step, failure message or None)."""
    import shutil

    import torch

    from lss2_multimodal_nu_tpu_torch.models.factory import build_model
    from lss2_multimodal_nu_tpu_torch.models.vovnet_pretrain import PRETRAIN_COMPONENTS
    from lss2_multimodal_nu_tpu_torch.train import checkpoint as ck
    from lss2_multimodal_nu_tpu_torch.train.state import build_optimizer
    from lss2_multimodal_nu_tpu_torch.train.steps import train_step

    tmp = ROOT / "build" / "chain"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    try:
        # 9b. the warm start from stage 1
        path = str(tmp / ck.BEST_PRETRAINED)
        ck.save_components(path, pretrain, epoch=1, lss_version="v1")
        cfg = chain_config("vovnet_transformer", batch_size=TRAIN_B, lr=1e-4, weight_decay=1e-8,
                           max_grad_norm=10.0, num_epochs=60, warmup_epochs=5, use_schedule=True)
        torch.cuda.empty_cache()
        model = build_model(cfg, device=dev, seed=2)
        perturb(model, seed=3)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        report = ck.restore_loose(path, model, map_location=dev)
        want = pretrain.state_dict()
        moved = [k for k, v in model.state_dict().items() if not torch.equal(
            v, want[k] if k.split(".")[0] in PRETRAIN_COMPONENTS else init[k])]
        print(f"9b warm start from {ck.BEST_PRETRAINED}: loaded {report['loaded']}, dropped "
              f"{report['dropped']}, left at init {report['absent']}; tensors off their source: "
              f"{len(moved)}")
        if report["loaded"] != list(PRETRAIN_COMPONENTS) or report["dropped"] or moved:
            return None, f"the stage-1 warm start is wrong: {report}, {moved[:5]}"
        del init, want

        opt, sched = build_optimizer(cfg, model.train(), steps_per_epoch=STEPS_PER_EPOCH)
        if len(opt.param_groups) != 2:
            return None, f"the flagship trains in {len(opt.param_groups)} groups"
        batch = train_batch(dev, TRAIN_B, seed=13)
        expected = {name: k[3] for name, k in KERNELS.items()}
        launches, step, err = drive_train("train-v2 flagship f32", model, opt, sched,
                                                   batch, wrappers, expected)
        if err:
            return launches, err
        step = stage4_saving("train-v2 flagship", model, opt, sched, batch, step)

        # a v2 pretrain's components into a v1 flagship: depth_net differs
        path2 = str(tmp / ck.PRETRAINED_EPOCH.format(epoch=10))
        v2 = build_model(chain_config("vovnet_pretrain", lss_version="v2"), device=dev, seed=4)
        ck.save_components(path2, v2, epoch=10, lss_version="v2")
        other = build_model(cfg, device=dev, seed=5)
        init = {k: v.clone() for k, v in other.state_dict().items()}
        report = ck.restore_loose(path2, other, map_location=dev)
        want = v2.state_dict()
        kept = all(torch.equal(v, init[k]) for k, v in other.state_dict().items()
                   if k.startswith("depth_net."))
        print(f"9b warm start from a v2 pretrain into the v1 flagship: loaded {report['loaded']}, "
              f"dropped {sorted(report['dropped'])}; depth_net at its init: {kept}")
        if (list(report["dropped"]) != ["depth_net"] or not kept
                or report["loaded"] != [c for c in PRETRAIN_COMPONENTS if c != "depth_net"]
                or not all(torch.equal(v, want[k]) for k, v in other.state_dict().items()
                           if k.split(".")[0] in report["loaded"])):
            return launches, f"the v2 -> v1 warm start is wrong: {report}"
        del v2, other, init, want

        # 9c. resume from state_latest
        path3 = str(tmp / ck.STATE_LATEST)
        ck.save_train_state(path3, model, opt, sched, step=step, epoch=step)
        fresh = build_model(cfg, device=dev, seed=6).train()
        f_opt, f_sched = build_optimizer(cfg, fresh, steps_per_epoch=STEPS_PER_EPOCH)
        meta = ck.restore_train_state(path3, fresh, f_opt, f_sched, map_location=dev)
        sd, f_sd = model.state_dict(), fresh.state_dict()
        o, f_o = opt.state_dict(), f_opt.state_dict()
        same = {
            "parameters and buffers": all(torch.equal(sd[k], f_sd[k]) for k in sd),
            "Adam moments": o["param_groups"] == f_o["param_groups"] and all(
                torch.equal(v, f_o["state"][i][k]) for i, st in o["state"].items()
                for k, v in st.items()),
            "scheduler": sched.state_dict() == f_sched.state_dict(),
            "step": meta["step"] == step,
        }
        same["Adam step counters on the host"] = all(
            st["step"].device.type == "cpu" for st in f_opt.state.values())
        print(f"9c restored from {ck.STATE_LATEST} at step {step}, bit for bit: {same}")
        if not all(same.values()):
            return launches, f"the restored state differs: {same}"
        m_a = train_step(model, opt, sched, batch, step)
        m_b = train_step(fresh, f_opt, f_sched, batch, meta["step"])
        same_loss = torch.equal(m_a["loss"], m_b["loss"])
        print(f"9c next step's loss, uninterrupted {float(m_a['loss']):.9g}, resumed "
              f"{float(m_b['loss']):.9g}: bit for bit {same_loss}")
        if not same_loss:
            return launches, "the resumed step's loss differs from the uninterrupted run's"
        bad = check_grads("9c resumed vs uninterrupted", fresh, model, upstream_leaves(model),
                          GRAD_TOL_LINEAR)
        if bad:
            return launches, f"the resumed step's gradients differ on {bad}"
        return launches, None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def precision_flags():
    """torch's process-wide float32 precision flags, as a short string."""
    import torch

    return (f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
            f"float32 matmul precision={torch.get_float32_matmul_precision()!r}")


def main() -> int:
    try:
        import numpy  # noqa: F401
        import torch
    except ImportError as e:
        return _fail(f"missing dependency: {e}")
    if not torch.cuda.is_available():
        return _fail("no CUDA device: this script measures the port on the card")
    if not (ROOT / "lss2_multimodal_nu_tpu_torch").is_dir():
        return _fail("run from a checkout of the repository: the port package is missing")
    sys.path.insert(0, str(ROOT))
    from lss2_multimodal_nu_tpu_torch.config import Config, ModelConfig
    from lss2_multimodal_nu_tpu_torch.models.factory import build_model
    from lss2_multimodal_nu_tpu_torch.ops import _build
    from lss2_multimodal_nu_tpu_torch.ops import deformable_sampling as ds
    from lss2_multimodal_nu_tpu_torch.ops import ffn
    from lss2_multimodal_nu_tpu_torch.ops import lift_splat as ls
    from lss2_multimodal_nu_tpu_torch.ops import seg_head as sh
    from lss2_multimodal_nu_tpu_torch.ops._precision import full_float32
    from lss2_multimodal_nu_tpu_torch.train.steps import train_step, train_without_dropout

    dev = torch.device("cuda", 0)

    # ---- 1. setup
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"card: {card}")
    defaults = precision_flags()
    with full_float32():
        pinned = precision_flags()
    print(f"precision flags: phases 2 and 2b run inside full_float32 ({pinned}); phases 3-6 "
          f"under the process's flags ({defaults}), and phase 4 a second time with float32 "
          "matmul precision 'high'; the port's entry points pin full float32 themselves")
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s for {sorted(built)}")
    for name, kernel, spill, used in ptxas_lines():
        print(f"  ptxas {name}: {kernel}: {spill}; {used}")
    for name in ("ffn_ln", "seg_head"):
        print(f"  {name}: {tf32_hgmma_count(_build.BUILD_DIR / f'lib{name}.so')} TF32 HGMMA "
              "instructions in the library (cuobjdump -sass)")

    # ---- 2, 2b. kernels against their plain versions, in full float32
    with full_float32():
        rows, bwd_rows, err = check_kernels(dev)
        if not err:
            # ---- 2c. kernels 3 and 3b at Stack A's width, C=64
            c64_rows, err = lift_c64_checks(dev)
    if err:
        return _fail(err)

    # ---- 3. the flagship eval forward at full width, B=6, bfloat16; 3b. float32
    wrappers = {"deformable_sample": ds.deformable_sample_combine_xy,
                "deformable_sample_backward": ds.deformable_sample_combine_xy_backward,
                "lift_splat": ls.fused_lift_splat,
                "lift_splat_backward": ls.fused_lift_splat_backward,
                "ffn_ln": ffn.fused_ffn_ln, "seg_head": sh.fused_seg_head}
    by_dtype = {}
    for dtype, phase in (("bfloat16", "3"), ("float32", "3b")):
        by_dtype[dtype], err, numbers = eval_forward(dev, dtype, phase, wrappers)
        if err:
            return _fail(err)
        if numbers["syncs"]["cudaStreamSynchronize"] or numbers["syncs"]["cudaMemcpy"]:
            return _fail(f"the {dtype} forward makes host syncs: {numbers['syncs']}")
    launches = by_dtype["bfloat16"]

    # ---- 4. float32 on the card (kernels) against the CPU (plain versions), B=1,
    # under the process's flags and again with float32 matmuls at "high"
    cfg32 = Config(model=ModelConfig(family="vovnet_transformer", compute_dtype="float32"))
    cpu_model = build_model(cfg32, device="cpu", seed=0)
    perturb(cpu_model, seed=1)
    gpu_model = build_model(cfg32, device=dev, seed=0)
    gpu_model.load_state_dict(cpu_model.state_dict())
    one = fake_inputs(1, seed=3)
    with torch.inference_mode():
        out_cpu = cpu_model(*[torch.from_numpy(a) for a in one])
    tol = {"bev_seg": 2e-3, "action": 1e-3, "desc": 1e-3}
    matmul, cudnn_tf32 = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32

    def card_forward():
        with torch.inference_mode():
            return [t.cpu() for t in gpu_model(*[torch.from_numpy(a).to(dev) for a in one])]

    # the forward with TF32 turned off by the caller: the forward pins the
    # same flags itself, so under any flags it must give these bits (a forward
    # run unpinned under torch's defaults misses them; scripts/port_precision.py)
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    out_off = card_forward()
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    torch.set_float32_matmul_precision(matmul)
    for precision in (matmul, "high"):
        torch.set_float32_matmul_precision(precision)
        before = precision_flags()
        out_gpu = card_forward()
        after = precision_flags()
        torch.set_float32_matmul_precision(matmul)
        print(f"phase 4 under {before}; after the forward: {after}")
        if after != before:
            return _fail(f"the forward left the precision flags at {after}, not {before}")
        same = all(torch.equal(a, b) for a, b in zip(out_gpu, out_off))
        print(f"card f32 forward under {before}: bit for bit equal to the forward with TF32 "
              f"turned off by the caller: {same}")
        if not same:
            return _fail(f"the forward under {before} differs from the one with TF32 turned off "
                         "by the caller: it does not pin full float32")
        for (name, atol), a, b in zip(tol.items(), out_gpu, out_cpu):
            diff = float((a - b).abs().max())
            print(f"gpu vs cpu f32 {name} (matmul {precision!r}): max abs diff {diff:.3e} "
                  f"(atol {atol}), max |cpu| {float(b.abs().max()):.3e}")
            if not diff <= atol:
                return _fail(f"GPU and CPU forwards disagree on {name} at matmul {precision!r}")

    del gpu_model, cpu_model, out_cpu, out_gpu

    # ---- 5. the flagship train step at full width, train-v2, B=8, bfloat16
    torch.cuda.empty_cache()
    try:
        model, opt, sched = train_setup(dev, "bfloat16")
        batch = train_batch(dev, TRAIN_B, seed=5)
        train_launches, _, err = drive_train("flagship bf16", model, opt, sched, batch,
                                                wrappers, {n: k[3] for n, k in KERNELS.items()})
    except torch.cuda.OutOfMemoryError:
        return _fail(f"the B={TRAIN_B} train step does not fit on the card: peak "
                     f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB before the failure")
    if err:
        return _fail(err)
    del model, opt, sched, batch

    # ---- 6. one float32 train step at B=1, dropout off: the card against the
    # CPU; and, as the yardstick of the gradient tolerances, the card against
    # itself from the same weights each moved by 1e-7 of its tensor's mean |value|
    cpu_model, cpu_opt, cpu_sched = train_setup("cpu", "float32")
    gpu_model, gpu_opt, gpu_sched = train_setup(dev, "float32")
    ctl_model, ctl_opt, ctl_sched = train_setup(dev, "float32")
    off_model, off_opt, off_sched = train_setup(dev, "float32")
    high_model, high_opt, high_sched = train_setup(dev, "float32")
    for m in (gpu_model, ctl_model, off_model, high_model):
        m.load_state_dict(cpu_model.state_dict())
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in ctl_model.parameters():
            p.add_(1e-7 * p.abs().mean() * torch.randn(p.shape, generator=gen).to(dev))
    cpu_batch = train_batch("cpu", 1, seed=3)
    gpu_batch = {k: v.to(dev) for k, v in cpu_batch.items()}
    m_cpu = train_step(train_without_dropout(cpu_model), cpu_opt, cpu_sched, cpu_batch, 0)
    m_gpu = train_step(train_without_dropout(gpu_model), gpu_opt, gpu_sched, gpu_batch, 0)
    train_step(train_without_dropout(ctl_model), ctl_opt, ctl_sched, gpu_batch, 0)
    cudnn_tf32, matmul = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    m_off = train_step(train_without_dropout(off_model), off_opt, off_sched, gpu_batch, 0)
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    torch.set_float32_matmul_precision("high")
    m_high = train_step(train_without_dropout(high_model), high_opt, high_sched, gpu_batch, 0)
    torch.set_float32_matmul_precision(matmul)
    # ten times the differences measured (7.4e-7 and 1.5e-4) or more
    for k, rtol in (("loss", 1e-5), ("grad_norm", 2e-3)):
        a, b = float(m_gpu[k]), float(m_cpu[k])
        print(f"gpu vs cpu f32 train {k}: {a:.6f} vs {b:.6f}, rel diff {abs(a - b) / abs(b):.3e} "
              f"(rtol {rtol})")
        if not abs(a - b) <= rtol * abs(b):
            return _fail(f"GPU and CPU train steps disagree on {k}")
    upstream = upstream_leaves(cpu_model)
    vs_cpu = grad_diffs(gpu_model, cpu_model, upstream)
    control = grad_diffs(ctl_model, gpu_model, upstream)
    top = max(d[2] for d in vs_cpu.values())
    # tol -> worst [max metric card vs CPU, control; norm metric card vs CPU, control]
    worst = {GRAD_TOL: [0.0] * 4, GRAD_TOL_LINEAR: [0.0] * 4}
    bad = []
    for n in upstream:
        (rel, nrel, scale), (crel, cnrel, _) = vs_cpu[n], control[n]
        if scale <= 1e-4 * top:
            # zero in exact arithmetic (a conv bias before a train-mode batch
            # norm): round-off on both sides, and nothing more on the card
            gmax = float(dict(gpu_model.named_parameters())[n].grad.abs().max())
            print(f"gpu vs cpu f32 grad {n}: zero up to round-off, max |cpu| {scale:.3e}, "
                  f"max |gpu| {gmax:.3e}")
            if not gmax <= 1e-3 * top:
                bad.append(n)
            continue
        tol = GRAD_TOL_LINEAR if n.startswith("cam_encode") or ".value_proj." in n else GRAD_TOL
        print(f"gpu vs cpu f32 grad {n}: max |cpu| {scale:.3e}, max diff / max |cpu| {rel:.3e} "
              f"(tol {tol}), norm of diff / norm {nrel:.3e} (tol {GRAD_NORM_TOL}); moved card "
              f"vs card {crel:.3e}, {cnrel:.3e}")
        worst[tol] = [max(w, x) for w, x in zip(worst[tol], (rel, crel, nrel, cnrel))]
        if not (rel <= tol and nrel <= GRAD_NORM_TOL):
            bad.append(n)
    for tol, (w_cpu, w_ctl, wn_cpu, wn_ctl) in worst.items():
        print(f"gradients upstream of the kernels under tol {tol}: worst max diff / max |grad|, "
              f"card vs CPU {w_cpu:.3e}, card vs card moved by 1e-7 {w_ctl:.3e}; worst norm of "
              f"diff / norm (tol {GRAD_NORM_TOL}), {wn_cpu:.3e} and {wn_ctl:.3e}")
    if bad:
        return _fail(f"GPU and CPU gradients disagree on {bad}")
    for label, m, model in (("torch's defaults", m_gpu, gpu_model),
                            ("matmul 'high'", m_high, high_model)):
        diffs = grad_diffs(model, off_model, upstream)
        top_off = max(d[2] for d in diffs.values())
        worst = max(d[1] for d in diffs.values() if d[2] > 1e-4 * top_off)
        same = bool(torch.equal(m["loss"], m_off["loss"]))
        print(f"card f32 train step under {label} against TF32 turned off by the caller: loss "
              f"bit for bit {same}; worst norm of diff / norm over the leaves upstream "
              f"{worst:.3e} (tol {PIN_GRAD_TOL})")
        if not (same and worst <= PIN_GRAD_TOL):
            return _fail(f"the train step under {label} differs from the one with TF32 turned "
                         "off by the caller: it does not pin full float32")

    del cpu_model, gpu_model, ctl_model, off_model, high_model
    del cpu_opt, gpu_opt, ctl_opt, off_opt, high_opt
    torch.cuda.empty_cache()

    # ---- 7. Stack A: BevTxt's eval forward at full width, B=1 and B=6, float32;
    # LSS and BevTxtOnlyBev at B=1 against the CPU
    stack_a_launches, err = stack_a_eval(dev, wrappers)
    if err:
        return _fail(err)
    torch.cuda.empty_cache()

    # ---- 8. Stack A: BevTxt's train step at the JAX CLI's train defaults
    stack_a_train_launches, err = stack_a_train(dev, wrappers)
    if err:
        return _fail(err)
    torch.cuda.empty_cache()

    # ---- 9. the stage-1 -> stage-2 chain at the CLI's defaults, float32:
    # 9a pretrain-v2; 9b the warm start and train-v2's flagship step; 9c resume
    pretrain, chain_launches, pretrain_eval_launches, err = pretrain_phase(dev, wrappers)
    if err:
        return _fail(err)
    flagship_f32_launches, err = flagship_chain_phase(dev, wrappers, pretrain)
    if err:
        return _fail(err)
    del pretrain

    kernels = []
    backward_outputs = {"deformable_sample_backward": ("dv", "dlx", "dly", "dattn"),
                        "lift_splat_backward": ("dfeat", "ddepth")}
    for name, (src, replaces, n_eval, _) in KERNELS.items():
        if name in backward_outputs:
            outs = [bwd_rows[(o, "bfloat16", "uniform")] for o in backward_outputs[name]]
            row = dict(outs[0], max_abs_err=max(r["max_abs_err"] for r in outs))
        else:
            row = rows[(name, "bfloat16", "uniform")]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name] if n_eval else train_launches[name],
            launches_eval_forward=launches[name], launches_train_step=train_launches[name],
            launches_pretrain_train_step=chain_launches[name],
            launches_pretrain_eval_step=pretrain_eval_launches[name],
            launches_flagship_f32_train_step=flagship_f32_launches[name],
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"],
            composite_ms=row.get("composite_ms"),
        ))
    # Stack A's lift-splat at C=64: the float32 B=6 rows (the CLI's default
    # precision and train's batch); launches from phases 7 (forward) and 8
    for name, out, n_launch in (("lift_splat_c64", "out", stack_a_launches["lift_splat"]),
                                ("lift_splat_backward_c64", "dfeat",
                                 stack_a_train_launches["lift_splat_backward"])):
        src, replaces = KERNELS[name[:-4]][:2]
        row = c64_rows[(name, "float32", STACK_A_B, out)]
        if name == "lift_splat_backward_c64":
            row = dict(row, max_abs_err=max(row["max_abs_err"], c64_rows[
                (name, "float32", STACK_A_B, "ddepth")]["max_abs_err"]))
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces, launches=n_launch,
            launches_eval_forward=stack_a_launches[name[:-4]],
            launches_train_step=stack_a_train_launches[name[:-4]], dtype="float32",
            batch=STACK_A_B, max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], composite_ms=row.get("composite_ms"),
        ))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
