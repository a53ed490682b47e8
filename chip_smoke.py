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
     train-v2 shapes (B=8), in float32 and bfloat16, every output checked
     and repeated bit for bit: the deformable sampling's at uniform, local
     and one-cell locations (every point in one cell), beside autograd
     through the composite yardstick, its steps (keys and sort, dv, query)
     timed alone, and at uniform ones with the cotangent scaled by 2^-20
     and 2^20; lift-splat's (the plain version is its composite);
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
     5 steps on one batch that must move the loss, "train steps repeat"
     (below), then timed and profiled, with no `cudaStreamSynchronize` or
     `cudaMemcpy` in a step;
  6. one float32 train step at B=1, dropout off, on the card against the
     CPU: loss, grad_norm and the gradients upstream of both sampling
     kernels, printed beside the card's own spread from weights moved by
     1e-7, the yardstick of their limits; and the card's step under torch's
     defaults and under matmul "high" against its step with TF32 turned off
     by the caller (the step pins it): the loss and every gradient bit for
     bit;
  2c. (run with phase 2) kernels 3 and 3b at Stack A's width, C=64, in
     float32 and bfloat16: the forward at B=6 and B=1, the backward at B=6,
     against their plain versions with phase 2's limits, repeated bit for
     bit, timed beside their bounds and `index_add_`;
  2d. kernel 8, the VoVNet-39 trunk's float32 convs (`ops/conv.py`), at
     each distinct trunk conv at 48 images (B=8 x 6 cameras) of 128x352:
     against its plain version (cuDNN float32, TF32 off, which is also the
     library call it replaces) to 1e-4, repeated bit for bit, timed beside
     its bound (three TF32 passes) and summed over the eval trunk's 26
     convs at LSS v1 (the benchmark's and the CLI's train-v2 model); its
     launches are counted on the main path's own runs with the other
     kernels' (`expected_launches`);
  7. Stack A: BevTxt, the published model (EfficientNet-b4, C=64, float32,
     the JAX CLI's defaults), its eval forward at B=1 (predict) and B=6
     through `build_model`: one lift-splat launch and no host sync a forward,
     timed with its stages; at B=1 BevTxt, LSS and BevTxtOnlyBev on the card
     against the CPU, and BevTxt bit for bit against TF32 turned off by the
     caller;
  8. BevTxt's train step at the CLI's `train` defaults (B=6, float32, lr
     1e-4, wd 1e-8, clip 5.0, one group, no schedule): one lift-splat forward
     and backward launch a step, no host sync, 5 steps that move the loss,
     "train steps repeat", timed and split; one B=1 step on the card against the CPU beside the
     card's own spread from weights moved by 1e-7;
  9. Stack B's stage-1 -> stage-2 chain at the CLI's defaults, float32,
     LSS v1, checkpoints in the original repo's `.pt` formats
     (`train/checkpoint.py`): 9a. pretrain-v2 (VoVNetPreTrain, B=12, clip
     5.0, one group, warmup-cosine) on labels with pixels at 255: launches
     of kernels 1, 2, 3 and 3b, no host sync, 5 steps that move the loss,
     "train steps repeat", timed, split and profiled (cuDNN's FFT kernels counted), what ROADMAP
     fault 7's statistics pass costs (stage 4 runs at v1 in training only,
     without autograd, for its batch-norm statistics), one
     B=12 eval step (kernels 1, 3, 4, 5), and at B=1 the card against the
     CPU (forward, the pin bit for bit, a train step's gradients beside the
     card's own spread); 9b. its components saved as `best_pretrained.pth`
     and loaded into train-v2's flagship (B=8, clip 10, two groups) with
     `restore_loose`, the four components bit for bit and the rest at init,
     the flagship's float32 train step timed as in 9a, and a v2 pretrain's
     file into the v1 flagship dropping `depth_net` whole; 9c.
     `state_latest.pth` saved and restored into fresh objects, the state
     bit for bit and the next step's loss, gradients and weights bit for
     bit;
 10. the nu-A2D data slice at full width (900x1600 JPEGs, `AugConfig`'s
     defaults with flips, 128x352 inputs, the 200x200 grid): 10a. the
     port's `synthetic.generate` fixture over every mini_train and mini_val
     scene, timed; 10b. kernel 6 (JPEG IDCT) against its plain version on
     12 fixture images, the C++ entropy decoder against the Python one on
     2, kernel 7 (PIL-exact augmentation) against its plain version over 64
     draws, one item through the CPU path against the card's, all bit for
     bit, and both kernels timed at train-v2's batch beside their plain
     versions, their bounds and (kernel 7) `F.interpolate`; 10c. the loader
     alone: samples/s with 4 worker threads and with the machine's cores,
     the host stage's parts, the device stage per batch; 10d. train-v2's
     flagship (float32, vovnet39, LSS v1, B=8) fed by the loader over a
     window of 20 steps (every launch counted, no host sync inside a step,
     the loss moving, the window's mean step with its epoch starts, device
     busy and idle share over a window) beside the same model on one
     preloaded batch, then one eval step on a val batch;
 11. the CLI (`python -m lss2_multimodal_nu_tpu_torch.cli`) through
     `cli.main`, every subcommand at its defaults (the card, float32,
     process workers) but `--version mini`, the phase-10 fixture's dataroot
     and one epoch, each in a working directory of its own; only `train`
     keeps the default process workers (10), the other training runs take
     worker threads (`CLI_THREADS`): 11b. pretrain-v2
     (validating every epoch), train-v2 warm-started by its default
     `--pretrained_path` (the four components bit for bit), train-v2
     `--resume --nepochs 2` from its `state_latest.pth` (bit for bit);
     11c. pretrain (LSS b4), train (BevTxt b4), train-onlybev, predict (B=1)
     on train's `model0.pt`, predict-iou on pretrain's; for each run its
     wall seconds, its train steps (each waited for) with the median steady
     step and samples/s, its evaluations' seconds and host syncs (profiler:
     none but the read of the results), every kernel's launches (each
     expected kernel at least once), the files it wrote, finite losses;
     11d. predict on the card against `predict --device cpu` on train's
     `model0.pt` with its batch norms calibrated, within the CPU tests'
     limits (`tests/test_torch_cli.py`);
 12. the distributed path (`parallel/`) on one card: train-v2's flagship
     (float32, LSS v1, B=8, dropout off, constant rate) as one process,
     again (the control), then in an NCCL group of one rank, where the
     loss normalisers', metrics' and replicated gradients' all-reduces run
     as collectives of one, replicated and FSDP2 from the same weights: the
     control, the replicated step and FSDP2 each bit for bit with the first
     (loss, gradients, weights after the step), kernels 1, 2, 3 and 3b
     launched, no host sync in a
     step, the step's median beside the one process's; 12a. the global
     batch norm (`_GlobalBatchNorm`, which the step takes only at world >
     1) called in the group at each of the step's batch-norm shapes:
     output, gradients and running statistics within BN_TOL of float64,
     torch's float32 batch norm beside; then `cli._evaluate` under FSDP2
     through the group's all-gathers against the one process's: equal,
     kernels 1, 3, 4 and 5 launched, one host read (`dist_phase`);
 13. the trace-replay harness (`port/parity.py::check_parity`) at its
     defaults (the card, rtol = atol = 1e-3): the CPU's float32 B=1
     forwards of phases 4 (the flagship) and 7 (BevTxt b4) stand in for the
     original repo's, written as traces (BevTxt's as `.npz`, the flagship's
     as a pickle) and replayed through `build_model` with the state_dict
     loaded by name: every output passes, kernels 1, 3, 4 and 5 launched on
     the flagship and lift-splat alone on BevTxt (counts set to 0 before
     each replay); then once per output one weight shifted by +1.0, the BEV
     head's last bias (`bev` fails) and a bias that only `act` reads (`act`
     fails, `bev` passes); each report, replay ms and the phase's seconds
     printed (`parity_phase`).

Phases 2, 2b and 2c run kernels, plain versions and yardsticks in full
float32 (`ops/_precision.py::full_float32`); phases 3 to 8 run under
torch's default flags, as a user's program would, and the port's entry
points pin full float32 themselves. "Train steps repeat" (`repeat_check`,
phases 5, 8, 9a and 9b: every training path): from one saved state the
same train step on the same batch twice, the loss, every gradient, every
parameter and buffer after it and Adam's moments `torch.equal`, one line
per path, the first leaf that differs named. The last lines are the card
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
# 32-bit integer operations, the data kernels' operations bound: on compute
# capability 9.0 multiplies and multiply-adds issue to the FMA pipe, adds,
# logic, shifts, compares and selects to the ALU pipe, each 64 lanes per SM
# per clock (CUDA C programming guide), and an SM issues 128 lanes' worth
# per clock at most (four warp schedulers); 132 SMs at the 1.98 GHz boost
# clock
INT32_PIPE_OPS_PER_S = 64 * 132 * 1.98e9
INT32_ISSUE_OPS_PER_S = 128 * 132 * 1.98e9

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
# float32 itself, its backward too, and every sum in it has a fixed order):
# the loss and every gradient bit for bit. With the pin taken out of the
# forward and the step, the stem conv's gradient moved by 0.47 in norm
# (scripts/port_precision.py, NVIDIA H100 80GB HBM3, 700.00 W).
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
                     "DeviceRadixSortOnesweep", "ffn_ln", "conv3x3", "split_tf32",
                     "jpeg_decode_kernel", "resize_h_kernel", "resize_v_kernel",
                     "conv_tf32x3")
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
    [0, 1] (the offsets' init puts point k at k+1 cells); "one_cell" are
    all inside one cell (the corner 00 at x 137, y 61), at uniform places
    in it, the most that learned offsets could pile up."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n = GRID * GRID
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    v = t(rng.normal(size=(bh, n, DH)))
    if locations == "uniform":
        lx = torch.clamp(t(rng.uniform(0, 1, size=(bh, NPTS, n))) * 1.1 - 0.05, 0, 1)
        ly = torch.clamp(t(rng.uniform(0, 1, size=(bh, NPTS, n))) * 1.1 - 0.05, 0, 1)
    elif locations == "one_cell":
        lx = t((137.51 + 0.98 * rng.uniform(0, 1, size=(bh, NPTS, n))) / GRID)
        ly = t((61.51 + 0.98 * rng.uniform(0, 1, size=(bh, NPTS, n))) / GRID)
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
    from lss2_multimodal_nu_tpu_torch.ops import ffn, img_aug, jpeg_idct
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
    maps of 200x200x32, 8 points), at uniform, local and one-cell
    locations, and at uniform ones again with the cotangent scaled by 2^-20
    and 2^20 (`scale`; checked, not timed): (dtype, locations, scale,
    kernel_fn, plain_fn, composite yardstick or None, bytes, ops,
    tolerances per output). Bytes: v and g in, lx/ly/attn in, dv in v's
    dtype and the three float32 small gradients out, each once (the float32
    dv that the kernel sums and the CSR it sorts are its own scratch, not
    outputs of the function). Ops: per (map, point, query, channel) and
    corner, an FMA for rc (2) and a multiply, a multiply and an add for dv
    (3), in float32."""
    import numpy as np
    import torch

    from lss2_multimodal_nu_tpu_torch.ops import deformable_sampling as ds

    bh, n = TRAIN_B * NH, GRID * GRID
    g = torch.from_numpy(np.random.default_rng(12).normal(size=(bh, n, DH)).astype(np.float32)).to(dev)
    inputs = {kind: deform_inputs(dev, bh, seed=11, locations=kind)
              for kind in ("uniform", "local", "one_cell")}
    cases = []
    for dt, name_dt in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        es = 4 if dt == torch.float32 else 2
        for kind, scale in (("uniform", 1.0), ("local", 1.0), ("one_cell", 1.0),
                            ("uniform", 2.0 ** -20), ("uniform", 2.0 ** 20)):
            v, lx, ly, attn = inputs[kind]
            a = (v.to(dt), lx, ly, attn, (g * scale).to(dt))
            cases.append(dict(
                dtype=name_dt, locations=kind, scale=scale,
                kernel=lambda a=a: ds.deformable_sample_combine_xy_backward(*a, GRID, GRID),
                steps=lambda a=a: ds._backward_steps(*a, GRID, GRID)[0],
                plain=lambda a=a: ds.deformable_sample_combine_xy_backward_plain(*a, GRID, GRID),
                # grid_sample's backward adds with atomics into the one cell's
                # four rows there: not a yardstick worth its time
                composite=(lambda a=a: deform_composite(*a[:4], g=a[4]))
                if kind != "one_cell" else None,
                bytes=3 * bh * n * DH * es + 6 * bh * NPTS * n * 4,
                ops=bh * n * NPTS * DH * 4 * 5,
                # Ten times the errors measured on the H100 or more: dv 3.9e-6
                # in float32 and 1.6e-3 in bfloat16 (dv is rounded once at the
                # end, and the plain version's other order may flip that
                # rounding); dlx/dly/dattn are float32 in both dtypes, 8.1e-6,
                # where rc_01 - rc_00 cancels. The one cell's rows sum 320000
                # points each, about 1e-5 apart in two float32 orders.
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


# kernel 8's launches in one float32 VoVNet-39 flagship-family (eval
# forward, train step), by LSS version: v1 reads c3 alone, so an eval
# forward runs the stem's last two convs and stages 1-3's 24, and a train
# step stage 4's 12 alone (run without autograd for its batch-norm
# statistics; a gradient flows through the rest, which stays on cuDNN); v2
# reads c4 as well: all 38 in eval, none in training. bfloat16 runs none.
CONV_LAUNCHES = {"v1": (26, 12), "v2": (38, 0)}

# kernel -> (source, the TPU kernel it replaces, launches per eval forward,
# launches per train step), the counts of the float32 flagship at LSS v1
# where they depend on them (`expected_launches`). The `kernels` line's
# `launches` is the count in the first path that runs the kernel: the eval
# forward for the four forward kernels (its meaning since they were ported)
# and, kernel 8, its float32 twin (phase 3b), the train step for the
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
    # the data slice's kernels, run by the loader (phase 10), no model path:
    # they replace the JAX package's PIL decode and resampling on the host
    "jpeg_idct": ("lss2_multimodal_nu_tpu_torch/csrc/jpeg_idct.cu",
                  "lss2_multimodal_nu_tpu/data/dataset.py:202", 0, 0),
    "img_aug": ("lss2_multimodal_nu_tpu_torch/csrc/img_aug.cu",
                "lss2_multimodal_nu_tpu/data/dataset.py:87", 0, 0),
    "conv_tf32x3": ("lss2_multimodal_nu_tpu_torch/csrc/conv_tf32x3.cu",
                    "none: the JAX package's convs are XLA's (lss2_multimodal_nu_tpu/nn/vovnet.py)",
                    *CONV_LAUNCHES["v1"]),
}


def expected_launches(col, dtype="float32", lss_version="v1"):
    """kernel -> launches in one flagship-family eval forward (col 2) or
    train step (col 3) in `dtype` at `lss_version`: `KERNELS`' counts,
    kernel 8's from `CONV_LAUNCHES`."""
    want = {name: k[col] for name, k in KERNELS.items()}
    want["conv_tf32x3"] = CONV_LAUNCHES[lss_version][col - 2] if dtype == "float32" else 0
    return want


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


# the four training paths, by the label their phase gives them
TRAIN_PATHS = ("flagship bf16", "BevTxt f32", "pretrain-v2 f32", "train-v2 flagship f32")


def train_path(dev, label):
    """(model in training mode, optimizer, scheduler, batch) of one of the
    four training paths as its phase builds it: the flagship in bfloat16 at
    B=8 (phase 5), BevTxt b4 in float32 at B=6 (8), pretrain-v2 in float32
    at B=12 (9a), train-v2's flagship in float32 at B=8 (9b); weights from a
    seed, without phase 8's batch-norm calibration and phase 9b's warm
    start, which change no step's work. Phases 5 and 9a build their paths
    with it, and scripts that time or check the four steps alone."""
    from lss2_multimodal_nu_tpu_torch.models.factory import build_model
    from lss2_multimodal_nu_tpu_torch.train.state import build_optimizer

    if label == "flagship bf16":
        model, opt, sched = train_setup(dev, "bfloat16")
        return model, opt, sched, train_batch(dev, TRAIN_B, seed=5)
    if label == "BevTxt f32":
        cfg = stack_a_config("bev_txt", batch_size=STACK_A_B, lr=1e-4, weight_decay=1e-8,
                             max_grad_norm=5.0)
        batch = train_batch(dev, STACK_A_B, seed=5)
    elif label == "pretrain-v2 f32":
        cfg = chain_config("vovnet_pretrain", batch_size=PRETRAIN_B, lr=1e-4, weight_decay=1e-8,
                           max_grad_norm=5.0, num_epochs=60, warmup_epochs=5, use_schedule=True)
        batch = pretrain_batch(dev, PRETRAIN_B, seed=11)
    elif label == "train-v2 flagship f32":
        cfg = chain_config("vovnet_transformer", batch_size=TRAIN_B, lr=1e-4, weight_decay=1e-8,
                           max_grad_norm=10.0, num_epochs=60, warmup_epochs=5, use_schedule=True)
        batch = train_batch(dev, TRAIN_B, seed=13)
    else:
        raise ValueError(f"no training path {label!r}; they are {TRAIN_PATHS}")
    model = build_model(cfg, device=dev, seed=0)
    perturb(model, seed=1)
    opt, sched = build_optimizer(cfg, model.train(), steps_per_epoch=STEPS_PER_EPOCH)
    return model, opt, sched, batch


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
        want = expected_launches(2, dtype, "v2")
        expected = {name: want[name] for name in wrappers}
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
        again = c["kernel"]()
        torch.cuda.synchronize()
        repeats = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
        del again
        timed = c["scale"] == 1.0
        if timed:
            kms = time_ms(c["kernel"])
            pms = time_ms(c["plain"], reps=5, warmup=1)
            steps = c["steps"]()
            parts = {name: time_ms(fn) for name, fn in steps.items()}
            del steps
            cms = None
            if c["composite"] is not None:
                composite = c["composite"]()
                cms = time_ms(composite, reps=10)
                del composite
            print(f"deformable backward {c['dtype']} at {c['locations']} locations: "
                  f"{kms:.4f} ms, its steps (each timed alone) {json.dumps(parts)}")
        t_bytes, t_ops = c["bytes"] / HBM_BYTES_PER_S * 1e3, c["ops"] / PEAK_OPS["float32"] * 1e3
        for out, a, b in zip(("dv", "dlx", "dly", "dattn"), got, ref):
            a, b = a.float(), b.float()
            err = float((a - b).abs().max())
            rel = err / max(float(b.abs().max()), 1e-30)
            passed = bool(torch.isfinite(a).all()) and rel <= c["tol"][out] and repeats
            ok &= passed
            row = dict(name="deformable_sample_backward", output=out, dtype=c["dtype"],
                       max_abs_err=err, max_rel_err=rel, rel_tol=c["tol"][out], passed=passed,
                       repeats_bit_for_bit=repeats, locations=c["locations"],
                       g_scale=c["scale"])
            if timed:
                row.update(ms=kms, parts_ms=parts, plain_ms=pms, library_ms=None,
                           bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops else "operations",
                           bytes=c["bytes"], ops=c["ops"], composite_ms=cms)
                bwd_rows[(out, c["dtype"], c["locations"])] = row
            print("kernel_check " + json.dumps(row))
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


def stack_a_eval(dev, wrappers, traces):
    """Phase 7: BevTxt's eval forward at full width (b4, C=64, float32) at
    B=1 (predict's batch) and B=6, through `build_model`: one lift-splat
    launch and nothing else of the port's kernels per forward, finite outputs
    of the right shapes, no `cudaStreamSynchronize`; host-clock median of 10,
    device busy, idle share, the stages (`encoder`, `lift_to_bev`,
    `bevencode`, `txt_branch`) and peak memory. Then at B=1 the card's f32
    forward of BevTxt, LSS and BevTxtOnlyBev against the CPU's (2e-3 on the
    BEV, 1e-3 on act/desc), and BevTxt's bit for bit against a forward with
    TF32 turned off by the caller. BevTxt's B=1 CPU forward goes into
    `traces` for phase 13. Returns (launches of the B=6 forward, failure
    message or None)."""
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
            traces[family] = parity_trace(family, cpu_model, [t.numpy() for t in cpu_one], want)
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


def step_leaves(model, opt, metrics):
    """{name: a copy} of what a train step leaves: its loss and grad_norm,
    every gradient, every parameter and buffer, Adam's two moments of each
    parameter."""
    out = {"loss": metrics["loss"].clone(), "grad_norm": metrics["grad_norm"].clone()}
    params = dict(model.named_parameters())
    out.update((f"grad {n}", p.grad.clone()) for n, p in params.items() if p.grad is not None)
    out.update((f"weight {n}", t.detach().clone()) for n, t in model.state_dict().items())
    for n, p in params.items():
        for k in ("exp_avg", "exp_avg_sq"):
            if k in opt.state.get(p, {}):
                out[f"{k} {n}"] = opt.state[p][k].clone()
    return out


def repeat_check(label, model, opt, sched, batch, step):
    """"train steps repeat": the model's, optimizer's and scheduler's state
    saved, train step `step` run, the state restored and the same step run
    on the same batch again (dropout seeded by (seed, step) both times);
    the loss, grad_norm, every gradient, every parameter and buffer after
    the step and Adam's moments must be torch.equal in the two runs. Prints
    one line; returns a failure naming the first leaf that differs, or
    None. The model is left as after one step."""
    import copy

    from lss2_multimodal_nu_tpu_torch.train.steps import train_step

    saved = ({k: v.clone() for k, v in model.state_dict().items()}, copy.deepcopy(opt.state_dict()),
             copy.deepcopy(sched.state_dict()))
    runs = []
    for _ in range(2):
        model.load_state_dict(saved[0])
        opt.load_state_dict(copy.deepcopy(saved[1]))  # Adam keeps tensors it is given
        sched.load_state_dict(saved[2])
        runs.append(step_leaves(model, opt, train_step(model, opt, sched, batch, step)))
    first, again = runs
    differ = [n for n in first if n not in again or not torch_equal(first[n], again[n])]
    kinds = {k: sum(1 for n in first if n.startswith(k))
             for k in ("grad ", "weight ", "exp_avg ", "exp_avg_sq ")}
    print(f"train steps repeat, {label}: step {step} run twice from one state, loss, grad_norm, "
          f"{kinds['grad ']} gradients, {kinds['weight ']} parameters and buffers, "
          f"{kinds['exp_avg '] + kinds['exp_avg_sq ']} Adam moments bit for bit: {not differ}"
          + (f"; {len(differ)} differ, first {differ[0]}" if differ else ""))
    if differ:
        return f"train steps repeat: the {label} step differs on its second run at {differ[0]}"
    return None


def torch_equal(a, b):
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


def drive_train(label, model, opt, sched, batch, wrappers, expected):
    """A main path's train step through `train_step`: every count set to 0
    just before the first step and read just after, against `expected`; 5
    steps on one batch that must move the loss by more than 1e-3, everything
    finite; "train steps repeat" (`repeat_check`) at step 5; the median of
    10 steps after 3 more on the host clock, the forward / backward /
    optimizer split (CUDA events), device busy, idle share, the busiest
    kernels (cuDNN's FFT kernels among them), host syncs (none allowed) and
    peak memory. Returns (launches, the next step's
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
    err = repeat_check(label, model, opt, sched, batch, 5)
    if err:
        return launches, 6, err
    step = 6
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
    """What fault 7 costs and saves in a train step at LSS v1, where nothing
    reads stage 4: the step as it runs (stage 4 in training for its
    batch-norm statistics alone, without autograd) against the step without
    that statistics pass, 5 steps each in turns (as it runs, without,
    without, as it runs), host-clock medians; and stage 4's train forward
    alone on c3 (CUDA events). Returns the next step's index."""
    import torch

    from lss2_multimodal_nu_tpu_torch.ops._precision import full_float32
    from lss2_multimodal_nu_tpu_torch.train.steps import train_step

    stage4 = model.backbone.backbone.stages[3]
    times = {"with the statistics pass": [], "without": []}
    for kind in ("with the statistics pass", "without", "without", "with the statistics pass"):
        if kind == "without":
            stage4.forward = lambda x: x
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            train_step(model, opt, sched, batch, step)
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t1) * 1e3)
            step += 1
        stage4.__dict__.pop("forward", None)
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    imgs = batch["imgs"]
    with torch.no_grad(), full_float32():
        c3 = model.backbone(imgs.reshape(-1, *imgs.shape[2:]), False)["c3"]
        alone = time_ms(lambda: stage4(c3), reps=10)
    with_pass, without = med["with the statistics pass"], med["without"]
    print(f"fault 7, {label} train step B={imgs.shape[0]}: {with_pass:.3f} ms with stage 4's "
          f"batch-norm statistics pass, {without:.3f} ms without (host-clock medians of 10 in "
          f"turns): the pass costs {with_pass - without:.3f} ms a step; stage 4's train forward "
          f"alone {alone:.3f} ms (CUDA events)")
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

    torch.cuda.empty_cache()
    model, opt, sched, batch = train_path(dev, "pretrain-v2 f32")
    cfg = model.cfg
    if len(opt.param_groups) != 1 or sched.get_last_lr() != [0.0]:
        return model, None, None, (f"the pretrain trains in {len(opt.param_groups)} groups from "
                                   f"{sched.get_last_lr()}")
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
    scheduler equal the saved ones bit for bit, and the next step's loss,
    gradients, weights and Adam moments equal the uninterrupted run's bit
    for bit. Returns (launches of the train step, failure message or
    None)."""
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
        want = step_leaves(model, opt, m_a)
        got = step_leaves(fresh, f_opt, m_b)
        differ = [n for n in want if n not in got or not torch_equal(want[n], got[n])]
        print(f"9c the resumed step's gradients, weights and Adam moments against the "
              f"uninterrupted run's ({len(want)} tensors): bit for bit {not differ}"
              + (f"; {len(differ)} differ, first {differ[0]}" if differ else ""))
        if differ:
            return launches, f"the resumed step differs from the uninterrupted run's at {differ[0]}"
        return launches, None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase 10: the data slice at full width. The fixture: every mini_train and
# mini_val scene at 900x1600, DATA_SAMPLES a scene (48 train samples, six
# batches of 8; 12 val samples, one batch of pretrain-v2's 12, which phase 11
# needs), rendered and encoded by a process pool; train-v2's loader (B=8,
# rand_flip, 4 workers, the CLI's defaults).
DATA_SAMPLES, LOADER_WORKERS, DATA_HW = 6, 4, (900, 1600)
# 10c's epochs (30 batches); 10d's window of loader-fed steps (3.3 epochs)
RATE_EPOCHS, LOADER_STEPS = 5, 20
DATA_WRAPPERS = ("jpeg_idct", "img_aug")


def data_datasets(root, dev, is_train, device=None):
    """The nu-A2D dataset over the phase-10 fixture at `AugConfig`'s defaults
    with flips, augmentation seeded."""
    from lss2_multimodal_nu_tpu_torch.config import AugConfig, GridConfig
    from lss2_multimodal_nu_tpu_torch.data.dataset import NuA2DDataset
    from lss2_multimodal_nu_tpu_torch.data.nuscenes_index import NuScenesIndex

    return NuA2DDataset(NuScenesIndex("v1.0-mini", str(root)), is_train,
                        AugConfig(rand_flip=True), GridConfig(), str(root), rng=0,
                        device=device or dev)


def data_fixture(root):
    """10a: the port's `synthetic.generate` at full width, timed."""
    import os

    from lss2_multimodal_nu_tpu_torch.data import synthetic
    from lss2_multimodal_nu_tpu_torch.data.splits import create_splits_scenes

    sp = create_splits_scenes("nu_a2d")
    workers = min(os.cpu_count() or 1, 8)
    t0 = time.perf_counter()
    synthetic.generate(str(root), scenes=sp["mini_train"] + sp["mini_val"],
                       samples_per_scene=DATA_SAMPLES, img_hw=DATA_HW, seed=0, workers=workers)
    n = len(list((root / "samples").glob("CAM_*/*.jpg")))
    print(f"10a fixture: {len(sp['mini_train'])} mini_train + {len(sp['mini_val'])} mini_val "
          f"scenes x {DATA_SAMPLES} samples, {n} JPEGs at {DATA_HW[0]}x{DATA_HW[1]} in "
          f"{time.perf_counter() - t0:.1f} s ({workers} processes)")


def int_ops_ms(ops):
    """The least ms for integer operations by pipe ({"fma", "alu", "either"},
    `ops/_build.py::INT_PIPES`): the busier of the FMA and ALU pipes, or all
    of them at the issue rate, whichever is longer (an "either" operation
    takes whichever pipe has room)."""
    return max(ops["fma"] / INT32_PIPE_OPS_PER_S, ops["alu"] / INT32_PIPE_OPS_PER_S,
               sum(ops.values()) / INT32_ISSUE_OPS_PER_S) * 1e3


def data_bound(nbytes, ops):
    """(bound ms, what binds): the larger of the bytes over HBM's rate and the
    integer operations by pipe (`int_ops_ms`)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, int_ops_ms(ops)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def data_ops_per_unit(ops=None):
    """The data kernels' integer operations by pipe per unit of work, counted
    from the SASS of their probes in the build of `ops` (the port's `ops`
    package by default; `ops/_build.py::sass_int_ops`): {"jpeg_idct":
    {unit: {pipe: n}}, "img_aug": ...}, the units each module's PROBES."""
    if ops is None:
        from lss2_multimodal_nu_tpu_torch import ops
    out = {}
    for name in ("jpeg_idct", "img_aug"):
        probes = getattr(ops, name).PROBES
        counts = ops._build.sass_int_ops(name, [k for k, _ in probes.values()])
        out[name] = {unit: {pipe: n / per for pipe, n in counts[k].items()}
                     for unit, (k, per) in probes.items()}
    return out


def random_coefficients(rng, h, w, ncomp, sampling):
    """A `Coefficients` of random quantised values (small, as real blocks
    have them) with the standard tables at a random quality."""
    import numpy as np

    from lss2_multimodal_nu_tpu_torch.data import jpeg

    qy, qc = jpeg.quality_tables(int(rng.integers(50, 101)))
    hs, vs = sampling
    mx, my = -(-w // (8 * hs)), -(-h // (8 * vs))
    n = my * vs * mx * hs + (ncomp - 1) * mx * my
    coefs = np.clip(np.round(rng.laplace(0, 3, (n, 64))), -200, 200).astype(np.int16)
    coefs[:, 0] = rng.integers(-60, 60, n)
    return jpeg.Coefficients(h, w, sampling, np.stack([qy, qc, qc][:ncomp]).astype(np.int32),
                             coefs)


# 10b's edge cases: kernel 6 at sizes off 16 and of 1-3 MCUs a side (4:2:0
# chroma 1-2 wide), each a batch of 4:2:0, 4:4:4 and one-component images;
# kernel 7 at (H, W, final_dim, rot_lim): windows of about 220 taps staged in
# turns, upsampling, rotations to 40 degrees, a crop 600 wide
JPEG_EDGES = ((1, 1), (3, 5), (4, 4), (4, 3), (16, 16), (17, 23), (33, 47), (48, 32))
AUG_EDGES = ((900, 1600, (13, 29), None), (37, 61, (64, 128), None),
             (90, 160, (32, 88), (-40.0, 40.0)), (200, 700, (40, 600), None))


def data_edges(dev):
    """10b's edge cases on the card, each kernel against its plain version
    bit for bit; returns the cases that differ."""
    import numpy as np
    import torch

    from lss2_multimodal_nu_tpu_torch.config import AugConfig
    from lss2_multimodal_nu_tpu_torch.core.augment import sample_augmentation
    from lss2_multimodal_nu_tpu_torch.ops import img_aug, jpeg_idct

    bad = []
    kinds = [(3, (2, 2)), (3, (1, 1)), (1, (1, 1)), (3, (2, 2))]
    for h, w in JPEG_EDGES:
        rng = np.random.default_rng(h * 1000 + w)
        packed = jpeg_idct.pack([random_coefficients(rng, h, w, *k) for k in kinds])
        c, q, m = (torch.from_numpy(a).to(dev) for a in packed[:3])
        got = jpeg_idct.decode(c, q, m, h, w)
        if not torch.equal(got, jpeg_idct.decode_plain(c, q, m, h, w)):
            bad.append(f"jpeg_idct {h}x{w}")
    for h, w, final_dim, rot_lim in AUG_EDGES:
        rng = np.random.default_rng(h + w)
        conf = AugConfig(H=h, W=w, final_dim=final_dim, rand_flip=True,
                         **({} if rot_lim is None else {"rot_lim": rot_lim}))
        draws = [sample_augmentation(conf, i % 4 != 0, rng) for i in range(16)]
        images = torch.from_numpy(rng.integers(0, 256, (16, h, w, 3), dtype=np.uint8)).to(dev)
        tabs = img_aug.plan(draws, h, w, final_dim)
        pt, ht, vt = (torch.from_numpy(a).to(dev) for a in tabs[:3])
        got = img_aug.augment(images, pt, ht, vt, final_dim, tabs[3])
        if not torch.equal(got, img_aug.augment_plain(images, pt, ht, vt, final_dim)):
            bad.append(f"img_aug {h}x{w} -> {final_dim} rot_lim {rot_lim}")
    print(f"10b edge cases: kernel 6 at {len(JPEG_EDGES)} sizes (4:2:0, 4:4:4, gray), kernel 7 "
          f"in {len(AUG_EDGES)} configurations: bit for bit {not bad} {bad}")
    return bad


def data_pieces(dev, root):
    """10b: the pieces bit for bit, and the kernels' numbers at train-v2's
    batch (8 samples, 48 images). Kernel 6 against its plain version on 12
    fixture images; the C++ entropy decoder against the Python one on 2;
    kernel 7 against its plain version over 64 draws (zero-filled crops,
    flips, both rotation signs, the eval path); the edge cases
    (`data_edges`); one full-width item through the CPU path (Python
    entropy decoder, plain IDCT, plain resampling) against the card's. The
    bounds: each module's `bound` (bytes, integer operations), the
    operations per unit from this build's SASS. Returns (rows for the
    kernels line, failure or None)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from lss2_multimodal_nu_tpu_torch.config import AugConfig
    from lss2_multimodal_nu_tpu_torch.core.augment import sample_augmentation
    from lss2_multimodal_nu_tpu_torch.data import jpeg
    from lss2_multimodal_nu_tpu_torch.data.dataset import collate
    from lss2_multimodal_nu_tpu_torch.ops import img_aug, jpeg_idct

    files = sorted((root / "samples").glob("CAM_*/*.jpg"))
    data = [f.read_bytes() for f in files[::max(1, len(files) // 12)][:12]]
    coefs = [jpeg.decode_coefficients(d, library=True) for d in data]
    packed = jpeg_idct.pack(coefs)
    c, q, m = (torch.from_numpy(a).to(dev) for a in packed[:3])
    rgb = jpeg_idct.decode(c, q, m, *packed[3:])
    same6 = torch.equal(rgb, jpeg_idct.decode_plain(c, q, m, *packed[3:]))
    print(f"10b kernel 6 (jpeg_idct) on {len(data)} fixture images against its plain version: "
          f"bit for bit {same6}")
    t0 = time.perf_counter()
    same_entropy = all(np.array_equal(jpeg.decode_coefficients(d, library=False).coefs, k.coefs)
                       for d, k in zip(data[:2], coefs[:2]))
    print(f"10b the C++ entropy decoder against the Python one on 2 full-size images: bit for "
          f"bit {same_entropy} (Python {(time.perf_counter() - t0) / 2 * 1e3:.0f} ms an image)")

    rng = np.random.default_rng(3)
    conf = AugConfig(rand_flip=True)
    draws = [sample_augmentation(conf, i % 8 != 0, rng) for i in range(64)]
    cover = {"zero-filled crops": sum(p.resize_dims[0] < conf.final_dim[1] for p in draws),
             "flips": sum(p.flip for p in draws), "rotations < 0": sum(p.rotate < 0 for p in draws),
             "rotations > 0": sum(p.rotate > 0 for p in draws),
             "eval draws": sum(p.rotate == 0 and not p.flip for p in draws)}
    images = rgb[torch.arange(64, device=dev) % rgb.shape[0]]
    tabs = img_aug.plan(draws, *packed[3:], conf.final_dim)
    pt, ht, vt = (torch.from_numpy(a).to(dev) for a in tabs[:3])
    got7 = img_aug.augment(images, pt, ht, vt, conf.final_dim, tabs[3])
    same7 = torch.equal(got7, img_aug.augment_plain(images, pt, ht, vt, conf.final_dim))
    print(f"10b kernel 7 (img_aug) over 64 draws ({cover}) against its plain version: bit for "
          f"bit {same7}")
    edges = data_edges(dev)

    item_cpu = data_datasets(root, dev, True, "cpu")[5]
    item_card = data_datasets(root, dev, True)[5]
    same_item = set(item_cpu) == set(item_card) and all(
        torch.equal(item_cpu[k], item_card[k].cpu()) for k in item_cpu)
    print(f"10b one full-width train item (6 cameras) through the CPU path against the card's: "
          f"bit for bit {same_item}; imgs {tuple(item_card['imgs'].shape)}")
    if not (same6 and same_entropy and same7 and same_item and not edges
            and all(cover.values())):
        return None, "phase 10b: a piece of the data slice differs from its plain version"

    # the kernels' numbers at train-v2's batch: 8 samples, 48 images
    ds = data_datasets(root, dev, True)
    hb = collate([ds.host_item(i) for i in range(TRAIN_B)], conf.final_dim)
    b6 = {k: hb["tensors"][k].to(dev) for k in ("coefs", "quant", "meta")}
    b7 = {k: hb["tensors"][k].to(dev) for k in ("params", "htab", "vtab")}
    n, ncam, h, w = hb["shape"]
    dec = lambda: jpeg_idct.decode(b6["coefs"], b6["quant"], b6["meta"], h, w)  # noqa: E731
    rgb = dec()
    ms6 = time_ms(dec, reps=10)
    plain6 = time_ms(lambda: jpeg_idct.decode_plain(b6["coefs"], b6["quant"], b6["meta"], h, w),
                     reps=2, warmup=1)
    aug = lambda: img_aug.augment(rgb, b7["params"], b7["htab"], b7["vtab"],  # noqa: E731
                                  conf.final_dim, hb["rows"])
    ms7 = time_ms(aug, reps=10)
    plain7 = time_ms(lambda: img_aug.augment_plain(rgb, b7["params"], b7["htab"], b7["vtab"],
                                                   conf.final_dim), reps=2, warmup=1)
    # yardstick: one antialiased bicubic resize of the batch to the eval size
    # (close to PIL's, not PIL-exact: a time only)
    x = rgb.permute(0, 3, 1, 2).float()
    eval_hw = (int(h * max(conf.final_dim[0] / h, conf.final_dim[1] / w)),
               int(w * max(conf.final_dim[0] / h, conf.final_dim[1] / w)))
    lib7 = time_ms(lambda: F.interpolate(x, size=eval_hw, mode="bicubic", antialias=True),
                   reps=10)
    del x
    # bounds: each module's count of bytes and integer operations, with the
    # operations per unit of this build
    per = data_ops_per_unit()
    ht = {k: v.numpy() for k, v in hb["tensors"].items()}
    work = {
        "jpeg_idct": jpeg_idct.bound(ht["meta"], ht["coefs"].shape[0], h, w, per["jpeg_idct"]),
        "img_aug": img_aug.bound(ht["params"], ht["htab"], ht["vtab"], h, w, conf.final_dim,
                                 per["img_aug"]),
    }
    rows = {}
    for name, ms, plain, lib in (("jpeg_idct", ms6, plain6, None), ("img_aug", ms7, plain7, lib7)):
        nbytes, ops = work[name]
        bound_ms, by = data_bound(nbytes, ops)
        rows[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bound_ms, bound_by=by,
                          library_ms=lib, bytes=nbytes, int_ops=ops,
                          bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                          ops_ms=int_ops_ms(ops), ops_per_unit=per[name])
    for name, r in rows.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.3f} ms"
        print(f"10b {name} at train-v2's batch ({n * ncam} images of {h}x{w}): {r['ms']:.4f} ms "
              f"(CUDA events, mean of 10), plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {r['bytes'] / 1e6:.1f} MB "
              f"{r['bytes_ms']:.4f} ms, integer operations by pipe "
              f"{json.dumps({k: round(v) for k, v in r['int_ops'].items()})} {r['ops_ms']:.4f} "
              f"ms; per unit {json.dumps(r['ops_per_unit'])}), share "
              f"{r['bound_ms'] / r['ms']:.3f}, library call {lib}")
    return rows, None


def data_loader_rate(dev, root):
    """10c: the loader alone (host and device stages, no model): samples/s
    at B=8 over RATE_EPOCHS epochs of the train split with LOADER_WORKERS
    and with os.cpu_count() worker threads, from the first batch to the
    last (the first batch's wait printed apart; every later epoch's start
    inside), and over the batches that start no epoch; the host stage's
    parts per image and per sample on one thread; the device stage per
    batch (CUDA events). Returns {workers: samples/s}."""
    import os

    import torch

    from lss2_multimodal_nu_tpu_torch.data import jpeg
    from lss2_multimodal_nu_tpu_torch.data.dataset import collate, device_stage
    from lss2_multimodal_nu_tpu_torch.data.loader import DataLoader

    ds = data_datasets(root, dev, True)
    cores = os.cpu_count() or 1
    rates = {}
    for workers in sorted({LOADER_WORKERS, cores}):
        dl = DataLoader(ds, TRAIN_B, shuffle=True, num_workers=workers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stamps, starts = [], []
        for _ in range(RATE_EPOCHS):
            for j, batch in enumerate(dl):
                torch.cuda.current_stream().synchronize()  # the batch is on the card
                stamps.append(time.perf_counter())
                starts.append(j == 0)
        end = stamps[-1]
        rates[workers] = TRAIN_B * (len(stamps) - 1) / (end - stamps[0])
        steps = list(zip(stamps, stamps[1:], starts[1:]))
        gaps = [(b - a) * 1e3 for a, b, first in steps if not first]
        ends = [(b - a) * 1e3 for a, b, first in steps if first]
        print(f"10c loader alone, B={TRAIN_B}, {workers} worker threads: {rates[workers]:.2f} "
              f"samples/s over {len(stamps)} batches of {RATE_EPOCHS} epochs ({len(ends)} epoch "
              f"starts inside, {sum(ends) / len(ends):.1f} ms a batch that starts one); "
              f"{TRAIN_B * 1e3 * len(gaps) / sum(gaps):.2f} samples/s over the {len(gaps)} "
              f"batches that start none; first batch after {(stamps[0] - t0) * 1e3:.0f} ms, the "
              f"whole {(end - t0):.2f} s; os.cpu_count() {cores}")
    files = sorted((root / "samples").glob("CAM_*/*.jpg"))[:24]
    blobs = [f.read_bytes() for f in files]
    t0 = time.perf_counter()
    for d in blobs:
        jpeg.decode_coefficients(d, library=True)
    decode_ms = (time.perf_counter() - t0) / len(blobs) * 1e3
    t0 = time.perf_counter()
    for rec in ds.ixes[:TRAIN_B]:
        ds.get_binimg(rec)
        ds.get_txt(rec)
    labels_ms = (time.perf_counter() - t0) / TRAIN_B * 1e3
    t0 = time.perf_counter()
    items = [ds.host_item(i) for i in range(TRAIN_B)]
    item_ms = (time.perf_counter() - t0) / TRAIN_B * 1e3
    t0 = time.perf_counter()
    hb = collate(items, ds.aug.final_dim, pin=True)
    collate_ms = (time.perf_counter() - t0) * 1e3
    stage_ms = time_ms(lambda: device_stage(hb, dev), reps=5, warmup=1)
    print(f"10c host stage on one thread: entropy decoding {decode_ms:.2f} ms an image "
          f"({sum(map(len, blobs)) / len(blobs) / 1e3:.0f} KB), labels {labels_ms:.2f} ms a "
          f"sample, a whole sample {item_ms:.1f} ms ({TRAIN_B * 1e3 / item_ms / LOADER_WORKERS:.1f}"
          f" batches/s on {LOADER_WORKERS} cores if they scale); collate into pinned memory "
          f"{collate_ms:.1f} ms a batch ({hb['tensors']['coefs'].numel() * 2 / 1e6:.0f} MB of "
          "coefficients); "
          f"device stage {stage_ms:.3f} ms a batch of {TRAIN_B * 6} images (copies, kernels 6 "
          "and 7; CUDA events)")
    return rates


def data_train(dev, root, wrappers):
    """10d: train-v2's flagship at the CLI's defaults (vovnet39, LSS v1, V3,
    float32, B=8, clip 10, two groups, warmup-cosine) fed by the loader (4
    worker threads, flips): after one step that starts the loader and warms
    the model, a window of LOADER_STEPS steps, each waited for and timed on
    the host clock (the fixture's epochs are 4 batches, so a quarter of
    them start one): every count set to 0 before the window and read after,
    the losses finite and moving, the mean over the whole window (epoch
    starts included), the median, and the steps that start an epoch apart.
    Then a second such window under the profiler: its mean, device busy
    over the same steps, and the idle share of the two. Host syncs inside
    one step, and in the loader's next() apart. Beside it the same model
    on one preloaded batch, both windows alike. Then one eval step on a
    val batch (kernels 1, 3, 4, 5). Returns (train launches, failure or
    None)."""
    import torch

    from lss2_multimodal_nu_tpu_torch.data.dataset import collate, device_stage
    from lss2_multimodal_nu_tpu_torch.data.loader import DataLoader
    from lss2_multimodal_nu_tpu_torch.models.factory import build_model
    from lss2_multimodal_nu_tpu_torch.train.state import build_optimizer
    from lss2_multimodal_nu_tpu_torch.train.steps import eval_step, train_step

    cfg = chain_config("vovnet_transformer", batch_size=TRAIN_B, lr=1e-4, weight_decay=1e-8,
                       max_grad_norm=10.0, num_epochs=60, warmup_epochs=5, use_schedule=True)
    model = build_model(cfg, device=dev, seed=30)
    perturb(model, seed=31)
    opt, sched = build_optimizer(cfg, model.train(), steps_per_epoch=STEPS_PER_EPOCH)
    dl = DataLoader(data_datasets(root, dev, True), TRAIN_B, shuffle=True,
                    num_workers=LOADER_WORKERS)
    starts = []  # for each batch handed out, whether it starts an epoch

    def endless():
        while True:
            for j, batch in enumerate(dl):
                starts.append(j == 0)
                yield batch

    it = endless()
    step = 0

    def window(next_batch):
        """LOADER_STEPS train steps, each waited for: (host ms by step,
        losses, whether each step's batch started an epoch)."""
        nonlocal step
        times, losses, first = [], [], []
        torch.cuda.synchronize()
        last = time.perf_counter()
        for _ in range(LOADER_STEPS):
            batch = next_batch()
            first.append(next_batch is loaded and starts[-1])
            m = train_step(model, opt, sched, batch, step)
            torch.cuda.synchronize()
            now = time.perf_counter()
            times.append((now - last) * 1e3)
            last = now
            step += 1
            losses.append(float(m["loss"]))
        return times, losses, first

    def profiled(next_batch):
        out = []
        busy, _, _, _ = device_profile(lambda: out.append(window(next_batch)))
        return busy, out[0][0]

    # one batch's device stage, for its launches of each data kernel
    ds = data_datasets(root, dev, True)
    hb = collate([ds.host_item(i) for i in range(TRAIN_B)], ds.aug.final_dim)
    for f in wrappers.values():
        f.launches = 0
    device_stage(hb, dev)
    per_batch = {n: wrappers[n].launches for n in DATA_WRAPPERS}
    print(f"10d launches of one batch's device stage: {per_batch}")

    loaded = lambda: next(it)  # noqa: E731
    train_step(model, opt, sched, next(it), step)
    step += 1
    torch.cuda.synchronize()
    for f in wrappers.values():
        f.launches = 0
    times, losses, first = window(loaded)
    launches = {name: f.launches for name, f in wrappers.items()}
    print(f"10d loader-fed train-v2 flagship f32 B={TRAIN_B}, {LOADER_STEPS} steps: launches "
          f"{launches}; losses {[round(x, 5) for x in losses]}")
    want = {n: LOADER_STEPS * k[3] for n, k in KERNELS.items() if n not in DATA_WRAPPERS}
    # the loader stages at most one batch ahead of the steps: each data
    # kernel's launches of one batch's device stage, LOADER_STEPS +- 1 times
    staged = {n: range(per_batch[n] * (LOADER_STEPS - 1), per_batch[n] * (LOADER_STEPS + 1) + 1,
                       per_batch[n]) for n in DATA_WRAPPERS}
    if {n: launches[n] for n in want} != want or not all(launches[n] in staged[n]
                                                        for n in DATA_WRAPPERS):
        return launches, f"loader-fed launch counts {launches}, expected {want} and " \
                         f"{ {n: list(r) for n, r in staged.items()} } of the data kernels"
    if not all(math.isfinite(x) for x in losses) or max(losses) - min(losses) <= 1e-3:
        return launches, f"the loader-fed losses are wrong: {losses}"
    batch = next(it)
    _, _, _, syncs = device_profile(lambda: train_step(model, opt, sched, batch, step))
    step += 1
    _, _, _, loader_syncs = device_profile(lambda: next(it))
    busy, ptimes = profiled(loaded)

    pre = {k: v.clone() for k, v in batch.items()}
    preloaded = lambda: pre  # noqa: E731
    pre_times, _, _ = window(preloaded)
    pre_busy, pre_ptimes = profiled(preloaded)
    _, _, _, pre_syncs = device_profile(lambda: train_step(model, opt, sched, pre, step))
    step += 1

    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    epoch_steps = [t for t, f in zip(times, first) if f]
    rest = [t for t, f in zip(times, first) if not f]
    print(f"10d loader-fed step: {mean(times):.3f} ms a step over the window of {LOADER_STEPS} "
          f"({TRAIN_B / mean(times) * 1e3:.2f} samples/s), median {med(times):.3f} "
          f"({min(times):.3f}-{max(times):.3f}); the {len(epoch_steps)} steps that start an epoch "
          f"{mean(epoch_steps):.3f} ms, the other {len(rest)} {mean(rest):.3f} ms; by step "
          f"{[round(t, 1) for t in times]}")
    print(f"10d loader-fed window under the profiler: {mean(ptimes):.3f} ms a step, device busy "
          f"{busy / LOADER_STEPS:.3f} ms a step over the same {LOADER_STEPS} steps, idle share "
          f"{1 - busy / sum(ptimes):.3f}; host syncs inside the step {json.dumps(syncs)}, in the "
          f"loader's next() {json.dumps(loader_syncs)}")
    print(f"10d preloaded batch, same model: {mean(pre_times):.3f} ms a step over the window of "
          f"{LOADER_STEPS}, median {med(pre_times):.3f} ({min(pre_times):.3f}-"
          f"{max(pre_times):.3f}), {TRAIN_B / mean(pre_times) * 1e3:.2f} samples/s; under the "
          f"profiler {mean(pre_ptimes):.3f} ms a step, device busy {pre_busy / LOADER_STEPS:.3f} "
          f"ms, idle share {1 - pre_busy / sum(pre_ptimes):.3f}; host syncs "
          f"{json.dumps(pre_syncs)}; loader-fed / preloaded {mean(times) / mean(pre_times):.3f} "
          f"on the window's mean, {med(times) / med(pre_times):.3f} on the median")
    if syncs["cudaStreamSynchronize"] or syncs["cudaMemcpy"]:
        return launches, f"the loader-fed train step makes host syncs: {syncs}"

    vb = next(iter(DataLoader(data_datasets(root, dev, False), TRAIN_B, shuffle=False,
                              num_workers=LOADER_WORKERS)))
    model.eval()
    for f in wrappers.values():
        f.launches = 0
    res = eval_step(model, vb, torch.zeros(4, 4, dtype=torch.int64, device=dev))
    torch.cuda.synchronize()
    eval_launches = {name: f.launches for name, f in wrappers.items()}
    counted = int(res["confmat"].sum())
    print(f"10d eval step on a val batch of {vb['imgs'].shape[0]}: launches {eval_launches}; "
          f"loss {float(res['loss']):.6f}; {counted} pixels in the confusion matrix")
    want = {name: k[2] for name, k in KERNELS.items()}
    if eval_launches != want or counted != vb["binimg"].numel() or not math.isfinite(
            float(res["loss"])):
        return launches, f"the loader-fed eval step is wrong: {eval_launches}, {res['loss']}"
    return launches, None


# phase 11: the CLI on the card. The kernels each subcommand's path launches
# (kernel 2 and 3b only where it trains, 4 and 5 only in Stack B's
# validation, 6 and 7 in the loader of every path)
CLI_STACK_B = tuple(KERNELS)
CLI_STACK_A = ("lift_splat", "lift_splat_backward", "jpeg_idct", "img_aug")
CLI_PREDICT = ("lift_splat", "jpeg_idct", "img_aug")
CLI_LOG_PATTERNS = ("Loading pre-trained", "resuming from", "loading ", "  format ",
                    "  dropped ", "mean IoU", "val_loss", "saved best", "Best mIoU", "not found")
# `predict` on the card against `--device cpu`: the CPU tests' limits on the
# slice (`tests/test_torch_cli.py`): confusion matrices apart in at most
# 1e-4 of the pixels, each IoU within 1e-3, the loss within 1e-4 relative,
# the act/desc F1 scores equal
CLI_PIXELS_TOL, CLI_IOU_TOL, CLI_LOSS_RTOL = 1e-4, 1e-3, 1e-4
# subcommand run -> the launches counted over it, for the `kernels` line
CLI_LAUNCHES = {}
# `train` runs at its default process workers (10); the other training runs
# take worker threads: on the card's host a pool of worker processes waits
# tens of seconds for its first batch (phase 11 prints `train`'s split
# beside the others'), and a training run starts three (the loader's probe,
# train, validation), which would take the script past its time limit
CLI_THREADS = ["--worker_type", "thread"]


def port_wrappers():
    """Every kernel's wrapper, whose `launches` counts its launches."""
    from lss2_multimodal_nu_tpu_torch.ops import conv, ffn, img_aug, jpeg_idct
    from lss2_multimodal_nu_tpu_torch.ops import deformable_sampling as ds
    from lss2_multimodal_nu_tpu_torch.ops import lift_splat as ls
    from lss2_multimodal_nu_tpu_torch.ops import seg_head as sh

    return {"deformable_sample": ds.deformable_sample_combine_xy,
            "deformable_sample_backward": ds.deformable_sample_combine_xy_backward,
            "lift_splat": ls.fused_lift_splat,
            "lift_splat_backward": ls.fused_lift_splat_backward,
            "ffn_ln": ffn.fused_ffn_ln, "seg_head": sh.fused_seg_head,
            "jpeg_idct": jpeg_idct.decode, "img_aug": img_aug.augment,
            "conv_tf32x3": conv.conv2d_tf32x3}


def _descendants_rss():
    """(this process's resident memory, the summed resident memory of its
    descendants: the loader's forkserver and workers), bytes, from /proc:
    resident pages less those shared with files (the libraries a forked
    worker shares with its forkserver)."""
    import os

    children = {}
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, IndexError, ValueError):
                continue
            children.setdefault(ppid, []).append(int(d))

    def rss(pid):
        try:
            with open(f"/proc/{pid}/statm") as f:
                resident, shared = f.read().split()[1:3]
            return (int(resident) - int(shared)) * os.sysconf("SC_PAGE_SIZE")
        except (OSError, IndexError, ValueError):
            return 0

    todo, total = list(children.get(os.getpid(), [])), 0
    while todo:
        pid = todo.pop()
        total += rss(pid)
        todo += children.get(pid, [])
    return rss(os.getpid()), total


def count_syncs(fn):
    """The calls of `SYNC_CALLS` that `fn` makes, and of
    `cudaLaunchKernel` (the proof that the runtime's calls were recorded),
    under torch.profiler with CUDA activity alone (the host's operators
    unrecorded, so that reading the profile of a long call stays cheap);
    the profiler's own stop adds a `cudaDeviceSynchronize`, not counted."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    syncs = {k: 0 for k in (*SYNC_CALLS, "cudaLaunchKernel")}
    for e in prof.events():
        if e.name in syncs:
            syncs[e.name] += 1
        elif e.name.startswith("cudaLaunchKernel"):  # cudaLaunchKernelExC (cuBLAS)
            syncs["cudaLaunchKernel"] += 1
    syncs["cudaDeviceSynchronize"] = max(syncs["cudaDeviceSynchronize"] - 1, 0)
    return syncs


class CliRecorder:
    """Instruments one `cli.main` run from outside: every train step waited
    for and timed (host clock between `torch.cuda.synchronize()` calls) with
    its loss read, and every evaluation timed and profiled (`count_syncs`,
    on a card); train-v2's model state taken right after its warm start or
    restore; the host memory at the first step. The clock at each step's
    and evaluation's ends (`marks`) splits the run's wall time."""

    def __init__(self, cuda):
        self.cuda = cuda
        self.steps, self.losses, self.bsize = [], [], None
        self.evals, self.snapshot, self.marks, self.memory = [], None, [], None

    def _sync(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize()

    def patches(self):
        import contextlib
        import unittest.mock as mock

        from lss2_multimodal_nu_tpu_torch import cli
        from lss2_multimodal_nu_tpu_torch.train import steps

        train_step, evaluate, warm = steps.train_step, cli._evaluate, cli._maybe_stage1_warmstart

        def timed_step(model, opt, sched, batch, step, mark=None):
            if self.memory is None:  # the epoch's workers are up, their batches queued
                self.memory = _descendants_rss()
            self._sync()
            t0 = time.perf_counter()
            m = train_step(model, opt, sched, batch, step)
            self._sync()
            self.marks.append(("step", t0, time.perf_counter()))
            self.steps.append((time.perf_counter() - t0) * 1e3)
            self.losses.append(float(m["loss"]))
            self.bsize = batch["imgs"].shape[0]
            return m

        def profiled_eval(cfg, model, loader, no_bev=False):
            out = []

            def run():
                self._sync()
                t0 = time.perf_counter()
                out.append(evaluate(cfg, model, loader, no_bev))
                self._sync()
                out.append((t0, time.perf_counter()))

            t_call = time.perf_counter()
            syncs = count_syncs(run) if self.cuda else (run(), {})[1]
            (t0, t1), t_end = out[1], time.perf_counter()
            self.marks.append(("eval", t0, t1))
            self.evals.append(dict(s=t1 - t0, profiler=(t_end - t_call) - (t1 - t0),
                                   batches=len(loader), syncs=syncs, loss=out[0]["loss"]))
            return out[0]

        def spy(args, family, model, device, restored):
            warm(args, family, model, device, restored)
            if family == "vovnet_transformer":
                self.snapshot = {k: v.detach().to("cpu", copy=True)
                                 for k, v in model.state_dict().items()}

        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(steps, "train_step", timed_step))
        stack.enter_context(mock.patch.object(cli, "_evaluate", profiled_eval))
        stack.enter_context(mock.patch.object(cli, "_maybe_stage1_warmstart", spy))
        return stack


def run_cli(argv, compare=None):
    """`cli.main(argv)` in the current directory, every kernel count set to
    0 before it and read after, instrumented by `CliRecorder`; with
    compare = {"path", "modules"}, the model state that train-v2 starts
    from (after its warm start or restore) against the file's (loaded
    before the run, which may overwrite it), bit for bit, over the named
    top-level modules (all if None). Returns the run's numbers."""
    import contextlib
    import io

    import torch

    from lss2_multimodal_nu_tpu_torch import cli
    from lss2_multimodal_nu_tpu_torch.train import checkpoint as ck

    want = None
    if compare:
        want, _ = ck.model_state(ck.load_file(compare["path"], "cpu"))
        want = {k: v for k, v in want.items()
                if compare["modules"] is None or k.split(".")[0] in compare["modules"]}
    wrappers = port_wrappers()
    cuda = "cpu" not in argv
    rec = CliRecorder(cuda)
    for f in wrappers.values():
        f.launches = 0
    buf = io.StringIO()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with rec.patches(), contextlib.redirect_stdout(buf):
        result = cli.main(argv)
    torch.cuda.synchronize()
    out = dict(wall=time.perf_counter() - t0, steps=rec.steps, losses=rec.losses,
               bsize=rec.bsize, evals=rec.evals, memory=rec.memory,
               marks=[(n, a - t0, b - t0) for n, a, b in rec.marks],
               launches={n: f.launches for n, f in wrappers.items()}, log=buf.getvalue())
    if isinstance(result, torch.nn.Module):
        out["training"] = result.training
    else:
        out["info"] = result
    if want is not None:
        out["compared"] = len(want)
        out["differ"] = [k for k, v in want.items() if not torch.equal(rec.snapshot[k], v)]
    return out


def cli_run(label, argv, cwd, kernels, files, compare=None):
    """11b-11d: one subcommand (`run_cli`) in the working directory `cwd`,
    its launches kept in CLI_LAUNCHES; prints its numbers and the key lines
    of its output. Fails if a kernel of `kernels` was not launched, a file
    of `files` is missing, a loss is not finite, an evaluation syncs with
    the host more than once (the read of its results), the model is not
    back in training mode after validation or the compared model state
    differs. Returns (the run's numbers, failure or None)."""
    import os

    cwd.mkdir(parents=True, exist_ok=True)
    old = os.getcwd()
    os.chdir(cwd)
    try:
        out = run_cli(argv, compare)
    finally:
        os.chdir(old)
    wall = out["wall"]
    launches = CLI_LAUNCHES[label] = out["launches"]
    written = sorted(str(p.relative_to(cwd)) for p in cwd.rglob("*") if p.is_file())
    steady = sorted(out["steps"][1:])
    med = steady[len(steady) // 2] if steady else float("nan")
    step_txt = (f"{len(out['steps'])} steps, median steady step {med:.1f} ms "
                f"({out['bsize'] / med * 1e3:.2f} samples/s at B={out['bsize']}), first "
                f"{out['steps'][0]:.1f} ms" if out["steps"] else "no train step")
    evals = "; ".join(f"{e['s']:.2f} s over {e['batches']} batches (the profiler "
                      f"{e['profiler']:.2f} s more), host syncs {json.dumps(e['syncs'])}"
                      for e in out["evals"])
    # the wall split: to the first step or evaluation (the loader's probe,
    # the model, restores, the first batch), the steps, the evaluations, the
    # rest (batches waited for, checkpoint writes)
    inside = {k: sum(b - a for n, a, b in out["marks"] if n == k) for k in ("step", "eval")}
    first = min((a for _, a, _ in out["marks"]), default=wall)
    memory = "" if out["memory"] is None else (
        f"; host memory at the first step (resident, not file-shared) {out['memory'][0] / 1e9:.2f}"
        f" GB this process, {out['memory'][1] / 1e9:.2f} GB its loader's workers")
    print(f"11 {label}: {wall:.1f} s wall (split: {first:.1f} s to the first step or evaluation, "
          f"steps {inside['step']:.1f} s, evaluations {inside['eval']:.1f} s, the rest "
          f"{wall - first - inside['step'] - inside['eval']:.1f} s); {step_txt}; evaluation "
          f"{evals}; launches {json.dumps(launches)}; files {written}{memory}")
    for line in out["log"].splitlines():
        if any(p in line for p in CLI_LOG_PATTERNS):
            print(f"    | {line}")
    missing = [f for f in files if not (cwd / f).is_file()]
    unlaunched = [n for n in kernels if not launches[n]]
    losses = out["losses"] + [e["loss"] for e in out["evals"]]
    if missing:
        return out, f"11 {label}: files not written: {missing}"
    if unlaunched:
        return out, f"11 {label}: kernels of its path never launched: {unlaunched}"
    if not out["evals"] or not all(math.isfinite(x) for x in losses):
        return out, f"11 {label}: no evaluation, or a loss not finite: {losses}"
    if kernels and any(e["syncs"]["cudaStreamSynchronize"] + e["syncs"]["cudaMemcpy"] > 1
                       for e in out["evals"]):
        return out, f"11 {label}: an evaluation syncs more than once: {evals}"
    if kernels and not all(e["syncs"]["cudaLaunchKernel"] for e in out["evals"]):
        return out, f"11 {label}: the profiler recorded no CUDA runtime call"
    if not out.get("training", True):
        return out, f"11 {label}: the model is not back in training mode after validation"
    if out.get("differ"):
        return out, f"11 {label}: the restored state differs from the file: {out['differ'][:5]}"
    return out, None


def cli_stack_b(data_arg, base):
    """11b: pretrain-v2, then train-v2 warm-started by its default
    --pretrained_path (the four components bit for bit), then train-v2
    --resume --nepochs 2 from its state_latest.pth (bit for bit), in one
    working directory."""
    from lss2_multimodal_nu_tpu_torch.models.vovnet_pretrain import PRETRAIN_COMPONENTS

    cwd = base / "stack_b"
    common = [*data_arg, *CLI_THREADS, "--nepochs", "1", "--eval_every", "1"]
    _, err = cli_run("pretrain-v2", ["pretrain-v2", *common], cwd, CLI_STACK_B,
                     ["pretrain_vovnet/best_pretrained.pth", "pretrain_vovnet/state_latest.pth",
                      "pretrain_vovnet/result.txt"])
    if err:
        return err
    out_dir = "checkpoints_vovnet_transformer"
    out, err = cli_run("train-v2", ["train-v2", *common], cwd, CLI_STACK_B,
                       [f"{out_dir}/best_model_V3.pth", f"{out_dir}/state_latest.pth",
                        f"{out_dir}/result.txt"],
                       compare=dict(path=str(cwd / "pretrain_vovnet/best_pretrained.pth"),
                                    modules=list(PRETRAIN_COMPONENTS)))
    if err:
        return err
    warm = "Loading pre-trained weights from: ./pretrain_vovnet/best_pretrained.pth" in out["log"]
    print(f"11b the default warm start printed: {warm}; the four components' {out['compared']} "
          f"tensors bit for bit equal to best_pretrained.pth: {not out['differ']}")
    if not warm:
        return "11b train-v2 did not warm-start from its default --pretrained_path"
    out, err = cli_run("train-v2 --resume --nepochs 2",
                       ["train-v2", *data_arg, *CLI_THREADS, "--nepochs", "2", "--eval_every", "1",
                        "--resume"],
                       cwd, CLI_STACK_B, [f"{out_dir}/state_latest.pth"],
                       compare=dict(path=str(cwd / out_dir / "state_latest.pth"), modules=None))
    if err:
        return err
    resumed = f"resuming from ./{out_dir}/state_latest.pth" in out["log"]
    warm = "Loading pre-trained" in out["log"]
    print(f"11b resume printed: {resumed}; the restored model's {out['compared']} tensors bit for "
          f"bit equal to state_latest.pth: {not out['differ']}; the warm start skipped: {not warm}")
    if not resumed or warm:
        return "11b train-v2 --resume did not restore state_latest.pth alone"
    return None


def cli_stack_a(data_arg, base):
    """11c: pretrain (LSS b4), train (BevTxt b4) and train-onlybev, each in
    a working directory of its own, then predict (B=1) on train's model0.pt
    and predict-iou on pretrain's."""
    common = [*data_arg, "--nepochs", "1"]
    runs = (("pretrain", "pretrain_result", "pretrain-result.txt"),
            ("train", "result-log", "result.txt"),
            ("train-onlybev", "result-log", "result.txt"))
    for cmd, logdir, results in runs:
        workers = [] if cmd == "train" else CLI_THREADS
        _, err = cli_run(cmd, [cmd, *common, *workers], base / cmd, CLI_STACK_A,
                         [f"{logdir}/model0.pt", f"{logdir}/state_latest.pth",
                          f"{logdir}/{results}"])
        if err:
            return err
    _, err = cli_run("predict", ["predict", *common, "--checkpoint", "result-log/model0.pt"],
                     base / "train", CLI_PREDICT, ["test.txt"])
    if err:
        return err
    _, err = cli_run("predict-iou", ["predict-iou", *common, "--checkpoint",
                                     "pretrain_result/model0.pt"], base / "pretrain",
                     CLI_PREDICT, ["b1_20.txt"])
    return err


def _number_lines(path):
    """(text with numbers as '#', [numbers], whether F1 scores) per line."""
    import re

    num = re.compile(r"-?\d+(?:\.\d+)?(?:e-?\d+)?")
    return [(num.sub("#", line), [float(x) for x in num.findall(line)],
             "F1" in line or "overall" in line or "_mean" in line)
            for line in path.read_text().splitlines()]


def cli_card_vs_cpu(dev, data_arg, base):
    """11d: train's model0.pt with its batch norms calibrated to the first
    test batch (raw, a random init trained 8 steps gives logits far from
    order 1, where float32 round-off flips argmaxes), `predict` on the card
    and `predict --device cpu` on that file and the same data: the
    confusion matrices, IoUs, loss, F1 scores and test.txt within the CPU
    tests' limits."""
    import numpy as np

    from lss2_multimodal_nu_tpu_torch import cli
    from lss2_multimodal_nu_tpu_torch.models.factory import build_model
    from lss2_multimodal_nu_tpu_torch.train import checkpoint as ck
    from lss2_multimodal_nu_tpu_torch.train.steps import MODEL_INPUTS

    cwd = base / "train"
    args = cli.build_parser().parse_args(["predict", *data_arg])
    cfg = cli._build_cfg(args, "bev_txt")
    model = build_model(cfg, dev, seed=0)
    ck.restore_loose(str(cwd / "result-log/model0.pt"), model, map_location=dev)
    batch = next(iter(cli._loaders(cfg, True, "nu_a2d", test=True, nworkers=4, device=dev)))
    calibrate(model, [batch[k] for k in MODEL_INPUTS])
    ck.save_params(str(cwd / "calibrated.pt"), model)
    del model, batch
    infos = {}
    for device in ("cuda", "cpu"):
        out, err = cli_run(f"predict --device {device} (calibrated)",
                           ["predict", *data_arg, "--nepochs", "1", "--device", device,
                            "--checkpoint", "calibrated.pt", "--out_file", f"{device}.txt"], cwd,
                           CLI_PREDICT if device == "cuda" else (), [f"{device}.txt"])
        if err:
            return err
        infos[device] = out["info"]
    got, want = infos["cuda"], infos["cpu"]
    pixels = int(want["confmat"].sum())
    moved = int(np.abs(got["confmat"] - want["confmat"]).sum()) // 2
    iou = float(np.nanmax(np.abs(got["iou"] - want["iou"])))
    loss = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    f1 = all(got[k] == want[k] for k in ("act_f1", "desc_f1", "act_overall", "desc_overall",
                                         "act_mean", "desc_mean"))
    lines_ok = True
    for (ta, na, fa), (tb, nb, _) in zip(_number_lines(cwd / "cuda.txt"),
                                         _number_lines(cwd / "cpu.txt")):
        tol = 0.0 if fa else 0.2  # one-decimal percentages: two roundings of 1e-3
        lines_ok &= ta == tb and all(abs(x - y) <= tol + 1e-12 for x, y in zip(na, nb))
    print(f"11d predict card vs CPU on {pixels} pixels: {moved} moved between cells "
          f"(limit {CLI_PIXELS_TOL * pixels:.0f}), max IoU diff {iou:.2e} (limit {CLI_IOU_TOL}), "
          f"loss {got['loss']:.6f} vs {want['loss']:.6f}, rel diff {loss:.2e} (limit "
          f"{CLI_LOSS_RTOL}); F1 scores equal {f1}; test.txt lines agree {lines_ok}; mIoU "
          f"{got['mean_iou']:.4f} vs {want['mean_iou']:.4f}")
    if not (moved <= CLI_PIXELS_TOL * pixels and iou <= CLI_IOU_TOL and loss <= CLI_LOSS_RTOL
            and f1 and lines_ok):
        return "11d predict on the card disagrees with predict on the CPU"
    return None


def cli_phase(dev, data_root):
    """Phase 11: the CLI on the card, subcommand by subcommand, from the
    phase-10 fixture (`--version mini`). Returns a failure or None."""
    import shutil

    base = ROOT / "build" / "cli11"
    shutil.rmtree(base, ignore_errors=True)
    data_arg = ["--version", "mini", "--dataroot", str(data_root.parent)]
    t0 = time.perf_counter()
    try:
        err = cli_stack_b(data_arg, base)
        if not err:
            err = cli_stack_a(data_arg, base)
        if not err:
            err = cli_card_vs_cpu(dev, data_arg, base)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    print(f"phase 11 (the CLI): {time.perf_counter() - t0:.1f} s")
    return err


# phase 12: the distributed path at world 1 (one card, an NCCL group of one)
DIST_B = 8
DIST_LR = 1e-4
DIST_EVAL_BATCHES = 2
DIST_TRAIN = ("deformable_sample", "deformable_sample_backward", "lift_splat",
              "lift_splat_backward")
DIST_EVAL = ("deformable_sample", "lift_splat", "ffn_ln", "seg_head")


def _full_grads(model):
    """{leaf: its gradient in full (a sharded one gathered), float32}."""
    out = {}
    for n, p in model.named_parameters():
        if p.grad is not None:
            g = p.grad.full_tensor() if hasattr(p.grad, "full_tensor") else p.grad
            out[n] = g.detach().float().clone()
    return out


def _full_weights(model):
    return {n: (p.full_tensor() if hasattr(p, "full_tensor") else p).detach().clone()
            for n, p in model.named_parameters()}


def _step_differs(run, want):
    """The leaves of two phase-12 runs (loss, gradients, weights) that are
    not bit for bit equal, in order; empty when the runs are equal."""
    (loss, grads, weights), (loss0, grads0, weights0) = run, want
    out = [] if torch_equal(loss, loss0) else ["loss"]
    out += [f"grad {n}" for n, g in grads0.items() if n not in grads or not torch_equal(grads[n], g)]
    return out + [f"weight {n}" for n, w in weights0.items() if not torch_equal(weights[n], w)]



BN_TOL = 1e-5  # _GlobalBatchNorm against float64, norm of difference / norm


def bn_check(dev, shapes):
    """12a: `nn/layers.py::global_batch_norm` (`_GlobalBatchNorm`, called
    directly: its all-gather and all-reduce run in the group of one) against
    torch's training batch norm on the same inputs, both held to float64,
    at each of `shapes` (the flagship step's batch norms): the output, the
    input's, weight's and bias's gradients, the running mean and variance.
    Returns (worst norm of difference / norm of the global one, of torch's
    float32), each {quantity: worst over the shapes}."""
    import torch
    import torch.nn.functional as F

    from lss2_multimodal_nu_tpu_torch.nn.layers import global_batch_norm

    gen = torch.Generator(device=dev).manual_seed(15)
    worst = {"global": {}, "torch": {}}
    for shape in shapes:
        c = shape[1]
        x = torch.randn(shape, device=dev, generator=gen) * 4.0 + 2.0
        dy = torch.randn(shape, device=dev, generator=gen)
        w0 = torch.rand(c, device=dev, generator=gen) + 0.5
        b0 = torch.randn(c, device=dev, generator=gen)
        got = {}
        for label, dtype in (("global", torch.float32), ("torch", torch.float32),
                             ("f64", torch.float64)):
            bn = torch.nn.BatchNorm2d(c, device=dev, dtype=dtype)
            with torch.no_grad():
                bn.weight.copy_(w0)
                bn.bias.copy_(b0)
            xi = x.to(dtype, copy=True).requires_grad_()
            if label == "global":
                y = global_batch_norm(xi, bn)
            else:
                y = F.batch_norm(xi, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                 training=True, momentum=bn.momentum, eps=bn.eps)
            y.backward(dy.to(dtype))
            got[label] = dict(y=y.detach(), dx=xi.grad, dweight=bn.weight.grad,
                              dbias=bn.bias.grad, running_mean=bn.running_mean,
                              running_var=bn.running_var)
        for label in ("global", "torch"):
            for k, ref in got["f64"].items():
                d = float((got[label][k].double() - ref).norm() / ref.norm())
                worst[label][k] = max(worst[label].get(k, 0.0), d)
        del x, dy, got
    return worst["global"], worst["torch"]


def dist_phase(dev, wrappers):
    """Phase 12: runs on more than one device, through the code that runs
    them, on one card. Train-v2's flagship (vovnet39, LSS v1, V3, float32,
    B=8, clip 10, two groups; a constant rate of 1e-4, so that the first
    Adam step moves the weights) with dropout off, from the same weights.
    First as one process, before any group exists: the step (its batch
    norms' input shapes recorded), the same step again (the control, which
    must be bit for bit the same), and `cli._evaluate` over two batches of
    8. Then in an NCCL group of
    one rank joined by `parallel/multihost.py` (a file store under build/),
    where the loss normalisers' and the metrics' all-reduces, the
    replicated model's bucketed gradient all-reduce and the evaluation's
    all-gathers run as collectives of one rank: the step replicated
    (`shard_state(..., "replicate")`) and under FSDP2 (`shard_state(...,
    "fsdp")`). Each: the loss, the gradients and the weights after the
    step bit for bit (the first differing leaf named);
    launches of kernels 1, 2, 3 and 3b (counts set to 0 before its first
    step); no cudaStreamSynchronize or cudaMemcpy in a step; the step's
    median ms of 5 beside the one process's. 12a: the global batch norm,
    which the step takes only at world > 1, called directly at every one of
    the recorded shapes (`bn_check`, within BN_TOL of float64). Then the
    evaluation under FSDP2 in the group: launches of kernels 1, 3, 4 and 5,
    one host read, results equal to the one process's. Returns ({"train",
    "fsdp_train", "eval": launches}, failure or None)."""
    import shutil
    import unittest.mock as mock

    import numpy as np
    import torch
    import torch.nn.functional as F

    from lss2_multimodal_nu_tpu_torch import cli
    from lss2_multimodal_nu_tpu_torch.models.factory import build_model
    from lss2_multimodal_nu_tpu_torch.parallel import multihost
    from lss2_multimodal_nu_tpu_torch.parallel.mesh import make_mesh, shard_state
    from lss2_multimodal_nu_tpu_torch.train.state import build_optimizer
    from lss2_multimodal_nu_tpu_torch.train.steps import train_step, train_without_dropout

    t0 = time.perf_counter()
    cfg = chain_config("vovnet_transformer", batch_size=DIST_B, lr=DIST_LR,
                       weight_decay=1e-8, max_grad_norm=10.0, num_epochs=60)
    base = build_model(cfg, device=dev, seed=12)
    perturb(base, seed=13)
    init = base.state_dict()
    batch = train_batch(dev, DIST_B, seed=14)
    loader = [train_batch(dev, DIST_B, seed=20 + i) for i in range(DIST_EVAL_BATCHES)]
    runs, launches, times, syncs, bn_shapes = {}, {}, {}, {}, set()
    infos, eval_syncs = {}, {}
    batch_norm = F.batch_norm

    def recording_batch_norm(x, *a, training=False, **k):
        if training:
            bn_shapes.add(tuple(x.shape))
        return batch_norm(x, *a, training=training, **k)

    def train(label, wrapper=None, mesh=None):
        model = build_model(cfg, device=dev, seed=12)
        model.load_state_dict(init)
        train_without_dropout(model)
        if wrapper:
            shard_state(model, mesh, wrapper=wrapper)
        opt, sched = build_optimizer(cfg, model, steps_per_epoch=STEPS_PER_EPOCH)
        torch.cuda.synchronize()
        for f in wrappers.values():
            f.launches = 0
        with mock.patch.object(F, "batch_norm", recording_batch_norm):
            m = train_step(model, opt, sched, batch, 0)
        torch.cuda.synchronize()
        launches[label] = {n: wrappers[n].launches for n in KERNELS}
        runs[label] = (m["loss"].clone(), _full_grads(model), _full_weights(model))
        if label != "control":
            syncs[label] = count_syncs(lambda: train_step(model, opt, sched, batch, 1))
            ts = []
            for i in range(2, 9):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                train_step(model, opt, sched, batch, i)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t1) * 1e3)
            times[label] = sorted(ts[2:])[len(ts[2:]) // 2]
        del model, opt, sched
        torch.cuda.empty_cache()

    def evaluate(label, wrapper=None, mesh=None):
        model = build_model(cfg, device=dev, seed=12)
        model.load_state_dict(init)
        if wrapper:
            shard_state(model, mesh, wrapper=wrapper)
        cli._evaluate(cfg, model, loader[:1])  # first calls
        torch.cuda.synchronize()
        for f in wrappers.values():
            f.launches = 0
        out = []
        eval_syncs[label] = count_syncs(lambda: out.append(cli._evaluate(cfg, model, loader)))
        infos[label] = out[0]
        launches[f"eval {label}"] = {n: wrappers[n].launches for n in KERNELS}
        del model

    # one process, no group
    train("unwrapped")
    train("control")
    evaluate("unwrapped")
    store = ROOT / "build" / "dist12"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    rank, world = multihost.initialize("cuda", init_method=f"file://{store / 'store'}", rank=0,
                                       world_size=1, join_alone=True)
    print(f"12 joined {torch.distributed.get_backend()} as rank {rank} of {world} on "
          f"{torch.cuda.current_device()}")
    try:
        mesh = make_mesh(cfg, "cuda")
        train("replicated", "replicate", mesh)
        train("fsdp", "fsdp", mesh)
        loss0 = runs["unwrapped"][0]
        differ = {label: _step_differs(runs[label], runs["unwrapped"])
                  for label in ("control", "replicated", "fsdp")}
        print(f"12 one process f32 B={DIST_B} step: loss {float(loss0):.9g}, median "
              f"{times['unwrapped']:.3f} ms; control (the same step again): loss, gradients and "
              f"weights bit for bit {not differ['control']}"
              + (f", first differing {differ['control'][0]}" if differ["control"] else ""))
        if differ["control"]:
            return launches, f"12: the same step run twice differs at {differ['control'][0]}"
        for label in ("replicated", "fsdp"):
            got = {n: launches[label][n] for n in DIST_TRAIN}
            print(f"12 {label} step: loss {float(runs[label][0]):.9g}; loss, gradients and "
                  f"weights bit for bit {not differ[label]}"
                  + (f" (first differing {differ[label][0]})" if differ[label] else "")
                  + f"; launches {json.dumps(got)}; host syncs in a step "
                  f"{json.dumps(syncs[label])}; median {times[label]:.3f} ms of 5 against "
                  f"{times['unwrapped']:.3f} one process "
                  f"({times[label] - times['unwrapped']:+.3f} ms)")
            if differ[label]:
                return launches, f"12: the {label} step differs at {differ[label][0]}"
            if not all(got.values()):
                return launches, f"12: the {label} step launched no {[n for n, c in got.items() if not c]}"
            if syncs[label]["cudaStreamSynchronize"] or syncs[label]["cudaMemcpy"]:
                return launches, f"12: the {label} step makes host syncs: {syncs[label]}"
        # 12a: the global batch norm at the step's shapes, in the group
        shapes = sorted(bn_shapes)
        t1 = time.perf_counter()
        bn_global, bn_torch = bn_check(dev, shapes)
        print(f"12a global batch norm at the step's {len(shapes)} batch-norm shapes "
              f"({shapes[0]} to {shapes[-1]}), worst norm of difference / norm against float64 "
              f"(tol {BN_TOL}): {json.dumps(bn_global)}; torch's float32 batch norm "
              f"{json.dumps(bn_torch)}; {time.perf_counter() - t1:.1f} s")
        if not max(bn_global.values()) <= BN_TOL:
            return launches, f"12a: the global batch norm differs from float64's: {bn_global}"
        # the evaluation under FSDP2 in the group against the one process's
        evaluate("fsdp", "fsdp", mesh)
        same = {k: bool(np.array_equal(np.asarray(infos["fsdp"][k]),
                                       np.asarray(infos["unwrapped"][k])))
                for k in ("loss", "confmat", "iou", "act_f1", "desc_f1")}
        got = {n: launches["eval fsdp"][n] for n in DIST_EVAL}
        reads = eval_syncs["fsdp"]["cudaStreamSynchronize"] + eval_syncs["fsdp"]["cudaMemcpy"]
        print(f"12 evaluation over {DIST_EVAL_BATCHES} batches of {DIST_B}, FSDP2 in the group "
              f"against one process: equal {json.dumps(same)}; mean IoU "
              f"{infos['fsdp']['mean_iou']:.6f}; launches {json.dumps(got)}; host syncs "
              f"{json.dumps(eval_syncs['fsdp'])} (one process {json.dumps(eval_syncs['unwrapped'])})")
        if not all(same.values()):
            return launches, f"12: the FSDP2 evaluation differs from the one process's: {same}"
        if not all(got.values()):
            return launches, f"12: the evaluation launched no {[n for n, c in got.items() if not c]}"
        if reads > 1 or not eval_syncs["fsdp"]["cudaLaunchKernel"]:
            return launches, f"12: the evaluation reads the host {reads} times"
        print(f"phase 12 (the distributed path at world 1): {time.perf_counter() - t0:.1f} s")
        return launches, None
    finally:
        multihost.shutdown()
        shutil.rmtree(store, ignore_errors=True)


# phase 13: the trace-replay harness. The CPU's float32 forwards of phases 4
# (the flagship) and 7 (BevTxt b4) stand in for the original repo's, written
# in `port/parity.py`'s trace format. Per family: the bias of the last conv
# that produces `bev`, and a bias that only `act` reads.
PARITY_SHIFTS = {
    "bev_txt": ("bevencode.up2.4.bias", "predictorf2.0.bias"),
    "vovnet_transformer": ("bev_encoder.seg_head.6.bias", "unified_predictor.action_head.bias"),
}


def parity_trace(family, model, inputs, outputs):
    """A trace of `model`'s forward on the numpy `inputs`, as the original
    repo would dump it: NCHW images and outputs, the state_dict as numpy."""
    from lss2_multimodal_nu_tpu_torch.port.parity import INPUTS, OUTPUTS

    return {"inputs": dict(zip(INPUTS, inputs)),
            "outputs": {n: t.numpy() for n, t in zip(OUTPUTS, outputs)},
            "state_dict": {k: v.numpy() for k, v in model.state_dict().items()},
            "family": family, "variant": "b4"}


def parity_phase(wrappers, traces):
    """Phase 13: `check_parity` on the card at its defaults (rtol = atol =
    1e-3) on BevTxt's trace, written as `.npz`, and the flagship's, as a
    pickle: every output must pass. Then once per output one weight shifted
    by +1.0: the BEV head's last bias must fail `bev`, a bias that only
    `act` reads must fail `act` and leave `bev` passing. Each replay's report,
    wall ms (the trace read, `build_model`, the load, the forward and the
    comparison) and launches (counts set to 0 just before it) are printed.
    Returns ({family: launches of the replay as traced}, failure message or
    None)."""
    import pickle
    import shutil

    import numpy as np

    from lss2_multimodal_nu_tpu_torch.port.parity import check_parity

    t0 = time.perf_counter()
    expected = {"vovnet_transformer": expected_launches(2, "float32", "v2"),
                "bev_txt": {name: int(name == "lift_splat") for name in wrappers}}
    out_dir = ROOT / "build" / "parity13"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    launches = {}
    try:
        for family, suffix in (("bev_txt", ".npz"), ("vovnet_transformer", ".pkl")):
            trace = traces[family]
            bev_key, act_key = PARITY_SHIFTS[family]
            for key in (None, bev_key, act_key):
                sd = dict(trace["state_dict"])
                if key:
                    sd[key] = sd[key] + 1.0
                path = out_dir / f"{family}{suffix}"
                if suffix == ".npz":
                    np.savez(path, **dict(trace, state_dict=sd))
                else:
                    with open(path, "wb") as f:
                        pickle.dump(dict(trace, state_dict=sd), f)
                for f in wrappers.values():
                    f.launches = 0
                t1 = time.perf_counter()
                report = check_parity(str(path))
                ms = (time.perf_counter() - t1) * 1e3
                n = {name: f.launches for name, f in wrappers.items()}
                label = f"{family} {'as traced' if key is None else key + ' + 1.0'}"
                print(f"13 replay {label} ({suffix}): {ms:.1f} ms, launches {json.dumps(n)}")
                for name, r in report.items():
                    print(f"  {name}: {json.dumps(r)}")
                if n != expected[family]:
                    return launches, f"13: {label} launched {n}, expected {expected[family]}"
                passed = {name: r["pass"] for name, r in report.items()}
                if key is None:
                    launches[family] = n
                    want = {name: True for name in ("bev", "act", "desc")}
                elif key == bev_key:
                    want = dict(passed, bev=False)
                else:
                    want = dict(passed, bev=True, act=False)
                if passed != want:
                    return launches, f"13: {label}: pass {passed}, expected {want}"
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"phase 13 (the trace-replay harness): {time.perf_counter() - t0:.1f} s")
    return launches, None


def precision_flags():
    """torch's process-wide float32 precision flags, as a short string."""
    import torch

    return (f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
            f"float32 matmul precision={torch.get_float32_matmul_precision()!r}")


def trunk_convs(h=IMG_H, w=IMG_W, name="vovnet39"):
    """(Cin, H, W, Cout, k, stride, stage) of every conv that kernel 8 runs
    in VoVNetV2(name) at h x w, in order (stage 0: the stem); an eval
    forward at LSS v1 runs those of stages 0-3, training stage 4's too."""
    import math

    from lss2_multimodal_nu_tpu_torch.nn.vovnet import TIMM_CONFIGS
    from lss2_multimodal_nu_tpu_torch.ops import conv

    stem, mids, outs, layers, blocks = TIMM_CONFIGS[name]
    convs, cin = [], 3
    for ch, s in zip(stem, (2, 1, 2)):
        if conv.takes(cin, ch, 3, s, 1, h * w):
            convs.append((cin, h, w, ch, 3, s, 0))
        h, w, cin = conv.out_size(h, 3, s), conv.out_size(w, 3, s), ch
    for st in range(4):
        if st > 0:
            h, w = math.ceil((h - 3) / 2) + 1, math.ceil((w - 3) / 2) + 1
        for _ in range(blocks[st]):
            c = cin
            for _ in range(layers):
                convs.append((c, h, w, mids[st], 3, 1, st + 1))
                c = mids[st]
            convs.append((cin + layers * mids[st], h, w, outs[st], 1, 1, st + 1))
            cin = outs[st]
    return convs


def conv_inputs(dev, b, cin, h, w, cout, k, seed):
    """ReLU'd normal activations (as the trunk's are), He-normal weights and
    a bias, from a numpy seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    return (t(np.maximum(rng.normal(size=(b, cin, h, w)), 0)),
            t(rng.normal(size=(cout, cin, k, k)) * np.sqrt(2.0 / (cin * k * k))),
            t(rng.normal(0, 0.1, cout)))


def conv_phase(dev):
    """Phase 2d: kernel 8 at each distinct conv of the trunk at 48 images,
    eval form (bias and ReLU), against its plain version, repeated, timed.
    Returns (the summary row over the eval trunk at LSS v1, failure message
    or None)."""
    from collections import Counter

    import torch

    from lss2_multimodal_nu_tpu_torch.ops import conv

    convs = trunk_convs()
    n_eval = Counter(c[:6] for c in convs if c[6] < 4)
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, max_abs_err=0.0, max_rel_err=0.0)
    ok = True
    for i, key in enumerate(dict.fromkeys(c[:6] for c in convs)):
        cin, h, w, cout, k, s = key
        x, wt, bias = conv_inputs(dev, 8 * NCAM, cin, h, w, cout, k, seed=20 + i)
        kernel = lambda: conv.conv2d_tf32x3(x, wt, bias, s, k // 2, relu=True)
        plain = lambda: conv.conv2d_tf32x3_plain(x, wt, bias, s, k // 2, relu=True)
        with torch.inference_mode():
            got, ref = kernel(), plain()
            repeats = bool(torch.equal(got, kernel()))
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            rel = err / max(float(ref.abs().max()), 1e-30)
            passed = bool(torch.isfinite(got).all()) and rel <= 1e-4 and repeats
            ok &= passed
            ops = 2 * x.shape[0] * got.shape[2] * got.shape[3] * cout * cin * k * k
            row = dict(name="conv_tf32x3", dtype="float32", conv=list(key), max_abs_err=err,
                       max_rel_err=rel, rel_tol=1e-4, passed=passed, repeats_bit_for_bit=repeats,
                       ms=time_ms(kernel), plain_ms=time_ms(plain, reps=10, warmup=1),
                       bound_ms=ops / PEAK_OPS["tf32x3"] * 1e3, bound_by="operations", ops=ops,
                       op_type="tf32x3", calls_eval_forward=n_eval[key])
            del got, ref
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        print("kernel_check " + json.dumps(row))
        for f in ("ms", "plain_ms", "bound_ms"):
            total[f] += row[f] * n_eval[key]
        total["max_abs_err"] = max(total["max_abs_err"], err)
        total["max_rel_err"] = max(total["max_rel_err"], rel)
        del x, wt, bias
    torch.cuda.empty_cache()
    if not ok:
        return None, "kernel 8 disagrees with its plain version or does not repeat"
    total.update(share_of_bound=total["bound_ms"] / total["ms"], bound_by="operations",
                 library_ms=total["plain_ms"], composite_ms=None)
    print(f"kernel 8 over the eval trunk's {sum(n_eval.values())} convs at 48 images: "
          f"{json.dumps(total)}")
    return total, None


def main() -> int:
    t_start = time.perf_counter()
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
    for name in ("ffn_ln", "seg_head", "conv_tf32x3"):
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
    # ---- 2d. kernel 8 at the trunk's convs
    conv_row, err = conv_phase(dev)
    if err:
        return _fail(err)

    # ---- 3. the flagship eval forward at full width, B=6, bfloat16; 3b. float32
    wrappers = port_wrappers()
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
    # phase 13 replays this CPU forward as a trace of the original model's
    traces = {"vovnet_transformer": parity_trace("vovnet_transformer", cpu_model, one, out_cpu)}
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
        model, opt, sched, batch = train_path(dev, "flagship bf16")
        train_launches, _, err = drive_train("flagship bf16", model, opt, sched, batch,
                                                wrappers, expected_launches(3, "bfloat16", "v2"))
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
    off_grads = {n: p.grad for n, p in off_model.named_parameters()}
    for label, m, model in (("torch's defaults", m_gpu, gpu_model),
                            ("matmul 'high'", m_high, high_model)):
        same = bool(torch.equal(m["loss"], m_off["loss"]))
        differ = [n for n, p in model.named_parameters() if not torch.equal(p.grad, off_grads[n])]
        print(f"card f32 train step under {label} against TF32 turned off by the caller: loss "
              f"bit for bit {same}; gradients bit for bit {not differ} ({len(off_grads)} leaves"
              + (f", {len(differ)} differ, first {differ[0]})" if differ else ")"))
        if not same or differ:
            return _fail(f"the train step under {label} differs from the one with TF32 turned "
                         "off by the caller: it does not pin full float32")

    del cpu_model, gpu_model, ctl_model, off_model, high_model
    del cpu_opt, gpu_opt, ctl_opt, off_opt, high_opt
    torch.cuda.empty_cache()

    # ---- 7. Stack A: BevTxt's eval forward at full width, B=1 and B=6, float32;
    # LSS and BevTxtOnlyBev at B=1 against the CPU
    stack_a_launches, err = stack_a_eval(dev, wrappers, traces)
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
    torch.cuda.empty_cache()

    # ---- 10. the data slice at full width: the fixture, the pieces bit for
    # bit, the loader alone, train-v2's flagship fed by it
    import shutil

    # the fixture as the CLI's `--dataroot build/data10 --version mini` reads it
    data_root = ROOT / "build" / "data10" / "mini"
    shutil.rmtree(data_root.parent, ignore_errors=True)
    try:
        data_fixture(data_root)
        data_rows, err = data_pieces(dev, data_root)
        if err:
            return _fail(err)
        data_loader_rate(dev, data_root)
        data_launches, err = data_train(dev, data_root, wrappers)
        if err:
            return _fail(err)
        torch.cuda.empty_cache()

        # ---- 11. the CLI: each subcommand through `cli.main` from the fixture
        err = cli_phase(dev, data_root)
        if err:
            return _fail(err)
    finally:
        shutil.rmtree(data_root.parent, ignore_errors=True)

    # ---- 12. the distributed path in an NCCL group of one: both wrappers
    # against the unwrapped step, the evaluation through the group
    torch.cuda.empty_cache()
    dist_launches, err = dist_phase(dev, wrappers)
    if err:
        return _fail(err)

    # ---- 13. the trace-replay harness on the card: phases 4's and 7's CPU
    # forwards as traces, replayed as traced and with one weight shifted
    torch.cuda.empty_cache()
    parity_launches, err = parity_phase(wrappers, traces)
    if err:
        return _fail(err)
    del traces

    kernels = []
    dist_keys = lambda name: dict(
        launches_dist_train_step=dist_launches["replicated"][name],
        launches_dist_fsdp_train_step=dist_launches["fsdp"][name],
        launches_dist_eval=dist_launches["eval fsdp"][name],
        launches_parity_replay=parity_launches["vovnet_transformer"][name])
    backward_outputs = {"deformable_sample_backward": ("dv", "dlx", "dly", "dattn"),
                        "lift_splat_backward": ("dfeat", "ddepth")}
    for name, (src, replaces, n_eval, _) in KERNELS.items():
        if name in DATA_WRAPPERS:
            kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                                launches=data_launches[name],
                                launches_loader_fed_train_steps=data_launches[name],
                                launches_cli={run: n[name] for run, n in CLI_LAUNCHES.items()},
                                loader_fed_train_steps=LOADER_STEPS, **dist_keys(name),
                                dtype="uint8 -> float32", batch=TRAIN_B, **data_rows[name]))
            continue
        first, extra = launches, {}  # the bfloat16 eval forward's counts (phase 3)
        if name == "conv_tf32x3":  # float32 alone: phase 2d's convs, phase 3b's forward
            row, first = conv_row, by_dtype["float32"]
            extra = dict(dtype="float32", batch=8 * NCAM)
        elif name in backward_outputs:
            outs = [bwd_rows[(o, "bfloat16", "uniform")] for o in backward_outputs[name]]
            row = dict(outs[0], max_abs_err=max(r["max_abs_err"] for r in outs))
        else:
            row = rows[(name, "bfloat16", "uniform")]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=first[name] if n_eval else train_launches[name],
            launches_eval_forward=first[name], launches_train_step=train_launches[name],
            launches_pretrain_train_step=chain_launches[name],
            launches_pretrain_eval_step=pretrain_eval_launches[name],
            launches_flagship_f32_train_step=flagship_f32_launches[name],
            launches_cli={run: n[name] for run, n in CLI_LAUNCHES.items()}, **dist_keys(name),
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"],
            composite_ms=row.get("composite_ms"),
            **({"parts_ms": row["parts_ms"]} if "parts_ms" in row else {}), **extra,
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
            launches_parity_replay=parity_launches["bev_txt"][name[:-4]],
            launches_cli={run: n[name[:-4]] for run, n in CLI_LAUNCHES.items()
                          if run.split()[0] in ("pretrain", "train", "train-onlybev", "predict",
                                                "predict-iou")},
            batch=STACK_A_B, max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], composite_ms=row.get("composite_ms"),
        ))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
