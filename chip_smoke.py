"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. setup: versions, the card's name and power limit, TF32 off, build the
     CUDA kernels of `lss2_multimodal_nu_tpu_torch/csrc/` with nvcc (timed);
  2. every forward kernel against its plain PyTorch version at the
     flagship's B=6 shapes, in float32 and bfloat16: max errors against the
     stated tolerances, kernel / plain / library times (CUDA events around
     back-to-back calls), and the least time the card could take (bound);
     the deformable sampling at uniform locations and at the main path's
     local ones, beside its composite yardstick (`grid_sample` and a
     weighted sum, two PyTorch calls);
  2b. the deformable-sampling backward kernel against its plain version at
     the train-v2 shapes (B=8), in float32 and bfloat16, at both kinds of
     locations, each of its four outputs checked, beside autograd through
     the composite yardstick; the lift-splat backward (PyTorch ops) timed;
  3. the flagship eval forward (VoVNetBEVTransformer, vovnet39, LSS v2, V3,
     6 cameras at 128x352 into a 200x200 BEV, B=6, bfloat16) through
     `build_model`, with every kernel's launch count checked, then timed;
  4. the same weights and inputs in float32 at B=1 on the card (kernels)
     against the CPU (plain versions);
  5. the flagship train step (train-v2: B=8, lr 1e-4, wd 1e-8, clip 10, the
     warmup-cosine schedule, bfloat16) through `train/steps.py::train_step`,
     with every kernel's launch count checked, 5 steps on one batch that
     must move the loss, then timed and profiled;
  6. one float32 train step at B=1, dropout off, on the card against the
     CPU: loss, grad_norm and the gradients upstream of both sampling
     kernels, printed beside the card's own spread from weights moved by
     1e-7, the yardstick of their limits.

The last lines are the card (nvidia-smi), one JSON object with every
kernel's numbers (the deformable kernels' at uniform locations), and `{"ok": true, "device": {...}}`. Needs one CUDA card;
imports no JAX.
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
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}

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
PORT_KERNEL_NAMES = ("deform_sample", "lift_splat", "ffn_ln", "conv3x3")


def device_profile(fn, top=12):
    """Device time by kernel name over one call of `fn` under torch.profiler
    (CUPTI): the busiest kernels and copies, and every kernel of the port's
    own, and their total busy time, in ms. Ranges that annotate the device
    timeline (`Optimizer.step#Adam.step`) are not work of their own and are
    left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    rows = sorted(((e.key[:90], e.self_device_time_total / 1e3, e.count) for e in kern),
                  key=lambda r: -r[1])
    shown = [r for i, r in enumerate(rows) if i < top or any(k in r[0] for k in PORT_KERNEL_NAMES)]
    return sum(r[1] for r in rows), shown


def lift_inputs(dev, b, seed=7):
    """Lift-splat operands at batch b: the real frustum geometry of the
    flagship inputs, softmax depth weights, feature rows from a numpy seed.
    Returns (feat (B, R, 128) float32, depth, seg, fidx, n_voxels, n_valid)."""
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
    fidx = torch.as_tensor(ls._feature_rows(NCAM, d, fh, fw), device=dev)[None].expand(b, p)
    feat = torch.from_numpy(rng.normal(size=(b, NCAM * fh * fw, 128)).astype(np.float32)).to(dev)
    return (feat, depth, seg.to(torch.int32), fidx.contiguous(), GRID * GRID,
            int(valid_f.sum()))


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
    the storage type."""
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
    feat, depth, seg, fidx, _, n_valid = lift_inputs(dev, B)
    p = depth.shape[1]
    fh_fw = feat.shape[1] // NCAM
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
            bytes=B * NCAM * fh_fw * 128 * es + 3 * B * p * 4 + B * n * 128 * es,
            ops=2 * n_valid * 128, op_dtype="float32",
            # float atomics add in a varying order
            rel_tol=2 ** -7 if bf else 1e-5,
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
            ops=4 * B * n * 256 * 1024, op_dtype=name_dt,
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
            library=cudnn,
            bytes=B * n * 256 * es + B * n * 4 * 4,
            ops=2 * B * n * (9 * 256 * 128 + 9 * 128 * 64 + 64 * 4), op_dtype=name_dt,
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


# kernel -> (source, the TPU kernel it replaces, launches per eval forward,
# launches per train step). The `kernels` line's `launches` is the count in
# the first path that runs the kernel: the eval forward for the four forward
# kernels (its meaning since they were ported), the train step for the
# backward, which only training runs.
KERNELS = {
    "deformable_sample": ("lss2_multimodal_nu_tpu_torch/csrc/deformable_sample.cu",
                          "lss2_multimodal_nu_tpu/ops/deformable_pallas.py:341", 1, 1),
    "deformable_sample_backward": (
        "lss2_multimodal_nu_tpu_torch/csrc/deformable_sample_backward.cu",
        "lss2_multimodal_nu_tpu/ops/deformable_pallas.py:484", 0, 1),
    "lift_splat": ("lss2_multimodal_nu_tpu_torch/csrc/lift_splat.cu",
                   "lss2_multimodal_nu_tpu/ops/lift_splat_pallas.py:50", 1, 1),
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s for {sorted(built)}")
    for log in sorted(_build.BUILD_DIR.glob("*.log")):
        for line in log.read_text().splitlines():
            if "Used" in line or "error" in line.lower():
                print(f"  {log.stem}: {line.strip()}")

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
        peak = PEAK_OPS[c["op_dtype"]]
        t_bytes, t_ops = c["bytes"] / HBM_BYTES_PER_S * 1e3, c["ops"] / peak * 1e3
        row = dict(name=c["name"], dtype=c["dtype"], max_abs_err=err, max_rel_err=rel,
                   rel_tol=c["rel_tol"], passed=passed, ms=kms, plain_ms=pms, library_ms=lms,
                   bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=c["bytes"], ops=c["ops"])
        if "locations" in c:
            comp = c["composite"]().float()
            row.update(locations=c["locations"], composite_ms=time_ms(c["composite"]),
                       composite_max_rel_err=float((comp - ref).abs().max()) / max(scale, 1e-30))
            del comp
        print("kernel_check " + json.dumps(row))
        rows[(c["name"], c["dtype"], c.get("locations", "uniform"))] = row
    if not ok:
        return _fail("a kernel disagrees with its plain version")

    # ---- 2b. the deformable-sampling backward kernel at the train-v2 shapes
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
    if not ok:
        return _fail("the backward kernel disagrees with its plain version")
    feat, depth, seg_i, fidx, n_vox, _ = lift_inputs(dev, TRAIN_B)
    feat = feat.bfloat16()
    g_bev = torch.randn(TRAIN_B, n_vox, 128, device=dev, dtype=torch.bfloat16)
    lsb_ms = time_ms(lambda: ls.fused_lift_splat_backward(feat, depth, seg_i, fidx, g_bev),
                     reps=10)
    print(f"lift-splat backward (PyTorch gather + index_add_), B={TRAIN_B} bf16: {lsb_ms:.3f} ms")
    del feat, depth, seg_i, fidx, g_bev

    # ---- 3. the flagship eval forward at full width, B=6, bfloat16
    cfg = Config(model=ModelConfig(family="vovnet_transformer", vovnet_type="vovnet39",
                                   lss_version="v2", compute_dtype="bfloat16"))
    model = build_model(cfg, device=dev, seed=0)
    perturb(model, seed=1)
    inputs = [torch.from_numpy(a).to(dev) for a in fake_inputs(B)]
    wrappers = {"deformable_sample": ds.deformable_sample_combine_xy,
                "deformable_sample_backward": ds.deformable_sample_combine_xy_backward,
                "lift_splat": ls.fused_lift_splat, "ffn_ln": ffn.fused_ffn_ln,
                "seg_head": sh.fused_seg_head}
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
        print(f"main path launches: {launches}")
        if launches != expected:
            return _fail(f"launch counts {launches}, expected {expected}")
        shapes = (tuple(seg.shape), tuple(action.shape), tuple(desc.shape))
        if shapes != ((B, 4, GRID, GRID), (B, 4), (B, 8)):
            return _fail(f"output shapes {shapes}")
        if not all(bool(torch.isfinite(t).all()) for t in (seg, action, desc)):
            return _fail("non-finite output")
        fwd = []
        for _ in range(10):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            model(*inputs)
            torch.cuda.synchronize()
            fwd.append((time.perf_counter() - t1) * 1e3)
        fwd.sort()
        fwd_ms = fwd[len(fwd) // 2]
        # stage breakdown through the model's own stage methods
        c3, c4 = model.encode_cameras(inputs[0])
        bev = model.lift_to_bev(c3, c4, *inputs[1:])
        _, refined = model.bev_encoder(bev)
        stages = {
            "encode_cameras": time_ms(lambda: model.encode_cameras(inputs[0]), reps=10),
            "lift_to_bev": time_ms(lambda: model.lift_to_bev(c3, c4, *inputs[1:]), reps=10),
            "bev_encoder": time_ms(lambda: model.bev_encoder(bev), reps=10),
            "txt_branch": time_ms(lambda: model.txt_branch(c3, refined), reps=10),
        }
        busy_ms, top = device_profile(lambda: model(*inputs))
    print(f"forward B={B} bf16: {fwd_ms:.3f} ms median of 10, {B / fwd_ms * 1e3:.2f} samples/s "
          f"(a sample is {NCAM} cameras)")
    print(f"stages (ms, CUDA events): {json.dumps(stages)}")
    idle = 1 - busy_ms / fwd_ms if busy_ms else None
    print(f"profiled forward: device busy {busy_ms:.3f} ms, idle share of the timed forward "
          f"{'not measured' if idle is None else f'{idle:.3f}'}")
    for name, ms, count in top:
        print(f"  {ms:9.3f} ms {count:4d}x {name}")
    print(f"peak device memory in phase 3: {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del model, seg, action, desc, c3, c4, bev, refined

    # ---- 4. float32 on the card (kernels) against the CPU (plain versions), B=1
    cfg32 = Config(model=ModelConfig(family="vovnet_transformer", compute_dtype="float32"))
    cpu_model = build_model(cfg32, device="cpu", seed=0)
    perturb(cpu_model, seed=1)
    gpu_model = build_model(cfg32, device=dev, seed=0)
    gpu_model.load_state_dict(cpu_model.state_dict())
    one = fake_inputs(1, seed=3)
    with torch.inference_mode():
        out_cpu = cpu_model(*[torch.from_numpy(a) for a in one])
        out_gpu = [t.cpu() for t in gpu_model(*[torch.from_numpy(a).to(dev) for a in one])]
    tol = {"bev_seg": 2e-3, "action": 1e-3, "desc": 1e-3}
    for (name, atol), a, b in zip(tol.items(), out_gpu, out_cpu):
        diff = float((a - b).abs().max())
        print(f"gpu vs cpu f32 {name}: max abs diff {diff:.3e} (atol {atol}), "
              f"max |cpu| {float(b.abs().max()):.3e}")
        if not diff <= atol:
            return _fail(f"GPU and CPU forwards disagree on {name}")

    del gpu_model, cpu_model, out_cpu, out_gpu

    # ---- 5. the flagship train step at full width, train-v2, B=8, bfloat16
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        model, opt, sched = train_setup(dev, "bfloat16")
        batch = train_batch(dev, TRAIN_B, seed=5)
        for f in wrappers.values():
            f.launches = 0
        metrics = [train_step(model, opt, sched, batch, 0)]
        torch.cuda.synchronize()
        train_launches = {name: f.launches for name, f in wrappers.items()}
        expected = {name: k[3] for name, k in KERNELS.items()}
        print(f"train step launches: {train_launches}")
        if train_launches != expected:
            return _fail(f"train launch counts {train_launches}, expected {expected}")
        for step in range(1, 5):
            metrics.append(train_step(model, opt, sched, batch, step))
        losses = [float(m["loss"]) for m in metrics]
        norms = [float(m["grad_norm"]) for m in metrics]
        print(f"train B={TRAIN_B} bf16, 5 steps on one batch: loss {losses}, grad_norm {norms}, "
              f"lr now {[g['lr'] for g in opt.param_groups]}")
        if not all(math.isfinite(x) for x in losses + norms):
            return _fail("non-finite loss or grad_norm in the train step")
        if not abs(losses[-1] - losses[0]) > 1e-3:
            return _fail(f"the loss did not move in 5 steps: {losses}")
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
        busy_ms, top = device_profile(lambda: train_step(model, opt, sched, batch, step), top=15)
        peak = torch.cuda.max_memory_allocated() / 1e9
    except torch.cuda.OutOfMemoryError:
        return _fail(f"the B={TRAIN_B} train step does not fit on the card: peak "
                     f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB before the failure")
    print(f"train step B={TRAIN_B} bf16: {step_ms:.3f} ms median of 10 "
          f"({times[0]:.3f}-{times[-1]:.3f}), {TRAIN_B / step_ms * 1e3:.2f} samples/s")
    print(f"train step split (ms, CUDA events, median of 5): {json.dumps(split)}")
    print(f"profiled train step: device busy {busy_ms:.3f} ms, idle share of the timed step "
          f"{1 - busy_ms / step_ms:.3f}")
    for name, ms, count in top:
        print(f"  {ms:9.3f} ms {count:4d}x {name}")
    print(f"peak device memory in phase 5: {peak:.2f} GB")
    del model, opt, sched, batch, metrics

    # ---- 6. one float32 train step at B=1, dropout off: the card against the
    # CPU; and, as the yardstick of the gradient tolerances, the card against
    # itself from the same weights each moved by 1e-7 of its tensor's mean |value|
    cpu_model, cpu_opt, cpu_sched = train_setup("cpu", "float32")
    gpu_model, gpu_opt, gpu_sched = train_setup(dev, "float32")
    ctl_model, ctl_opt, ctl_sched = train_setup(dev, "float32")
    gpu_model.load_state_dict(cpu_model.state_dict())
    ctl_model.load_state_dict(cpu_model.state_dict())
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in ctl_model.parameters():
            p.add_(1e-7 * p.abs().mean() * torch.randn(p.shape, generator=gen).to(dev))
    cpu_batch = train_batch("cpu", 1, seed=3)
    gpu_batch = {k: v.to(dev) for k, v in cpu_batch.items()}
    m_cpu = train_step(train_without_dropout(cpu_model), cpu_opt, cpu_sched, cpu_batch, 0)
    m_gpu = train_step(train_without_dropout(gpu_model), gpu_opt, gpu_sched, gpu_batch, 0)
    train_step(train_without_dropout(ctl_model), ctl_opt, ctl_sched, gpu_batch, 0)
    # ten times the differences measured (7.4e-7 and 1.5e-4) or more
    for k, rtol in (("loss", 1e-5), ("grad_norm", 2e-3)):
        a, b = float(m_gpu[k]), float(m_cpu[k])
        print(f"gpu vs cpu f32 train {k}: {a:.6f} vs {b:.6f}, rel diff {abs(a - b) / abs(b):.3e} "
              f"(rtol {rtol})")
        if not abs(a - b) <= rtol * abs(b):
            return _fail(f"GPU and CPU train steps disagree on {k}")
    # the leaves upstream of both kernels, which a cut-off autograd would zero
    upstream = [n for n, _ in cpu_model.named_parameters()
                if n.split(".")[0] in ("cam_encode", "depth_net")
                or n in ("backbone.backbone.stem.0.conv.weight",
                         *(f"bev_encoder.transformer.encoder.self_attn.{m}.weight"
                           for m in ("sampling_offsets", "attention_weights", "value_proj")))]
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

    kernels = []
    for name, (src, replaces, n_eval, _) in KERNELS.items():
        if name == "deformable_sample_backward":
            outs = [bwd_rows[(o, "bfloat16", "uniform")] for o in ("dv", "dlx", "dly", "dattn")]
            row = dict(outs[0], max_abs_err=max(r["max_abs_err"] for r in outs))
        else:
            row = rows[(name, "bfloat16", "uniform")]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name] if n_eval else train_launches[name],
            launches_eval_forward=launches[name], launches_train_step=train_launches[name],
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"],
            composite_ms=row.get("composite_ms"),
        ))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
