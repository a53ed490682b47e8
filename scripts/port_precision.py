"""What the port's float32 pin does on one CUDA card: the flagship in float32
with and without `ops/_precision.py::full_float32`, against the CPU.

    python3 scripts/port_precision.py

The weights, inputs and batch of `chip_smoke.py` phases 4 and 6 (B=1, the
flagship at full width, dropout off in the train step). The forward runs on
the card under three settings of the caller's flags (TF32 turned off, torch's
defaults, torch's defaults with float32 matrix products at "high"), once as
the port ships it and once unpinned: `full_float32` replaced by a context
that does nothing in the model's forward, and the train step called without
its own pin (`train_step.__wrapped__`). Each forward prints its max abs diff
against the CPU per output beside phase 4's limits, and whether it equals bit
for bit the pinned forward with TF32 turned off by the caller. Each train
step prints its loss and grad_norm against the CPU's, its worst gradient
against the CPU's over phase 6's leaves upstream of the kernels (max diff
over max, norm of diff over norm), and against the pinned step with TF32
turned off by the caller: the loss bit for bit, and the worst norm of diff
over norm of those leaves (leaving out, as phase 6 does, those whose
gradient is zero up to round-off). One JSON line per run, then the card's
name and power limit. Needs one CUDA card; imports no JAX.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FLAGS = {"tf32_off_by_caller": (False, "highest"), "torch_defaults": (True, "highest"),
         "torch_defaults_matmul_high": (True, "high")}


@contextlib.contextmanager
def caller_flags(cudnn_tf32, matmul):
    """The caller's process-wide flags for the block, restored after."""
    import torch

    old = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    torch.set_float32_matmul_precision(matmul)
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old[0]
        torch.set_float32_matmul_precision(old[1])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_precision: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from lss2_multimodal_nu_tpu_torch.config import Config, ModelConfig
    from lss2_multimodal_nu_tpu_torch.models import vovnet_transformer as vt
    from lss2_multimodal_nu_tpu_torch.models.factory import build_model
    from lss2_multimodal_nu_tpu_torch.ops import _build
    from lss2_multimodal_nu_tpu_torch.train import steps

    dev = torch.device("cuda", 0)
    _build.build_all()
    pinned_fn = vt.full_float32
    unpinned = {"pinned": (pinned_fn, steps.train_step),
                "unpinned": (contextlib.nullcontext, steps.train_step.__wrapped__)}

    cfg = Config(model=ModelConfig(family="vovnet_transformer", compute_dtype="float32"))
    cpu_model = build_model(cfg, device="cpu", seed=0)
    smoke.perturb(cpu_model, seed=1)
    gpu_model = build_model(cfg, device=dev, seed=0)
    gpu_model.load_state_dict(cpu_model.state_dict())
    one = smoke.fake_inputs(1, seed=3)
    with torch.inference_mode():
        want = cpu_model(*[torch.from_numpy(a) for a in one])
    ref = None
    for pin, (ctx, _) in unpinned.items():
        vt.full_float32 = ctx
        for flags, values in FLAGS.items():
            with caller_flags(*values), torch.inference_mode():
                got = [t.cpu() for t in gpu_model(*[torch.from_numpy(a).to(dev) for a in one])]
            ref = got if ref is None else ref
            print(json.dumps(dict(
                what="forward", pin=pin, caller_flags=flags,
                max_abs_diff={k: float((a - b).abs().max())
                              for k, a, b in zip(("bev_seg", "action", "desc"), got, want)},
                atol={"bev_seg": 2e-3, "action": 1e-3, "desc": 1e-3},
                bitwise_equal_to_pinned_tf32_off=all(torch.equal(a, b) for a, b in zip(got, ref)))))
    vt.full_float32 = pinned_fn
    del gpu_model

    cpu_model, cpu_opt, cpu_sched = smoke.train_setup("cpu", "float32")
    batch = smoke.train_batch("cpu", 1, seed=3)
    m_cpu = steps.train_step(steps.train_without_dropout(cpu_model), cpu_opt, cpu_sched, batch, 0)
    upstream = smoke.upstream_leaves(cpu_model)
    ref = None
    for pin, (ctx, step_fn) in unpinned.items():
        vt.full_float32 = ctx
        for flags, values in FLAGS.items():
            with caller_flags(*values):
                model, opt, sched = smoke.train_setup(dev, "float32")
                model.load_state_dict(cpu_model.state_dict())
                m = step_fn(steps.train_without_dropout(model), opt, sched,
                            {k: v.to(dev) for k, v in batch.items()}, 0)
            grads = {n: p.grad.cpu() for n, p in model.named_parameters() if n in upstream}
            ref = (m, grads) if ref is None else ref
            vs_cpu = list(smoke.grad_diffs(model, cpu_model, upstream).values())
            vs_cpu = [d for d in vs_cpu if d[2] > 1e-4 * max(e[2] for e in vs_cpu)]
            top = max(float(g.abs().max()) for g in ref[1].values())
            vs_ref = {n: float((grads[n] - g).norm() / g.norm()) for n, g in ref[1].items()
                      if float(g.abs().max()) > 1e-4 * top}
            worst = max(vs_ref, key=vs_ref.get)
            print(json.dumps(dict(
                what="train_step", pin=pin, caller_flags=flags,
                rel_diff_vs_cpu={k: abs(float(m[k]) - float(m_cpu[k])) / abs(float(m_cpu[k]))
                                 for k in ("loss", "grad_norm")},
                upstream_worst_max_rel_vs_cpu=max(d[0] for d in vs_cpu),
                upstream_worst_norm_rel_vs_cpu=max(d[1] for d in vs_cpu),
                loss_bitwise_equal_to_pinned_tf32_off=bool(torch.equal(m["loss"], ref[0]["loss"])),
                upstream_worst_norm_rel_vs_pinned_tf32_off=vs_ref[worst], worst_leaf=worst)))
            del model, opt, sched
    vt.full_float32 = pinned_fn
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
