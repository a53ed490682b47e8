"""Output parity against the original PyTorch model: replay a trace of its
eval forward through the port and report the error of each output.

The port keeps the original repo's module names, so the original's
`state_dict` loads into `build_model`'s model by name: no weight porter and
no NCHW <-> NHWC transpose stand between the trace and the replay.

Dumping a trace where the original repo runs (its predict.py-style eval,
after any augmentation, so the inputs are what the model saw):

    trace = {"inputs": {"imgs": ..., "rots": ..., "trans": ..., "intrins": ...,
                        "post_rots": ..., "post_trans": ...},  # numpy, imgs (B, N, 3, H, W)
             "outputs": {"bev": ..., "act": ..., "desc": ...},  # numpy, bev (B, C, X, Y)
             "state_dict": {k: v.cpu().numpy() for k, v in model.state_dict().items()},
             "family": "bev_txt", "variant": "b4"}
    np.savez("trace.npz", **trace)  # or pickle.dump(trace, f)

A single-output model (`lss`, `vovnet_pretrain`) has `bev` alone. Then

    from lss2_multimodal_nu_tpu_torch.port.parity import check_parity
    report = check_parity("trace.npz")

replays it on the card. A trace is a pickle (an `.npz` holds its dicts as
pickled objects): read only traces from a trusted source, since unpickling
can run arbitrary code.

Any family that `build_model` builds replays. The JAX package's harness
(`lss2_multimodal_nu_tpu/port/parity.py`) passes the family's variant to a
porter that the flagship's does not take, and so raises for
`vovnet_transformer` (ROADMAP fault 6f); nothing here depends on a porter.
The JAX porter has no rule for `vovnet_pretrain`, so a trace of it has no
JAX output to be held against in the tests; it replays all the same.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import Config, ModelConfig
from ..models.factory import build_model
from ..ops._precision import full_float32

INPUTS = ("imgs", "rots", "trans", "intrins", "post_rots", "post_trans")
OUTPUTS = ("bev", "act", "desc")


def load_trace(path: str) -> Dict[str, Any]:
    """A trace from an `.npz` (object entries through `.item()`, 0-d string
    entries as `str`) or, for any other name, a pickle."""
    if str(path).endswith(".npz"):
        with np.load(path, allow_pickle=True) as z:
            trace = {}
            for k in z.files:
                v = z[k]
                if v.dtype == object:
                    v = v.item()
                elif v.ndim == 0 and v.dtype.kind == "U":
                    v = str(v)
                trace[k] = v
            return trace
    with open(path, "rb") as f:
        return pickle.load(f)


def load_state(model: torch.nn.Module, state_dict: Dict[str, Any]) -> None:
    """The original's `state_dict` (numpy values) into `model` by name. Keys
    missing from it or unknown to the model are printed as one `[parity]`
    line, `num_batches_tracked` aside; a value of the wrong shape raises
    (torch's `RuntimeError`, which names its key)."""
    result = model.load_state_dict(
        {k: torch.from_numpy(np.asarray(v)) for k, v in state_dict.items()}, strict=False)
    missing, unexpected = ([k for k in keys if not k.endswith("num_batches_tracked")]
                           for keys in (result.missing_keys, result.unexpected_keys))
    if missing or unexpected:
        print(f"[parity] {len(missing)} model keys missing from the trace (first: "
              f"{missing[:3]}), {len(unexpected)} trace keys unknown to the model (first: "
              f"{unexpected[:3]})")


def check_parity(
    trace_path: str,
    family: Optional[str] = None,
    variant: str = "b4",
    rtol: float = 1e-3,
    atol: float = 1e-3,
    cfg: Optional[Config] = None,
    device="cuda",
) -> Dict[str, Dict[str, float]]:
    """Replay the trace at `trace_path` through `build_model(cfg)` on
    `device` (the card unless the caller asks for the CPU) in eval mode and
    full float32, and report per output `max_abs`, `max_rel` (over
    max(|want|, 1e-6)), `mean_abs`, `argmax_match` (the BEV's, over its
    class axis; NaN for the others) and `pass` (`np.allclose` at
    `rtol`/`atol`), in the trace's NCHW layout. The family comes from the
    argument, else the trace, else "bev_txt"; the variant from the trace,
    else the argument."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("check_parity: no CUDA device is available "
                           "(device='cpu' replays on the CPU)")
    trace = load_trace(trace_path)
    family = family or trace.get("family", "bev_txt")
    variant = trace.get("variant", variant)
    cfg = cfg or Config(model=ModelConfig(family=family, effnet_variant=variant))

    model = build_model(cfg, device=device)
    load_state(model, trace["state_dict"])
    inputs = [torch.from_numpy(np.ascontiguousarray(trace["inputs"][k], np.float32)).to(device)
              for k in INPUTS]
    with torch.no_grad(), full_float32():
        out = model(*inputs)
    if not isinstance(out, tuple):
        out = (out,)
    # one host read for every output
    flat = torch.cat([t.reshape(-1).float() for t in out]).cpu().numpy()
    got = np.split(flat, np.cumsum([t.numel() for t in out])[:-1])

    report = {}
    for name, g, t in zip(OUTPUTS, got, out):
        g = g.reshape(t.shape)
        want = np.asarray(trace["outputs"][name])
        if want.shape != g.shape:
            raise ValueError(f"{name}: the trace's shape {want.shape} is not the model's "
                             f"{g.shape}")
        err = np.abs(g - want)
        report[name] = {
            "max_abs": float(err.max()),
            "max_rel": float((err / np.maximum(np.abs(want), 1e-6)).max()),
            "mean_abs": float(err.mean()),
            "argmax_match": float((g.argmax(1) == want.argmax(1)).mean())
            if name == "bev" else float("nan"),
            "pass": bool(np.allclose(g, want, rtol=rtol, atol=atol)),
        }
    return report
