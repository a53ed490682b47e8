"""The model's weights, made from the seed on the device: one draw of
standard normals from a `torch.Generator` for every float leaf of the
reference model's state dict, shaped leaf by leaf.

- convolutions: He-scaled, sqrt(2 / fan_in); linears and attention
  projections: sqrt(1 / fan_in); their biases 0.1 N(0, 1);
- batch norm: scale and running variance uniform on [0.5, 1.5], shift and
  running mean 0.1 N(0, 1) (`chip_smoke.py::perturb`'s draws);
- LayerNorm: scale 1 + 0.1 N(0, 1), shift 0.1 N(0, 1);
- the deformable attention's sampling-offset and attention-weight
  projections: weights 0.02 N(0, 1), so that queries sample off their
  reference points (`perturb`'s draw); the offsets' bias the spiral of the
  model's own init, the attention weights' bias 0;
- embeddings N(0, 1); any other parameter 0.1 N(0, 1).

The same state dict loads into the port's model and the reference, by name.

`calibrate` then sets every batch norm's running statistics to one batch's
(an eval cell's weights): with drawn statistics the EfficientNet trunk's
activations grow to 1e4 by the BEV logits, and the eval forward becomes so
sensitive that float32 round-off alone moves its outputs by their own size.
A trained model's statistics are its data's; these are the pool's first
batch's, computed by the plain reference in full float32.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn


def spiral_offset_bias(n_heads: int, n_points: int) -> np.ndarray:
    """Initial offsets: heads spread on a circle, point k pushed out k+1."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], axis=-1)
    grid = grid / np.abs(grid).max(axis=-1, keepdims=True)
    grid = np.tile(grid[:, None, :], (1, n_points, 1))
    for i in range(n_points):
        grid[:, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


def _rule(module: nn.Module, leaf: str, shape):
    """A function of the standard normals z of one leaf, or a constant."""
    uniform = lambda z: 0.5 + torch.special.ndtr(z)  # noqa: E731
    small = lambda s: (lambda z: s * z)  # noqa: E731
    if isinstance(module, nn.BatchNorm2d):
        return {"weight": uniform, "running_var": uniform}.get(leaf, small(0.1))
    if isinstance(module, nn.LayerNorm):
        return (lambda z: 1 + 0.1 * z) if leaf == "weight" else small(0.1)
    if isinstance(module, nn.Embedding):
        return small(1.0)
    if isinstance(module, nn.MultiheadAttention):
        return small(1 / math.sqrt(shape[-1])) if leaf == "in_proj_weight" else small(0.1)
    if isinstance(module, nn.Conv2d):
        fan_in = shape[1] * shape[2] * shape[3] if leaf == "weight" else None
        return small(math.sqrt(2.0 / fan_in)) if fan_in else small(0.1)
    if isinstance(module, nn.Linear):
        return small(1 / math.sqrt(shape[1])) if leaf == "weight" else small(0.1)
    return small(0.1)


def _special(name: str):
    """Leaves drawn otherwise: the deformable attention's projections."""
    if name.endswith("sampling_offsets.weight") or name.endswith("attention_weights.weight"):
        return lambda z: 0.02 * z
    if name.endswith("attention_weights.bias"):
        return "zero"
    if name.endswith("sampling_offsets.bias"):
        return "spiral"
    return None


@torch.no_grad()
def make(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: tensor on `device`} for every entry of model's state dict
    (model may live on the meta device)."""
    leaves, keys = [], set(model.state_dict())
    for mname, module in model.named_modules():
        for leaf, t in list(module.named_parameters(recurse=False)) + \
                list(module.named_buffers(recurse=False)):
            name = f"{mname}.{leaf}" if mname else leaf
            if name in keys:
                leaves.append((name, leaf, module, t))
    floats = [x for x in leaves if x[3].is_floating_point()]
    total = sum(t.numel() for *_, t in floats)
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, leaf, module, t in leaves:
        if not t.is_floating_point():
            out[name] = torch.zeros(t.shape, dtype=t.dtype, device=device)
            continue
        zz = z[off:off + t.numel()].view(t.shape)
        off += t.numel()
        rule = _special(name) or _rule(module, leaf, tuple(t.shape))
        if rule == "zero":
            out[name] = torch.zeros_like(zz)
        elif rule == "spiral":  # the parent holds n_heads and n_points
            attn = model.get_submodule(name.rsplit(".", 2)[0])
            out[name] = torch.tensor(spiral_offset_bias(attn.n_heads, attn.n_points),
                                     device=device)
        else:
            out[name] = rule(zz).contiguous()
    return out


@torch.no_grad()
def calibrate(cfg: dict, weights: Dict[str, torch.Tensor], batch: dict) -> Dict[str, torch.Tensor]:
    """The running statistics of every batch norm, set to the batch's by one
    forward of the reference in training mode with momentum 1 and dropout
    and drop-connect off; returned on the host."""
    from reference import train as ref_train
    from benchlib.check import precision

    device = batch["imgs"].device
    model = ref_train.build(cfg, device)
    model.load_state_dict(weights)
    model.train()
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.momentum = 1.0
        elif not any(isinstance(c, nn.BatchNorm2d) for c in m.children()):
            m.training = False  # dropout, attention dropout, drop-connect
        if hasattr(m, "drop_rate"):
            m.drop_rate = 0.0
    with precision("float32"):
        model(*(batch[k] for k in ref_train.MODEL_INPUTS))
    return {k: v.detach().cpu() for k, v in model.state_dict().items()
            if k.endswith("running_mean") or k.endswith("running_var")}
