"""Bilinear resize with the semantics of the JAX package's
`ops/sampling.py::resize_bilinear`, on NCHW tensors.

The resize is separable and its size is static, so, as in the JAX package,
it is two matrix products with precomputed 1-D interpolation matrices
(`_resize_matrix`, the port's own copy): rows, then columns, in x's dtype.
Its gradient is autograd through the two products, which sum in a fixed
order: unlike `F.interpolate`'s CUDA backward, which adds with atomics, it
repeats bit for bit. In float32 the products run at the callers' pinned
full float32 precision (`ops/_precision.py`).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


@lru_cache(maxsize=64)
def _resize_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """(out_size, in_size) bilinear interpolation matrix, torch-compatible
    (the JAX package's `ops/sampling.py::_resize_matrix`)."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    if out_size == 1:
        # torch maps a single output sample to source 0 (align=True) /
        # scale*0.5-0.5 clamped (align=False); both reduce to index 0 weightings
        if align_corners or in_size == 1:
            w[0, 0] = 1.0
            return w
    for i in range(out_size):
        if align_corners:
            src = i * (in_size - 1) / max(out_size - 1, 1)
        else:
            src = (i + 0.5) * in_size / out_size - 0.5
            src = min(max(src, 0.0), in_size - 1.0)
        i0 = int(np.floor(src))
        i0 = min(i0, in_size - 1)
        i1 = min(i0 + 1, in_size - 1)
        frac = src - i0
        w[i, i0] += 1.0 - frac
        w[i, i1] += frac
    return w


@lru_cache(maxsize=64)
def _matrix(in_size: int, out_size: int, align_corners: bool, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """`_resize_matrix` on `device` in `dtype`, made once: a copy to the
    card at every call would sync the host. Made outside inference mode,
    so that a matrix first made for an inference-mode forward can be saved
    for a later training step's backward."""
    with torch.inference_mode(False):
        m = torch.from_numpy(_resize_matrix(in_size, out_size, align_corners))
        return m.to(device, dtype)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int], align_corners: bool) -> torch.Tensor:
    """Bilinear resize of NCHW x to out_hw (torch's `F.interpolate(mode=
    "bilinear")`); identity when the size already matches."""
    h, w = x.shape[-2:]
    out_h, out_w = out_hw
    if (out_h, out_w) == (h, w):
        return x
    mh = _matrix(h, out_h, align_corners, x.dtype, x.device)
    mw = _matrix(w, out_w, align_corners, x.dtype, x.device)
    x = torch.einsum("oh,nchw->ncow", mh, x)
    return torch.einsum("pw,ncow->ncop", mw, x)
