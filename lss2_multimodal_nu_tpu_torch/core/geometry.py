"""Frustum -> ego-frame geometry and voxel quantisation.

Everything runs in float32 with the 3x3 products written out as
multiply-and-sum, so no TF32 matrix unit can round them on the card.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


def invert_3x3(m: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = torch.stack(
        [
            torch.stack([co_a, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([co_b, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([co_c, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def _matvec(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """m (B, N, 3, 3) applied to points p (B, N, D, fH, fW, 3)."""
    return (m[:, :, None, None, None] * p[..., None, :]).sum(-1)


def get_geometry(
    frustum: torch.Tensor,
    rots: torch.Tensor,
    trans: torch.Tensor,
    intrins: torch.Tensor,
    post_rots: torch.Tensor,
    post_trans: torch.Tensor,
) -> torch.Tensor:
    """Ego-frame (x, y, z) of every frustum point.

    frustum (D, fH, fW, 3); rots, intrins, post_rots (B, N, 3, 3); trans,
    post_trans (B, N, 3). Returns (B, N, D, fH, fW, 3) float32: undo the
    augmentation affine, lift (u, v, d) to (u*d, v*d, d), then rot @ K^-1
    plus translation.
    """
    f32 = torch.float32
    frustum, rots, trans, intrins, post_rots, post_trans = (
        t.to(f32) for t in (frustum, rots, trans, intrins, post_rots, post_trans)
    )
    pts = frustum[None, None] - post_trans[:, :, None, None, None, :]
    pts = _matvec(invert_3x3(post_rots), pts)
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], dim=-1)
    combine = (rots[..., :, :, None] * invert_3x3(intrins)[..., None, :, :]).sum(-2)
    pts = _matvec(combine, pts)
    return pts + trans[:, :, None, None, None, :]


@lru_cache(maxsize=16)
def _grid_consts(dx: tuple, bx: tuple, nx: tuple, dtype, device):
    """(low edge, voxel size, voxel counts) of the grid as tensors on `device`,
    made once per grid and device: a copy from host memory on every call
    would make the host wait for the device. The low edge is `bx - dx / 2.0`
    in float32 tensor arithmetic, rounded as the JAX package rounds it (a
    Python float would round in double and could move a point across a
    voxel edge). Made outside inference mode, whatever the first caller's
    mode, so that autograd may use them later."""
    with torch.inference_mode(False):
        dxt = torch.tensor(dx, dtype=dtype, device=device)
        bxt = torch.tensor(bx, dtype=dtype, device=device)
        nxt = torch.tensor(nx, dtype=torch.int32, device=device)
        return bxt - dxt / 2.0, dxt, nxt


def voxel_indices(
    geom: torch.Tensor, dx: np.ndarray, bx: np.ndarray, nx: np.ndarray
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantise ego-frame points to int32 voxel coordinates plus a validity
    mask. The cast truncates toward zero, as the original model's `.long()`
    does (not floor), so points just below the grid's low edge land in
    voxel 0."""
    key = lambda a, t: tuple(np.asarray(a, dtype=t).tolist())
    low, dxt, nxt = _grid_consts(key(dx, np.float32), key(bx, np.float32), key(nx, np.int64),
                                 geom.dtype, geom.device)
    idx = ((geom - low) / dxt).to(torch.int32)
    valid = ((idx >= 0) & (idx < nxt)).all(dim=-1)
    return idx, valid
