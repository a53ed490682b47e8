"""Image-augmentation parameters and their affine bookkeeping, in numpy.

The host stage of the loader draws the augmentation of each camera here and
records the 3x3 `post_rot` / 3-vector `post_tran` with which the model
undoes it inside the geometry. The pixels are resampled by
`ops/img_aug.py`. The draws and their order are the JAX package's
(`core/augment.py` there), so that one seed gives one augmentation.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def get_rot(h: float) -> np.ndarray:
    """2x2 rotation by h radians, clockwise for positive h (PIL's
    `Image.rotate` sign)."""
    return np.array(
        [[np.cos(h), np.sin(h)], [-np.sin(h), np.cos(h)]], dtype=np.float32
    )


@dataclasses.dataclass(frozen=True)
class AugParams:
    resize: float
    resize_dims: Tuple[int, int]  # (newW, newH)
    crop: Tuple[int, int, int, int]  # (w0, h0, w1, h1)
    flip: bool
    rotate: float  # degrees


def sample_augmentation(
    aug_conf, is_train: bool, rng: np.random.Generator | None = None
) -> AugParams:
    """Train: random resize, crop, flip and rotation, drawn from `rng` in
    that order (no flip is drawn when `rand_flip` is off); eval: resize =
    max(fH/H, fW/W), a centred crop at the mean bottom cut, no flip, no
    rotation."""
    H, W = aug_conf.H, aug_conf.W
    fH, fW = aug_conf.final_dim
    if is_train:
        if rng is None:
            rng = np.random.default_rng()
        resize = float(rng.uniform(*aug_conf.resize_lim))
        resize_dims = (int(W * resize), int(H * resize))
        newW, newH = resize_dims
        crop_h = int((1 - rng.uniform(*aug_conf.bot_pct_lim)) * newH) - fH
        crop_w = int(rng.uniform(0, max(0, newW - fW)))
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        flip = bool(aug_conf.rand_flip and rng.integers(0, 2))
        rotate = float(rng.uniform(*aug_conf.rot_lim))
    else:
        resize = max(fH / H, fW / W)
        resize_dims = (int(W * resize), int(H * resize))
        newW, newH = resize_dims
        crop_h = int((1 - np.mean(aug_conf.bot_pct_lim)) * newH) - fH
        crop_w = int(max(0, newW - fW) / 2)
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        flip = False
        rotate = 0.0
    return AugParams(resize, resize_dims, crop, flip, rotate)


def accumulate_post_transform(params: AugParams) -> Tuple[np.ndarray, np.ndarray]:
    """The 2D affine of (resize -> crop -> flip -> rotate), from identity:

        post_rot *= resize
        post_tran -= crop[:2]
        flip:   A=[[-1,0],[0,1]], b=(cropW, 0);  post = A@post, A@tran + b
        rotate: A=R(rad), b = A@(-c) + c where c = crop_size/2

    Returns (post_rot 2x2, post_tran 2) float32 with
    pixel_final = post_rot @ pixel_orig + post_tran.
    """
    post_rot = np.eye(2, dtype=np.float32) * params.resize
    post_tran = -np.array(params.crop[:2], dtype=np.float32)
    if params.flip:
        A = np.array([[-1, 0], [0, 1]], dtype=np.float32)
        b = np.array([params.crop[2] - params.crop[0], 0], dtype=np.float32)
        post_rot = A @ post_rot
        post_tran = A @ post_tran + b
    A = get_rot(params.rotate / 180.0 * np.pi)
    b = (
        np.array(
            [params.crop[2] - params.crop[0], params.crop[3] - params.crop[1]],
            dtype=np.float32,
        )
        / 2.0
    )
    b = A @ (-b) + b
    post_rot = A @ post_rot
    post_tran = A @ post_tran + b
    return post_rot, post_tran


def expand_to_3x3(post_rot2: np.ndarray, post_tran2: np.ndarray):
    """The 2D affine as the 3x3 / 3-vector the model consumes."""
    post_rot = np.eye(3, dtype=np.float32)
    post_rot[:2, :2] = post_rot2
    post_tran = np.zeros(3, dtype=np.float32)
    post_tran[:2] = post_tran2
    return post_rot, post_tran
