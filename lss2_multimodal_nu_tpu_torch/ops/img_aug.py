"""The camera images' augmentation on the card, PIL-exact (kernel 7).

No TPU kernel stands behind it: the JAX package resamples with PIL on the
host (`data/dataset.py::img_transform` and `normalize_img` there). The kernel
(`csrc/img_aug.cu`) and its plain version here compute, bit for bit, what
Pillow computes for

    img.resize(resize_dims)            # BICUBIC, a = -0.5, antialiased
       .crop(crop)                     # zero outside the image
       .transpose(FLIP_LEFT_RIGHT)     # when flip
       .rotate(rotate)                 # NEAREST, zero fill
    -> ToTensor + Normalize(ImageNet)  # float32, (3, fH, fW)

in two passes, as Pillow runs them. The horizontal pass resamples the rows
that the vertical pass reads, over the columns the crop keeps, into a uint8
intermediate (Pillow writes uint8 between its passes); the vertical pass is
fused with the crop, the flip, the rotation and the normalisation.

`plan` computes on the host what both need: Pillow's resampling weights
(`precompute_coeffs` in double, `normalize_coeffs_8bpc` to 22-bit fixed
point), per output column and row of the crop, and `rotate`'s matrix as
Pillow builds it (`round(cos, 15)`, `round(sin, 15)`) in its 16.16 fixed
point (`affine_fixed`: the source coordinate of pixel (x, y) is
(a2 + y a1 + x a0) >> 16, exact in integers).

The kernel's two launches read every tap and weight from shared memory,
each CTA staging the source columns or intermediate rows its pixels' windows
span. `bound` counts the bytes and the integer operations of a batch.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
PRECISION_BITS = 22  # Pillow's 8-bit resampling: 32 - 8 - 2
N_PARAMS = 14  # newW, newH, crop w0, h0, flip, rotate, a0..a5, first row, rows


def _bicubic(x: float) -> float:
    """Pillow's `bicubic_filter`, a = -0.5."""
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


@lru_cache(maxsize=512)
def resize_coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's `precompute_coeffs` (BICUBIC, support 2 scaled by the
    reduction) and `normalize_coeffs_8bpc`: (bounds (out, 2) int32 of
    (first input sample, count), weights (out, ksize) int32 at 22 bits)."""
    scale = filterscale = float(in_size) / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    bounds = np.zeros((out_size, 2), np.int32)
    kk = np.zeros((out_size, ksize), np.int32)
    ss = 1.0 / filterscale
    one = 1 << PRECISION_BITS
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        kk[xx, :xmax] = [int(-0.5 + w * one) if w < 0 else int(0.5 + w * one) for w in k]
        bounds[xx] = (xmin, xmax)
    return bounds, kk


def rotate_fixed(angle: float, w: int, h: int) -> Optional[Tuple[int, ...]]:
    """(a0, a1, a2, a3, a4, a5) of Pillow's `Image.rotate(angle)` on a w x h
    image in 16.16 fixed point, or None where Pillow copies (angle % 360 ==
    0). ValueError where Pillow takes another path (a quarter turn, a scale
    only, coordinates past 16 bits)."""
    angle = angle % 360.0
    if angle == 0:
        return None
    if angle in (90.0, 180.0, 270.0):
        raise ValueError(f"rotate({angle}) is a transpose in Pillow, not taken here")
    cx, cy = w / 2, h / 2
    rad = -math.radians(angle)
    a, b, c, d, e, f = (round(math.cos(rad), 15), round(math.sin(rad), 15), 0.0,
                        round(-math.sin(rad), 15), round(math.cos(rad), 15), 0.0)
    c, f = a * -cx + b * -cy + c, d * -cx + e * -cy + f
    c += cx
    f += cy
    if b == 0 and d == 0:
        raise ValueError(f"rotate({angle}) scales only in Pillow, not taken here")
    for x, y in ((0, 0), (w, h), (0, h), (w, 0)):
        if not (abs(x * a + y * b + c) < 32768.0 and abs(x * d + y * e + f) < 32768.0):
            raise ValueError("rotate's coordinates leave Pillow's 16.16 fixed point")

    def fix(v):
        v = v * 65536.0 + 0.5
        return math.floor(v) if v < 0 else int(v)

    return (fix(a), fix(b), fix(c + a * 0.5 + b * 0.5), fix(d), fix(e), fix(f + d * 0.5 + e * 0.5))


def plan(aug: Sequence, height: int, width: int, final_dim: Tuple[int, int]):
    """The host's part for a batch of images of height x width, one
    `core/augment.py::AugParams` each: (params (n, 14) int32, htab (n, fW,
    2 + KH) int32, vtab (n, fH, 2 + KV) int32, rows, the most intermediate
    rows of one image). htab[i, j]: the horizontal weights of crop column
    j, (first source column, count, weights...), count 0 outside the
    resized image; vtab[i, r]: those of crop row r, the first row counted
    from the image's first intermediate row params[i, 12]."""
    fh, fw = final_dim
    n = len(aug)
    params = np.zeros((n, N_PARAMS), np.int32)
    hs, vs = [], []
    for i, p in enumerate(aug):
        new_w, new_h = p.resize_dims
        x0, y0, x1, y1 = (int(round(v)) for v in p.crop)
        if (x1 - x0, y1 - y0) != (fw, fh):
            raise ValueError(f"crop {p.crop} is not {fw}x{fh}")
        rot = rotate_fixed(p.rotate, fw, fh)
        hb, hk = resize_coeffs(width, new_w)
        vb, vk = resize_coeffs(height, new_h)
        cols = np.arange(x0, x0 + fw)
        rows = np.arange(y0, y0 + fh)
        col_ok = (cols >= 0) & (cols < new_w)
        row_ok = (rows >= 0) & (rows < new_h)
        h_rows = np.zeros((fw, 2 + hk.shape[1]), np.int32)
        h_rows[col_ok, :2] = hb[cols[col_ok]]
        h_rows[col_ok, 2:] = hk[cols[col_ok]]
        v_rows = np.zeros((fh, 2 + vk.shape[1]), np.int32)
        v_rows[row_ok, :2] = vb[rows[row_ok]]
        v_rows[row_ok, 2:] = vk[rows[row_ok]]
        first = int(v_rows[row_ok, 0].min()) if row_ok.any() else 0
        last = int((v_rows[row_ok, 0] + v_rows[row_ok, 1]).max()) if row_ok.any() else 0
        v_rows[row_ok, 0] -= first
        params[i] = (new_w, new_h, x0, y0, int(p.flip), rot is not None,
                     *(rot or (0,) * 6), first, last - first)
        hs.append(h_rows)
        vs.append(v_rows)
    kh = max(h.shape[1] for h in hs)
    kv = max(v.shape[1] for v in vs)
    htab = np.zeros((n, fw, kh), np.int32)
    vtab = np.zeros((n, fh, kv), np.int32)
    for i, (h, v) in enumerate(zip(hs, vs)):
        htab[i, :, :h.shape[1]] = h
        vtab[i, :, :v.shape[1]] = v
    return params, htab, vtab, int(params[:, 13].max())


# The kernel's probes (`csrc/img_aug.cu`), whose SASS `ops/_build.py::
# sass_int_ops` counts: a unit of work's probe and the units it runs. A tap
# of either pass (three multiply-adds), a pixel of either pass (three sums
# clipped), an output pixel's source through the rotation and the flip.
PROBES = {"tap": ("ops_probe_tap", 1), "clip": ("ops_probe_clip", 1),
          "source": ("ops_probe_source", 1)}


def bound(params: np.ndarray, htab: np.ndarray, vtab: np.ndarray, height: int, width: int,
          final_dim: Tuple[int, int],
          ops: Dict[str, Dict[str, float]]) -> Tuple[int, Dict[str, float]]:
    """(bytes, integer operations by pipe) the kernel must move and do for a
    batch of (n, height, width, 3) images with `plan`'s tables: the source
    windows the crops read (the intermediate rows by the columns their taps
    span), the tables, the float32 output written once; `ops` by pipe per
    unit of PROBES: a tap and a pixel of either pass (the live columns' taps
    of every intermediate row, the inside pixels' taps), an output pixel's
    source."""
    fh, fw = final_dim
    n = params.shape[0]
    window = h_taps = h_pixels = v_taps = v_pixels = 0
    y = np.arange(fh, dtype=np.int64)[:, None]
    x = np.arange(fw, dtype=np.int64)[None, :]
    for p, ht, vt in zip(params.tolist(), htab, vtab):
        rows = p[13]
        live = ht[:, 1] > 0
        if rows and live.any():
            window += rows * int((ht[live, 0] + ht[live, 1]).max() - ht[live, 0].min()) * 3
            h_taps += rows * int(ht[:, 1].sum())
            h_pixels += rows * int(live.sum())
        ys, inside = np.broadcast_to(y, (fh, fw)), np.ones((fh, fw), bool)
        if p[5]:
            xs = (p[8] + y * p[7] + x * p[6]) >> 16
            ys = (p[11] + y * p[10] + x * p[9]) >> 16
            inside = (xs >= 0) & (xs < fw) & (ys >= 0) & (ys < fh)
        counts = np.where(inside, vt[np.clip(ys, 0, fh - 1), 1], 0) if rows else 0 * inside
        v_taps += int(counts.sum())
        v_pixels += int((counts > 0).sum())
    nbytes = (window + params.nbytes + htab.nbytes + vtab.nbytes + n * 3 * fh * fw * 4)
    units = {"tap": h_taps + v_taps, "clip": h_pixels + v_pixels, "source": n * fh * fw}
    return nbytes, _build.int_ops(units, ops)


# ---- the plain version


def _clip8(acc: torch.Tensor) -> torch.Tensor:
    """Pillow's `clip8`: the 22-bit fixed-point sum to uint8."""
    return torch.where(acc >= 1 << (PRECISION_BITS + 8), 255,
                       torch.where(acc <= 0, 0, acc >> PRECISION_BITS)).to(torch.uint8)


def _resample(src: torch.Tensor, tab: torch.Tensor, axis: int) -> torch.Tensor:
    """One pass over `axis` (0 rows, 1 columns) of (R, C, 3) uint8 with a
    table (out, 2 + K): each output the 22-bit weighted sum of its window,
    rounded and clipped as Pillow does; 0 where count is 0."""
    first, count, k = tab[:, 0].long(), tab[:, 1], tab[:, 2:]
    size = src.shape[axis]
    acc = torch.full((tab.shape[0], src.shape[1 - axis], 3), 1 << (PRECISION_BITS - 1),
                     dtype=torch.int32, device=src.device)
    s = src.to(torch.int32) if axis == 0 else src.to(torch.int32).transpose(0, 1)
    for j in range(k.shape[1]):
        idx = (first + j).clamp(max=size - 1)
        acc += s[idx] * k[:, j, None, None]
    out = _clip8(acc)
    out[count == 0] = 0
    return out if axis == 0 else out.transpose(0, 1)


def _source_coords(p, fh: int, fw: int, device):
    """Per output pixel the crop pixel it shows: (yc, xc, inside), through
    the rotation (16.16 fixed point) and the flip."""
    y = torch.arange(fh, device=device, dtype=torch.int32)[:, None].expand(fh, fw)
    x = torch.arange(fw, device=device, dtype=torch.int32)[None, :].expand(fh, fw)
    inside = torch.ones(fh, fw, dtype=torch.bool, device=device)
    if p[5]:
        a0, a1, a2, a3, a4, a5 = p[6:12]
        xs = (a2 + y.long() * a1 + x.long() * a0) >> 16
        ys = (a5 + y.long() * a4 + x.long() * a3) >> 16
        inside = (xs >= 0) & (xs < fw) & (ys >= 0) & (ys < fh)
        x, y = xs.clamp(0, fw - 1), ys.clamp(0, fh - 1)
    if p[4]:
        x = fw - 1 - x
    return y.long(), x.long(), inside


def normalize_plain(pixels: torch.Tensor) -> torch.Tensor:
    """ToTensor + Normalize in float32 as numpy computes it: x / 255, then
    minus the mean, over the std, each rounded to float32 (a true division
    by a tensor: CUDA's division by a Python scalar multiplies by its
    reciprocal)."""
    dev = pixels.device
    x = pixels.to(torch.float32) / torch.tensor(255.0, device=dev)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=dev)
    return (x - mean) / std


def augment_plain(images, params, htab, vtab, final_dim) -> torch.Tensor:
    """Plain version of `augment`, per image in PyTorch calls."""
    fh, fw = final_dim
    out = torch.empty(images.shape[0], 3, fh, fw, dtype=torch.float32, device=images.device)
    for i, p in enumerate(params.tolist()):
        if p[13]:
            rows = images[i, p[12]:p[12] + p[13]]
            crop = _resample(_resample(rows, htab[i], 1), vtab[i], 0)  # (fH, fW, 3)
        else:  # the crop misses the resized image
            crop = torch.zeros(fh, fw, 3, dtype=torch.uint8, device=images.device)
        yc, xc, inside = _source_coords(p, fh, fw, images.device)
        pix = torch.where(inside[..., None], crop[yc, xc], 0)
        out[i] = normalize_plain(pix).permute(2, 0, 1)
    return out


# ---- the kernel

_ARGTYPES = [_build.P] * 6 + [_build.I] * 8 + [_build.P]


@lru_cache(maxsize=None)
def _fn():
    return _build.bind("img_aug", "img_aug_forward", _ARGTYPES)


def augment(images, params, htab, vtab, final_dim, max_rows: int) -> torch.Tensor:
    """(n, 3, fH, fW) float32 of (n, H, W, 3) uint8 images with `plan`'s
    tables, each image resized, cropped, flipped, rotated and normalised as
    Pillow and numpy do it.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (two launches: the horizontal pass into a scratch of (n, rows, fW
    rounded up to 4) 32-bit words, then the rest; the first is skipped
    where no image has a row to resample). `max_rows`, `plan`'s most
    intermediate rows of an image, sizes the scratch."""
    if images.device.type == "cpu":
        return augment_plain(images, params, htab, vtab, final_dim)
    fh, fw = final_dim
    n, height, width, ch = images.shape
    if images.device.type != "cuda" or images.dtype != torch.uint8 or ch != 3:
        raise ValueError(f"no augmentation kernel for {images.dtype} {tuple(images.shape)} on "
                         f"{images.device}")
    if params.shape != (n, N_PARAMS) or htab.shape[:2] != (n, fw) or vtab.shape[:2] != (n, fh):
        raise ValueError("params, htab and vtab do not fit the batch")
    _build.same_device(images, params, htab, vtab)
    images = images.contiguous()
    params, htab, vtab = (t.to(torch.int32).contiguous() for t in (params, htab, vtab))
    scratch = torch.empty(n, max(max_rows, 1), -(-fw // 4) * 4, dtype=torch.int32,
                          device=images.device)
    out = torch.empty(n, 3, fh, fw, dtype=torch.float32, device=images.device)
    with _build.on(images.device):
        code = _fn()(*map(_build.ptr, (images, params, htab, vtab, scratch, out)), n, height,
                     width, fh, fw, htab.shape[2], vtab.shape[2], max_rows,
                     _build.stream(images.device))
    augment.launches += 2 if max_rows > 0 else 1  # horizontal pass, then the rest
    _build.check("img_aug", code)
    return out


augment.launches = 0
