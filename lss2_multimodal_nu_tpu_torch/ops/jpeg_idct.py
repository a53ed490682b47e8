"""JPEG decoding on the card after the entropy decoding: dequantise, IDCT,
upsample, convert colour, for a whole batch of images (kernel 6).

No TPU kernel stands behind it: the JAX package decodes with PIL on the
host. The kernel (`csrc/jpeg_idct.cu`) and its plain version here compute
what libjpeg-turbo computes with PIL's settings, bit for bit: the quantised
coefficients times the table, `jpeg_idct_islow` (13-bit constants, its
descales, the range-limit table), `h2v2_fancy_upsample` for 4:2:0 (the 3:1
triangle in both directions, +8 / +7 rounding, edges replicated; plain
replication where the chroma is at most 2 samples wide) and
`ycc_rgb_convert` (16-bit fixed-point tables), all in 32-bit integers.

A batch is packed by `pack` from `data/jpeg.py::Coefficients`:
  coefs (blocks, 64) int16, every image's blocks one after another;
  quant (n, 3, 64) int32, each image's tables per component;
  meta (n, 4) int32: first block, components (1 or 3), sampling h, v.
All images of a batch have one size; the output is (n, H, W, 3) uint8 (a
one-component image gives R = G = B, as PIL's "L" does once stacked).

The kernel is one launch: a CTA owns a strip of whole MCUs across and a band
of MCU rows of one image, the tiles chosen by its C entry from the card's
SMs, and decodes its blocks (with 4:2:0, the chroma one block row and column
beyond its pixels on each side, for the upsampling) into shared memory
before it writes its pixels. `bound` counts the bytes and the integer
operations of a batch.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import _build


def pack(images: Sequence, out=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """(coefs, quant, meta, H, W) of a batch of `Coefficients` of one size,
    as numpy arrays: the kernel's inputs. `out`, a callable, gives the
    (blocks, 64) int16 array to pack the coefficients into (pinned memory,
    written once); a new array by default."""
    height, width = images[0].height, images[0].width
    quant = np.zeros((len(images), 3, 64), np.int32)
    meta = np.zeros((len(images), 4), np.int32)
    first = 0
    for i, im in enumerate(images):
        if (im.height, im.width) != (height, width):
            raise ValueError(f"a batch holds images of one size: {im.height}x{im.width} beside "
                             f"{height}x{width}")
        quant[i, :im.ncomp] = im.quant
        meta[i] = (first, im.ncomp, *im.sampling)
        first += im.coefs.shape[0]
    coefs = out(first) if out is not None else np.empty((first, 64), np.int16)
    for (start, *_), im in zip(meta, images):
        coefs[start:start + im.coefs.shape[0]] = im.coefs
    return coefs, quant, meta, height, width


def _layout(ncomp: int, hs: int, vs: int, height: int, width: int):
    """Per component (first block relative to the image's, blocks down,
    blocks across, samples down, samples across): the block grid over whole
    MCUs and the samples that hold the image (libjpeg's downsampled size)."""
    mx, my = -(-width // (8 * hs)), -(-height // (8 * vs))
    out, first = [], 0
    for c in range(ncomp):
        h, v = (hs, vs) if c == 0 else (1, 1)
        rows, cols = my * v, mx * h
        out.append((first, rows, cols, -(-height * v // vs), -(-width * h // hs)))
        first += rows * cols
    return out


# The kernel's probes (`csrc/jpeg_idct.cu`), whose SASS `ops/_build.py::
# sass_int_ops` counts: a unit of work's probe and the units it runs. A
# block's dequantisation, two passes and range limit; a 4:2:0 pixel's
# upsampling (both components) and colour; a 4:4:4 pixel's colour.
PROBES = {"block": ("ops_probe_idct_block", 1), "pixel_420": ("ops_probe_pixels_420", 8),
          "pixel_444": ("ops_probe_pixel_444", 1)}


def bound(meta: np.ndarray, total_blocks: int, height: int, width: int,
          ops: Dict[str, Dict[str, float]]) -> Tuple[int, Dict[str, float]]:
    """(bytes, integer operations by pipe) the kernel must move and do for a
    packed batch: the int16 coefficients, tables and meta read once, the RGB
    written once; `ops` by pipe per unit of PROBES (a one-component image
    converts no colour)."""
    n = meta.shape[0]
    nbytes = total_blocks * 64 * 2 + n * 3 * 64 * 4 + meta.nbytes + n * height * width * 3
    kinds = [(c, h) for _, c, h, _ in meta.tolist()]
    units = {"block": total_blocks,
             "pixel_420": height * width * sum(k == (3, 2) for k in kinds),
             "pixel_444": height * width * sum(c == 3 and h != 2 for c, h in kinds)}
    return nbytes, _build.int_ops(units, ops)


# ---- the plain version


def _range_limit(device) -> torch.Tensor:
    """libjpeg's post-IDCT range limit, indexed by (value & 1023):
    128 + x for x in [0, 128), 255 up to 512, 0 up to 896, then x - 896."""
    x = torch.arange(1024, device=device, dtype=torch.int32)
    return torch.where(x < 128, x + 128, torch.where(x < 512, 255, torch.where(
        x < 896, 0, x - 896))).to(torch.uint8)


def _idct_pass(x, shift: int):
    """One pass of `jpeg_idct_islow` over the last axis of x (int32), its
    outputs descaled by `shift`."""
    z2, z3 = x[..., 2], x[..., 6]
    z1 = (z2 + z3) * 4433
    tmp2 = z1 + z3 * -15137
    tmp3 = z1 + z2 * 6270
    tmp0 = (x[..., 0] + x[..., 4]) * 8192
    tmp1 = (x[..., 0] - x[..., 4]) * 8192
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[..., 7], x[..., 5], x[..., 3], x[..., 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    t0, t1, t2, t3 = t0 * 2446, t1 * 16819, t2 * 25172, t3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    rnd = 1 << (shift - 1)
    outs = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return torch.stack([(o + rnd) >> shift for o in outs], -1)


def idct_plain(blocks: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
    """`jpeg_idct_islow` of (m, 64) quantised blocks with their (m, 64)
    tables -> (m, 64) uint8 samples, natural order."""
    x = (blocks.to(torch.int32) * quant.to(torch.int32)).view(-1, 8, 8)
    ws = _idct_pass(x.transpose(1, 2), 11).transpose(1, 2)  # columns, 2 extra bits kept
    out = _idct_pass(ws, 18)  # rows: 13 + 2 + 3 bits
    return _range_limit(blocks.device)[(out & 1023).long()].view(-1, 64)


def _plane(samples: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return samples.view(rows, cols, 8, 8).permute(0, 2, 1, 3).reshape(rows * 8, cols * 8)


def _fancy_h2v2(p: torch.Tensor) -> torch.Tensor:
    """libjpeg-turbo's `h2v2_fancy_upsample` of a (h, w) plane -> (2h, 2w)."""
    p = p.to(torch.int32)
    up = torch.cat([p[:1], p[:-1]])
    down = torch.cat([p[1:], p[-1:]])
    rows = torch.stack([3 * p + up, 3 * p + down], 1).reshape(-1, p.shape[1])  # column sums
    left = torch.cat([rows[:, :1], rows[:, :-1]], 1)
    right = torch.cat([rows[:, 1:], rows[:, -1:]], 1)
    out = torch.stack([(3 * rows + left + 8) >> 4, (3 * rows + right + 7) >> 4], 2)
    return out.reshape(rows.shape[0], -1)


def _ycc_to_rgb(y, cb, cr) -> torch.Tensor:
    """libjpeg's `ycc_rgb_convert` with its fixed-point tables."""
    cb, cr = cb.to(torch.int32) - 128, cr.to(torch.int32) - 128
    y = y.to(torch.int32)
    r = y + ((91881 * cr + 32768) >> 16)
    g = y + ((-22554 * cb + 32768 - 46802 * cr) >> 16)
    b = y + ((116130 * cb + 32768) >> 16)
    return torch.stack([r, g, b], -1).clamp_(0, 255).to(torch.uint8)


def decode_plain(coefs, quant, meta, height: int, width: int) -> torch.Tensor:
    """Plain version of `decode`, in PyTorch calls on coefs' device."""
    out = torch.empty(meta.shape[0], height, width, 3, dtype=torch.uint8, device=coefs.device)
    for i, (first, ncomp, hs, vs) in enumerate(meta.tolist()):
        planes = []
        for c, (off, rows, cols, sh, sw) in enumerate(_layout(ncomp, hs, vs, height, width)):
            blk = coefs[first + off:first + off + rows * cols]
            plane = _plane(idct_plain(blk, quant[i, c].expand(blk.shape[0], 64)), rows, cols)
            plane = plane[:sh, :sw]
            if c and hs == 2:
                plane = _fancy_h2v2(plane) if sw > 2 else plane.repeat_interleave(
                    2, 0).repeat_interleave(2, 1)
            planes.append(plane[:height, :width])
        out[i] = (planes[0][..., None].expand(-1, -1, 3) if ncomp == 1
                  else _ycc_to_rgb(*planes))
    return out


# ---- the kernel

_ARGTYPES = [_build.P] * 4 + [_build.I] * 4 + [_build.P]


@lru_cache(maxsize=None)
def _fn():
    return _build.bind("jpeg_idct", "jpeg_idct_decode", _ARGTYPES)


def decode(coefs, quant, meta, height: int, width: int) -> torch.Tensor:
    """(n, H, W, 3) uint8 RGB of a packed batch (see the module's doc).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel,
    once, its tiles sized to the card's SMs."""
    if coefs.device.type == "cpu":
        return decode_plain(coefs, quant, meta, height, width)
    if coefs.device.type != "cuda" or coefs.dtype != torch.int16 or coefs.dim() != 2 \
            or coefs.shape[1] != 64:
        raise ValueError(f"no JPEG IDCT kernel for {coefs.dtype} {tuple(coefs.shape)} on "
                         f"{coefs.device}")
    n = meta.shape[0]
    if quant.shape != (n, 3, 64) or meta.shape != (n, 4):
        raise ValueError("quant must be (n, 3, 64) and meta (n, 4)")
    _build.same_device(coefs, quant, meta)
    coefs = _build.aligned(coefs)
    quant = quant.to(torch.int32).contiguous()
    meta = meta.to(torch.int32).contiguous()
    out = torch.empty(n, height, width, 3, dtype=torch.uint8, device=coefs.device)
    with _build.on(coefs.device):
        code = _fn()(*map(_build.ptr, (coefs, quant, meta, out)), n, height, width,
                     _build.sm_count(coefs.device), _build.stream(coefs.device))
    decode.launches += 1
    _build.check("jpeg_idct", code)
    return out


decode.launches = 0
