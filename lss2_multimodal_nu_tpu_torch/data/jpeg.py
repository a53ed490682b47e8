"""Baseline JPEG: the markers, the entropy decoder and an encoder.

Decoding is split as the loader splits it. The host reads the markers and
turns the entropy-coded data into quantised DCT coefficients
(`decode_coefficients`): in C++ (`csrc/jpeg_entropy.cu`, host code only,
bound with ctypes, which releases the GIL so that worker threads decode in
parallel) or, as its plain version, in Python. The card dequantises,
transforms, upsamples and converts the colour (`ops/jpeg_idct.py`).

What is decoded is what libjpeg-turbo (through PIL) decodes: SOF0 baseline,
8-bit samples, one component or three, sampled 1x1 (4:4:4) or with the
first component at 2x2 and the others at 1x1 (4:2:0), Huffman coding with
restart intervals. Anything else (progressive, arithmetic coding, 12-bit
samples, other sampling) raises `JpegError`.

`encode` writes what PIL's `Image.save(..., quality=q)` writes for an RGB
image: libjpeg's colour conversion, 2x2 downsampling with its alternating
bias, edge expansion, `jpeg_fdct_islow`, the standard tables scaled to the
quality and the standard Huffman tables. It is used by
`data/synthetic.py` only.
"""
from __future__ import annotations

import ctypes
import dataclasses
import re
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

# zigzag position k -> natural (row-major) index in the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int64)

# the standard tables of the JPEG specification (Annex K), natural order
STD_LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.int64)
STD_CHROMA_QUANT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
] + [99] * 32, dtype=np.int64)

# (bits[1..16], values) of the four standard Huffman tables
_AC_LUMA_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728"
    "292a3435363738393a434445464748494a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2"
    "e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_CHROMA_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718191a26"
    "2728292a35363738393a434445464748494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da"
    "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")
STD_HUFFMAN = {
    (0, 0): (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12))),
    (1, 0): (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d]), _AC_LUMA_VALS),
    (0, 1): (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12))),
    (1, 1): (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), _AC_CHROMA_VALS),
}


class JpegError(ValueError):
    """A file this decoder does not take, or corrupt data."""


@dataclasses.dataclass
class Frame:
    """The markers of one baseline JPEG file.

    comps: per component (id, h, v, quant table id); quant: table id ->
    (64,) natural order; huffman: (class 0 DC / 1 AC, id) -> (bits, values);
    scan: per component of the scan in frame order (dc id, ac id);
    data: the entropy-coded bytes (stuffing and restart markers in place)."""

    height: int
    width: int
    comps: List[Tuple[int, int, int, int]]
    quant: Dict[int, np.ndarray]
    huffman: Dict[Tuple[int, int], Tuple[bytes, bytes]]
    restart_interval: int
    scan: List[Tuple[int, int]]
    data: bytes

    @property
    def h_max(self) -> int:
        return self.comps[0][1]

    @property
    def v_max(self) -> int:
        return self.comps[0][2]

    @property
    def mcus(self) -> Tuple[int, int]:
        """(MCUs across, MCUs down)."""
        return (-(-self.width // (8 * self.h_max)), -(-self.height // (8 * self.v_max)))

    def block_dims(self) -> List[Tuple[int, int]]:
        """(blocks down, blocks across) of each component, dummy blocks of
        the last MCU row and column included."""
        mx, my = self.mcus
        return [(my * v, mx * h) for _, h, v, _ in self.comps]


@dataclasses.dataclass
class Coefficients:
    """An image as quantised DCT coefficients: `coefs` (blocks, 64) int16 in
    natural order, the components one after another, each's blocks row by
    row over `block_dims`; `quant` (ncomp, 64) int32, each component's
    table in natural order; `sampling` (h, v) of the first component (1, 1)
    or (2, 2), the others at (1, 1)."""

    height: int
    width: int
    sampling: Tuple[int, int]
    quant: np.ndarray
    coefs: np.ndarray

    @property
    def ncomp(self) -> int:
        return self.quant.shape[0]

    @property
    def mcus(self) -> Tuple[int, int]:
        h, v = self.sampling
        return (-(-self.width // (8 * h)), -(-self.height // (8 * v)))


_SOF_OTHER = {0xC1: "extended sequential", 0xC2: "progressive", 0xC3: "lossless",
              0xC5: "differential", 0xC6: "differential progressive",
              0xC7: "differential lossless", 0xC9: "arithmetic-coded",
              0xCA: "arithmetic-coded progressive", 0xCB: "arithmetic-coded lossless",
              0xCD: "arithmetic-coded", 0xCE: "arithmetic-coded", 0xCF: "arithmetic-coded"}
_SCAN_END = re.compile(rb"\xff[^\x00\xd0-\xd7]")


def parse(data: bytes) -> Frame:
    """Read the markers of a baseline JPEG file up to its one scan."""
    if data[:2] != b"\xff\xd8":
        raise JpegError("not a JPEG file (no SOI marker)")
    pos, quant, huffman, restart, sof = 2, {}, {}, 0, None
    n = len(data)
    while True:
        while pos < n and data[pos] == 0xFF and pos + 1 < n and data[pos + 1] == 0xFF:
            pos += 1  # fill bytes
        if pos + 4 > n or data[pos] != 0xFF:
            raise JpegError("truncated or corrupt marker segment")
        marker = data[pos + 1]
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        seg = data[pos + 4:pos + 2 + length]
        if len(seg) != length - 2:
            raise JpegError("truncated marker segment")
        pos += 2 + length
        if marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq == 0:
                    table = np.frombuffer(seg, np.uint8, 64, i + 1).astype(np.int64)
                    i += 65
                else:
                    table = np.frombuffer(seg, ">u2", 64, i + 1).astype(np.int64)
                    i += 129
                nat = np.empty(64, np.int64)
                nat[ZIGZAG] = table
                quant[tq] = nat
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                bits = bytes(seg[i + 1:i + 17])
                count = sum(bits)
                if count > 256:
                    raise JpegError("bad Huffman table: more than 256 codes")
                huffman[(tc, th)] = (bits, bytes(seg[i + 17:i + 17 + count]))
                i += 17 + count
        elif marker == 0xDD:
            restart = int.from_bytes(seg[:2], "big")
        elif marker == 0xC0:
            if seg[0] != 8:
                raise JpegError(f"{seg[0]}-bit samples: only 8-bit baseline JPEG is decoded")
            h, w, nf = int.from_bytes(seg[1:3], "big"), int.from_bytes(seg[3:5], "big"), seg[5]
            comps = [(seg[6 + 3 * k], seg[7 + 3 * k] >> 4, seg[7 + 3 * k] & 15, seg[8 + 3 * k])
                     for k in range(nf)]
            sof = (h, w, comps)
        elif marker in _SOF_OTHER:
            raise JpegError(f"{_SOF_OTHER[marker]} JPEG (SOF{marker - 0xC0}): only baseline "
                            "(SOF0) is decoded")
        elif marker == 0xDA:
            break
        elif marker == 0xD9:
            raise JpegError("no scan before EOI")
    if sof is None:
        raise JpegError("no SOF0 frame header before the scan")
    h, w, comps = sof
    if h == 0 or w == 0:
        raise JpegError("image without size")
    samp = [(c[1], c[2]) for c in comps]
    if len(comps) not in (1, 3) or (len(comps) == 1 and samp != [(1, 1)] and samp != [(2, 2)]) or (
            len(comps) == 3 and samp not in ([(1, 1)] * 3, [(2, 2), (1, 1), (1, 1)])):
        raise JpegError(f"components {len(comps)} sampled {samp}: only 1 component, or 3 at "
                        "4:4:4 or 4:2:0, are decoded")
    if len(comps) == 1:  # one component is never interleaved: its MCU is one block
        comps = [(comps[0][0], 1, 1, comps[0][3])]
    ns = seg[0]
    ids = [seg[1 + 2 * k] for k in range(ns)]
    if ids != [c[0] for c in comps]:
        raise JpegError("the scan must hold every component in frame order (one scan)")
    scan = [(seg[2 + 2 * k] >> 4, seg[2 + 2 * k] & 15) for k in range(ns)]
    ss, se, ahal = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
    if (ss, se, ahal) != (0, 63, 0):
        raise JpegError("a scan other than the full sequential one")
    for c in comps:
        if c[3] not in quant:
            raise JpegError(f"missing quantisation table {c[3]}")
    for dc, ac in scan:
        if (0, dc) not in huffman or (1, ac) not in huffman:
            raise JpegError("missing Huffman table")
    end = _SCAN_END.search(data, pos)
    return Frame(h, w, comps, quant, huffman, restart, scan,
                 data[pos:end.start() if end else n])


def _segments(frame: Frame) -> List[bytes]:
    """The entropy-coded data cut at its restart markers, unstuffed."""
    parts = re.split(rb"\xff[\xd0-\xd7]", frame.data) if frame.restart_interval else [frame.data]
    return [p.replace(b"\xff\x00", b"\xff") for p in parts]


@lru_cache(maxsize=64)
def _lookup(bits: bytes, vals: bytes) -> List[int]:
    """16-bit peek -> (code length << 8) | symbol, 0 where no code starts."""
    table = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            lo = code << (16 - length)
            table[lo:lo + (1 << (16 - length))] = (length << 8) | vals[k]
            code += 1
            k += 1
        code <<= 1
    return table.tolist()


def _mcu_layout(frame: Frame):
    """Per block of one MCU: (component, row in the MCU, column in the MCU),
    in coding order; each component's first block in `coefs`; its blocks
    across."""
    dims = frame.block_dims()
    first = np.cumsum([0] + [r * c for r, c in dims])[:-1]
    order = [(ci, dy, dx) for ci, (_, h, v, _) in enumerate(frame.comps)
             for dy in range(v) for dx in range(h)]
    return order, [int(f) for f in first], [c for _, c in dims]


def _entropy_decode_plain(frame: Frame) -> np.ndarray:
    """The plain version of `csrc/jpeg_entropy.cu`: Huffman decoding of the
    scan into (blocks, 64) int16, natural order."""
    order, first, across = _mcu_layout(frame)
    mx, my = frame.mcus
    nblocks = first[-1] + frame.block_dims()[-1][0] * across[-1]
    out = [0] * (nblocks * 64)
    zz = ZIGZAG.tolist()
    dc_tabs = [_lookup(*frame.huffman[(0, dc)]) for dc, _ in frame.scan]
    ac_tabs = [_lookup(*frame.huffman[(1, ac)]) for _, ac in frame.scan]
    comp_h = [c[1] for c in frame.comps]
    comp_v = [c[2] for c in frame.comps]
    ri = frame.restart_interval or mx * my
    segments = _segments(frame)
    for mcu in range(mx * my):
        if mcu % ri == 0:
            seg_i = mcu // ri
            if seg_i >= len(segments):
                raise JpegError("fewer restart intervals than the image needs")
            # zero bytes past the end, as libjpeg inserts: no block reads
            # more than 216 bytes
            raw = np.frombuffer(segments[seg_i] + bytes(1024), np.uint8).astype(np.int64)
            win = ((raw[:-3] << 24) | (raw[1:-2] << 16) | (raw[2:-1] << 8) | raw[3:]).tolist()
            limit = len(segments[seg_i]) * 8
            pos = 0
            pred = [0] * len(frame.comps)
        my_i, mx_i = divmod(mcu, mx)
        for ci, dy, dx in order:
            base = (first[ci] + (my_i * comp_v[ci] + dy) * across[ci] + mx_i * comp_h[ci] + dx) * 64
            tab = dc_tabs[ci]
            e = tab[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if not e:
                raise JpegError("corrupt data: no DC code")
            pos += e >> 8
            s = e & 255
            if s:
                if s > 11:
                    raise JpegError("corrupt data: DC difference too large")
                v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                pred[ci] += v
            out[base] = pred[ci]
            tab = ac_tabs[ci]
            k = 1
            while k < 64:
                e = tab[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                if not e:
                    raise JpegError("corrupt data: no AC code")
                pos += e >> 8
                rs = e & 255
                s = rs & 15
                if s:
                    k += rs >> 4
                    if k > 63:
                        raise JpegError("corrupt data: AC run past the block")
                    v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                    pos += s
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                    out[base + zz[k]] = v
                    k += 1
                elif rs == 0xF0:
                    k += 16
                else:
                    break
            if pos > limit:
                raise JpegError("corrupt data: the scan ends inside an MCU")
    arr = np.array(out, dtype=np.int64)
    if arr.size and (arr.max() > 32767 or arr.min() < -32768):
        raise JpegError("corrupt data: coefficient out of range")
    return arr.astype(np.int16).reshape(nblocks, 64)


# ---- the C++ entropy decoder (csrc/jpeg_entropy.cu)

# data, bytes, tables (4 x 273), components (ncomp x 6 int32), ncomp, MCUs across,
# MCUs down, restart interval, out, out's values
_C_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_longlong]


@lru_cache(maxsize=1)
def _c_decoder():
    from ..ops import _build

    lib = _build.library("jpeg_entropy")
    fn = lib.lss_jpeg_entropy_decode
    fn.argtypes, fn.restype = _C_ARGTYPES, ctypes.c_int
    msg = lib.lss_jpeg_error_string
    msg.argtypes, msg.restype = [ctypes.c_int], ctypes.c_char_p
    return fn, msg


def _entropy_decode_library(frame: Frame) -> np.ndarray:
    """`csrc/jpeg_entropy.cu::lss_jpeg_entropy_decode` on the scan."""
    fn, msg = _c_decoder()
    _, first, across = _mcu_layout(frame)
    nblocks = first[-1] + frame.block_dims()[-1][0] * across[-1]
    tables = np.zeros((4, 17 + 256), np.uint8)  # the scan's tables in the order it first uses them
    ids = {}
    comp = np.zeros((len(frame.comps), 6), np.int32)
    for ci, ((_, h, v, _), (dc, ac)) in enumerate(zip(frame.comps, frame.scan)):
        for cls, tid in ((0, dc), (1, ac)):
            if (cls, tid) not in ids:
                slot = len(ids)
                if slot >= 4:
                    raise JpegError("more than four Huffman tables in one scan")
                bits, vals = frame.huffman[(cls, tid)]
                tables[slot, 1:17] = np.frombuffer(bits, np.uint8)
                tables[slot, 17:17 + len(vals)] = np.frombuffer(vals, np.uint8)
                ids[(cls, tid)] = slot
        comp[ci] = (h, v, ids[(0, dc)], ids[(1, ac)], across[ci], first[ci])
    mx, my = frame.mcus
    out = np.empty((nblocks, 64), np.int16)
    data = np.frombuffer(frame.data, np.uint8)
    code = fn(data.ctypes.data, data.size, tables.ctypes.data, comp.ctypes.data,
              len(frame.comps), mx, my, frame.restart_interval, out.ctypes.data, out.size)
    if code:
        raise JpegError(f"corrupt data: {msg(code).decode()}")
    return out


def decode_coefficients(data: bytes, library: bool = True) -> Coefficients:
    """The host stage of decoding: the markers, then the scan's entropy
    decoding, by `csrc/jpeg_entropy.cu` (`library`) or its plain version."""
    frame = parse(data)
    coefs = _entropy_decode_library(frame) if library else _entropy_decode_plain(frame)
    quant = np.stack([frame.quant[c[3]] for c in frame.comps]).astype(np.int32)
    return Coefficients(frame.height, frame.width, (frame.h_max, frame.v_max), quant, coefs)


# ---- the encoder


def quality_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """libjpeg's `jpeg_set_quality(quality, force_baseline=TRUE)`: the
    standard luminance and chrominance tables scaled, natural order."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (STD_LUMA_QUANT, STD_CHROMA_QUANT))


_FIX = {k: int(v * 65536 + 0.5) for k, v in
        (("r_y", 0.29900), ("g_y", 0.58700), ("b_y", 0.11400), ("r_cb", 0.16874),
         ("g_cb", 0.33126), ("half", 0.5), ("g_cr", 0.41869), ("b_cr", 0.08131))}


def rgb_to_ycc(rgb: np.ndarray) -> np.ndarray:
    """libjpeg's `rgb_ycc_convert` (16-bit fixed point, its rounding
    constants): (H, W, 3) uint8 -> (3, H, W) int64."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    f = _FIX
    one_half, cbcr = 1 << 15, 128 << 16
    y = (f["r_y"] * r + f["g_y"] * g + f["b_y"] * b + one_half) >> 16
    cb = (-f["r_cb"] * r - f["g_cb"] * g + f["half"] * b + cbcr + one_half - 1) >> 16
    cr = (f["half"] * r - f["g_cr"] * g - f["b_cr"] * b + cbcr + one_half - 1) >> 16
    return np.stack([y, cb, cr])


def _pad_edge(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    return np.pad(plane, ((0, rows - plane.shape[0]), (0, cols - plane.shape[1])), mode="edge")


def _fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """libjpeg's `jpeg_fdct_islow` on (n, 8, 8) int64 samples minus 128:
    columns of the output scaled by 8, as libjpeg leaves them."""
    def rows(d, first):
        # one pass over the last axis; `first`: pass 1 (rows), else pass 2
        x = [d[..., i] for i in range(8)]
        t0, t7 = x[0] + x[7], x[0] - x[7]
        t1, t6 = x[1] + x[6], x[1] - x[6]
        t2, t5 = x[2] + x[5], x[2] - x[5]
        t3, t4 = x[3] + x[4], x[3] - x[4]
        t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
        out = [None] * 8
        if first:
            out[0], out[4] = (t10 + t11) << 2, (t10 - t11) << 2
            sh = 11
        else:
            out[0], out[4] = (t10 + t11 + 2) >> 2, (t10 - t11 + 2) >> 2
            sh = 15
        rnd = 1 << (sh - 1)
        z1 = (t12 + t13) * 4433
        out[2] = (z1 + t13 * 6270 + rnd) >> sh
        out[6] = (z1 - t12 * 15137 + rnd) >> sh
        z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
        z5 = (z3 + z4) * 9633
        t4, t5, t6, t7 = t4 * 2446, t5 * 16819, t6 * 25172, t7 * 12299
        z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069 + z5, z4 * -3196 + z5
        out[7] = (t4 + z1 + z3 + rnd) >> sh
        out[5] = (t5 + z2 + z4 + rnd) >> sh
        out[3] = (t6 + z2 + z3 + rnd) >> sh
        out[1] = (t7 + z1 + z4 + rnd) >> sh
        return np.stack(out, -1)

    d = rows(blocks, True)
    return np.swapaxes(rows(np.swapaxes(d, 1, 2), False), 1, 2)


def _quantize(work: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's `quantize` by reciprocal, correction and shift
    (`compute_reciprocal`, 16-bit DCTELEM): round half up of |x| / (8 q)."""
    out = np.empty_like(work)
    for i in range(64):
        div = int(qtable[i]) * 8
        b = div.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, div)
        c = div // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= div // 2:
            c += 1
        else:
            fq += 1
        x = work[:, i]
        mag = ((np.abs(x) + c) * fq) >> r
        out[:, i] = np.where(x < 0, -mag, mag)
    return out


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(rows, cols) -> (rows/8 * cols/8, 8, 8), blocks row by row."""
    r, c = plane.shape
    return plane.reshape(r // 8, 8, c // 8, 8).swapaxes(1, 2).reshape(-1, 8, 8)


def encode_coefficients(rgb: np.ndarray, quality: int = 95) -> Coefficients:
    """The quantised coefficients libjpeg computes from an RGB image at
    `quality`, 4:2:0, in the layout `decode_coefficients` gives, dummy
    blocks included."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]
    qy, qc = quality_tables(quality)
    ycc = rgb_to_ycc(rgb)
    mx, my = -(-w // 16), -(-h // 16)
    wb_y, hb_y = -(-w // 8), -(-h // 8)  # the luma blocks that hold image samples
    wb_c, hb_c = mx, my
    planes = []
    # luma: edge replicated to whole blocks
    y = _pad_edge(ycc[0], hb_y * 8, wb_y * 8)
    planes.append((y, hb_y, wb_y, qy))
    for comp in ycc[1:]:
        # chroma: edge replicated to 2 x its blocks, then h2v2_downsample
        full = _pad_edge(comp, -(-h // 2) * 2, wb_c * 16)
        bias = np.tile([1, 2], wb_c * 4)
        down = (full[0::2, 0::2] + full[0::2, 1::2] + full[1::2, 0::2] + full[1::2, 1::2]
                + bias) >> 2
        planes.append((_pad_edge(down, hb_c * 8, wb_c * 8), hb_c, wb_c, qc))
    coefs = []
    for ci, (plane, hb, wb, q) in enumerate(planes):
        work = _fdct_islow(_blocks(plane - 128)).reshape(-1, 64)
        quant = _quantize(work, q).reshape(hb, wb, 64)
        if ci == 0:
            # dummy blocks of the last MCU column and row: zero, with the DC of
            # the block before them in coding order (libjpeg's compress_data)
            full = np.zeros((my * 2, mx * 2, 64), np.int64)
            full[:hb, :wb] = quant
            if wb < mx * 2:
                full[:hb, wb, 0] = full[:hb, wb - 1, 0]
            if hb < my * 2:
                full[hb, :, 0] = full[hb - 1, 1::2, 0].repeat(2)
            quant = full
        coefs.append(quant.reshape(-1, 64))
    quant_tables = np.stack([qy, qc, qc]).astype(np.int32)
    return Coefficients(h, w, (2, 2), quant_tables,
                        np.concatenate(coefs).astype(np.int16))


@lru_cache(maxsize=8)
def _code_table(bits: bytes, vals: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """symbol -> (code, length) of a canonical Huffman table."""
    codes = np.zeros(256, np.int64)
    lengths = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]], lengths[vals[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return codes, lengths


def _size(v: np.ndarray) -> np.ndarray:
    """JPEG's magnitude category: the bit length of |v|."""
    a = np.abs(v)
    s = np.zeros_like(a)
    while (a > 0).any():
        s += a > 0
        a >>= 1
    return s


def _entropy_encode(coefs: Coefficients) -> bytes:
    """Huffman-code the blocks in MCU order with the standard tables; pad
    the last byte with ones and stuff 0x00 after every 0xFF."""
    mx, my = coefs.mcus
    hb = [my * 2, my, my]
    wb = [mx * 2, mx, mx]
    first = np.cumsum([0] + [a * b for a, b in zip(hb, wb)])
    # the blocks in coding order: per MCU Y00 Y01 Y10 Y11 Cb Cr
    m_y, m_x = np.meshgrid(np.arange(my), np.arange(mx), indexing="ij")
    m_y, m_x = m_y.reshape(-1, 1), m_x.reshape(-1, 1)
    idx = np.concatenate([
        first[0] + (m_y * 2 + np.array([0, 0, 1, 1])) * wb[0] + m_x * 2 + np.array([0, 1, 0, 1]),
        first[1] + m_y * wb[1] + m_x, first[2] + m_y * wb[2] + m_x], axis=1).reshape(-1)
    comp = np.tile([0, 0, 0, 0, 1, 2], mx * my)
    zz = coefs.coefs.astype(np.int64)[idx][:, ZIGZAG]
    nb = zz.shape[0]
    # DC differences per component in coding order
    dc = zz[:, 0]
    diff = np.empty_like(dc)
    for c in range(3):
        sel = comp == c
        d = dc[sel]
        diff[sel] = np.diff(d, prepend=0)
    tab = [0, 1, 1]
    dc_codes = [_code_table(*STD_HUFFMAN[(0, tab[c])]) for c in range(3)]
    ac_codes = [_code_table(*STD_HUFFMAN[(1, tab[c])]) for c in range(3)]

    def huff(codes_per_comp, comps, symbols):
        code = np.zeros(symbols.shape, np.int64)
        length = np.zeros(symbols.shape, np.int64)
        for c in range(3):
            sel = comps == c
            code[sel] = codes_per_comp[c][0][symbols[sel]]
            length[sel] = codes_per_comp[c][1][symbols[sel]]
        return code, length

    def value_bits(v, s):
        return np.where(v < 0, v + (1 << s) - 1, v) & ((1 << s) - 1)

    # items: (bits, length) in stream order, keyed by (block, position)
    s_dc = _size(diff)
    c_dc, l_dc = huff(dc_codes, comp, s_dc)
    dc_item = ((c_dc << s_dc) | value_bits(diff, s_dc), l_dc + s_dc)
    blk, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[blk, k]
    start = np.r_[True, blk[1:] != blk[:-1]] if blk.size else np.zeros(0, bool)
    prev = np.where(start, 0, np.r_[0, k[:-1]])
    run = k - prev - 1
    nzrl = run // 16
    s_ac = _size(v)
    c_ac, l_ac = huff(ac_codes, comp[blk], ((run % 16) << 4) | s_ac)
    ac_item = ((c_ac << s_ac) | value_bits(v, s_ac), l_ac + s_ac)
    last = np.zeros(nb, np.int64)
    last[blk] = k  # the last nonzero position of each block (0: none)
    eob_blocks = np.nonzero(last < 63)[0]
    c_eob, l_eob = huff(ac_codes, comp[eob_blocks], np.zeros(eob_blocks.size, np.int64))
    zrl_blk = np.repeat(blk, nzrl)
    c_zrl, l_zrl = huff(ac_codes, comp[zrl_blk], np.full(zrl_blk.size, 0xF0))
    # order: per block DC, then per nonzero its ZRLs then itself, then EOB;
    # sort keys (block, slot) with slot 0 for DC, 2k - 1 for a ZRL before k, 2k
    # for the coefficient at k, 200 for EOB (ZRLs before one k keep their order:
    # a stable sort)
    keys = np.concatenate([np.arange(nb) * 256, blk * 256 + 2 * k,
                           zrl_blk * 256 + 2 * np.repeat(k, nzrl) - 1, eob_blocks * 256 + 200])
    vals = np.concatenate([dc_item[0], ac_item[0], c_zrl, c_eob])
    lens = np.concatenate([dc_item[1], ac_item[1], l_zrl, l_eob])
    order = np.argsort(keys, kind="stable")
    vals, lens = vals[order], lens[order]
    # bit-serialise: every item's bits, most significant first, then pad with 1s
    total = int(lens.sum())
    pad = -total % 8
    owner = np.repeat(np.arange(lens.size), lens)
    bit_in = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    bits = ((vals[owner] >> (lens[owner] - 1 - bit_in)) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(pad, np.uint8)])
    packed = np.packbits(bits)
    ff = np.nonzero(packed == 0xFF)[0]
    return np.insert(packed, ff + 1, 0).tobytes()


def _marker(code: int, payload: bytes) -> bytes:
    return bytes([0xFF, code]) + (len(payload) + 2).to_bytes(2, "big") + payload


def encode(rgb: np.ndarray, quality: int = 95) -> bytes:
    """An RGB (H, W, 3) uint8 image as the JPEG file PIL writes with
    `Image.fromarray(rgb).save(f, quality=quality)`: JFIF 1.01, two
    quantisation tables, 4:2:0, the standard Huffman tables, one scan."""
    coefs = encode_coefficients(rgb, quality)
    h, w = coefs.height, coefs.width
    out = [b"\xff\xd8", _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for tid in (0, 1):
        out.append(_marker(0xDB, bytes([tid]) + bytes(
            coefs.quant[tid][ZIGZAG].astype(np.uint8).tolist())))
    out.append(_marker(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
                       + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for cls, tid in ((0, 0), (1, 0), (0, 1), (1, 1)):
        bits, vals = STD_HUFFMAN[(cls, tid)]
        out.append(_marker(0xC4, bytes([cls << 4 | tid]) + bits + vals))
    out.append(_marker(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out.append(_entropy_encode(coefs))
    out.append(b"\xff\xd9")
    return b"".join(out)
