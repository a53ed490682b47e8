"""`fill_poly`: OpenCV's `cv2.fillPoly` for one polygon (8-connected edges,
no subpixel shift), in Python, bit for bit.

OpenCV draws each edge of the polygon as an 8-connected Bresenham line, then
fills between the edges scanline by scanline with the edges' x in 16.16 fixed
point (`CollectPolyEdges` and `FillEdgeCollection` in its `drawing.cpp`). A
plain even-odd scanline fill differs from it on edge pixels, and the BEV
labels' vehicle footprints are a few pixels wide, so the port draws what
OpenCV draws.
"""
from __future__ import annotations

import numpy as np

_SHIFT = 16
_ONE = 1 << _SHIFT
_INT_MAX = 2 ** 31 - 1


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's `clipLine` to a w x h image: (inside, x1, y1, x2, y2)."""
    if w <= 0 or h <= 0:
        return False, x1, y1, x2, y2
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _outside(w, h, *pts) -> bool:
    return any(not (0 <= x < w and 0 <= y < h) for x, y in pts)


def draw_line(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, value) -> None:
    """OpenCV's 8-connected `Line` (its `LineIterator`, left to right)."""
    h, w = img.shape[:2]
    if _outside(w, h, (x1, y1), (x2, y2)):
        inside, x1, y1, x2, y2 = clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    ystep = 1
    if dy < 0:
        dy, ystep = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = value
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += ystep
            x += minor
        else:
            x += 1
            y += ystep if minor else 0


class _Edge:
    __slots__ = ("y0", "y1", "x", "dx", "next")

    def __init__(self, y0=_INT_MAX, y1=0, x=0, dx=0):
        self.y0, self.y1, self.x, self.dx, self.next = y0, y1, x, dx, None


def _collect_edges(img, pts, value):
    """OpenCV's `CollectPolyEdges` (LINE_8, shift 0): draw every edge, and
    return the non-horizontal ones in 16.16 fixed point. An edge with an end
    outside the image takes the x of its clipped ends, and their y unless
    the clipped edge is a point (OpenCV 5's rule, held to cv2 in the
    tests)."""
    h, w = img.shape[:2]
    edges = []
    x0, y0 = int(pts[-1][0]) << _SHIFT, int(pts[-1][1])
    for px, py in pts:
        x1, y1 = int(px) << _SHIFT, int(py)
        t0x, t1x = (x0 + (_ONE >> 1)) >> _SHIFT, (x1 + (_ONE >> 1)) >> _SHIFT
        t0y, t1y = y0, y1
        draw_line(img, t0x, t0y, t1x, t1y, value)
        c0x, c0y, c1x, c1y = x0, y0, x1, y1
        if _outside(w, h, (t0x, t0y), (t1x, t1y)):
            _, t0x, t0y, t1x, t1y = clip_line(w, h, t0x, t0y, t1x, t1y)
            if t0y != t1y:
                c0y, c1y = t0y, t1y
            c0x, c1x = t0x << _SHIFT, t1x << _SHIFT
        if y0 != y1:
            dx = _trunc_div(c1x - c0x, c1y - c0y)
            if y0 < y1:
                edges.append(_Edge(y0, y1, c0x + (y0 - c0y) * dx, dx))
            else:
                edges.append(_Edge(y1, y0, c1x + (y1 - c1y) * dx, dx))
        x0, y0 = x1, y1
    return edges


def _fill_edges(img, edges, value) -> None:
    """OpenCV's `FillEdgeCollection` (LINE_8): an active edge list walked
    scanline by scanline, spans between pairs of edges filled inclusively."""
    h, w = img.shape[:2]
    total = len(edges)
    if total < 2:
        return
    y_min, y_max = min(e.y0 for e in edges), max(e.y1 for e in edges)
    ends = [e.x + (e.y1 - e.y0) * e.dx for e in edges]
    x_min = min(min(e.x for e in edges), min(ends))
    x_max = max(max(e.x for e in edges), max(ends))
    if y_max < 0 or y_min >= h or x_max < 0 or x_min >= (w << _SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e.y0, e.x, e.dx)) + [_Edge()]
    head = _Edge()
    i = 0
    e = edges[0]
    for y in range(e.y0, min(y_max, h)):
        prelast, last, draw = head, head.next, 0
        while last is not None or e.y0 == y:
            if last is not None and last.y1 == y:
                prelast.next = last = last.next  # the edge ends at this row
                continue
            keep = prelast
            if last is not None and (e.y0 > y or last.x < e.x):
                prelast, last = last, last.next
            elif i < total:
                prelast.next, e.next = e, last
                prelast = e
                i += 1
                e = edges[i]
            else:
                break
            if draw:
                if y >= 0:
                    a, b = (prelast, keep) if keep.x > prelast.x else (keep, prelast)
                    x1, x2 = (a.x + _ONE - 1) >> _SHIFT, b.x >> _SHIFT
                    if x1 < w and x2 >= 0:
                        img[y, max(x1, 0):min(x2, w - 1) + 1] = value
                keep.x += keep.dx
                prelast.x += prelast.dx
            draw ^= 1
        # bubble sort of the active edges by x
        keep = None
        while True:
            prelast, last, exchanged = head, head.next, None
            while last is not keep and last.next is not None:
                te = last.next
                if last.x > te.x:
                    prelast.next, last.next, te.next = te, te.next, last
                    prelast = exchanged = te
                else:
                    prelast, last = last, te
            if exchanged is None:
                break
            keep = exchanged
            if keep is head.next or keep is head:
                break


def fill_poly(img: np.ndarray, pts: np.ndarray, value: float) -> None:
    """`cv2.fillPoly(img, [pts], value)` in place: pts (K, 2) integer (x, y)
    vertices of one polygon."""
    pts = np.asarray(pts).astype(np.int64).tolist()
    _fill_edges(img, _collect_edges(img, pts, value), value)
