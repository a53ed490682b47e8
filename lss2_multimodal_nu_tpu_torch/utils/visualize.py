"""Visualisation: BEV class maps as RGB images and PNG files (numpy and the
standard library), and the matplotlib figures of the JAX package's
`utils/visualize.py`. matplotlib is imported only inside the functions that
draw with it, so the port runs where it is not installed; those functions
then raise ImportError."""
from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

from ..data.raster import fill_poly
from ..ops.img_aug import IMAGENET_MEAN, IMAGENET_STD

# class colours: background, vehicle, drivable, divider
BEV_PALETTE = np.array(
    [
        [255, 255, 255],
        [0, 120, 255],
        [255, 127, 80],
        [159, 0, 255],
    ],
    dtype=np.uint8,
)
EGO_COLOR = (118, 185, 0)  # '#76b900'


def ego_footprint_points(bx, dx) -> np.ndarray:
    """The ego car's footprint as a polygon in BEV pixel coordinates."""
    W = 1.85
    pts = np.array(
        [
            [-4.084 / 2.0 + 0.5, W / 2.0],
            [4.084 / 2.0 + 0.5, W / 2.0],
            [4.084 / 2.0 + 0.5, -W / 2.0],
            [-4.084 / 2.0 + 0.5, -W / 2.0],
        ]
    )
    pts = (pts - np.asarray(bx)[:2]) / np.asarray(dx)[:2]
    pts[:, [0, 1]] = pts[:, [1, 0]]
    return pts


def bev_to_rgb(bev_classes: np.ndarray, draw_ego: bool = True, bx=None, dx=None) -> np.ndarray:
    """(X, Y) int class map -> (X, Y, 3) uint8 image, with the ego car's
    footprint filled in green when `draw_ego` and the grid's bx, dx are
    given."""
    img = BEV_PALETTE[np.clip(bev_classes, 0, len(BEV_PALETTE) - 1)]
    if draw_ego and bx is not None:
        marker = np.zeros(img.shape[:2], dtype=np.float64)
        fill_poly(marker, ego_footprint_points(bx, dx).astype(np.int32), -1.0)
        img = img.copy()
        img[marker < 0] = EGO_COLOR
    return img


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(rgb: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 image as a PNG file: 8-bit RGB, no filter."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {rgb.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _png_chunk(b"IEND", b""))


def save_bev_png(path: str, bev_classes: np.ndarray, bx=None, dx=None) -> None:
    """`bev_to_rgb` of the class map (the ego car drawn when bx is given)
    written to `path` as a PNG."""
    with open(path, "wb") as f:
        f.write(png_bytes(bev_to_rgb(bev_classes, bx is not None, bx, dx)))


def side_by_side(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Prediction and ground truth as RGB, side by side, 4 grey columns
    between them."""
    sep = np.full((pred.shape[0], 4, 3), 64, dtype=np.uint8)
    return np.concatenate([bev_to_rgb(pred), sep, bev_to_rgb(gt)], axis=1)


def denormalize_img(img: np.ndarray) -> np.ndarray:
    """A normalised (3, H, W) camera image (the port's layout) as (H, W, 3)
    uint8, the inverse of the loader's normalisation."""
    x = (np.asarray(img, np.float32).transpose(1, 2, 0) * np.float32(IMAGENET_STD)
         + np.float32(IMAGENET_MEAN))
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


# ---- matplotlib figures


def add_ego(bx, dx, ax=None):
    """Fill the ego car's footprint in green on the current BEV axes."""
    import matplotlib.pyplot as plt

    ax = ax or plt.gca()
    pts = ego_footprint_points(bx, dx)
    ax.fill(pts[:, 0], pts[:, 1], "#76b900")


def plot_local_map(polys, dx, bx, ax=None):
    """Draw a `data/map_gen.py::get_local_map` dict on the BEV axes: road
    polygons coral at alpha 0.2, road dividers blue and lane dividers purple
    at 0.5, plotted as (y, x) (the BEV's row/column swap)."""
    import matplotlib.pyplot as plt

    ax = ax or plt.gca()
    dx2, bx2 = np.asarray(dx)[:2], np.asarray(bx)[:2]
    for name in ("road_segment", "lane"):
        for la in polys.get(name, []):
            pts = (la - bx2) / dx2
            ax.fill(pts[:, 1], pts[:, 0], c=(1.00, 0.50, 0.31), alpha=0.2)
    for la in polys.get("road_divider", []):
        pts = (la - bx2) / dx2
        ax.plot(pts[:, 1], pts[:, 0], c=(0.0, 0.0, 1.0), alpha=0.5)
    for la in polys.get("lane_divider", []):
        pts = (la - bx2) / dx2
        ax.plot(pts[:, 1], pts[:, 0], c=(159.0 / 255.0, 0.0, 1.0), alpha=0.5)


def compose_prediction_figure(imgs: np.ndarray, bev_pred: np.ndarray, bx, dx,
                              polys: Optional[dict] = None,
                              lidar_pts: Optional[np.ndarray] = None,
                              cam_names: Optional[list] = None,
                              out_path: Optional[str] = None):
    """The predict-time figure: the normalised camera frames, imgs (N, 3,
    H, W), around a BEV panel that carries, bottom to top, the local map,
    an optional lidar scatter ((3+, M) ego-frame points,
    `data/lidar.py::get_lidar_data`), the predicted classes (X, Y) and the
    ego car. Returns the matplotlib Figure, saved to `out_path` if given."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = imgs.shape[0]
    fig = plt.figure(figsize=(14, 6))
    gs = fig.add_gridspec(2, n // 2 + 2)
    order = cam_names or ["FRONT_LEFT", "FRONT", "FRONT_RIGHT", "BACK_LEFT", "BACK",
                          "BACK_RIGHT"]
    for i in range(n):
        ax = fig.add_subplot(gs[i // (n // 2), i % (n // 2)])
        ax.imshow(denormalize_img(imgs[i]))
        ax.set_title(order[i] if i < len(order) else f"cam{i}", fontsize=8)
        ax.axis("off")
    ax = fig.add_subplot(gs[:, n // 2:])
    if polys is not None:
        plot_local_map(polys, dx, bx, ax=ax)
    if lidar_pts is not None and lidar_pts.size:
        pts = (lidar_pts[:2].T - np.asarray(bx)[:2]) / np.asarray(dx)[:2]
        ax.scatter(pts[:, 1], pts[:, 0], s=0.2, c="gray", alpha=0.4)
    rgba = np.zeros(bev_pred.shape + (4,), dtype=np.float32)
    color = BEV_PALETTE.astype(np.float32) / 255.0
    for cls in range(1, len(BEV_PALETTE)):
        m = bev_pred == cls
        rgba[m, :3] = color[cls]
        rgba[m, 3] = 0.6
    ax.imshow(rgba, origin="lower")
    add_ego(bx, dx, ax=ax)
    ax.set_xlim(0, bev_pred.shape[1])
    ax.set_ylim(0, bev_pred.shape[0])
    ax.set_aspect("equal")
    ax.set_title("BEV prediction", fontsize=9)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
    return fig
