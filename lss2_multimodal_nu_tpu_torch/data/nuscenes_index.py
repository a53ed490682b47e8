"""Self-contained nuScenes-format metadata index, in numpy.

The original repo uses nuscenes-devkit (`NuScenes(version, dataroot)`) only
to index its JSON tables and for `Box` and quaternion helpers. This module
reads the tables directly and keeps the few geometry helpers the data
pipeline needs (quaternion rotation matrices, 3D box bottom corners) in the
conventions of pyquaternion and the devkit.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

TABLE_NAMES = (
    "scene",
    "sample",
    "sample_data",
    "calibrated_sensor",
    "ego_pose",
    "sensor",
    "sample_annotation",
)


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def quaternion_rotation_matrix(q) -> np.ndarray:
    """pyquaternion-convention (w, x, y, z) quaternion -> 3x3 rotation."""
    w, x, y, z = [float(v) for v in q]
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0.0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ],
        dtype=np.float64,
    )


def quaternion_inverse(q) -> np.ndarray:
    w, x, y, z = [float(v) for v in q]
    n = w * w + x * x + y * y + z * z
    return np.array([w / n, -x / n, -y / n, -z / n])


def quaternion_multiply(a, b) -> np.ndarray:
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def box_bottom_corners(
    center: np.ndarray, size_wlh: np.ndarray, quat: np.ndarray
) -> np.ndarray:
    """nuscenes Box.bottom_corners(): (2, 4) xy of the 4 bottom corners.

    Conventions follow nuscenes.utils.data_classes.Box: size is (w, l, h),
    corners built l/2 on x, w/2 on y, h/2 on z; bottom = corner columns
    [2, 3, 7, 6].
    """
    w, l, h = [float(v) for v in size_wlh]
    x_c = l / 2 * np.array([1, 1, 1, 1, -1, -1, -1, -1], dtype=np.float64)
    y_c = w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1], dtype=np.float64)
    z_c = h / 2 * np.array([1, 1, -1, -1, 1, 1, -1, -1], dtype=np.float64)
    corners = quaternion_rotation_matrix(quat) @ np.vstack([x_c, y_c, z_c])
    corners += np.asarray(center, dtype=np.float64)[:, None]
    return corners[:2, [2, 3, 7, 6]]


class NuScenesIndex:
    """Minimal, read-only stand-in for nuscenes.NuScenes."""

    def __init__(self, version: str, dataroot: str, verbose: bool = False):
        self.version = version
        self.dataroot = dataroot
        table_root = os.path.join(dataroot, version)
        self._tables: Dict[str, List[dict]] = {}
        self._by_token: Dict[str, Dict[str, dict]] = {}
        for name in TABLE_NAMES:
            path = os.path.join(table_root, f"{name}.json")
            rows = _read_json(path) if os.path.isfile(path) else []
            self._tables[name] = rows
            self._by_token[name] = {r["token"]: r for r in rows}
        if not self._tables["sample"]:
            # A wrong dataroot/version otherwise surfaces as a silently empty
            # dataset (zero batches, bare StopIteration deep in training).
            raise FileNotFoundError(
                f"no nuScenes tables under {table_root!r} (missing or empty "
                "sample.json) — expected <dataroot>/<version>/sample.json etc. "
                "Note the CLI joins --dataroot with the version directory "
                "(e.g. --dataroot D --version mini reads D/mini/v1.0-mini/)."
            )
        self._link()
        if verbose:
            for n, rows in self._tables.items():
                print(f"{n}: {len(rows)}")

    # devkit-compatible accessors -----------------------------------------
    def get(self, table: str, token: str) -> dict:
        return self._by_token[table][token]

    @property
    def sample(self) -> List[dict]:
        return self._tables["sample"]

    @property
    def sample_data(self) -> List[dict]:
        return self._tables["sample_data"]

    # ---------------------------------------------------------------------
    def _link(self):
        """Reconstruct the devkit's reverse indices: sample['data'][channel]
        and sample['anns']."""
        sensors = self._by_token["sensor"]
        calibs = self._by_token["calibrated_sensor"]
        for s in self._tables["sample"]:
            s.setdefault("data", {})
            s.setdefault("anns", [])
        for sd in self._tables["sample_data"]:
            calib = calibs.get(sd["calibrated_sensor_token"])
            channel = None
            if calib is not None and calib.get("sensor_token") in sensors:
                channel = sensors[calib["sensor_token"]]["channel"]
            sd["channel"] = channel or sd.get("channel", "")
            if sd.get("is_key_frame"):
                samp = self._by_token["sample"].get(sd["sample_token"])
                if samp is not None and sd["channel"]:
                    samp["data"][sd["channel"]] = sd["token"]
        for ann in self._tables["sample_annotation"]:
            samp = self._by_token["sample"].get(ann["sample_token"])
            if samp is not None:
                samp["anns"].append(ann["token"])
