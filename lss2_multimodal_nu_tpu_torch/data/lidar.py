"""Lidar sweeps in the ego frame, for visualisation (`VizDataset`)."""
from __future__ import annotations

import os

import numpy as np

from .nuscenes_index import NuScenesIndex, quaternion_rotation_matrix


def _transform_matrix(translation, rotation, inverse: bool = False) -> np.ndarray:
    tm = np.eye(4)
    r = quaternion_rotation_matrix(rotation)
    t = np.asarray(translation, dtype=np.float64)
    if inverse:
        tm[:3, :3] = r.T
        tm[:3, 3] = -(r.T @ t)
    else:
        tm[:3, :3] = r
        tm[:3, 3] = t
    return tm


def load_pointcloud(path: str) -> np.ndarray:
    """A nuScenes `.pcd.bin`: float32 rows (x, y, z, intensity, ring) ->
    (5, N)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 5).T


def remove_close(points: np.ndarray, min_distance: float) -> np.ndarray:
    """The points outside the square of half-side `min_distance` around the
    sensor."""
    keep = ~((np.abs(points[0]) < min_distance) & (np.abs(points[1]) < min_distance))
    return points[:, keep]


def get_lidar_data(nusc: NuScenesIndex, sample_rec: dict, nsweeps: int,
                   min_distance: float) -> np.ndarray:
    """At most `nsweeps` lidar sweeps, from the sample's back through its
    `prev` links, in the sample's ego frame: (5, N) rows x, y, z,
    reflectance, and the sweep's time lag in seconds."""
    points = np.zeros((5, 0))
    ref_sd = nusc.get("sample_data", sample_rec["data"]["LIDAR_TOP"])
    ref_pose = nusc.get("ego_pose", ref_sd["ego_pose_token"])
    ref_time = 1e-6 * ref_sd["timestamp"]
    car_from_global = _transform_matrix(ref_pose["translation"], ref_pose["rotation"],
                                        inverse=True)
    cur = ref_sd
    for _ in range(nsweeps):
        pc = remove_close(load_pointcloud(os.path.join(nusc.dataroot, cur["filename"])),
                          min_distance)
        pose = nusc.get("ego_pose", cur["ego_pose_token"])
        global_from_car = _transform_matrix(pose["translation"], pose["rotation"])
        cs = nusc.get("calibrated_sensor", cur["calibrated_sensor_token"])
        car_from_current = _transform_matrix(cs["translation"], cs["rotation"])
        tm = car_from_global @ global_from_car @ car_from_current
        xyz1 = np.vstack([pc[:3], np.ones((1, pc.shape[1]))])
        pc[:3] = (tm @ xyz1)[:3]
        pc[4] = ref_time - 1e-6 * cur["timestamp"]  # the ring's row holds the time lag
        points = np.concatenate([points, pc], axis=1)
        if not cur.get("prev"):
            break
        cur = nusc.get("sample_data", cur["prev"])
    return points
