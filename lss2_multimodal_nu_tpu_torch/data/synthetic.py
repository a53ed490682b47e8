"""Synthetic nu-A2D fixture: a small on-disk dataset in nuScenes format
(JSON tables, camera JPEGs, and the local_binmap / action_all / desc_all
sidecars), made from a seed, so that the data pipeline and training run
without a download.

It writes what the JAX package's `data/synthetic.py::generate` writes from
the same seed: the same JSON tables and sidecars byte for byte, and the
same JPEG files, which the port encodes itself (`data/jpeg.py::encode`, the
file PIL's `save(quality=95)` writes). The random stream is consumed in the
same order. The cameras may be rendered and encoded in a process pool
(`workers`): the calling process draws each camera's noise from the one
stream, in order, and the workers do the rest.

The fixture is learnable: each sample is a random ground-plane scene (a road
rectangle, lane dividers, vehicle footprints, in the ego frame) rendered
into all three label surfaces:

  * camera JPEGs, by casting each pixel's ray through the calibrated
    intrinsics and extrinsics onto the z=0 ground plane and colouring it by
    class, so the BEV labels are recoverable through the camera model the
    LSS lift uses;
  * `local_binmap` sidecars, stored pre-inverted so that the loader's
    fliplr + rot90 lands them back on the ego-frame raster;
  * `sample_annotation` boxes for the vehicles, which `get_binimg`
    rasterises with the footprint the images show.

The act/desc labels are deterministic functions of the scene.
"""
from __future__ import annotations

import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional

import numpy as np

from .jpeg import encode
from .splits import create_splits_scenes

CAMS = (
    "CAM_FRONT_LEFT",
    "CAM_FRONT",
    "CAM_FRONT_RIGHT",
    "CAM_BACK_LEFT",
    "CAM_BACK",
    "CAM_BACK_RIGHT",
)

# outward camera yaws (rad), roughly the nuScenes rig layout
_CAM_YAW = {
    "CAM_FRONT_LEFT": np.deg2rad(55.0),
    "CAM_FRONT": 0.0,
    "CAM_FRONT_RIGHT": np.deg2rad(-55.0),
    "CAM_BACK_LEFT": np.deg2rad(125.0),
    "CAM_BACK": np.pi,
    "CAM_BACK_RIGHT": np.deg2rad(-125.0),
}
_CAM_HEIGHT = 1.55
_CAM_RADIUS = 1.2

# class -> render colour (uint8 RGB); distinct, roughly road-scene-like
_COLORS = np.array(
    [
        [105, 105, 95],  # 0 background ground
        [200, 40, 40],  # 1 vehicle footprint
        [45, 45, 52],  # 2 drivable area
        [235, 235, 228],  # 3 divider
    ],
    dtype=np.float32,
)
_SKY = np.array([135, 170, 220], dtype=np.float32)


def _tok(kind: str, i: int) -> str:
    return f"{kind}{i:06d}"


def _quat_from_matrix(m: np.ndarray) -> list:
    """Rotation matrix -> (w, x, y, z) quaternion (Shepperd's method)."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s]
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s,
             (m[0, 2] + m[2, 0]) / s]
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s,
             (m[1, 2] + m[2, 1]) / s]
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
             (m[1, 2] + m[2, 1]) / s, 0.25 * s]
    return [float(v) for v in q]


def _cam_pose(cam: str):
    """(R cam->ego, t cam-in-ego, quaternion) for an outward-facing camera.

    nuScenes camera convention: x right, y down, z forward (optical axis).
    """
    yaw = _CAM_YAW[cam]
    c, s = np.cos(yaw), np.sin(yaw)
    right = np.array([s, -c, 0.0])
    down = np.array([0.0, 0.0, -1.0])
    fwd = np.array([c, s, 0.0])
    rot = np.stack([right, down, fwd], axis=1)
    tran = np.array([_CAM_RADIUS * c, _CAM_RADIUS * s, _CAM_HEIGHT])
    return rot, tran, _quat_from_matrix(rot)


def _make_scene(rng: np.random.Generator) -> dict:
    """Random ground-plane scene in the ego frame: one road rectangle, 1-2
    dividers along it, 5-10 vehicles on it. All rects: (cx, cy, half_long,
    half_lat, yaw) with half_long along the yaw direction.

    Densities keep the sparse classes learnable at fixture training budgets:
    vehicles cover about 0.8% and dividers about 2% of BEV pixels."""
    theta = float(rng.uniform(0, np.pi))
    half_w = float(rng.uniform(5.0, 10.0))
    road = (float(rng.uniform(-6, 6)), float(rng.uniform(-6, 6)),
            70.0, half_w, theta)
    d = np.array([np.cos(theta), np.sin(theta)])
    n = np.array([-np.sin(theta), np.cos(theta)])
    offsets = [0.0]
    if rng.random() < 0.5:  # second divider only sometimes, so the
        offsets.append(float(rng.choice([-0.5, 0.5])) * half_w)  # desc[4]
        # label has both positives and negatives
    dividers = []
    for off in offsets:
        c = np.array(road[:2]) + off * n
        dividers.append((float(c[0]), float(c[1]), 70.0, 0.6, theta))
    vehicles = []
    for _ in range(int(rng.integers(5, 11))):
        along = float(rng.uniform(5.0, 38.0)) * float(rng.choice([-1.0, 1.0]))
        lat = float(rng.uniform(-0.8, 0.8)) * (half_w - 1.5)
        c = np.array(road[:2]) + along * d + lat * n
        vyaw = theta if rng.random() < 0.5 else theta + np.pi
        vehicles.append((float(c[0]), float(c[1]), 2.4, 1.1, float(vyaw)))
    return {"road": road, "dividers": dividers, "vehicles": vehicles}


def _paint(grid_xy: np.ndarray, rects, cls: int, out: np.ndarray) -> None:
    """Paint rotated rectangles onto a class raster. grid_xy: (..., 2) ego
    xy of cell centres; out: int raster of matching leading shape."""
    for cx, cy, hl, hw, yaw in rects:
        d = np.array([np.cos(yaw), np.sin(yaw)])
        rel = grid_xy - np.array([cx, cy])
        u = rel @ d
        v = rel @ np.array([-d[1], d[0]])
        out[(np.abs(u) <= hl) & (np.abs(v) <= hw)] = cls


def _scene_raster(scene: dict, n: int, res: float, vehicles: bool) -> np.ndarray:
    """Class raster indexed [x_idx, y_idx] over [-n*res/2, n*res/2)^2 with
    cell centres at (i + 0.5) * res - n*res/2."""
    ax = (np.arange(n) + 0.5) * res - n * res / 2.0
    gx, gy = np.meshgrid(ax, ax, indexing="ij")
    grid = np.stack([gx, gy], axis=-1)
    out = np.zeros((n, n), dtype=np.int64)
    _paint(grid, [scene["road"]], 2, out)
    _paint(grid, scene["dividers"], 3, out)
    if vehicles:
        _paint(grid, scene["vehicles"], 1, out)
    return out


def _shade(scene_fine: np.ndarray, res: float, intrin, rot, tran, h: int, w: int) -> np.ndarray:
    """Ray-cast the ground-plane scene through the camera: for every pixel,
    intersect the ray (R @ K^-1 [u v 1]) with z=0 and colour it by the scene
    class there, (h, w, 3) float32 before the noise. The exact inverse of the
    LSS lift geometry (core/geometry.get_geometry), so BEV labels are
    recoverable from pixels."""
    fx, fy = intrin[0][0], intrin[1][1]
    cx, cy = intrin[0][2], intrin[1][2]
    u, v = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
    d_cam = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1)
    d_ego = d_cam @ rot.T  # (h, w, 3)
    below = d_ego[..., 2] < -1e-6
    s = np.where(below, -tran[2] / np.where(below, d_ego[..., 2], -1.0), np.inf)
    gx = np.where(below, tran[0] + s * d_ego[..., 0], 0.0)
    gy = np.where(below, tran[1] + s * d_ego[..., 1], 0.0)
    half = scene_fine.shape[0] * res / 2.0
    ix = np.floor((gx + half) / res).astype(np.int64)
    iy = np.floor((gy + half) / res).astype(np.int64)
    inb = below & (ix >= 0) & (ix < scene_fine.shape[0]) \
        & (iy >= 0) & (iy < scene_fine.shape[1])
    cls = np.where(inb, scene_fine[np.clip(ix, 0, scene_fine.shape[0] - 1),
                                   np.clip(iy, 0, scene_fine.shape[1] - 1)], 0)
    return np.where(below[..., None], _COLORS[cls], _SKY[None, None])


def _render_and_write(path: str, noise: np.ndarray, *shade_args) -> None:
    """The camera image (`_shade` plus the noise drawn by the caller, from
    the fixture's one stream) written as a JPEG."""
    img = np.clip(_shade(*shade_args) + noise, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode(img, quality=95))


def _act_desc(scene: dict):
    """Deterministic txt labels from the scene (learnable by the heads)."""
    road = scene["road"]
    vehicles = scene["vehicles"]
    vx = np.array([v[0] for v in vehicles])
    vy = np.array([v[1] for v in vehicles])
    dist = np.hypot(vx, vy)
    # thresholds sit near the medians of the scene distribution so every
    # column has both positives and negatives (a column that is constant in
    # the fixture can only ever score F1 0 or 1 — not learnable evidence)
    act = [
        float(abs(np.cos(road[4])) > 0.7),  # road runs mostly fore-aft
        float(len(vehicles) >= 8),
        float(bool(np.any((vx > 3.0) & (dist < 20.0)))),  # vehicle ahead
        float(bool(np.any((vx < -3.0) & (dist < 20.0)))),  # vehicle behind
    ]
    desc = [
        float(np.count_nonzero((vx > 0) & (vy > 0)) >= 2),
        float(np.count_nonzero((vx > 0) & (vy <= 0)) >= 2),
        float(np.count_nonzero((vx <= 0) & (vy > 0)) >= 2),
        float(np.count_nonzero((vx <= 0) & (vy <= 0)) >= 2),
        float(len(scene["dividers"]) >= 2),
        float(road[3] > 7.5),  # wide road
        float(bool(np.any(dist < 12.0))),  # close vehicle
        float(len(vehicles) >= 9),
    ]
    return act, desc


def generate(
    root: str,
    version: str = "v1.0-mini",
    scenes: Optional[List[str]] = None,
    samples_per_scene: int = 2,
    img_hw=(90, 160),
    seed: int = 0,
    scenes_out: Optional[list] = None,
    workers: int = 0,
) -> str:
    """Create the fixture: JSON tables under `root/<version>/`, media and
    sidecars (samples/, local_binmap/, action_all/, desc_all/) directly under
    `root`, the layout of one nuScenes `dataroot/version` directory. With
    `workers`, that many processes render, encode and write the camera
    images. Returns `root`."""
    pool = None
    if workers:
        pool = ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))
    pending = []
    try:
        _generate(root, version, scenes, samples_per_scene, img_hw, seed, scenes_out, pool,
                  pending)
        for f in pending:
            f.result()
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    return root


def _dump_json(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def _generate(root, version, scenes, samples_per_scene, img_hw, seed, scenes_out, pool,
              pending) -> None:
    rng = np.random.default_rng(seed)
    if scenes is None:
        sp = create_splits_scenes("nu_a2d")
        scenes = sp["mini_train"][:2] + sp["mini_val"][:1]
    ver_dir = root
    tbl_dir = os.path.join(root, version)
    os.makedirs(tbl_dir, exist_ok=True)

    sensors, calibs, ego_poses, samples, sample_datas, scene_rows, anns = (
        [], [], [], [], [], [], [])

    # sensors: 6 cams + lidar
    for i, ch in enumerate(list(CAMS) + ["LIDAR_TOP"]):
        sensors.append(
            {"token": _tok("sen", i), "channel": ch,
             "modality": "camera" if ch != "LIDAR_TOP" else "lidar"}
        )

    h, w = img_hw
    fidx = 0
    for si, scene_name in enumerate(scenes):
        scene_tok = _tok("scene", si)
        first = last = None
        for sj in range(samples_per_scene):
            i = si * samples_per_scene + sj
            samp_tok = _tok("samp", i)
            if first is None:
                first = samp_tok
            last = samp_tok
            samples.append(
                {
                    "token": samp_tok,
                    "scene_token": scene_tok,
                    "timestamp": 1_000_000 * (i + 1),
                    "prev": "", "next": "",
                }
            )
            # ego pose (identity rotation: ego frame == world - translation,
            # so scene geometry authored in the ego frame round-trips through
            # get_binimg's pose inverse exactly)
            ego_tok = _tok("ego", i)
            ego_t = rng.uniform(-100, 100, 3)
            ego_t[2] = 0.0
            ego_poses.append(
                {
                    "token": ego_tok,
                    "translation": ego_t.tolist(),
                    "rotation": [1.0, 0.0, 0.0, 0.0],
                    "timestamp": 1_000_000 * (i + 1),
                }
            )
            # the sample's ground-plane scene (drives images + all labels)
            scene = _make_scene(rng)
            if scenes_out is not None:
                scenes_out.append((samp_tok, scene))
            scene_fine = _scene_raster(scene, n=400, res=0.25, vehicles=True)
            # per-camera sample_data + calibrated sensor
            for ci, cam in enumerate(CAMS):
                calib_tok = _tok("cal", fidx)
                intrin = [[1266.0 * w / 1600, 0.0, w / 2],
                          [0.0, 1266.0 * w / 1600, h / 2],
                          [0.0, 0.0, 1.0]]
                rot, tran, quat = _cam_pose(cam)
                calibs.append(
                    {
                        "token": calib_tok,
                        "sensor_token": _tok("sen", ci),
                        "translation": tran.tolist(),
                        "rotation": quat,
                        "camera_intrinsic": intrin,
                    }
                )
                fname = f"samples/{cam}/{samp_tok}_{cam}.jpg"
                os.makedirs(os.path.join(ver_dir, "samples", cam), exist_ok=True)
                args = (os.path.join(ver_dir, fname), rng.normal(0.0, 5.0, (h, w, 3)),
                        scene_fine, 0.25, intrin, rot, tran, h, w)
                if pool is None:
                    _render_and_write(*args)
                else:
                    pending.append(pool.submit(_render_and_write, *args))
                sample_datas.append(
                    {
                        "token": _tok("sd", fidx),
                        "sample_token": samp_tok,
                        "calibrated_sensor_token": calib_tok,
                        "ego_pose_token": ego_tok,
                        "filename": fname,
                        "is_key_frame": True,
                        "fileformat": "jpg",
                        "timestamp": 1_000_000 * (i + 1),
                    }
                )
                fidx += 1
            # lidar sample_data (pose carrier for get_binimg)
            calib_tok = _tok("cal", fidx)
            calibs.append(
                {
                    "token": calib_tok,
                    "sensor_token": _tok("sen", 6),
                    "translation": [0.0, 0.0, 1.8],
                    "rotation": [1.0, 0.0, 0.0, 0.0],
                    "camera_intrinsic": [],
                }
            )
            lidar_fname = f"samples/LIDAR_TOP/{samp_tok}.pcd.bin"
            os.makedirs(os.path.join(ver_dir, "samples", "LIDAR_TOP"), exist_ok=True)
            pts = rng.uniform(-40, 40, size=(128, 5)).astype(np.float32)
            pts[:, 3] = rng.uniform(0, 255, 128)  # intensity
            pts[:, 4] = 0.0  # ring
            pts.tofile(os.path.join(ver_dir, lidar_fname))
            sample_datas.append(
                {
                    "token": _tok("sd", fidx),
                    "sample_token": samp_tok,
                    "calibrated_sensor_token": calib_tok,
                    "ego_pose_token": ego_tok,
                    "filename": lidar_fname,
                    "is_key_frame": True,
                    "fileformat": "pcd",
                    "timestamp": 1_000_000 * (i + 1),
                    "prev": "",
                }
            )
            fidx += 1
            # vehicle annotations: the scene's vehicles, in world frame
            # (ego rotation is identity so world = ego + ego_t); get_binimg
            # rasterizes these bottom corners back onto the BEV grid with
            # the same footprint the rendered images show
            for vi, (vcx, vcy, hl, hw_v, vyaw) in enumerate(scene["vehicles"]):
                anns.append(
                    {
                        "token": _tok("ann", i * 16 + vi),
                        "sample_token": samp_tok,
                        "category_name": "vehicle.car",
                        "translation": [vcx + ego_t[0], vcy + ego_t[1], 0.8],
                        "size": [2 * hw_v, 2 * hl, 1.6],
                        "rotation": [float(np.cos(vyaw / 2)), 0.0, 0.0,
                                     float(np.sin(vyaw / 2))],
                    }
                )
            # sidecar labels: the binmap stores road+dividers pre-inverted so
            # the loader's fliplr + rot90 (data/dataset.py get_binimg)
            # recovers the ego raster; txt labels are scene-derived
            ego_raster = _scene_raster(scene, n=200, res=0.5, vehicles=False)
            act_lbl, desc_lbl = _act_desc(scene)
            for d, payload in (
                ("local_binmap", None),
                ("action_all", act_lbl),
                ("desc_all", desc_lbl),
            ):
                os.makedirs(os.path.join(ver_dir, d), exist_ok=True)
                if d == "local_binmap":
                    m = np.fliplr(np.rot90(ego_raster, -1))
                    np.save(os.path.join(ver_dir, d, samp_tok + ".npy"),
                            np.ascontiguousarray(m))
                else:
                    _dump_json(payload, os.path.join(ver_dir, d, samp_tok + ".json"))
        scene_rows.append(
            {
                "token": scene_tok,
                "name": scene_name,
                "first_sample_token": first,
                "last_sample_token": last,
                "nbr_samples": samples_per_scene,
            }
        )

    tables = {
        "scene": scene_rows,
        "sample": samples,
        "sample_data": sample_datas,
        "calibrated_sensor": calibs,
        "ego_pose": ego_poses,
        "sensor": sensors,
        "sample_annotation": anns,
    }
    for name, rows in tables.items():
        _dump_json(rows, os.path.join(tbl_dir, f"{name}.json"))


def generate_map_expansion(root: str, map_name: str = "boston-seaport", seed: int = 0):
    """Write a tiny nuScenes map-expansion JSON (nodes/polygons/lines +
    road_segment/lane/dividers) covering [-150, 150]^2 so map_gen can run."""
    rng = np.random.default_rng(seed)
    nodes, polygons, lines = [], [], []
    road_segments, lanes, road_dividers, lane_dividers = [], [], [], []

    def add_node(x, y):
        tok = _tok("node", len(nodes))
        nodes.append({"token": tok, "x": float(x), "y": float(y)})
        return tok

    def add_rect_poly(cx, cy, w, h):
        toks = [
            add_node(cx - w / 2, cy - h / 2),
            add_node(cx + w / 2, cy - h / 2),
            add_node(cx + w / 2, cy + h / 2),
            add_node(cx - w / 2, cy + h / 2),
        ]
        ptok = _tok("poly", len(polygons))
        polygons.append({"token": ptok, "exterior_node_tokens": toks, "holes": []})
        return ptok

    for i in range(4):
        cx, cy = rng.uniform(-120, 120, 2)
        p = add_rect_poly(cx, cy, rng.uniform(40, 90), rng.uniform(40, 90))
        road_segments.append({"token": _tok("rs", i), "polygon_token": p})
    for i in range(3):
        cx, cy = rng.uniform(-120, 120, 2)
        p = add_rect_poly(cx, cy, rng.uniform(10, 30), rng.uniform(60, 120))
        lanes.append({"token": _tok("lane", i), "polygon_token": p})
    for i in range(3):
        x0, y0 = rng.uniform(-120, 120, 2)
        toks = [add_node(x0 + 10 * k, y0 + rng.uniform(-2, 2)) for k in range(8)]
        ltok = _tok("line", len(lines))
        lines.append({"token": ltok, "node_tokens": toks})
        (road_dividers if i % 2 == 0 else lane_dividers).append(
            {"token": _tok("div", i), "line_token": ltok}
        )

    data = {
        "node": nodes, "polygon": polygons, "line": lines,
        "road_segment": road_segments, "lane": lanes,
        "road_divider": road_dividers, "lane_divider": lane_dividers,
    }
    out = os.path.join(root, "maps", "expansion")
    os.makedirs(out, exist_ok=True)
    _dump_json(data, os.path.join(out, f"{map_name}.json"))
    return os.path.join(out, f"{map_name}.json")
