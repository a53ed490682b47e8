"""The offline BEV map labels: the `local_binmap/<token>.npy` rasters
(drivable area 2, dividers 3, 200x200 around the ego car) that the dataset
reads, made from a nuScenes map-expansion JSON.

`NuScenesMapLite` reads the part of the nuScenes devkit's map API that the
original repo uses (polygon and line records, the records whose bounding box
meets a patch); `get_local_map` takes the patch's polygons and lines into
the ego frame; `rasterize_local_map` fills them with OpenCV's `fillPoly`
(`data/raster.py`), dividers as polygons over their polylines, as the
original does."""
from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

from ..core.augment import get_rot
from .nuscenes_index import NuScenesIndex, quaternion_rotation_matrix
from .raster import fill_poly

POLY_LAYERS = ("road_segment", "lane")
LINE_LAYERS = ("road_divider", "lane_divider")


class NuScenesMapLite:
    """One map location's expansion JSON, with its polygons' and lines'
    points."""

    def __init__(self, dataroot: str, map_name: str):
        with open(os.path.join(dataroot, "maps", "expansion", f"{map_name}.json")) as f:
            data = json.load(f)
        nodes = {n["token"]: (n["x"], n["y"]) for n in data.get("node", [])}
        self._layers: Dict[str, List[dict]] = {
            name: data.get(name, []) for name in POLY_LAYERS + LINE_LAYERS
        }
        self._poly_pts: Dict[str, np.ndarray] = {}
        for poly in data.get("polygon", []):
            pts = np.array([nodes[t] for t in poly.get("exterior_node_tokens", [])],
                           dtype=np.float64)
            if len(pts):
                self._poly_pts[poly["token"]] = pts
        self._line_pts: Dict[str, np.ndarray] = {}
        for line in data.get("line", []):
            pts = np.array([nodes[t] for t in line.get("node_tokens", [])], dtype=np.float64)
            if len(pts):
                self._line_pts[line["token"]] = pts

    def extract_polygon(self, token: str) -> np.ndarray:
        return self._poly_pts.get(token, np.zeros((0, 2)))

    def extract_line(self, token: str) -> np.ndarray:
        return self._line_pts.get(token, np.zeros((0, 2)))

    @staticmethod
    def _polygon_tokens(rec: dict) -> List[str]:
        return [rec["polygon_token"]] if "polygon_token" in rec else rec.get("polygon_tokens", [])

    def records_in_patch(self, box, layer_names: Sequence[str]) -> Dict[str, List[str]]:
        """For each layer, the tokens of the records one of whose polygons'
        bounding box meets box = (x0, y0, x1, y1) (the devkit's intersect
        mode)."""
        x0, y0, x1, y1 = box
        out: Dict[str, List[str]] = {}
        for name in layer_names:
            toks = []
            for rec in self._layers[name]:
                for pt in self._polygon_tokens(rec):
                    pts = self._poly_pts.get(pt)
                    if pts is None:
                        continue
                    if (pts[:, 0].max() >= x0 and pts[:, 0].min() <= x1
                            and pts[:, 1].max() >= y0 and pts[:, 1].min() <= y1):
                        toks.append(rec["token"])
                        break
            out[name] = toks
        return out


def get_local_map(nmap: NuScenesMapLite, center, stretch: float) -> Dict[str, List[np.ndarray]]:
    """The polygons of the records that meet the square of half-side
    `stretch` around center = (x, y, cos yaw, sin yaw), and every divider
    line, in the ego frame: {layer: [(K, 2) points]}."""
    box = (center[0] - stretch, center[1] - stretch, center[0] + stretch, center[1] + stretch)
    polys: Dict[str, List[np.ndarray]] = {}
    recs = nmap.records_in_patch(box, POLY_LAYERS)
    for layer in POLY_LAYERS:
        polys[layer] = []
        wanted = set(recs[layer])
        for rec in nmap._layers[layer]:
            if rec["token"] not in wanted:
                continue
            for pt in nmap._polygon_tokens(rec):
                arr = nmap.extract_polygon(pt)
                if len(arr):
                    polys[layer].append(arr.copy())
    for layer in LINE_LAYERS:
        polys[layer] = []
        for rec in nmap._layers[layer]:
            arr = nmap.extract_line(rec["line_token"]) if "line_token" in rec else None
            if arr is not None and len(arr):
                polys[layer].append(arr.copy())
    rot = get_rot(np.arctan2(center[3], center[2])).T
    for layer in polys:
        polys[layer] = [(p - center[:2]) @ rot for p in polys[layer]]
    return polys


def rasterize_local_map(polys, dx, bx, size=(200, 200)) -> np.ndarray:
    """The local map as an int raster: drivable polygons 2, then dividers
    3 over them."""
    backg = np.zeros(size, dtype=np.float64)
    for layers, value in ((POLY_LAYERS, 2.0), (LINE_LAYERS, 3.0)):
        for layer in layers:
            for la in polys[layer]:
                fill_poly(backg, np.round((la - bx[:2]) / dx[:2]).astype(np.int32), value)
    return backg.astype(int)


def generate_binmaps(nusc: NuScenesIndex, map_root: str, scene_to_map: Dict[str, str],
                     out_dir: str, dx, bx) -> int:
    """Write `out_dir/<sample token>.npy`, the local map raster around the
    ego pose of each sample's lidar, for every sample; returns how many."""
    os.makedirs(out_dir, exist_ok=True)
    maps: Dict[str, NuScenesMapLite] = {}
    n = 0
    for rec in nusc.sample:
        map_name = scene_to_map[nusc.get("scene", rec["scene_token"])["name"]]
        if map_name not in maps:
            maps[map_name] = NuScenesMapLite(map_root, map_name)
        ego = nusc.get("ego_pose",
                       nusc.get("sample_data", rec["data"]["LIDAR_TOP"])["ego_pose_token"])
        r = quaternion_rotation_matrix(ego["rotation"])
        yaw = np.arctan2(r[1, 0], r[0, 0])
        center = np.array([ego["translation"][0], ego["translation"][1], np.cos(yaw),
                           np.sin(yaw)])
        polys = get_local_map(maps[map_name], center, 50.0)
        raster = rasterize_local_map(polys, np.asarray(dx), np.asarray(bx))
        np.save(os.path.join(out_dir, rec["token"] + ".npy"), raster)
        n += 1
    return n
