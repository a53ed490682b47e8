"""nu-A2D dataset: the host stage of the pipeline, and the device stage of a
batch.

An item comes out as the JAX package's `data/dataset.py::NuA2DDataset`
gives it, but NCHW and in torch: imgs (N, 3, fH, fW) float32, rots, trans,
intrins, post_rots, post_trans, binimg (X, Y) int64, and with `with_txt`
act (4,) and desc (8,). It is made in two stages:

  * the host stage (`host_item`, run by the loader's workers): the camera
    JPEGs read and entropy-decoded to DCT coefficients (`data/jpeg.py`),
    the augmentation drawn (`core/augment.py`, one generator per item from
    (seed, epoch, index)), the BEV labels rasterised (`get_binimg`, with
    OpenCV's polygon fill in `data/raster.py`), the txt labels read;
  * the device stage (`device_stage`, per batch in the consumer): kernel 6
    (`ops/jpeg_idct.py`) decodes every camera image to RGB, kernel 7
    (`ops/img_aug.py`) resizes, crops, flips, rotates and normalises it.

On the card the host decodes with the C++ entropy decoder and the device
stage runs the kernels; on the CPU (`device="cpu"`) both run their plain
versions. Either gives the JAX loader's batches bit for bit.
"""
from __future__ import annotations

import json
import os
from glob import glob
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import AugConfig, GridConfig
from ..core.augment import accumulate_post_transform, expand_to_3x3, sample_augmentation
from ..core.grid import gen_dx_bx
from ..ops import img_aug, jpeg_idct
from .jpeg import decode_coefficients
from .nuscenes_index import (
    NuScenesIndex,
    box_bottom_corners,
    quaternion_inverse,
    quaternion_multiply,
    quaternion_rotation_matrix,
)
from .raster import fill_poly
from .splits import create_splits_scenes

LABELS = ("rots", "trans", "intrins", "post_rots", "post_trans", "binimg", "act", "desc")


class NuA2DDataset:
    """Map-style dataset over nu-A2D keyframes."""

    def __init__(
        self,
        nusc: NuScenesIndex,
        is_train: bool,
        aug: AugConfig,
        grid: GridConfig,
        data_root: str,
        split: Optional[str] = None,  # 'train' | 'val' | 'test' | 'mini_train' | ...
        split_family: str = "nu_a2d",
        with_txt: bool = True,
        rng=None,
        device="cuda",
    ):
        self.nusc = nusc
        self.is_train = is_train
        self.aug = aug
        self.grid = grid
        self.dataroot = data_root
        self.with_txt = with_txt
        self.device = torch.device(device)
        # one generator per item from (seed, epoch, index): the loader's
        # threads share the dataset, and a Generator is not thread-safe.
        # seed None draws from the OS's entropy, as the original repo does
        if rng is None:
            self._seed = None
        elif isinstance(rng, (int, np.integer)):
            self._seed = int(rng)
        else:
            self._seed = int(rng.integers(0, 2**31 - 1))
        self._epoch = 0

        if split is None:
            split = {
                "v1.0-trainval": {True: "train", False: "val"},
                "v1.0-mini": {True: "mini_train", False: "mini_val"},
            }[nusc.version][is_train]
        self.scenes = create_splits_scenes(split_family)[split]
        self.ixes = self._prepro()
        self.dx, self.bx, self.nx = gen_dx_bx(grid.xbound, grid.ybound, grid.zbound)
        self._fix_nuscenes_formatting()

    def set_epoch(self, epoch: int):
        """Advance the augmentation stream (the loader calls it per epoch)."""
        self._epoch = int(epoch)

    def _item_rng(self, index: int) -> np.random.Generator:
        if self._seed is None:
            return np.random.default_rng()
        return np.random.default_rng((self._seed, self._epoch, index))

    def _fix_nuscenes_formatting(self):
        """Path self-healing for sharded storage layouts: if
        `samples/CAM_X/f.jpg` is missing, look for
        `samples/<shard>/samples/CAM_X/f.jpg` and rewrite the filenames."""
        if not self.ixes:
            return
        rec = self.ixes[0]
        samp = self.nusc.get("sample_data", rec["data"][self.aug.cams[1]])
        if os.path.isfile(os.path.join(self.nusc.dataroot, samp["filename"])):
            return
        print("adjusting nuscenes file paths")
        info = {}
        pats = [
            os.path.join(self.nusc.dataroot, "samples/*/samples/CAM*/*.jpg"),
            os.path.join(self.nusc.dataroot, "samples/*/samples/LIDAR_TOP/*.pcd.bin"),
            os.path.join(self.nusc.dataroot, "sweeps/*/sweeps/LIDAR_TOP/*.pcd.bin"),
        ]
        for pat in pats:
            for f in glob(pat):
                parts = f.split(os.sep)
                di, fi = parts[-2], parts[-1]
                rel = os.sep.join(parts[-5:])
                top = parts[-5]  # 'samples' or 'sweeps'
                info[f"{top}/{di}/{fi}"] = rel
        for sd in self.nusc.sample_data:
            key = sd["filename"]
            if key in info:
                sd["filename"] = info[key]

    def _prepro(self) -> List[dict]:
        samples = [
            s
            for s in self.nusc.sample
            if self.nusc.get("scene", s["scene_token"])["name"] in self.scenes
        ]
        samples.sort(key=lambda x: (x["scene_token"], x["timestamp"]))
        return samples

    def __len__(self) -> int:
        return len(self.ixes)

    def get_image_data(self, rec: dict, cams: Sequence[str], rng=None) -> Dict[str, list]:
        """Per camera: its JPEG as coefficients, its augmentation drawn from
        `rng`, its calibration and the augmentation's affine."""
        rng = rng if rng is not None else np.random.default_rng()
        library = self.device.type == "cuda"
        out = {k: [] for k in ("jpeg", "aug", "rots", "trans", "intrins", "post_rots",
                               "post_trans")}
        for cam in cams:
            samp = self.nusc.get("sample_data", rec["data"][cam])
            with open(os.path.join(self.nusc.dataroot, samp["filename"]), "rb") as f:
                out["jpeg"].append(decode_coefficients(f.read(), library=library))
            sens = self.nusc.get("calibrated_sensor", samp["calibrated_sensor_token"])
            params = sample_augmentation(self.aug, self.is_train, rng)
            pr3, pt3 = expand_to_3x3(*accumulate_post_transform(params))
            out["aug"].append(params)
            out["intrins"].append(np.asarray(sens["camera_intrinsic"], dtype=np.float32))
            out["rots"].append(quaternion_rotation_matrix(sens["rotation"]).astype(np.float32))
            out["trans"].append(np.asarray(sens["translation"], dtype=np.float32))
            out["post_rots"].append(pr3)
            out["post_trans"].append(pt3)
        for k in ("rots", "trans", "intrins", "post_rots", "post_trans"):
            out[k] = np.stack(out[k])
        return out

    def get_binimg(self, rec: dict) -> np.ndarray:
        """The precomputed map raster plus the vehicles' footprints: classes
        {0 background, 1 vehicle, 2 drivable, 3 divider}, (X, Y) int64."""
        egopose = self.nusc.get(
            "ego_pose",
            self.nusc.get("sample_data", rec["data"]["LIDAR_TOP"])["ego_pose_token"],
        )
        trans = -np.array(egopose["translation"])
        rot_inv = quaternion_inverse(egopose["rotation"])

        img = np.zeros((int(self.nx[0]), int(self.nx[1])), dtype=np.float64)
        map_path = os.path.join(self.dataroot, "local_binmap", rec["token"] + ".npy")
        map_np = np.load(map_path)
        map_np = np.rot90(np.fliplr(map_np), 1).astype(float)
        if map_np.shape != img.shape:
            # binmaps are made offline at the 200x200 grid; another grid takes
            # the ego-centred crop (or pad)
            oy = (map_np.shape[0] - img.shape[0]) // 2
            ox = (map_np.shape[1] - img.shape[1]) // 2
            if oy >= 0 and ox >= 0:
                map_np = map_np[oy : oy + img.shape[0], ox : ox + img.shape[1]]
            else:
                pad_y, pad_x = max(-oy, 0), max(-ox, 0)
                map_np = np.pad(map_np, ((pad_y, pad_y), (pad_x, pad_x)))[
                    : img.shape[0], : img.shape[1]
                ]
        img += map_np

        for tok in rec["anns"]:
            inst = self.nusc.get("sample_annotation", tok)
            if inst["category_name"].split(".")[0] != "vehicle":
                continue
            center = np.asarray(inst["translation"], dtype=np.float64) + trans
            center = quaternion_rotation_matrix(rot_inv) @ center
            pts = box_bottom_corners(center, inst["size"],
                                     quaternion_multiply(rot_inv, inst["rotation"])).T
            pts = np.round(
                (pts - self.bx[:2] + self.dx[:2] / 2.0) / self.dx[:2]
            ).astype(np.int32)
            pts[:, [1, 0]] = pts[:, [0, 1]]
            fill_poly(img, pts, 1.0)
        return img.astype(np.int64)

    def get_txt(self, rec: dict):
        with open(os.path.join(self.dataroot, "action_all", rec["token"] + ".json")) as f:
            act = json.load(f)
        with open(os.path.join(self.dataroot, "desc_all", rec["token"] + ".json")) as f:
            desc = json.load(f)
        return np.asarray(act, np.float32), np.asarray(desc, np.float32)

    def host_item(self, index: int) -> dict:
        """The host stage of item `index`: 'jpeg' and 'aug' per camera, and
        the labels as numpy arrays."""
        rec = self.ixes[index]
        assert self.aug.ncams == 6
        out = self.get_image_data(rec, self.aug.cams, self._item_rng(index))
        out["binimg"] = self.get_binimg(rec)
        if self.with_txt:
            out["act"], out["desc"] = self.get_txt(rec)
        return out

    def __getitem__(self, index: int) -> Dict[str, torch.Tensor]:
        """Item `index` on the dataset's device, both stages run here."""
        batch = device_stage(collate([self.host_item(index)], self.aug.final_dim), self.device)
        return {k: v[0] for k, v in batch.items()}


def collate(items: Sequence[dict], final_dim, pin: bool = False) -> dict:
    """The host's part of a batch: every camera's coefficients packed
    (`ops/jpeg_idct.py::pack`), the augmentation's tables
    (`ops/img_aug.py::plan`) and the labels stacked, as CPU tensors under
    'tensors', in pinned memory with `pin` (for copies to the card that do
    not block; the coefficients, most of the bytes, are written there
    once)."""
    coefs = None

    def out(blocks):
        nonlocal coefs
        coefs = torch.empty((blocks, 64), dtype=torch.int16, pin_memory=pin)
        return coefs.numpy()

    _, quant, meta, height, width = jpeg_idct.pack([c for it in items for c in it["jpeg"]], out)
    params, htab, vtab, rows = img_aug.plan([a for it in items for a in it["aug"]], height,
                                            width, final_dim)
    arrays = dict(quant=quant, meta=meta, params=params, htab=htab, vtab=vtab)
    arrays.update({k: np.stack([it[k] for it in items]) for k in LABELS if k in items[0]})
    tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
    if pin:
        tensors = {k: v.pin_memory() for k, v in tensors.items()}
    tensors["coefs"] = coefs
    return dict(tensors=tensors, shape=(len(items), len(items[0]["jpeg"]), height, width),
                rows=rows, max_blocks=jpeg_idct.max_blocks(meta, coefs.shape[0]),
                final_dim=tuple(final_dim))


def device_stage(host: dict, device) -> Dict[str, torch.Tensor]:
    """A collated batch on `device`: imgs (B, N, 3, fH, fW) float32 by
    kernels 6 and 7 (their plain versions on the CPU), the labels copied.
    On the card the copies are asynchronous (pinned memory) and everything
    is enqueued on the current stream; nothing waits for the card."""
    t = {k: v.to(device, non_blocking=True) for k, v in host["tensors"].items()}
    b, n, height, width = host["shape"]
    rgb = jpeg_idct.decode(t["coefs"], t["quant"], t["meta"], height, width, host["max_blocks"])
    imgs = img_aug.augment(rgb, t["params"], t["htab"], t["vtab"], host["final_dim"],
                           host["rows"])
    out = {"imgs": imgs.view(b, n, *imgs.shape[1:])}
    out.update({k: t[k] for k in LABELS if k in t})
    return out


class VizDataset(NuA2DDataset):
    """The dataset for visualisation: each item also holds 'lidar', (3, M)
    float32 x, y, z of up to 3 lidar sweeps in the ego frame (points within
    2.2 m of the sensor dropped), on the dataset's device."""

    def __getitem__(self, index: int) -> Dict[str, torch.Tensor]:
        from .lidar import get_lidar_data

        out = super().__getitem__(index)
        pts = get_lidar_data(self.nusc, self.ixes[index], nsweeps=3, min_distance=2.2)
        out["lidar"] = torch.from_numpy(pts[:3].astype(np.float32)).to(self.device)
        return out
