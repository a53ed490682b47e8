"""The benchmark's inputs, made from the seed: a pool of batches on the
device, each with camera images, BEV labels, action and description
targets, the nuScenes six-camera rig's calibration, and each camera's
augmentation as the loader draws it (training) or fixes it (eval).

The images, labels and targets come from one `torch.Generator` on the
device, in one call each for the whole pool; the augmentation's few numbers
from a numpy generator on the host, copied once. The same seed gives the
same pool, on the same device.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

# nuScenes v1.0's calibrated_sensor rows of the six cameras (the rig of the
# mini split's first log, 1600x900 images): translation (m, ego frame),
# rotation as a (w, x, y, z) quaternion camera -> ego, fx = fy, cx, cy.
NUSCENES_RIG = {
    "CAM_FRONT_LEFT": ([1.52387798135, 0.494631336551, 1.50932822144],
                       [0.6757265034669446, -0.6736266522251881, 0.21214015046209478,
                        -0.21122827103904068], (1272.5979470598488, 826.6154927353808,
                                                479.75165386361925)),
    "CAM_FRONT": ([1.70079118954, 0.0159456324149, 1.51095763913],
                  [0.4998015430569128, -0.5030316162024876, 0.4997798114386805,
                   -0.49737083824542755], (1266.417203046554, 816.2670197447984,
                                           491.50706579294757)),
    "CAM_FRONT_RIGHT": ([1.5508477543, -0.493404796419, 1.49574800619],
                        [0.2060347966337182, -0.2026940577919598, 0.6824507824531167,
                         -0.6713610884174485], (1260.8474446004698, 807.968244525554,
                                                495.3344268742088)),
    "CAM_BACK_LEFT": ([1.04852047718, 0.483058131052, 1.56210154484],
                      [0.6924185592174665, -0.7031619420114925, -0.11648342771943819,
                       0.11203317912370753], (1256.7414812095406, 792.1125740759628,
                                              492.7757465151356)),
    "CAM_BACK": ([0.0283260309358, 0.00345136761476, 1.57910346144],
                 [0.5037872666382278, -0.49740249788611096, -0.4941850223835201,
                  0.5045496097725578], (809.2209905677063, 829.2196003259838,
                                        481.77842384512485)),
    "CAM_BACK_RIGHT": ([1.03569100218, -0.484795032713, 1.59097014818],
                       [0.12280980120078765, -0.132400842670559, -0.7004305821388234,
                        0.690496031265798], (1259.5137405846733, 807.2529053838625,
                                             501.19579884916527)),
}
CAM_ORDER = ("CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_BACK_LEFT", "CAM_BACK",
             "CAM_BACK_RIGHT")


def quat_to_matrix(q) -> np.ndarray:
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float32)


def rig(ncams: int):
    """(rots (N, 3, 3), trans (N, 3), intrins (N, 3, 3)) float32."""
    rots, trans, intrins = [], [], []
    for cam in CAM_ORDER[:ncams]:
        t, q, (f, cx, cy) = NUSCENES_RIG[cam]
        rots.append(quat_to_matrix(q))
        trans.append(np.asarray(t, np.float32))
        intrins.append(np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float32))
    return np.stack(rots), np.stack(trans), np.stack(intrins)


def _rot2(deg: float) -> np.ndarray:
    h = deg / 180.0 * np.pi
    return np.array([[np.cos(h), np.sin(h)], [-np.sin(h), np.cos(h)]], dtype=np.float32)


def augmentation(aug: dict, train: bool, rng: np.random.Generator):
    """(post_rot 3x3, post_tran 3) of one camera: in training a random
    resize, bottom crop, flip (where `rand_flip`) and rotation, drawn in that
    order as the loader draws them; in eval the fixed resize and centred
    crop."""
    H, W = aug["H"], aug["W"]
    fH, fW = aug["final_dim"]
    if train:
        resize = float(rng.uniform(*aug["resize_lim"]))
        newW, newH = int(W * resize), int(H * resize)
        crop_h = int((1 - rng.uniform(*aug["bot_pct_lim"])) * newH) - fH
        crop_w = int(rng.uniform(0, max(0, newW - fW)))
        flip = bool(aug["rand_flip"] and rng.integers(0, 2))
        rotate = float(rng.uniform(*aug["rot_lim"]))
    else:
        resize = max(fH / H, fW / W)
        newW, newH = int(W * resize), int(H * resize)
        crop_h = int((1 - np.mean(aug["bot_pct_lim"])) * newH) - fH
        crop_w = int(max(0, newW - fW) / 2)
        flip, rotate = False, 0.0
    rot = np.eye(2, dtype=np.float32) * resize
    tran = -np.array([crop_w, crop_h], dtype=np.float32)
    if flip:
        a = np.array([[-1, 0], [0, 1]], dtype=np.float32)
        rot, tran = a @ rot, a @ tran + np.array([fW, 0], dtype=np.float32)
    a = _rot2(rotate)
    b = np.array([fW, fH], dtype=np.float32) / 2.0
    b = a @ (-b) + b
    rot, tran = a @ rot, a @ tran + b
    post_rot = np.eye(3, dtype=np.float32)
    post_rot[:2, :2] = rot
    post_tran = np.zeros(3, dtype=np.float32)
    post_tran[:2] = tran
    return post_rot, post_tran


def batch_size(cfg: dict, traffic: dict, train: bool) -> int:
    """The traffic's `batch`, or where it names none the configuration's
    published batch for training or for evaluation."""
    return traffic.get("batch") or (cfg["train"]["batch_size"] if train else
                                    cfg["eval_batch_size"])


def make_pool(cfg: dict, traffic: dict, b: int, train: bool, seed: int,
              device) -> List[Dict[str, torch.Tensor]]:
    """`traffic["pool"]` distinct batches of `b` samples on `device`, each
    camera augmented as in training (`train`) or as in evaluation."""
    aug, grid = cfg["aug"], cfg["grid"]
    n, (h, w), pool = aug["ncams"], aug["final_dim"], traffic["pool"]
    nx, ny = (int((g[1] - g[0]) / g[2]) for g in (grid["xbound"], grid["ybound"]))
    gen = torch.Generator(device=device).manual_seed(seed)
    imgs = torch.randn((pool, b, n, 3, h, w), generator=gen, device=device)
    u = torch.rand((pool, b, nx, ny), generator=gen, device=device)
    edges = torch.tensor(np.cumsum(traffic["label_shares"])[:-1], dtype=torch.float32,
                         device=device)
    binimg = torch.bucketize(u, edges)
    act = (torch.rand((pool, b, cfg["model"]["num_action_classes"]), generator=gen,
                      device=device) < traffic["target_rate"]).float()
    desc = (torch.rand((pool, b, cfg["model"]["num_desc_classes"]), generator=gen,
                       device=device) < traffic["target_rate"]).float()
    rots, trans, intrins = rig(n)
    rng = np.random.default_rng([seed, 1])
    post = [augmentation(aug, train, rng) for _ in range(pool * b * n)]
    post_rots = np.stack([p[0] for p in post]).reshape(pool, b, n, 3, 3)
    post_trans = np.stack([p[1] for p in post]).reshape(pool, b, n, 3)
    host = {"rots": np.broadcast_to(rots, (pool, b, n, 3, 3)),
            "trans": np.broadcast_to(trans, (pool, b, n, 3)),
            "intrins": np.broadcast_to(intrins, (pool, b, n, 3, 3)),
            "post_rots": post_rots, "post_trans": post_trans}
    small = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in host.items()}
    return [{"imgs": imgs[i], "binimg": binimg[i], "act": act[i], "desc": desc[i],
             **{k: v[i] for k, v in small.items()}} for i in range(pool)]
