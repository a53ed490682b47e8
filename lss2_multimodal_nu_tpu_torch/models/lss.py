"""LSS, Stack A's BEV model (counterpart of the JAX package's
`models/lss.py`): EfficientNet encoder, LSS v1 depth net, frustum
geometry, fused lift-splat (kernel 3 at C=cam_channels, 64 by default; its
backward in training), resnet18 BEV decoder.

The stages are methods, so that BevTxt reuses them and a timer can call
them one by one: `encode_cameras` (imgs -> camera features), `lift_to_bev`
(camera features and calibration -> (B, Z*C, X, Y) BEV features) and
`bevencode` (-> (B, seg_classes, X, Y) logits). `model.train()` puts batch
norm on batch statistics and turns the trunk's drop-connect on. While a
torch.profiler session records, each stage records a span
(`utils/profiling.py`): `trunk` (the `encoder`), `depth`, `lift_splat`,
`bev_encoder` (`bevencode`), and the backwards of the first and the last.
"""
from __future__ import annotations

import torch
from torch import nn

from ..config import Config
from ..core.frustum import create_frustum
from ..core.geometry import get_geometry, voxel_indices
from ..core.grid import gen_dx_bx
from ..nn.lss_modules import BevEncode, CamEncode, Encoder
from ..ops._precision import full_float32
from ..ops.lift_splat import lift_splat
from ..utils import profiling


class LSS(nn.Module):
    """forward(imgs (B, N, 3, H, W), rots, trans, intrins, post_rots,
    post_trans) -> BEV logits (B, seg_classes, X, Y) in the config's compute
    dtype. Parameters stay float32; the forward runs in full float32
    precision whatever torch's TF32 flags say (`ops/_precision.py`)."""

    def __init__(self, cfg: Config):
        super().__init__()
        grid, mc = cfg.grid, cfg.model
        self.cfg = cfg
        self.dtype = mc.torch_dtype
        self.dx, self.bx, self.nx = gen_dx_bx(grid.xbound, grid.ybound, grid.zbound)
        frustum = create_frustum(cfg.aug.final_dim, grid.dbound, mc.downsample)
        self.register_buffer("frustum", torch.from_numpy(frustum), persistent=False)
        self.depth_bins = frustum.shape[0]
        self.cam_c = mc.cam_channels
        self.encoder = Encoder(mc.effnet_variant)
        self.camencode = CamEncode(self.depth_bins, self.cam_c)
        self.bevencode = BevEncode(self.cam_c * int(self.nx[2]), mc.seg_classes)

    def encode_cameras(self, imgs):
        """imgs (B, N, 3, H, W) -> camera features (B*N, 512, H/16, W/16)."""
        b, n = imgs.shape[:2]
        x = imgs.reshape(b * n, *imgs.shape[2:]).to(self.dtype)
        with profiling.span("trunk", device=True, backward=True) as sp:
            return sp.call(self.encoder, x)

    def lift_to_bev(self, cam_feats, rots, trans, intrins, post_rots, post_trans):
        """Depth distribution and features, frustum geometry, fused
        lift-splat -> (B, Z*C, X, Y) BEV features."""
        b, n = rots.shape[:2]
        with profiling.span("depth", device=True):
            depth, feat = self.camencode(cam_feats)
        fh, fw = feat.shape[-2:]
        depth = depth.view(b, n, self.depth_bins, fh, fw)
        feat = feat.view(b, n, self.cam_c, fh, fw)
        with profiling.span("lift_splat", device=True):
            geom = get_geometry(self.frustum, rots, trans, intrins, post_rots, post_trans)
            idx, valid = voxel_indices(geom, self.dx, self.bx, self.nx)
            return lift_splat(feat, depth, idx, valid, self.nx)

    def forward(self, imgs, rots, trans, intrins, post_rots, post_trans):
        with full_float32():
            cam_feats = self.encode_cameras(imgs)
            bev = self.lift_to_bev(cam_feats, rots, trans, intrins, post_rots, post_trans)
            with profiling.span("bev_encoder", device=True, backward=True) as sp:
                return sp.call(self.bevencode, bev)
