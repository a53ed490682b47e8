"""VoVNet + LSS v1/v2 + lightweight BEV transformer + per-camera reasoning,
the flagship model (counterpart of the JAX package's
`models/vovnet_transformer.py`).

BEV branch (`VoVNetBEVBranch`, which the pretrain model shares): VoVNet
c3/c4 (c3 alone at LSS v1) -> depth net -> CamEncodeV2 -> fused lift-splat
(kernel 3) -> BEVEncoderTransformer (deformable sampling, kernel 1; FFN/LN
tail, kernel 4; seg head, kernel 5). TXT branch: AdaptiveFeaturePyramid(c3)
-> SceneUnder -> global pool -> camera attention (V2/V3) -> BEV-camera
fusion (V3) -> UnifiedPredictor. `model.train()` switches every module to
its training path, the JAX package's `train=True`: batch norm on batch
statistics, dropout, and the FFN tail and seg head op by op instead of
kernels 4 and 5; the sampling's backward is kernel 2. While a
torch.profiler session records, each stage records a span
(`utils/profiling.py`): `trunk` (the `backbone`), `depth`, `lift_splat`,
`bev_encoder`, `heads` (the TXT branch), and the backwards of the trunk and
the BEV encoder.
"""
from __future__ import annotations

import torch
from torch import nn

from ..config import Config
from ..core.frustum import create_frustum
from ..core.geometry import get_geometry, voxel_indices
from ..core.grid import gen_dx_bx
from ..nn.depth_net import CamEncodeV2, MultiScaleDepthNet, StandardDepthNet
from ..nn.fusion import (
    AdaptiveFeaturePyramid,
    BEVCameraFusion,
    BEVEncoderTransformer,
    LightweightCameraTransformer,
    UnifiedPredictor,
)
from ..nn.layers import global_avg_pool
from ..nn.lss_modules import SceneUnder
from ..nn.vovnet import VoVNetBackbone
from ..ops._precision import full_float32
from ..ops.lift_splat import lift_splat
from ..utils import profiling


class VoVNetBEVBranch(nn.Module):
    """The BEV branch that the flagship and the pretrain model share, under
    the original model's names: `backbone`, `depth_net`, `cam_encode`,
    `bev_encoder`. Its stage methods are `encode_cameras` and
    `lift_to_bev`; each subclass's forward calls them and pins full float32
    (`ops/_precision.py`), which the stage methods do not pin themselves."""

    def __init__(self, cfg: Config):
        super().__init__()
        grid, mc = cfg.grid, cfg.model
        self.cfg = cfg
        self.dtype = mc.torch_dtype
        self.dx, self.bx, self.nx = gen_dx_bx(grid.xbound, grid.ybound, grid.zbound)
        frustum = create_frustum(cfg.aug.final_dim, grid.dbound, mc.downsample)
        self.register_buffer("frustum", torch.from_numpy(frustum), persistent=False)
        self.depth_bins = frustum.shape[0]
        self.cam_c = mc.v2_cam_channels

        self.backbone = VoVNetBackbone(mc.vovnet_type)
        if mc.lss_version == "v2":
            self.depth_net = MultiScaleDepthNet(self.depth_bins)
        else:
            self.depth_net = StandardDepthNet(self.depth_bins)
        self.cam_encode = CamEncodeV2(768, self.cam_c)
        self.bev_encoder = BEVEncoderTransformer(
            self.cam_c * int(self.nx[2]), mc.seg_classes, mc.ln_eps)

    def encode_cameras(self, imgs):
        """Backbone over the flattened (B*N) camera stack -> (c3, c4). At
        LSS v1 nothing reads c4, and c4 is None: stage 4 runs only in
        training, without autograd, for its batch-norm statistics."""
        b, n = imgs.shape[:2]
        with_c4 = self.cfg.model.lss_version == "v2"
        x = imgs.reshape(b * n, *imgs.shape[2:]).to(self.dtype)
        with profiling.span("trunk", device=True, backward=True) as sp:
            feats = sp.call(self.backbone, x, with_c4)
        return feats["c3"], feats.get("c4")

    def lift_to_bev(self, c3, c4, rots, trans, intrins, post_rots, post_trans):
        """Depth and feature heads, frustum geometry, fused lift-splat ->
        (B, Z*C, X, Y) BEV features."""
        b, n = rots.shape[:2]
        with profiling.span("depth", device=True):
            depth = self.depth_net(c3, c4)  # (B*N, D, fH, fW)
            feat = self.cam_encode(c3)  # (B*N, C, fH, fW)
        fh, fw = feat.shape[-2:]
        depth = depth.view(b, n, self.depth_bins, fh, fw)
        feat = feat.view(b, n, self.cam_c, fh, fw)
        with profiling.span("lift_splat", device=True):
            geom = get_geometry(self.frustum, rots, trans, intrins, post_rots, post_trans)
            idx, valid = voxel_indices(geom, self.dx, self.bx, self.nx)
            return lift_splat(feat, depth, idx, valid, self.nx)


class VoVNetBEVTransformer(VoVNetBEVBranch):
    """forward(imgs (B, N, 3, H, W), rots, trans, intrins, post_rots,
    post_trans) -> (bev_seg (B, 4, X, Y), action (B, 4), desc (B, 8)), in the
    config's compute dtype. Parameters stay float32. The forward runs in
    full float32 precision whatever torch's TF32 flags say
    (`ops/_precision.py`); the stage methods it calls do not pin them
    themselves."""

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        mc = cfg.model
        self.n_cameras = cfg.aug.ncams
        eps = mc.ln_eps
        self.feature_pyramid = AdaptiveFeaturePyramid(768, 256)
        self.sceneunder = SceneUnder(256)
        self.camera_transformer = (
            LightweightCameraTransformer(n_cameras=self.n_cameras, ln_eps=eps)
            if mc.use_camera_attn else None
        )
        self.bev_fusion = BEVCameraFusion(ln_eps=eps) if mc.use_cross_attn else None
        self.unified_predictor = UnifiedPredictor(
            mc.num_action_classes, mc.num_desc_classes, self.n_cameras, eps)

    def txt_branch(self, c3, bev_refined):
        """Feature pyramid -> scene understanding -> (cross-)attention ->
        action / description predictor."""
        scene = self.sceneunder(self.feature_pyramid(c3))
        scene_global = global_avg_pool(scene, keepdim=False)
        n = self.n_cameras
        x = scene_global.view(-1, n, scene_global.shape[-1])
        if self.camera_transformer is not None:
            cam_ids = torch.arange(n, device=x.device).expand(x.shape[0], n)
            x = self.camera_transformer(x, cam_ids)
        if self.bev_fusion is not None:
            x = self.bev_fusion(x, bev_refined)
        return self.unified_predictor(x)

    def forward(self, imgs, rots, trans, intrins, post_rots, post_trans):
        with full_float32():
            c3, c4 = self.encode_cameras(imgs)
            bev = self.lift_to_bev(c3, c4, rots, trans, intrins, post_rots, post_trans)
            with profiling.span("bev_encoder", device=True, backward=True) as sp:
                bev_seg, bev_refined = sp.call(self.bev_encoder, bev)
            with profiling.span("heads", device=True):
                action, desc = self.txt_branch(c3, bev_refined)
        return bev_seg, action, desc
