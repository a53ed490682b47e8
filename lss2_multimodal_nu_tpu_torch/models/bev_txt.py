"""Stack A's multitask models (counterparts of the JAX package's
`models/bev_txt.py`), both LSS plus a TXT branch that returns (bev, act,
desc). Like the original models they hold LSS's modules at the top level
(`encoder`, `camencode`, `bevencode`), not under a prefix.

* `BevTxt`, the published Multimodal-XAD model: the TXT branch reads the
  ASPP'd camera features of every camera but CAM_BACK (index 4), each beside
  the encoded BEV crop, which is *detached*: the TXT loss sends no gradient
  into the BEV branch.
* `BevTxtOnlyBev`, the BEV-only ablation: act and desc come from the BEV
  crop alone, which is *not* detached. The original also builds a
  SceneUnder that it never calls; it is left out, as in the JAX package.
"""
from __future__ import annotations

import torch

from ..config import Config
from ..nn.lss_modules import BevPost, EmbedderConv, EmbedderFlat, Predictor, SceneUnder
from ..ops._precision import full_float32
from ..utils import profiling
from .lss import LSS

# the BEV crop that the TXT branch reads: rows 60:140 of X, columns 56:144 of Y
CROP_X = (60, 140)
CROP_Y = (56, 144)


def bev_crop(bev: torch.Tensor) -> torch.Tensor:
    """(B, C, X, Y) -> (B, C, 80, 88)."""
    return bev[:, :, CROP_X[0]:CROP_X[1], CROP_Y[0]:CROP_Y[1]]


def _post_hw():
    return BevPost.out_size(CROP_X[1] - CROP_X[0], CROP_Y[1] - CROP_Y[0])


class BevTxtOnlyBev(LSS):
    """forward(...) -> (bev (B, 4, X, Y), act (B, 4), desc (B, 8))."""

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        mc = cfg.model
        h, w = _post_hw()
        self.bevpost = BevPost(mc.seg_classes, 8)
        self.embeder_bev = EmbedderFlat(8 * h * w, 8)
        self.predictor_bev1 = Predictor(8, mc.num_action_classes)
        self.predictor_bev2 = Predictor(8, mc.num_desc_classes)

    def txt_branch(self, bev):
        emb = self.embeder_bev(self.bevpost(bev_crop(bev)))
        return self.predictor_bev1(emb), self.predictor_bev2(emb)

    def forward(self, imgs, rots, trans, intrins, post_rots, post_trans):
        with full_float32():
            bev = super().forward(imgs, rots, trans, intrins, post_rots, post_trans)
            with profiling.span("heads", device=True):
                act, desc = self.txt_branch(bev)
        return bev, act, desc


class BevTxt(LSS):
    """forward(...) -> (bev (B, 4, X, Y), act (B, 4), desc (B, 8)); desc is
    [desc_f (4), FL, BL, FR, BR]. The camera features' size (H/16, W/16)
    must equal the encoded crop's, (8, 22): 128x352 images."""

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        h, w = _post_hw()
        self.sceneunder = SceneUnder(512)
        self.bevpost = BevPost(cfg.model.seg_classes, 8)
        self.embeder_f1 = EmbedderConv(256, 32)
        self.embeder_f2 = EmbedderFlat(40 * h * w, 40)
        self.embeder_lr1 = EmbedderConv(256, 32)
        self.embeder_lr2 = EmbedderFlat(40 * h * w, 40)
        self.predictorf1 = Predictor(40, 4)
        self.predictorf2 = Predictor(40, 4)
        self.predictorlr = Predictor(40, 1)

    def txt_branch(self, bev, cam_feats):
        """(bev (B, 4, X, Y), camera features (B*N, 512, 8, 22)) -> (act,
        desc)."""
        b = bev.shape[0]
        bev_post = self.bevpost(bev_crop(bev.detach()))  # (B, 8, 8, 22)
        y = self.sceneunder(cam_feats)
        y = y.view(b, -1, *y.shape[1:])
        # camera order FL F FR BL B BR; CAM_BACK (4) is not read
        y_fl, y_f, y_fr, y_bl, y_br = y[:, 0], y[:, 1], y[:, 2], y[:, 3], y[:, 5]

        def side(cam):
            e = torch.cat([self.embeder_lr1(cam), bev_post], dim=1)
            return self.predictorlr(self.embeder_lr2(e))  # (B, 1)

        yf = self.embeder_f2(torch.cat([self.embeder_f1(y_f), bev_post], dim=1))
        act = self.predictorf2(yf)
        desc = torch.cat([self.predictorf1(yf), side(y_fl), side(y_bl), side(y_fr), side(y_br)],
                         dim=1)
        return act, desc

    def forward(self, imgs, rots, trans, intrins, post_rots, post_trans):
        with full_float32():
            cam_feats = self.encode_cameras(imgs)
            bev = self.lift_to_bev(cam_feats, rots, trans, intrins, post_rots, post_trans)
            with profiling.span("bev_encoder", device=True, backward=True) as sp:
                bev = sp.call(self.bevencode, bev)
            with profiling.span("heads", device=True):
                act, desc = self.txt_branch(bev, cam_feats)
        return bev, act, desc
