"""Stack B's stage-1 model (counterpart of the JAX package's
`models/vovnet_pretrain.py`): the flagship's BEV branch alone, VoVNet ->
depth net -> CamEncodeV2 -> fused lift-splat -> BEVEncoderTransformer,
returning the BEV logits.

Its modules are the flagship's, under the flagship's names
(`VoVNetBEVBranch`), so the components that `pretrain-v2` saves
(`PRETRAIN_COMPONENTS`) load into the flagship without remapping.
"""
from __future__ import annotations

from ..ops._precision import full_float32
from ..utils import profiling
from .vovnet_transformer import VoVNetBEVBranch

# the components that the stage-1 checkpoint carries to stage 2
PRETRAIN_COMPONENTS = ("backbone", "depth_net", "cam_encode", "bev_encoder")


class VoVNetPreTrain(VoVNetBEVBranch):
    """forward(imgs (B, N, 3, H, W), rots, trans, intrins, post_rots,
    post_trans) -> bev_seg (B, seg_classes, X, Y) in the config's compute
    dtype, in full float32 precision whatever torch's TF32 flags say."""

    def forward(self, imgs, rots, trans, intrins, post_rots, post_trans):
        with full_float32():
            c3, c4 = self.encode_cameras(imgs)
            bev = self.lift_to_bev(c3, c4, rots, trans, intrins, post_rots, post_trans)
            with profiling.span("bev_encoder", device=True, backward=True) as sp:
                bev_seg, _ = sp.call(self.bev_encoder, bev)
        return bev_seg
