"""Configuration of the PyTorch port (mirrors `lss2_multimodal_nu_tpu/config.py`).

Same defaults as the JAX package's `GridConfig`, `AugConfig`, `ModelConfig`,
`TrainConfig`, `MeshConfig`, `Config` and `preset`; the TPU-only knob
`dropout_rng_impl` is left out. `ModelConfig` adds
`ln_eps`, the eps of every LayerNorm of the model, and `torch_dtype`, the
torch dtype that `compute_dtype` names.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch

CAM_ORDER = (
    "CAM_FRONT_LEFT",
    "CAM_FRONT",
    "CAM_FRONT_RIGHT",
    "CAM_BACK_LEFT",
    "CAM_BACK",
    "CAM_BACK_RIGHT",
)


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """BEV voxel-grid bounds, each (lo, hi, step)."""

    xbound: Tuple[float, float, float] = (-50.0, 50.0, 0.5)
    ybound: Tuple[float, float, float] = (-50.0, 50.0, 0.5)
    zbound: Tuple[float, float, float] = (-10.0, 10.0, 20.0)
    dbound: Tuple[float, float, float] = (4.0, 45.0, 1.0)

    @property
    def nx(self) -> Tuple[int, int, int]:
        return tuple(
            int((b[1] - b[0]) / b[2]) for b in (self.xbound, self.ybound, self.zbound)
        )

    @property
    def dx(self) -> Tuple[float, float, float]:
        return (self.xbound[2], self.ybound[2], self.zbound[2])

    @property
    def bx(self) -> Tuple[float, float, float]:
        return tuple(b[0] + b[2] / 2.0 for b in (self.xbound, self.ybound, self.zbound))

    @property
    def num_depth_bins(self) -> int:
        lo, hi, step = self.dbound
        return int(math.ceil((hi - lo) / step))


@dataclasses.dataclass(frozen=True)
class AugConfig:
    """Image-augmentation configuration."""

    H: int = 900
    W: int = 1600
    final_dim: Tuple[int, int] = (128, 352)
    resize_lim: Tuple[float, float] = (0.193, 0.225)
    bot_pct_lim: Tuple[float, float] = (0.0, 0.22)
    rot_lim: Tuple[float, float] = (-5.4, 5.4)
    rand_flip: bool = False
    cams: Sequence[str] = CAM_ORDER
    ncams: int = 6


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model-family selection and architecture knobs."""

    # 'lss' | 'bev_txt' | 'bev_txt_onlybev' | 'vovnet_transformer' | 'vovnet_pretrain'
    family: str = "lss"
    seg_classes: int = 4
    cam_channels: int = 64
    downsample: int = 16
    effnet_variant: str = "b4"
    vovnet_type: str = "vovnet39"  # 'vovnet39' | 'vovnet57' | 'vovnet99'
    lss_version: str = "v2"  # 'v1' | 'v2'
    use_camera_attn: bool = True  # ablation V2/V3
    use_cross_attn: bool = True  # ablation V3
    v2_cam_channels: int = 128
    num_action_classes: int = 4
    num_desc_classes: int = 8
    # numerics: parameters are always fp32; activations in compute_dtype
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    # flax's LayerNorm default, which every LayerNorm of the JAX reference
    # uses (torch's own default is 1e-5)
    ln_eps: float = 1e-6

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.compute_dtype]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization settings (the JAX package's `TrainConfig`, without the
    TPU-only `dropout_rng_impl`)."""

    batch_size: int = 6
    lr: float = 1e-4
    weight_decay: float = 1e-8
    max_grad_norm: float = 5.0
    num_epochs: int = 50
    # layer-wise lr + warmup-cosine, stepped per batch
    backbone_lr_mult: float = 0.1
    warmup_epochs: int = 5
    min_lr: float = 1e-6
    use_schedule: bool = False
    seed: int = 42
    log_every: int = 200
    # per-top-module gradient norms and a strided sample of the gradients
    # in the train step's metrics (`train/steps.py::grad_watch_summaries`)
    watch_gradients: bool = False


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The (dp, fsdp) layout of a run on more than one device
    (`parallel/mesh.py`): the batch is sharded over all dp*fsdp ranks, the
    parameters replicated over dp and sharded over fsdp; dp*fsdp must equal
    the world size."""

    dp: int = 1
    fsdp: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    grid: GridConfig = GridConfig()
    aug: AugConfig = AugConfig()
    model: ModelConfig = ModelConfig()
    train: TrainConfig = TrainConfig()
    mesh: MeshConfig = MeshConfig()
    dataroot: str = "/data/nu-A2D"
    version: str = "trainval"  # 'trainval' | 'mini'
    logdir: str = "./result-log"


def preset(name: str) -> Config:
    """The configuration of one of the original repo's five entry points:
    'pretrain', 'train', 'train_onlybev', 'pretrain_v2', 'train_v2'."""
    if name == "pretrain":
        return Config(
            model=ModelConfig(family="lss"),
            train=TrainConfig(batch_size=6, lr=1e-3, weight_decay=1e-7),
            aug=AugConfig(rand_flip=True),
        )
    if name == "train":
        return Config(
            model=ModelConfig(family="bev_txt"),
            train=TrainConfig(batch_size=6, lr=1e-4, weight_decay=1e-8),
        )
    if name == "train_onlybev":
        return Config(
            model=ModelConfig(family="bev_txt_onlybev"),
            train=TrainConfig(batch_size=6, lr=1e-4, weight_decay=1e-8),
        )
    if name == "pretrain_v2":
        return Config(
            model=ModelConfig(family="vovnet_pretrain", lss_version="v2"),
            train=TrainConfig(batch_size=12, lr=1e-4, weight_decay=1e-8, num_epochs=60,
                              use_schedule=True),
            aug=AugConfig(rand_flip=True),
        )
    if name == "train_v2":
        return Config(
            model=ModelConfig(family="vovnet_transformer", lss_version="v1"),
            train=TrainConfig(batch_size=8, lr=1e-4, weight_decay=1e-8, max_grad_norm=10.0,
                              num_epochs=60, use_schedule=True),
            aug=AugConfig(rand_flip=True),
        )
    raise ValueError(f"unknown preset: {name}")
