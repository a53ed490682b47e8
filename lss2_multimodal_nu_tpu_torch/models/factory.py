"""Model construction by family: the five families of the JAX package's
`models/factory.py`."""
from __future__ import annotations

import torch

from ..config import Config
from .bev_txt import BevTxt, BevTxtOnlyBev
from .lss import LSS
from .vovnet_pretrain import VoVNetPreTrain
from .vovnet_transformer import VoVNetBEVTransformer

FAMILIES = {
    "vovnet_transformer": VoVNetBEVTransformer,
    "lss": LSS,
    "bev_txt": BevTxt,
    "bev_txt_onlybev": BevTxtOnlyBev,
    "vovnet_pretrain": VoVNetPreTrain,
}


def build_model(cfg: Config, device="cuda", seed: int = 0) -> torch.nn.Module:
    """The config's model with seeded random weights, in eval mode, on
    `device` (the card unless the caller asks for the CPU)."""
    family = cfg.model.family
    if family not in FAMILIES:
        raise ValueError(f"unknown model family {family!r}")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = FAMILIES[family](cfg)
    return model.to(device).eval()
