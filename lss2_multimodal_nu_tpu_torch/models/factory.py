"""Model construction by family. The port builds the flagship and Stack A;
the family it does not build yet is listed in ROADMAP.md."""
from __future__ import annotations

import torch

from ..config import Config
from .bev_txt import BevTxt, BevTxtOnlyBev
from .lss import LSS
from .vovnet_transformer import VoVNetBEVTransformer

FAMILIES = {
    "vovnet_transformer": VoVNetBEVTransformer,
    "lss": LSS,
    "bev_txt": BevTxt,
    "bev_txt_onlybev": BevTxtOnlyBev,
}
_NOT_YET = {"vovnet_pretrain": "ROADMAP.md queue 1 item 13 (pretrain family)"}


def build_model(cfg: Config, device="cuda", seed: int = 0) -> torch.nn.Module:
    """The config's model with seeded random weights, in eval mode, on
    `device` (the card unless the caller asks for the CPU)."""
    family = cfg.model.family
    if family in _NOT_YET:
        raise NotImplementedError(f"family {family!r} is not ported yet: {_NOT_YET[family]}")
    if family not in FAMILIES:
        raise ValueError(f"unknown model family {family!r}")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = FAMILIES[family](cfg)
    return model.to(device).eval()
