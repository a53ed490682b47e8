"""Scene-split tables (the package's own copy of `assets/scene_splits.json`).

Two split families, kept as the original repo has them:
  * `nu_a2d`: the custom 200/50/50 nu-A2D splits, used by training and
    evaluation;
  * `nuscenes_full`: the larger original nuScenes splits, used only by
    pre-training.
The two families disagree on purpose; neither is corrected to the other.
"""
from __future__ import annotations

import functools
import json
import os
from typing import Dict, List

_ASSET = os.path.join(os.path.dirname(__file__), "assets", "scene_splits.json")


@functools.lru_cache(maxsize=1)
def _load() -> Dict[str, Dict[str, List[str]]]:
    with open(_ASSET) as f:
        return json.load(f)


def create_splits_scenes(family: str = "nu_a2d") -> Dict[str, List[str]]:
    """family: 'nu_a2d' or 'nuscenes_full'."""
    return _load()[family]
