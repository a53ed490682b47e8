"""Shared pieces of the benchmark's own tests (`pytest benchmark/tests`).

Tests that need an NVIDIA card carry the `card` marker, registered here,
and skip without one (decided inside the test, never at import). The tiny
configurations under `data/` exist for these CPU tests alone.
"""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
DATA = Path(__file__).resolve().parent / "data"
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")


def tiny_cell(which: str, mode: str):
    """A cell of the tiny `which` configuration ("flagship" or "bevtxt")
    under the tiny `mode` traffic ("train" or "eval"), with the metrics and
    limits of the full-size cell it stands for."""
    from benchlib import manifest

    cfg = json.loads((DATA / f"tiny_{which}.json").read_text())
    traffic = json.loads((DATA / f"tiny_{mode}.json").read_text())
    full = {"flagship": "flagship_v39", "bevtxt": "bevtxt_b4"}[which] + f".{mode}"
    ref = manifest.load_cell(ROOT, full)
    return manifest.Cell(full, cfg, traffic, ref.limits, 1, ref.end_to_end, ref.per_layer)
