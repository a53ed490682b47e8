"""On the card, at each cell's own size: the port passes the cell's check
and the control fails it. The port is driven by the cell's loop through a
short window and the check's steps after it (`readings.py::program`); the
control is the plain reference computed with TF32 on, the precision below
the configurations' float32, put in the port's place
(`readings.py::control`). Marked `card`: skips without a card."""
import json

import pytest

from conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2 ** 31 + 1001


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_port_passes_and_control_fails(card, cell):
    import readings
    from benchlib import check, manifest

    c = manifest.load_cell(ROOT, cell)
    loop, got, kept = readings.program(c, SEED, card, 3.0)
    args = (loop.KIND, c.cfg, SEED)
    rest = (kept, loop.pool_n, card, loop.overrides)
    assert check.verdict(check.numbers(*args, got, *rest), c.limits) == []
    ctrl = readings.control(c, SEED, loop, kept, card)
    assert check.verdict(check.numbers(*args, ctrl, *rest), c.limits)
