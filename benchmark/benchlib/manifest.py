"""What one run needs, found by name from `BENCHMARK.json`: the cell, its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`), the loop that the mix names to drive the window
(`loops/<loop>.py`), the limits of its correctness check
(`limits/<cell>.json`) and a reader per metric it reports
(`metrics/<metric>.py`). Adding any of them is adding a file and an entry;
nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(entry: dict, cell: str) -> bool:
    """Whether a metric entry is reported in the cell: named in its
    `workloads`, or every cell where it has none."""
    return cell in entry.get("workloads", (cell,))


def load_cell(root: Path, name: str) -> Cell:
    manifest = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg = _json(root / configs[w["config"]]["file"])
    e2e = [m for m in manifest["end_to_end"] if reports(m, name)]
    per_layer = [m for m in manifest["per_layer"] if reports(m, name)]
    return Cell(name=name, cfg=cfg, traffic=_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
                limits=_json(BENCH_DIR / "limits" / f"{name}.json"), chips=w["chips"],
                end_to_end=e2e, per_layer=per_layer)


def _module(folder: str, name: str) -> ModuleType:
    """`<folder>/<name>.py`, loaded from its path (names hold dots)."""
    path = BENCH_DIR / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> ModuleType:
    """`metrics/<metric>.py`: `read(run)` returns the metric or None."""
    return _module("metrics", metric)


def loop(traffic: dict) -> ModuleType:
    """`loops/<traffic["loop"]>.py`: its `Loop` drives the window."""
    return _module("loops", traffic["loop"])


def readers(entries: List[dict]) -> Dict[str, ModuleType]:
    return {m["name"]: reader(m["name"]) for m in entries}
