"""The manifest and the files it names: every cell's configuration, traffic,
loop, limits and metric readers are found by name; a metric file, and a
traffic mix with a loop of its own, dropped into a copy of the benchmark are
picked up with no other edit; and BENCHMARK.json keeps to the shape a
manifest must have."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files_are_found_by_name(cell):
    from benchlib import manifest

    c = manifest.load_cell(ROOT, cell)
    assert manifest.loop(c.traffic).Loop.KIND in ("train", "eval")
    assert c.limits and all(isinstance(v, (int, float)) for v in c.limits.values())
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(manifest.reader(m["name"]).read)
    for m in c.per_layer:  # each per-layer metric's end-to-end metric is reported too
        assert m["moves"] in names


def test_manifest_shape():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    configs = {c["name"] for c in MANIFEST["configs"]}
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "loops" / f"{traffic['loop']}.py").exists()
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == configs
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
    every = MANIFEST["configs"] + MANIFEST["workloads"] + MANIFEST["end_to_end"] + \
        MANIFEST["per_layer"]
    for x in every:
        assert NAME.match(x["name"]), x["name"]
        if "unit" in x:
            assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    assert len({x["name"] for x in every}) == len(every)


def test_metric_dropped_into_a_copy_is_picked_up(tmp_path):
    """A new per-layer metric is one file under metrics/ and one entry in
    BENCHMARK.json: nothing else changes."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    manifest = dict(MANIFEST)
    manifest["per_layer"] = MANIFEST["per_layer"] + [{
        "name": "steps_in_window.train", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "entry", "moves": "train_samples_per_s",
        "workloads": ["bevtxt_b4.train"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    (tmp_path / "benchmark" / "metrics" / "steps_in_window.train.py").write_text(
        "def read(run):\n    return run.steps\n")
    code = ("import sys; sys.path.insert(0, 'benchmark'); from pathlib import Path; "
            "from benchlib import manifest; c = manifest.load_cell(Path('.'), 'bevtxt_b4.train'); "
            "r = manifest.readers(c.per_layer); "
            "print(sorted(r), r['steps_in_window.train'].read(type('V', (), {'steps': 7})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, check=True).stdout
    assert "'steps_in_window.train'" in out and out.strip().endswith("7")
    assert "deform_bwd_roofline.train" not in out  # a flagship-only metric stays out


SYNCED_LOOP = '''"""Train steps, each synchronised on before the next is sent."""
import time

from benchlib import manifest, session


class Loop(manifest.loop({"loop": "train_steps"}).Loop):
    def window(self, seconds, profile):
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() < t0 + seconds:
            self.once()
            session.sync(self.device)
            n += 1
        return session.Window(t0, time.perf_counter() - t0, n, [])
'''


def test_traffic_with_a_loop_of_its_own_dropped_into_a_copy_runs(tmp_path):
    """A new kind of traffic is a loop file under loops/, a traffic file
    naming it, a limits file and entries in BENCHMARK.json: a copy with
    only those added runs a cell of it (tiny, on the CPU) to a correct
    result, its batch the traffic's."""
    from conftest import DATA

    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    new = tmp_path / "benchmark"
    (new / "loops" / "train_synced.py").write_text(SYNCED_LOOP)
    traffic = json.loads((DATA / "tiny_train.json").read_text()) | {"loop": "train_synced",
                                                                      "batch": 1}
    (new / "traffic" / "train_synced.json").write_text(json.dumps(traffic))
    shutil.copy(DATA / "tiny_flagship.json", new / "configs" / "tiny_flagship.json")
    shutil.copy(BENCH / "limits" / "flagship_v39.train.json",
                new / "limits" / "tiny_flagship.train_synced.json")
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["configs"].append({"name": "tiny_flagship", "source": "tests/data",
                                "file": "benchmark/configs/tiny_flagship.json", "reduced": [],
                                "why": "a test"})
    manifest["workloads"].append({"name": "tiny_flagship.train_synced", "config": "tiny_flagship",
                                  "traffic": "train_synced", "chips": 1, "why": "a test"})
    for m in manifest["end_to_end"]:
        if "train_samples_per_s" in m["name"]:
            m["workloads"].append("tiny_flagship.train_synced")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    code = ("import json, sys, time, torch; torch.set_num_threads(4); "
            "sys.path.insert(0, 'benchmark'); from pathlib import Path; "
            "from benchlib import manifest, session; "
            "c = manifest.load_cell(Path('.'), 'tiny_flagship.train_synced'); "
            "r = session.run(c, 2 ** 31 + 9, 0.5, False, ['cpu'], time.perf_counter()); "
            "print(json.dumps(r))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))  # the port, which the copy leaves out
    done = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, env=env)
    assert done.returncode == 0, done.stderr[-3000:]
    r = json.loads(done.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, r["checks"]
    steps = r["attempted"]
    rate = r["metrics"]["train_samples_per_s"]["value"]
    assert steps > 0 and 0 < rate
