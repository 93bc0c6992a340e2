"""BENCHMARK.json and the files it names: they resolve, keep to the
contract's names and units, and a cell, configuration, traffic and metric
added as new files is found with no edit to a file that is there."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark import run

ROOT = run.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = run.load_cell(cell)
    assert c.chips == 1
    assert (run.BENCHMARK_DIR / "drivers" / f"{c.traffic['driver']}.py").exists()
    assert c.limits
    for kind in ("end_to_end", "per_layer"):
        for m in c.metrics(kind):
            assert (run.BENCHMARK_DIR / "metrics" / f"{m['name']}.py").exists()


def test_names_and_units():
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[kind]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((kind, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200
    assert len(names) == len(set(names))
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).exists()


def test_every_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)
    for cell in CELLS:
        reported = [m for m in SPEC["end_to_end"]
                    if cell in m.get("workloads", CELLS)]
        assert "setup_s" in [m["name"] for m in reported]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", CELLS)
                   for m in SPEC["per_layer"])


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    cell and a metric reader as new files and new entries; the harness
    finds each by its name, and the files that were there are unchanged."""
    shutil.copytree(run.BENCHMARK_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    bench = tmp_path / "benchmark"
    config = json.loads((bench / "configs" / "hpe_hpm.json").read_text())
    (bench / "configs" / "hpe_hpm_b16.json").write_text(
        json.dumps({**config, "name": "hpe_hpm_b16", "batch_size": 16}))
    traffic = json.loads((bench / "traffic" / "hpe_train.json").read_text())
    (bench / "traffic" / "hpe_mix06.json").write_text(
        json.dumps({**traffic, "augmentation_ratio": 0.6}))
    (bench / "workloads" / "hpe_hpm_b16.mix06.json").write_text(
        json.dumps({"limits": {"loss_gap": 0.5}}))
    (bench / "metrics" / "steps_per_s.py").write_text(
        "def read(r):\n    return r.steps / r.window_s\n")
    spec = dict(SPEC)
    spec["configs"] = SPEC["configs"] + [{
        "name": "hpe_hpm_b16", "source": "https://example.org",
        "file": "benchmark/configs/hpe_hpm_b16.json", "reduced": [],
        "why": "a smaller batch"}]
    spec["workloads"] = SPEC["workloads"] + [{
        "name": "hpe_hpm_b16.mix06", "config": "hpe_hpm_b16",
        "traffic": "hpe_mix06", "chips": 1, "why": "ratio 0.6"}]
    spec["end_to_end"] = SPEC["end_to_end"] + [{
        "name": "steps_per_s", "unit": "steps/s", "better": "higher",
        "bound": 0.05, "source": "host_clock",
        "workloads": ["hpe_hpm_b16.mix06"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = run.load_cell("hpe_hpm_b16.mix06", root=tmp_path)
    assert cell.config["batch_size"] == 16
    assert cell.traffic["augmentation_ratio"] == 0.6
    assert cell.limits == {"loss_gap": 0.5}
    assert "steps_per_s" in [m["name"] for m in cell.metrics("end_to_end")]
    reader = run.load_reader("steps_per_s", bench=bench)
    assert reader(run.Reading(cell=cell, run=None, setup_s=1.0,
                              window_s=2.0, steps=10)) == 5.0
    for path, data in before.items():
        assert path.read_bytes() == data, path
