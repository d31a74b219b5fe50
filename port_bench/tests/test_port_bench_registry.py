"""Every part of a cell is found by the name BENCHMARK.json gives it, and
a new cell, mix, configuration or metric is picked up from a new file and
a new entry alone."""

import json
import shutil

import pytest

import port_bench.metrics
from port_bench import registry


def test_every_named_part_is_found():
    bench = registry.load_benchmark()
    for w in bench["workloads"]:
        cell = registry.cell(w["name"], bench)
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer
    for c in bench["configs"]:
        assert registry.config_file(c["name"]).as_posix().endswith(c["file"])
        assert json.loads(registry.config_file(c["name"]).read_text())[
            "reduced"] == c["reduced"]


@pytest.mark.parametrize("entry", registry.load_benchmark()["per_layer"],
                         ids=lambda e: e["name"])
def test_metric_module_states_its_entry(entry):
    mod = registry.metric_module(entry["name"])
    assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.SOURCE, mod.MOVES) == (
        entry["layer"], entry["unit"], entry["better"], entry["source"],
        entry["moves"])
    assert callable(mod.read)


def test_a_new_cell_needs_only_new_files_and_entries(tmp_path, monkeypatch):
    for part in ("configs", "traffic"):
        shutil.copytree(registry.ROOT / part, tmp_path / part)
    (tmp_path / "metrics").mkdir()
    monkeypatch.setattr(registry, "ROOT", tmp_path)
    monkeypatch.setattr(port_bench.metrics, "__path__",
                        list(port_bench.metrics.__path__)
                        + [str(tmp_path / "metrics")])
    cfg = json.loads((tmp_path / "configs/fleet20_production.json")
                     .read_text())
    cfg["name"] = "fleet21_new"
    (tmp_path / "configs/fleet21_new.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic/batch7.json").write_text(json.dumps(
        {"name": "batch7", "batch": 7, "chunk": 7}))
    (tmp_path / "metrics/new_metric_pct.py").write_text(
        'LAYER = "device"\nUNIT = "%"\nBETTER = "lower"\n'
        'SOURCE = "device_trace"\nMOVES = "solves_per_s"\n\n\n'
        'def read(ctx):\n    return None\n')
    bench = registry.load_benchmark()
    bench["configs"].append({"name": "fleet21_new"})
    bench["workloads"].append({"name": "fleet21.batch7",
                               "config": "fleet21_new", "traffic": "batch7",
                               "chips": 1})
    bench["per_layer"].append({"name": "new_metric_pct",
                               "workloads": ["fleet21.batch7"]})
    cell = registry.cell("fleet21.batch7", bench)
    assert cell.traffic["batch"] == 7
    assert cell.config["name"] == "fleet21_new"
    assert [e["name"] for e, _ in cell.per_layer][-1] == "new_metric_pct"
    assert cell.per_layer[-1][1].read(None) is None
    old = registry.cell("fleet20.batch4096", bench)
    assert "new_metric_pct" not in [e["name"] for e, _ in old.per_layer]


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        registry.cell("no.such.cell")
