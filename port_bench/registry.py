"""Find a cell's parts by the names in ``BENCHMARK.json``.

A configuration ``<config>`` is ``port_bench/configs/<config>.json``, a
traffic mix ``<traffic>`` is ``port_bench/traffic/<traffic>.json``, and a
per-layer metric ``<name>`` is the module ``port_bench.metrics.<name>``
(dots in the name become underscores) with its ``LAYER``, ``UNIT``,
``BETTER``, ``SOURCE``, ``MOVES`` and ``read(ctx)``.  A new cell, mix,
configuration or metric is a new file and a new entry; no file here names
any of them.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"


class Cell(NamedTuple):
    workload: dict        # the cell's entry of ``workloads``
    config: dict          # its configuration file
    traffic: dict         # its traffic file
    end_to_end: list      # the end-to-end entries the cell reports
    per_layer: list       # (entry, module) of the per-layer metrics it reports


def load_benchmark(path: Path = BENCHMARK) -> dict:
    return json.loads(Path(path).read_text())


def config_file(name: str) -> Path:
    return ROOT / "configs" / f"{name}.json"


def traffic_file(name: str) -> Path:
    return ROOT / "traffic" / f"{name}.json"


def metric_module(name: str):
    return importlib.import_module(
        f"port_bench.metrics.{name.replace('.', '_')}")


def _reports(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def cell(name: str, bench: dict | None = None) -> Cell:
    """The parts of the cell ``name``; KeyError if there is none."""
    bench = load_benchmark() if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    config = json.loads(config_file(w["config"]).read_text())
    traffic = json.loads(traffic_file(w["traffic"]).read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    layer = [(m, metric_module(m["name"])) for m in bench["per_layer"]
             if _reports(m, name)]
    return Cell(w, config, traffic, e2e, layer)
