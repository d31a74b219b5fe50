"""The benchmark's command refuses to run without a card, and a run at a
small size on the CPU (the look for a card skipped) gives a whole line."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from helpers import small_cell
from port_bench import run

ROOT = Path(__file__).resolve().parents[2]


def test_the_command_exits_non_zero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "port_bench.run",
                          "--workload", "fleet20.batch4096", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("trace", [0, 1])
def test_a_small_run_on_the_cpu_is_correct_and_whole(trace):
    line, checks = run.run_cell(small_cell(), 2 ** 31 + 11, 0.3,
                                bool(trace), "cpu")
    assert line["correct"], checks
    assert list(line)[-1] == "checks"
    assert set(checks) == set(small_cell().config["limits"])
    assert line["attempted"] >= 8
    assert 0 <= line["failed"] <= line["attempted"]
    names = set(line["metrics"])
    if trace:
        assert {"dispatch_useful_pct", "phase1_pct",
                "scp_iters_mean"} <= names
        assert "breakdown" in line
    else:
        assert names == {"solves_per_s", "setup_s"}
    json.dumps(run._finite(line), allow_nan=False)
