"""PyTorch port: the entry points on the CPU at a small size.  The batch
CLI's JSON and CSV against the JAX CLI's output at the same flags (keys,
header and per-row fields; the scenarios of a seed differ between the two
packages), its resumable checkpoints, the bench twin's output against
``bench.py``'s fields, the single-scenario, position-generator and boxplot
CLIs, and the card as every entry point's default device."""

import csv
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ba_path_planning_tpu.cli import compute_trajectories_batch as jcli
from ba_path_planning_tpu.utils import checkpoint as jck

from ba_path_planning_torch import bench
from ba_path_planning_torch.cli import boxplot as box_cli
from ba_path_planning_torch.cli import compute_trajectories as single_cli
from ba_path_planning_torch.cli import compute_trajectories_batch as cli
from ba_path_planning_torch.cli import position_generator as pos_cli
from ba_path_planning_torch.parallel.mesh import ShardedSCPSolver
from ba_path_planning_torch.utils.config import ProblemConfig

ROOT = Path(__file__).resolve().parent.parent
# N=3, K=16: every scenario reachable within the horizon
BATCH_FLAGS = ["--ns", "3", "--trials-per-n", "4", "--time-horizon", "8",
               "--time-step", "0.5", "--max-iterations", "4",
               "--rng-seed", "0"]


def _outputs(results_dir):
    (js,), (cs,) = (sorted(Path(results_dir).glob(f"scp_benchmark_*.{x}"))
                    for x in ("json", "csv"))
    with open(cs) as f:
        reader = csv.DictReader(f)
        return json.loads(js.read_text()), reader.fieldnames, list(reader)


@pytest.fixture(scope="module")
def port_batch(tmp_path_factory):
    rd = tmp_path_factory.mktemp("port") / "results"
    assert cli.main(BATCH_FLAGS + ["--results-dir", str(rd)],
                    device="cpu") == 0
    return rd


def test_batch_cli_schema_matches_the_jax_cli(port_batch, tmp_path):
    jrd = tmp_path / "jax"
    assert jcli.main(BATCH_FLAGS + ["--results-dir", str(jrd)]) == 0
    got, got_header, got_rows = _outputs(port_batch)
    want, want_header, want_rows = _outputs(jrd)
    assert set(got) == set(want) == {"meta", "runs", "summary"}
    assert set(got["meta"]) == set(want["meta"])
    for key in ("schema_version", "timing_mode"):
        assert got["meta"][key] == want["meta"][key], key
    assert {k: v for k, v in got["meta"]["config"].items()
            if k != "results_dir"} == {k: v for k, v in want["meta"][
                "config"].items() if k != "results_dir"}
    assert got["meta"]["engine"] == "ba_path_planning_torch"
    assert "GPU" in got["meta"]["description"]
    assert set(got["summary"]) == set(want["summary"]) == {"3"}
    assert set(got["summary"]["3"]) == set(want["summary"]["3"])
    assert len(got["runs"]) == len(want["runs"]) == 4
    for r, w in zip(got["runs"], want["runs"]):
        assert list(r) == list(w)
        for key in ("N", "trial_index", "K", "T", "h", "seed"):
            assert r[key] == w[key], key
    assert got_header == want_header == ["N", "trial_index", "status",
                                         "time_sec", "K", "T", "h", "error"]
    assert len(got_rows) == len(want_rows) == 4
    # every scenario of the port's run is solved, and the iteration-weighted
    # time proxy sums to a positive wall time
    assert [r["status"] for r in got["runs"]] == ["success"] * 4
    assert sum(r["time_sec"] for r in got["runs"]) > 0


def test_boxplot_cli_reads_the_batch_output(port_batch, tmp_path):
    out = tmp_path / "plots" / "box.pdf"
    assert box_cli.main(["--data-dir", str(port_batch),
                         "--out-path", str(out)]) == 0
    assert out.stat().st_size > 0
    assert box_cli.main(["--data-dir", str(tmp_path / "none"),
                         "--out-path", str(tmp_path / "x.pdf")]) == 1


CFG = {"Ns": [4], "trials_per_N": 16, "time_horizon": 3.0, "time_step": 0.5,
       "min_distance": 0.6, "space_dims": [0, 0, 20, 20], "max_iterations": 4,
       "rng_seed": 7}


def _rows(resume_dir=None, cfg=CFG):
    return cli.run_batch_for_n(4, cfg, torch.float32, resume_dir=resume_dir,
                               resume_chunk=8, device="cpu")


def test_killed_batch_run_resumes_to_the_same_result(tmp_path, monkeypatch):
    straight = _rows()
    calls = {"n": 0}
    orig = ShardedSCPSolver.solve_compacted

    def dying(self, *a, **kw):
        if calls["n"] >= 1:
            raise RuntimeError("simulated kill")
        calls["n"] += 1
        return orig(self, *a, **kw)

    monkeypatch.setattr(ShardedSCPSolver, "solve_compacted", dying)
    with pytest.raises(RuntimeError, match="simulated kill"):
        _rows(resume_dir=str(tmp_path / "run"))
    monkeypatch.setattr(ShardedSCPSolver, "solve_compacted", orig)
    assert len(list((tmp_path / "run" / "N4").glob("chunk_*.npz"))) == 1

    resumed = _rows(resume_dir=str(tmp_path / "run"))
    assert len(resumed) == len(straight) == 16
    assert any(r["scp_iterations"] > 0 for r in straight)
    for a, b in zip(resumed, straight):
        for key in ("status", "scp_iterations", "scp_status", "error"):
            assert a[key] == b[key], key
        np.testing.assert_allclose(a["goal_error_m"], b["goal_error_m"],
                                   atol=1e-6)
    # a rerun finds every chunk done and gives the same rows
    monkeypatch.setattr(ShardedSCPSolver, "solve_compacted", dying)
    assert _rows(resume_dir=str(tmp_path / "run")) == resumed


def test_batch_resume_refuses_other_runs(tmp_path):
    _rows(resume_dir=str(tmp_path / "run"))
    with pytest.raises(ValueError, match="different config"):
        _rows(resume_dir=str(tmp_path / "run"),
              cfg=dict(CFG, max_iterations=9))
    # a directory of the JAX CLI: the same run identity but for the engine
    # (its scenarios for this seed are JAX's)
    jax_ident = {"N": 4, "trials": 16, "seed": 7, "solver": "production",
                 "stop_mode": "feasible", "chunk": 8, "padded": 16,
                 "n_dev": 1, **{k: CFG[k] for k in (
                     "time_horizon", "time_step", "min_distance",
                     "max_iterations")}}
    jck.ChunkedRun(tmp_path / "jax_run" / "N4", jax_ident)
    with pytest.raises(ValueError, match="different config"):
        _rows(resume_dir=str(tmp_path / "jax_run"))


def _bench_fields():
    """The JSON keys and the summary's field names of ``bench.py``."""
    src = (ROOT / "bench.py").read_text()
    out = src.split("out = {", 1)[1].split("}", 1)[0]
    summary = src.split('print(f"# batch=', 1)[1].split("file=sys.stderr")[0]
    return (re.findall(r'"(\w+)":', out),
            ["batch"] + re.findall(r"([\w<]+)=\{", summary))


def test_bench_twin_prints_the_fields_of_bench_py():
    keys, fields = _bench_fields()
    problem = ProblemConfig(n_vehicles=3, time_horizon=8.0, time_step=0.5,
                            min_distance=0.8, max_iterations=4,
                            stop_mode="feasible", goal_project=True)
    line, summary = bench.measure(problem, batch=4, chunk=2, device="cpu",
                                  lat_runs=2, slope_m=(1, 2), slope_reps=1)
    assert list(line) == keys == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "scenario_solves_per_sec"
    assert line["unit"] == "solves/s" and line["vs_baseline"] is None
    assert line["value"] > 0
    assert re.findall(r"([\w<]+)=", summary) == fields
    assert "p50_ondevice_solve_ms" in fields
    assert re.search(r"ok=4/4 ", summary)
    assert bench.headline_problem().n_steps == 50
    assert (bench.BATCH, bench.CHUNK) == (4096, 512)


SINGLE = ["--n-vehicles", "3", "--time-horizon", "6", "--time-step", "0.5",
          "--min-distance", "0.8", "--seed", "3"]


@pytest.mark.parametrize("viz", [False, True])
def test_single_scenario_cli(tmp_path, capsys, viz):
    traj, snaps = tmp_path / "traj.pdf", tmp_path / "snaps.pdf"
    flags = ["--trajectories-out", str(traj), "--snapshots-out", str(snaps)]
    if not viz:
        flags.append("--no-viz")
    assert single_cli.main(SINGLE + flags, device="cpu") == 0
    out = capsys.readouterr().out
    assert "DISTANCE SUMMARY" in out
    assert re.search(r"Status: [012] \| SCP iterations: \d+ \| "
                     r"collision-free: (True|False)", out)
    assert traj.exists() == snaps.exists() == viz


def test_position_generator_cli(tmp_path, capsys):
    out = tmp_path / "scenario.pdf"
    assert pos_cli.main(["--n-vehicles", "8", "--min-distance", "0.8",
                         "--seed", "5", "--out", str(out)]) == 0
    assert out.exists() and "DISTANCE SUMMARY" in capsys.readouterr().out
    assert pos_cli.main(["--n-vehicles", "60", "--min-distance", "5",
                         "--no-viz"]) == 1


def test_entry_points_default_to_the_card(tmp_path):
    """Given no device, the CLIs and the bench twin run on "cuda"; where
    there is none they raise and nothing runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    problem = bench.headline_problem().replace(n_vehicles=2,
                                               time_horizon=1.0)
    for run in (lambda: cli.main(BATCH_FLAGS + ["--results-dir",
                                                str(tmp_path)]),
                lambda: single_cli.main(SINGLE + ["--no-viz"]),
                lambda: bench.measure(problem, batch=2, chunk=2)):
        with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
            run()
