"""The soak / N-sweep round record of the port
(``scripts/torch_soak_nsweep.py``) and the routes of its configurations, on
the CPU.

The record must carry every key of the JAX package's record
(``docs/soak_nsweep_v5e.json``).  The sweep's widths N = 10, 50 and 60 at
K = 50 in float32 must take the route the JAX router takes, computed here
from its gate arithmetic (``ba_path_planning_tpu/solvers/banded.py``,
``solve_qp_state``) on the JAX production solver's static options as the
TPU sets them, and the port's launch plans must serve them.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ba_path_planning_tpu.utils import config as jcfg

from ba_path_planning_torch.ops import admm_fused as af
from ba_path_planning_torch.ops import group_solve as gs
from ba_path_planning_torch.solvers import banded as tb
from ba_path_planning_torch.utils.config import ProblemConfig, SolverConfig

ROOT = Path(__file__).resolve().parent.parent


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_soak_nsweep", ROOT / "scripts" / "torch_soak_nsweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_route(static, N, K, isz):
    """The JAX router's x-update route for the collision QP, from its own
    gate arithmetic (``solve_qp_state``: the auto group, the 12 MiB and
    96 MiB gates, the fused choice)."""
    np_ = -(-6 * N // 128) * 128
    per_g = 4 * np_ * np_ * isz + 5 * K * np_ * isz
    auto_g = max(1, min(32, (12 * 1024 * 1024) // per_g))
    group_n = (static.group if static.group > 0
               else auto_g if static.group == 0 and static.pallas else 0)
    factor_bytes = 2 * K * (6 * N) ** 2 * isz
    if static.factor_form == "X":
        nr8 = -(-6 * N // 8) * 8
        fused_ok = K * nr8 * np_ * isz <= 96 * 1024 * 1024
        use_fused = static.fused and fused_ok and (group_n == 0
                                                   or group_n < 16)
    else:
        use_fused = (static.fused and group_n == 0
                     and factor_bytes <= 12 * 1024 * 1024)
    if use_fused:
        return f"fused_{static.factor_form}"
    if group_n:
        return f"grouped_{static.factor_form}"
    if static.pallas and 2 * factor_bytes <= 12 * 1024 * 1024:
        return "resident"
    return "dense"


@pytest.mark.parametrize("N", [10, 20, 30, 40, 50, 60])
def test_sweep_widths_route_as_jax_and_fit_the_plans(N):
    """The production solver at K = 50 in float32: N = 10 and 20 on the
    grouped X sweeps (the soak's chunk 512 and its tail chunk 128), N >= 30
    on the fused X interval, which reads packed upper triangles at N = 50
    and 60 (n = 300, 360)."""
    K = 50
    problem = jcfg.ProblemConfig(n_vehicles=N, time_horizon=10.0,
                                 time_step=0.2, min_distance=0.8)
    jstatic = jcfg.SolverConfig.production(pallas=True,
                                           problem=problem).static_part()
    want = _jax_route(jstatic, N, K, 4)
    static = SolverConfig.production(problem=ProblemConfig(
        n_vehicles=N, time_horizon=10.0, time_step=0.2,
        min_distance=0.8)).static_part()
    took = tb.qp_route(static, n_vehicles=N, n_steps=K, dtype=torch.float32,
                       col_enabled=True)
    assert took == want == ("grouped_X" if N <= 21 else "fused_X")
    n = 6 * N
    if took == "fused_X":
        plan = af.fused_plan(K, N, "X")
        assert plan.smem_bytes <= af.FUSED_SMEM_MAX
        assert plan.packed == (af.FUSED_X_PACKED_MIN_N <= n
                               <= af.FUSED_X_PACKED_MAX_N)
        assert plan.packed or N < 39
    else:
        for B in (512, 128, 1024):
            plan = gs.sweep_plan(B, K, n, "X")
            assert plan.smem_bytes <= gs.SMEM_BLOCK_MAX


def test_soak_twin_record_has_the_jax_record_keys(tmp_path):
    """``--ns 3 --batch 8 --device cpu``: the soak and the sweep at N = 3,
    eight scenarios each; the record holds every key of the JAX record, at
    the top and in each configuration, and the port's own keys."""
    out = tmp_path / "record.json"
    mod = _script()
    rc = mod.main(["--ns", "3", "--batch", "8", "--device", "cpu",
                   "--out", str(out)])
    assert rc == 0
    rec = json.loads(out.read_text())
    jax_rec = json.loads((ROOT / "docs" / "soak_nsweep_v5e.json").read_text())
    assert set(jax_rec) <= set(rec)
    assert {"card", "bar_misses"} <= set(rec)
    entries = [rec["soak"]] + rec["n_sweep"]
    assert len(entries) == 2
    want_keys = set(jax_rec["soak"]) | {"mean_qp_iters", "route",
                                        "peak_mem_gib", "launches",
                                        "missed_lanes"}
    for want in jax_rec["n_sweep"]:
        assert set(want) <= want_keys
    for e in entries:
        assert want_keys <= set(e)
        assert (e["N"], e["batch"], e["chunk"]) == (3, 8, 8)
        assert 0 <= e["collision_free"] <= 8
        assert e["route"] == "grouped_X"
        assert np.isfinite(e["solves_per_sec"]) and e["mean_qp_iters"] > 0
        assert not any(e["launches"].values())     # plain versions only
        assert len(e["missed_lanes"]) == 8 - e["collision_free"]


def test_soak_twin_holds_the_validated_widths_to_the_jax_record():
    """The bars apply to the soak and N = 10 .. 40 at the JAX record's
    batches only: every lane collision-free, mean SCP iterations within
    0.05 of JAX's."""
    mod = _script()
    ok = dict(N=30, batch=2048, collision_free=2048, mean_scp_iters=1.80,
              missed_lanes=[])
    assert mod.bar_misses(ok) == []
    assert len(mod.bar_misses(dict(ok, mean_scp_iters=1.82))) == 1
    assert len(mod.bar_misses(dict(ok, collision_free=2047,
                                   missed_lanes=[5]))) == 1
    assert mod.bar_misses(dict(ok, N=60, mean_scp_iters=9.0)) == []
    assert mod.bar_misses(dict(ok, batch=256, mean_scp_iters=9.0)) == []
    jax_rec = json.loads((ROOT / "docs" / "soak_nsweep_v5e.json").read_text())
    assert mod.bar_misses(dict(ok, N=20, batch=4096, collision_free=4096,
                               mean_scp_iters=1.40)) != []
    assert mod.JAX_RECORD == {(e["N"], e["batch"]): e["mean_scp_iters"]
                              for e in [jax_rec["soak"]] + jax_rec["n_sweep"]}


def test_soak_twin_keeps_the_successful_draws_at_n_60():
    """At N = 60 rejection sampling fills both position sets of a lane in
    a few percent of the draws (the four start circles hold about 59
    vehicles 0.8 m apart when filled at random), so the twin keeps the
    lanes that succeeded, batch after batch from consecutive seeds: B
    scenarios, every pair of each set at least R apart, the same for the
    same seed.  At N = 3 the first batch is the whole draw.  Later batches
    are cut from DRAW_BATCH to 64 lanes to keep the host's rejection loop
    short."""
    mod = _script()
    mod.DRAW_BATCH = 64
    p0, pf, drawn = mod.scenarios(5, 4, 60, "cpu")
    assert p0.shape == pf.shape == (4, 60, 2) and drawn > 4
    for pts in (p0, pf):
        d = torch.cdist(pts.double(), pts.double())
        d = d + torch.eye(60, dtype=torch.float64) * 1e3
        assert float(d.min()) >= mod.R - 1e-6
        assert float(pts.abs().max()) <= 20.0
    again = mod.scenarios(5, 4, 60, "cpu")
    assert torch.equal(again[0], p0) and again[2] == drawn
    small = mod.scenarios(5, 8, 3, "cpu")
    assert small[2] == 8 and small[0].shape == (8, 3, 2)
