"""PyTorch port, the profiling helpers (``utils/profiling.py``): the cost
models against a count by hand at N=20, K=50 in float32 and with bf16
factors (rows on the 8-element stride), the CG method's FLOP count against
the JAX package's formula, ``PhaseTimer``'s summary and ``trace``'s
Chrome-trace file on the CPU."""

import json

import pytest
import torch

from ba_path_planning_tpu.utils import profiling as jprof

from ba_path_planning_torch.ops.cuda_build import BF16_ROW_ALIGN
from ba_path_planning_torch.utils import profiling as prof


@pytest.mark.parametrize("itemsize,ld", [(4, 120), (2, 120)])
def test_cost_models_count_the_port_layout(itemsize, ld):
    """N=20: n = 120 = 15 * 8, so the bf16 stride equals n; N=21 below
    checks a padded stride."""
    N, K, n = 20, 50, 120
    x = prof.direct_xupdate_cost(N, K, itemsize)
    assert x == {"flops": 2 * 50 * 2 * 120 * 120,
                 "hbm_bytes": 2 * 50 * 120 * ld * itemsize,
                 "n": 120, "ld": ld}
    P = 190
    it = prof.admm_iteration_cost(N, K, itemsize)
    assert it["flops"] == (x["flops"] + 2 * (2 * N * P * K * 2) * 2
                           + 12 * 6 * N * K)
    assert it["hbm_bytes"] == x["hbm_bytes"] + 10 * (6 * N * K + K * P) * 4
    f = prof.factorize_X_cost(N, K, itemsize=itemsize)
    assert f["flops"] == (46 * (2 * 2 * 2 * n ** 3 + 4 * n * n)
                          + 4 * int((7 / 3) * 2 * n ** 3))
    assert f["hbm_bytes"] == 3 * K * n * n * itemsize


def test_bf16_rows_lie_on_the_aligned_stride():
    x = prof.direct_xupdate_cost(21, 50, 2)
    assert x["n"] == 126 and x["ld"] == 128 and 128 % BF16_ROW_ALIGN == 0
    assert x["hbm_bytes"] == 2 * 50 * 126 * 128 * 2
    assert prof.direct_xupdate_cost(21, 50, 4)["ld"] == 126


def test_cg_flop_counts_match_the_jax_formula():
    for N, K, cg in ((20, 50, 10), (3, 10, 20)):
        assert (prof.admm_iteration_flops(N, K, cg)
                == jprof.admm_iteration_flops(N, K, cg))
        assert (prof.solve_flops(N, K, cg, 100, 5)
                == jprof.solve_flops(N, K, cg, 100, 5))


def test_bound_ms_takes_the_larger_time():
    cost = {"flops": 67e9, "hbm_bytes": 3.35e9}        # 1 ms each
    assert prof.bound_ms(cost, count=2) == pytest.approx((2.0, "bytes"))
    t, by = prof.bound_ms({"flops": 134e9, "hbm_bytes": 3.35e9})
    assert by == "operations" and t == pytest.approx(2.0)


def test_phase_timer_summary():
    timer = prof.PhaseTimer()
    for _ in range(2):
        with timer.phase("solve"):
            torch.ones(4).sum()
    with timer.phase("io"):
        pass
    s = timer.summary()
    assert set(s["phases"]) == {"solve", "io"}
    assert s["total_sec"] == pytest.approx(
        timer.phases["solve"] + timer.phases["io"])
    assert sum(p["frac"] for p in s["phases"].values()) == pytest.approx(1.0)
    assert json.loads(timer.report()) == s


def test_trace_writes_a_chrome_trace(tmp_path):
    with prof.trace(str(tmp_path)) as p:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    data = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in data["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in p.key_averages())
