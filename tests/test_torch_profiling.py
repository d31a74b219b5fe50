"""PyTorch port, the profiling helpers (``utils/profiling.py``): the cost
models against a count by hand at N=20, K=50 in float32 and with bf16
factors (rows on the 8-element stride), the CG method's FLOP count against
the JAX package's formula, ``trace``'s Chrome-trace file on the CPU, and
the spans, host reads and host writes of the production solve path: under
a CPU ``torch.profiler`` a ``solve_compacted`` opens every span of the path
under its parent, reads from and copies to the card as often as the code
implies and gives the answers of an unprofiled call, bit for bit; with no
profiler a span opens no range."""

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


def test_trace_writes_a_chrome_trace(tmp_path):
    with prof.trace(str(tmp_path)) as p:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    data = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in data["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in p.key_averages())


@pytest.mark.parametrize("n", [6, 120, 2052])
def test_ns_chain_interior_flops_counts_what_the_kernel_forms(n):
    """The NS chain's interior count, element by element: each of the K-4
    interior steps forms S_k (9 outputs of 13 operations a slot pair, of
    (n/3)^2 pairs), then per Newton-Schulz iteration every element of
    T' = X S (a length-n dot product) and the update's elements on and
    above the diagonal only (a dot product, then 2 x - v), for each of B
    scenarios; about 3/4 of two whole products at large n."""
    B, K, iters = 3, 50, 2
    slot_pairs = (n // 3) ** 2
    whole = n * n * 2 * n
    upper = sum(n - i for i in range(n)) * (2 * n + 2)
    step = 117 * slot_pairs + iters * (whole + upper)
    assert prof.ns_chain_interior_flops(B, K, n, iters) == B * (K - 4) * step
    if n == 2052:
        ratio = step / (iters * 4 * n ** 3)
        assert 0.75 < ratio < 0.752


# The spans of the production solve path on the CPU and the parents they
# nest under (the QP's under the SCP step, and under phase 1 for its
# collision-free QP; the bounds and the goal projection's copies also under
# phase 1 and finalize).  The card's NS chain also opens ``qp.anchors``
# under ``qp.factors`` (tests/test_torch_kernels_gpu.py).
QP_PARENTS = {"scp.step", "mesh.phase1"}
SPAN_PARENTS = {
    "mesh.call": {None}, "mesh.phase1": {"mesh.call"},
    "mesh.pack": {"mesh.call"}, "mesh.scatter": {"mesh.call"},
    "mesh.finalize": {"mesh.call"}, "mesh.host_read": {"mesh.call"},
    "mesh.host_write": {"mesh.pack"},
    "scp.step": {"mesh.call"}, "scp.host_read": {"scp.step"},
    "scp.host_write": {"scp.step", "scp.check", "mesh.phase1",
                       "mesh.finalize"},
    "scp.linearize": {"scp.step"}, "scp.check": {"scp.step"},
    "scp.merge": {"scp.step"},
    "qp.rows": QP_PARENTS, "qp.factors": QP_PARENTS,
    "qp.interval": QP_PARENTS, "qp.residuals": QP_PARENTS,
    "qp.host_write": {"qp.rows", "qp.interval"},
    "qp.assemble": {"qp.factors"}, "qp.ns_chain": {"qp.factors"},
}


def _solve(profiled: bool, chunk: int, step_iters: int):
    """A production ``solve_compacted`` at N=3, K=20, B=4, stopping and
    projecting onto the goals as the benchmark's configuration does, in
    dispatches of ``chunk`` on the CPU:
    (result, last_timing, the program's spans as (start, end, name) sorted,
    longest first at a start)."""
    from torch.profiler import ProfilerActivity, profile

    from ba_path_planning_torch.parallel.mesh import ShardedSCPSolver
    from ba_path_planning_torch.scenarios.generator import (
        generate_scenario_batch)
    from ba_path_planning_torch.utils.config import (ProblemConfig,
                                                     SolverConfig)
    problem = ProblemConfig(n_vehicles=3, time_horizon=4.0, time_step=0.2,
                            min_distance=0.8, stop_mode="feasible",
                            goal_project=True)
    solver = ShardedSCPSolver(problem, SolverConfig.production(
        problem=problem), dtype=torch.float32, device="cpu")
    sc = generate_scenario_batch(3, 4, n_vehicles=3, min_distance=0.8,
                                 device="cpu")
    v0 = torch.zeros_like(sc.initial)

    def call():
        return solver.solve_compacted(sc.initial, v0, sc.final, v0,
                                      chunk=chunk, step_iters=step_iters)
    if not profiled:
        return call(), solver.last_timing, []
    with profile(activities=[ProfilerActivity.CPU]) as p:
        res = call()
    spans = sorted(((e.start_ns(), e.end_ns(), e.name())
                    for e in p.profiler.kineto_results.events()
                    if e.name().partition(".")[0] in ("mesh", "scp", "qp")),
                   key=lambda s: (s[0], -s[1]))
    return res, solver.last_timing, spans


@pytest.fixture(scope="module")
def solves():
    """The same solve unprofiled with ``record_function`` made to raise
    (a span that opened a range would fail it), then profiled, at one SCP
    iteration a dispatch of 4 (tails of 1); and profiled at the whole
    budget a dispatch of 2, so that the two lanes of one dispatch stop at
    different iterations."""
    def refuse(*a, **k):
        raise AssertionError("a span opened a range with no profiler")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", refuse)
        plain = _solve(False, 4, 1)
    return {"plain": plain, "profiled": _solve(True, 4, 1),
            "whole": _solve(True, 2, 15)}


def _parents(spans):
    """The name of each span's parent (None for the outermost)."""
    out, stack = [], []
    for s, e, name in spans:
        while stack and stack[-1][1] <= s:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
        stack.append((s, e, name))
    return out


def test_span_without_a_profiler_is_one_null_context(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    first, second = prof.span("mesh.call"), prof.span("qp.factors")
    assert first is second
    with first:
        with second:
            pass
    reads, writes = prof.host_read.count, prof.host_write.count
    assert prof.host_read("scp", torch.ones(2)).tolist() == [1.0, 1.0]
    assert prof.host_read.count == reads + 1
    w = prof.host_write("qp", [2.0], dtype=torch.float64, device="cpu")
    assert w.dtype == torch.float64 and w.tolist() == [2.0]
    assert prof.host_write.count == writes + 1


def test_a_profiled_call_opens_every_span_under_its_parent(solves):
    names = set()
    for key in ("profiled", "whole"):
        spans = solves[key][2]
        call = [sp for sp in spans if sp[2] == "mesh.call"]
        assert len(call) == 1
        for (s, e, name), parent in zip(spans, _parents(spans)):
            assert parent in SPAN_PARENTS[name], (name, parent)
            assert call[0][0] <= s and e <= call[0][1]
            names.add(name)
    assert names == set(SPAN_PARENTS)
    # phase 1's QP runs on the channel route: its own qp spans, no chain;
    # beside it, the copies of the bounds and of the goal projection
    phase1 = [sp for sp, parent in zip(solves["profiled"][2],
                                       _parents(solves["profiled"][2]))
              if parent == "mesh.phase1"]
    assert {n for *_, n in phase1} == {"qp.rows", "qp.factors",
                                       "qp.interval", "qp.residuals",
                                       "scp.host_write"}


def test_host_reads_are_the_count_the_code_implies(solves):
    """1 after phase 1, 1 a round, 3 a dispatch at one SCP iteration a
    dispatch (does a lane go on; do all; none after the iteration); the
    profiled call counts as many ``*.host_read`` spans."""
    for key in ("plain", "profiled"):
        t = solves[key][1]
        assert t["loop_dispatches"] > t["loop_rounds"] >= 2
        assert t["host_reads"] == (1 + t["loop_rounds"]
                                   + 3 * t["loop_dispatches"])
        assert 0.0 <= t["host_read_s"] <= t["call_s"]
    spans = solves["profiled"][2]
    assert solves["profiled"][1]["host_reads"] == sum(
        name.endswith(".host_read") for *_, name in spans)
    assert solves["plain"][1]["host_reads"] == solves["profiled"][1][
        "host_reads"]


def test_host_writes_are_the_count_the_code_implies(solves):
    """At one SCP iteration a dispatch: a dispatch copies its lane index
    (``mesh``), the position bounds' two corners and the degenerate
    angles' seed, the goal projection's column (``scp``), the QP's seven
    row scalings, its loose rho and the interval's step length (``qp``);
    phase 1 the same less the index and the seed; finalize the goal
    projection's column.  The profiled calls count as many
    ``*.host_write`` spans."""
    for key in ("plain", "profiled"):
        t = solves[key][1]
        assert t["host_writes"] == 13 + 14 * t["loop_dispatches"]
        assert 0.0 <= t["host_write_s"] <= t["call_s"]
        assert t["loop_prep_s"] + t["loop_enqueue_s"] + t["host_read_s"] \
            + t["host_write_s"] <= t["call_s"]
    for key in ("profiled", "whole"):
        assert solves[key][1]["host_writes"] == sum(
            name.endswith(".host_write") for *_, name in solves[key][2])


def test_a_profiled_call_answers_as_an_unprofiled_one(solves):
    plain, profiled = solves["plain"][0], solves["profiled"][0]
    for name, a, b in zip(plain._fields, plain, profiled):
        assert torch.equal(a, b), name
