"""The plain reference solves what the program solves: on the CPU in
float64, the program's plain path (its kernels' plain versions) and the
reference give the same trajectories, SCP counts and statuses; and the
reference's constraint operator and its adjoint agree."""

import torch

from ba_path_planning_torch.parallel.mesh import ShardedSCPSolver
from helpers import small_cell
from port_bench import run
from port_bench.reference import scp


def test_reference_equals_the_programs_plain_path_in_float64():
    cell = small_cell(n_vehicles=5)
    cell.config["dtype"] = "float64"
    spec = scp.from_config(cell.config)
    solver = run.build_solver(cell.config, "cpu")
    assert isinstance(solver, ShardedSCPSolver)
    (p0, pf), = run.draw_pool(cell.config, dict(cell.traffic,
                                                pool_batches=1), 17)
    v0 = torch.zeros_like(p0)
    res = solver.solve_compacted(p0, v0, pf, v0, chunk=4)
    ref = scp.solve(spec, p0, pf, torch.arange(p0.shape[0]))
    assert torch.equal(res.iterations.long(), ref.iterations)
    assert torch.equal(res.status.long(), ref.status)
    assert (res.positions - ref.positions).abs().max() < 1e-8
    assert bool((ref.iterations > 0).any())


def test_the_operator_and_its_adjoint_agree():
    g = torch.Generator().manual_seed(0)
    S, K, N = 2, 6, 3
    pi, pj = scp.pair_index(N)
    P = pi.numel()

    def r(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64)
    a, p, v = r(S, K, N, 2), r(S, K, N, 2), r(S, K, N, 2)
    eta = r(S, K, P, 2)
    rows = scp.apply_A(a, p, v, 0.2, eta, pi, pj)
    y = {k: r(*t.shape) for k, t in rows.items()}
    ta, tp, tv = scp.apply_AT(y, 0.2, N, eta, pi, pj)
    lhs = sum(float((rows[k] * y[k]).sum()) for k in rows)
    rhs = float((a * ta).sum() + (p * tp).sum() + (v * tv).sum())
    assert abs(lhs - rhs) < 1e-9 * max(1.0, abs(lhs))
