"""PyTorch port, the solver options of the JAX package end to end: the
default ``SolverConfig()`` (the CG method with adaptive rho and its polish)
behind ``SCPEngine(problem)``, the parity configuration of
``scripts/parity_full.py`` (the direct method with the exact active-set
polish), and the production solver with adaptive rho and polish, each held
against the JAX ``SCPEngine`` at N=3, K=10, B=4 in float64: equal statuses,
SCP and QP iteration counts, positions within 1e-6.

The JAX engine's grouped sweeps refuse a per-lane rho under ``vmap``, so
with adaptive rho on that route its scenarios are solved one at a time
(``SCPEngine.solve``), which is what each lane of its vmapped solve
computes.  The degenerate-pair angles of the JAX engine are injected into
the port, so both draw the same directions.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ba_path_planning_tpu.solvers.scp import SCPEngine as JEngine
from ba_path_planning_tpu.utils import config as jcfg

from ba_path_planning_torch.parallel.mesh import ShardedSCPSolver
from ba_path_planning_torch.solvers.scp import SCPEngine
from ba_path_planning_torch.utils.convert import config_from_jax

from test_torch_scp import JaxAngles, _problem, _scenarios

F64 = torch.float64
N, B = 3, 4


def _parity_solver():
    """``scripts/parity_full.py``'s engine configuration."""
    return jcfg.SolverConfig(method="direct", eps_abs=1e-6, eps_rel=1e-6,
                             polish=True, rho=1.6, adaptive_rho=False,
                             max_iter=50000, check_interval=100)


def _inputs(problem, seed):
    p0, pf = _scenarios(B, N, seed=seed)
    keys = jax.random.split(jax.random.key(3), B)
    return p0, np.zeros_like(p0), pf, keys


def _compare(got, want):
    for name in ("status", "iterations", "qp_iterations", "feasible_final",
                 "qp_converged_all"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.positions.numpy(),
                               np.asarray(want.positions), rtol=0, atol=1e-6)


# min_distance 0.3: the default solver's QPs converge on these crossings
# (at 0.8 some spend their 4000 iterations, and two implementations of an
# unconverged ADMM run part ways)
def _cg_problem():
    return _problem(N).replace(min_distance=0.3)


def test_default_solver_config_matches_jax():
    """``SCPEngine(problem)``: the CG method, adaptive rho, CG polish."""
    problem = _cg_problem()
    p0, v0, pf, keys = _inputs(problem, seed=0)
    want = JEngine(problem, dtype=jnp.float64).solve_batch(p0, v0, pf, v0,
                                                           keys)
    tp, _ = config_from_jax(problem, jcfg.SolverConfig())
    eng = SCPEngine(tp, dtype=F64, device="cpu")
    assert eng.solver.method == "cg" and eng.solver.adaptive_rho \
        and eng.solver.polish
    got = eng.solve_batch(p0, v0, pf, v0,
                          angle_fn=JaxAngles(keys, N, tp.n_steps))
    _compare(got, want)
    assert int(np.asarray(want.iterations).max()) >= 1   # the loop ran
    # ShardedSCPSolver.solve serves the CG method too
    solver = ShardedSCPSolver(tp, dtype=F64, device="cpu")
    _compare(solver.solve(p0, v0, pf, v0,
                          angle_fn=JaxAngles(keys, N, tp.n_steps)), want)


def test_parity_config_matches_jax():
    """The direct method with the exact active-set polish on both phases
    (``_scp_start_direct`` and ``_direct_body``), the dense route."""
    problem = _cg_problem()
    p0, v0, pf, keys = _inputs(problem, seed=0)
    want = JEngine(problem, _parity_solver(),
                   dtype=jnp.float64).solve_batch(p0, v0, pf, v0, keys)
    tp, ts = config_from_jax(problem, _parity_solver())
    got = SCPEngine(tp, ts, dtype=F64, device="cpu").solve_batch(
        p0, v0, pf, v0, angle_fn=JaxAngles(keys, N, tp.n_steps))
    _compare(got, want)


def test_production_with_adaptive_rho_and_polish_matches_jax():
    """The production solver (grouped X route) with adaptive rho over four
    25-iteration intervals and the polish, through ``solve_compacted``."""
    problem = _problem(N)
    p0, v0, pf, keys = _inputs(problem, seed=N)
    jsolver = jcfg.SolverConfig.production(
        pallas=False, problem=problem).replace(group=2, adaptive_rho=True,
                                               polish=True, max_iter=100)
    eng = JEngine(problem, jsolver, dtype=jnp.float64)
    lanes = [eng.solve(p0[i], v0[i], pf[i], v0[i], key=keys[i])
             for i in range(B)]
    want = jax.tree.map(lambda *t: np.stack([np.asarray(a) for a in t]),
                        *lanes)
    tp, ts = config_from_jax(problem, jsolver)
    solver = ShardedSCPSolver(tp, ts, dtype=F64, device="cpu")
    got = solver.solve_compacted(p0, v0, pf, v0, chunk=2,
                                 angle_fn=JaxAngles(keys, N, tp.n_steps))
    _compare(got, want)
    assert int(np.asarray(want.iterations).max()) >= 1


def test_cg_method_is_not_resumable():
    """As in JAX, the CG method has no start/step/finalize:
    ``solve_compacted`` raises for it."""
    problem = _cg_problem()
    tp, _ = config_from_jax(problem, jcfg.SolverConfig())
    solver = ShardedSCPSolver(tp, dtype=F64, device="cpu")
    p0, v0, pf, _ = _inputs(problem, seed=0)
    with pytest.raises(NotImplementedError, match="direct"):
        solver.solve_compacted(p0, v0, pf, v0, chunk=2)
    with pytest.raises(NotImplementedError, match="resumable SCP"):
        solver.engine.start(*solver.engine.as_inputs(p0, v0, pf, v0))
