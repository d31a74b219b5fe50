"""PyTorch port, the fused ADMM-interval module (``ops/admm_fused.py``) and
the fused route of ``solve_qp_state``, held against the JAX package.

On the CPU the wrapper runs its plain version, which is held (a) against
the Pallas kernel ``_fused_batched_X`` in interpret mode, with one scenario
per program (``_admm_kernel_X``) and two (``_admm_kernel_XG``); (b) the
fused route of the port's ``solve_qp_state`` against the JAX one; (c) the
fused route against the port's grouped route in float64; (d) the whole
slice, ``solve_compacted`` on the fused route, against the JAX engine.  The
CUDA kernel itself is held against the plain version in
``test_torch_kernels_gpu.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ba_path_planning_tpu.ops import collisions as jcol
from ba_path_planning_tpu.ops.pallas import admm_fused as jaf
from ba_path_planning_tpu.ops.rollout import rollout as jrollout
from ba_path_planning_tpu.solvers import banded as jb
from ba_path_planning_tpu.solvers.admm import make_solver_params as jparams
from ba_path_planning_tpu.solvers.scp import SCPEngine as JEngine
from ba_path_planning_tpu.solvers.scp import _warm_state as j_warm_state
from ba_path_planning_tpu.utils import config as jcfg

from ba_path_planning_torch.ops import admm_fused
from ba_path_planning_torch.parallel.mesh import ShardedSCPSolver
from ba_path_planning_torch.solvers import banded as tb
from ba_path_planning_torch.utils.config import (SolverConfig,
                                                 make_solver_params)
from ba_path_planning_torch.utils.convert import (config_from_jax,
                                                  rowvals_from_numpy)

from test_torch_banded import _close_tree, _qp_inputs
from test_torch_scp import JaxAngles, _problem, _scenarios

F32, F64 = torch.float32, torch.float64
H = 0.2


def _iteration_qp(N=4, K=10, B=4, seed=5):
    """The QP of one SCP iteration, built with the JAX package in float64:
    phase-1 solution, linearized collision rows (row 0 vacuous, rows k >= 1
    finite), warm start and duals from phase 1."""
    problem, p0, v0, pf, lo, up, x0 = _qp_inputs(N=N, K=K, B=B, seed=seed)
    P = problem.n_pairs
    cfg = jcfg.SolverConfig.production(pallas=False,
                                       problem=problem).replace(group=2)
    E = jcol.make_pair_index(N, dtype=jnp.float64).E
    prm = jparams(cfg, jnp.float64)
    y0 = jax.tree.map(jnp.zeros_like, lo)
    phase1 = jax.vmap(lambda l, u, x, y: jb.solve_qp_state(
        l, u, jnp.zeros((K, P, 2)), x, prm, E, h=H, static=cfg.static_part(),
        n_vehicles=N, y_init=y, col_enabled=False))(lo, up, x0, y0)
    a = phase1.x.a
    jp = jcol.make_pair_index(N, dtype=jnp.float64)
    prev, _ = jrollout(a, jnp.asarray(p0), jnp.asarray(v0), H)
    eta, dist = jax.vmap(lambda p: jcol.linearize(p, jp,
                                                  jax.random.key(0)))(prev)
    col_lo = jax.vmap(lambda e, d, p: jb.collision_lower_bounds_state(
        e, d, p, jp, min_distance=problem.min_distance + 0.13))(eta, dist,
                                                                prev)
    xw = jax.vmap(lambda aa, pp, vv: j_warm_state(aa, pp, vv, H))(
        a, jnp.asarray(p0), jnp.asarray(v0))
    return problem, lo._replace(col=col_lo), up, eta, xw, phase1.y


def _np(tree, dtype):
    return jax.tree.map(lambda t: np.array(t, dtype), tree)


def _interval_inputs(dtype=np.float32, **kw):
    """Everything one fused interval reads, as numpy arrays of ``dtype``:
    the rows of :func:`_iteration_qp`, z = clip(A x, l, u), and the port's
    X-form factors of the production rho pattern (no isinf fix-up, as the
    fused route builds them)."""
    problem, *rest = _iteration_qp(**kw)
    lo, up, eta, xw, y = _np(rest, dtype)
    N, K, P = problem.n_vehicles, problem.n_steps, problem.n_pairs
    tdt = torch.float32 if dtype == np.float32 else F64
    _, tsolver = config_from_jax(problem, jcfg.SolverConfig.production(
        pallas=False, problem=problem).replace(fused=True))
    prm = make_solver_params(tsolver, tdt)
    scaling = tb.row_scaling_state(K, H, dtype=tdt)
    rho = tb.rho_pattern_masks(scaling, tsolver.static_part(), prm.rho,
                               prm.col_rho_boost, n_steps=K, n_pairs=P,
                               col_enabled=True, dtype=tdt)
    E = torch.as_tensor(np.array(jcol.make_pair_index(N).E), dtype=tdt)
    t_eta = torch.as_tensor(eta)
    D, C = tb.assemble_D(rho, t_eta, E, h=H, sigma=prm.sigma, n_vehicles=N)
    X = tb.factorize_X(D, C, ns_iters=2)
    t_lo, t_up = rowvals_from_numpy(lo, tdt), rowvals_from_numpy(up, tdt)
    t_x = tb.StateVars(*map(torch.as_tensor, xw))
    z = tb.tree_map(torch.clamp, tb.apply_A(t_x, t_eta, E, H), t_lo, t_up)
    return dict(N=N, K=K, P=P, prm=prm, rho=rho, E=E, eta=t_eta, X=X, C=C,
                lower=t_lo, upper=t_up, x=t_x, z=z,
                y=rowvals_from_numpy(y, tdt))


def _port_interval(inp, n_iters):
    prm = inp["prm"]
    return admm_fused.admm_interval_fused_X(
        inp["X"], inp["C"], inp["eta"], inp["E"], inp["lower"], inp["upper"],
        inp["x"], inp["z"], inp["y"], inp["rho"], h=H, sigma=prm.sigma,
        alpha=prm.alpha, lam=prm.col_penalty, n_iters=n_iters)


def _jax_interval(inp, n_iters, group):
    """The Pallas kernel in interpret mode on the same inputs, its planes
    converted back to StateVars / RowVals."""
    N, K, prm = inp["N"], inp["K"], inp["prm"]

    def j(t):
        return jnp.asarray(t.numpy())

    def jrv(rv):
        return jb.RowVals(*map(j, rv))
    jrho = jrv(inp["rho"])._replace(col=j(inp["rho"].col.contiguous()))
    l_s, _ = jaf.bound_planes(jrv(inp["lower"]), -jnp.inf)
    u_s, _ = jaf.bound_planes(jrv(inp["upper"]), jnp.inf)
    zs, zc = jaf.rowvals_to_planes(jrv(inp["z"]))
    ys, yc = jaf.rowvals_to_planes(jrv(inp["y"]))
    rho_sk, rho_c = jaf.rho_planes(jrho, jb._LOOSE_RHO)
    E2b, E2bT = jaf.pair_matrices_block(N, jnp.float32)
    fpar = jnp.asarray([H, float(prm.sigma), float(prm.alpha),
                        float(prm.col_penalty)], jnp.float32)
    out = jaf._fused_batched_X(
        fpar, jnp.asarray([n_iters], jnp.int32),
        j(inp["C"]).reshape(K - 1, 9), j(inp["X"]),
        jaf.eta_to_block(j(inp["eta"])), l_s, u_s, j(inp["lower"].col),
        j(tb.to_stacked(inp["x"])), zs, zc, ys, yc,
        rho_sk, rho_c, E2b, E2bT, interpret=True, group=group)
    xp, zsp, zcp, ysp, ycp = (np.array(t) for t in out)
    return (tb.from_stacked(torch.as_tensor(xp), N),
            jaf.planes_to_rowvals(zsp, zcp, N, jb.RowVals),
            jaf.planes_to_rowvals(ysp, ycp, N, jb.RowVals))


def _rel(got, want):
    """max |got - want| / max(max |want|, 1) over a leaf (some leaves, the
    duals of inactive rows, are all zero)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1.0)


# float32 against float32 in another summation order: about 1e-5 on every
# leaf after one iteration and 2e-5 after twelve (alpha = 1.9 and the 1e3
# rho boost of the equality rows amplify rounding), so 1e-4 and 5e-4.
_TOL = {1: 1e-4, 12: 5e-4}


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("n_iters", [1, 12])
def test_plain_interval_matches_pallas_interpret(group, n_iters):
    """N=4, K=10, B=4, float32: ``group=1`` runs ``_admm_kernel_X``,
    ``group=2`` ``_admm_kernel_XG``; every leaf of x, z and y within the
    tolerance of :data:`_TOL` (relative, :func:`_rel`)."""
    inp = _interval_inputs()
    before = admm_fused.admm_interval_fused_X.launches
    x, z, y = _port_interval(inp, n_iters)
    assert admm_fused.admm_interval_fused_X.launches == before   # plain
    jx, jz, jy = _jax_interval(inp, n_iters, group)
    for got, want in zip(list(x) + list(z) + list(y),
                         list(jx) + list(jz) + list(jy)):
        assert got.dtype == F32 and _rel(got, want) < _TOL[n_iters]


# The short-horizon fleet the router sends to the fused X route at K = 9
# (its widest N there, n = 1608): the rows' products sum 1608 terms against
# 24 at N = 4, so float32 against float32 in another order lands up to
# about 7e-5 after two iterations; 2e-4 leaves the same margin over it
# that _TOL leaves at N = 4.
_TOL_WIDE = 2e-4


def test_plain_interval_matches_pallas_interpret_at_k9_n268():
    """B=1, K=9, N=268, two iterations, float32: the widest N the router
    sends to ``fused_X`` at K = 9, which the card's kernel serves since its
    pair table left shared memory; one scenario a program
    (``_admm_kernel_X``), every leaf within :data:`_TOL_WIDE`."""
    inp = _interval_inputs(N=268, K=9, B=1, seed=268)
    assert tb.qp_route(SolverConfig.production().static_part(),
                       n_vehicles=268, n_steps=9, dtype=F32,
                       col_enabled=True) == "fused_X"
    x, z, y = _port_interval(inp, 2)
    jx, jz, jy = _jax_interval(inp, 2, 1)
    for got, want in zip(list(x) + list(z) + list(y),
                         list(jx) + list(jz) + list(jy)):
        assert got.dtype == F32 and _rel(got, want) < _TOL_WIDE


def test_plain_interval_leaves_inputs_and_counts_zero_iters():
    inp = _interval_inputs()
    keep = [t.clone() for t in list(inp["z"]) + list(inp["y"])]
    x, z, y = _port_interval(inp, 0)
    assert x is inp["x"] and z is inp["z"] and y is inp["y"]
    x, z, y = _port_interval(inp, 3)
    for a, b in zip(keep, list(inp["z"]) + list(inp["y"])):
        assert torch.equal(a, b)


def _solve_fused(jproblem, lo, up, eta, xw, y0, dtype, **change):
    """The port's ``solve_qp_state`` with the JAX ``production(pallas=False)``
    options and ``change``, on numpy inputs of ``dtype``."""
    N = jproblem.n_vehicles
    jsolver = jcfg.SolverConfig.production(pallas=False,
                                           problem=jproblem).replace(**change)
    _, tsolver = config_from_jax(jproblem, jsolver)
    E = torch.as_tensor(np.array(jcol.make_pair_index(N).E), dtype=dtype)
    return tb.solve_qp_state(
        rowvals_from_numpy(lo, dtype), rowvals_from_numpy(up, dtype),
        torch.as_tensor(np.asarray(eta), dtype=dtype),
        tb.StateVars(*(torch.as_tensor(np.asarray(t), dtype=dtype)
                       for t in xw)),
        make_solver_params(tsolver, dtype), E, h=H,
        static=tsolver.static_part(), n_vehicles=N,
        y_init=rowvals_from_numpy(y0, dtype)), tsolver, jsolver


def test_fused_route_qp_matches_jax_fused_f32():
    """float32, the JAX package's own tolerances for its fused kernel
    against its XLA loop (tests/test_admm_fused.py:168-176): x atol 2e-4 /
    rtol 1e-3, y atol 5e-3 / rtol 1e-2; equal iterations and convergence
    flags."""
    problem, *rest = _iteration_qp()
    lo, up, eta, xw, y0 = _np(rest, np.float32)
    N = problem.n_vehicles
    res, tsolver, jsolver = _solve_fused(problem, lo, up, eta, xw, y0, F32,
                                         fused=True)
    assert tb.qp_route(tsolver.static_part(), n_vehicles=N,
                       n_steps=problem.n_steps, dtype=F32,
                       col_enabled=True) == "fused_X"
    prm = jparams(jsolver, jnp.float32)
    E = jcol.make_pair_index(N, dtype=jnp.float32).E
    jres = jax.vmap(lambda l, u, e, x, y: jb.solve_qp_state(
        l, u, e, x, prm, E, h=H, static=jsolver.static_part(), n_vehicles=N,
        y_init=y))(*(jax.tree.map(jnp.asarray, t)
                     for t in (lo, up, eta, xw, y0)))
    for got, want in zip(res.x, jres.x):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                                   rtol=1e-3)
    for got, want in zip(res.y, jres.y):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3,
                                   rtol=1e-2)
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(jres.iters))
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(jres.converged))


def test_fused_route_equals_grouped_route_f64():
    """With finite collision rows k >= 1 the rho fix-up of the grouped
    route changes nothing, so the two routes are the same math: float64,
    1e-10 relative."""
    problem, *rest = _iteration_qp()
    lo, up, eta, xw, y0 = _np(rest, np.float64)
    fused, _, _ = _solve_fused(problem, lo, up, eta, xw, y0, F64, fused=True)
    grouped, tsolver, _ = _solve_fused(problem, lo, up, eta, xw, y0, F64,
                                       group=2)
    assert tb.qp_route(tsolver.static_part(), n_vehicles=problem.n_vehicles,
                       n_steps=problem.n_steps, dtype=F64,
                       col_enabled=True) == "grouped_X"
    _close_tree(fused.x, grouped.x)
    _close_tree(fused.y, grouped.y)
    np.testing.assert_array_equal(fused.converged.numpy(),
                                  grouped.converged.numpy())


@pytest.mark.parametrize("N,B,chunk", [(3, 4, 2)])
def test_solve_compacted_fused_route_matches_jax_engine(N, B, chunk):
    """The whole slice on the fused route, float64:
    ``production(kernels=False).replace(fused=True)`` against the JAX engine
    under the same options (its fused kernel in interpret mode).  Equal
    statuses and SCP and QP iteration counts, positions within 1e-3 (the
    JAX kernel takes its pair-coupling products in float32)."""
    problem = _problem(N)
    p0, pf = _scenarios(B, N, seed=N)
    v0 = np.zeros_like(p0)
    keys = jax.random.split(jax.random.key(3), B)
    jsolver = jcfg.SolverConfig.production(
        pallas=False, problem=problem).replace(fused=True)
    want = JEngine(problem, jsolver, dtype=jnp.float64).solve_batch(
        p0, v0, pf, v0, keys)
    tp, ts = config_from_jax(problem, jsolver)
    assert tb.qp_route(ts.static_part(), n_vehicles=N, n_steps=tp.n_steps,
                       dtype=F64, col_enabled=True) == "fused_X"
    solver = ShardedSCPSolver(tp, ts, dtype=F64, device="cpu")
    got = solver.solve_compacted(p0, v0, pf, v0, chunk=chunk,
                                 angle_fn=JaxAngles(keys, N, tp.n_steps))
    for name in ("status", "iterations", "feasible_final", "qp_iterations"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.positions.numpy(),
                               np.asarray(want.positions), atol=1e-3)
    assert max(np.asarray(want.iterations)) >= 1     # the SCP loop ran
