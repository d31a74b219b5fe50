"""PyTorch port, modules 6-8 and 11 (``solvers/banded.py``): rows and
bounds, the phase-1 channel path, the X-form factors and one whole QP, each
held against the JAX package on the same numpy inputs.  Tolerances: 1e-10
relative in float64 for the building blocks, 1e-8 for a whole 25-iteration
ADMM solve.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ba_path_planning_tpu.ops import collisions as jcol
from ba_path_planning_tpu.ops.rollout import rollout as jrollout
from ba_path_planning_tpu.solvers import banded as jb
from ba_path_planning_tpu.solvers.admm import make_solver_params as jparams
from ba_path_planning_tpu.solvers.scp import _warm_state as j_warm_state
from ba_path_planning_tpu.utils import config as jcfg

from ba_path_planning_torch.ops import collisions as tcol
from ba_path_planning_torch.solvers import banded as tb
from ba_path_planning_torch.utils.config import make_solver_params
from ba_path_planning_torch.utils.convert import (config_from_jax,
                                                  rowvals_from_numpy)

F64 = torch.float64


def T(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def _close(got, want, rtol=1e-10):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want[np.isfinite(want)]), initial=0.0)),
                1e-30)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    assert float(np.max(np.abs(got[fin] - want[fin]), initial=0.0)) \
        <= rtol * scale


def _close_tree(got, want, rtol=1e-10):
    for g, w in zip(got, want):
        _close(g, w, rtol)


def _state(rng, B, N, K):
    return [rng.normal(size=(B, N, K, 2)) for _ in range(3)]


def _eta(rng, B, K, P):
    e = rng.normal(size=(B, K, P, 2))
    return e / np.linalg.norm(e, axis=-1, keepdims=True)


def _rho(static, N, K, col_enabled, dtype):
    scaling = jb.row_scaling_state(K, 0.2, dtype=dtype)
    return jb.rho_pattern_masks(scaling, static, dtype(2.6), dtype(2.5),
                                n_steps=K, n_pairs=N * (N - 1) // 2,
                                col_enabled=col_enabled, dtype=dtype)


STATIC = jcfg.SolverConfig.production(pallas=False).static_part()


def test_apply_A_AT_match_jax_and_are_adjoint():
    rng = np.random.default_rng(0)
    B, N, K, h = 2, 4, 6, 0.2
    P = N * (N - 1) // 2
    x = _state(rng, B, N, K)
    eta = _eta(rng, B, K, P)
    E = np.asarray(jcol.make_pair_index(N, dtype=jnp.float64).E)
    jx = jb.StateVars(*map(jnp.asarray, x))
    Ax = tb.apply_A(tb.StateVars(*map(T, x)), T(eta), T(E), h)
    jAx = jax.vmap(lambda xv, e: jb.apply_A(xv, e, jnp.asarray(E), h))(
        jx, jnp.asarray(eta))
    _close_tree(Ax, jAx)
    y = [rng.normal(size=np.shape(leaf)) for leaf in jAx]
    ATy = tb.apply_AT(tb.RowVals(*map(T, y)), T(eta), T(E), h)
    jATy = jax.vmap(lambda yv, e: jb.apply_AT(yv, e, jnp.asarray(E), h))(
        jb.RowVals(*map(jnp.asarray, y)), jnp.asarray(eta))
    _close_tree(ATy, jATy)
    # <A x, y> = <x, A^T y> per scenario
    lhs = sum((a * T(b)).sum(dim=tuple(range(1, a.dim())))
              for a, b in zip(Ax, y))
    rhs = sum((T(a) * b).sum(dim=tuple(range(1, b.dim())))
              for a, b in zip(x, ATy))
    assert torch.allclose(lhs, rhs, rtol=1e-12, atol=1e-12)


def test_bounds_scaling_and_rho_match_jax():
    rng = np.random.default_rng(1)
    B, N, K, h = 3, 4, 7, 0.2
    P = N * (N - 1) // 2
    lim = jcfg.ProblemConfig(n_vehicles=N).limits
    arrs = [rng.normal(size=(B, N, 2)) for _ in range(4)]
    lo, up = tb.build_bounds(*map(T, arrs), n_vehicles=N, n_steps=K, h=h,
                             limits=lim, n_pairs=P)
    jlo, jup = jax.vmap(lambda a, b, c, d: jb.build_bounds(
        a, b, c, d, n_vehicles=N, n_steps=K, h=h, limits=lim, n_pairs=P))(
        *map(jnp.asarray, arrs))
    _close_tree(lo, jlo)
    _close_tree(up, jup)

    pos = rng.uniform(0, 3, size=(B, N, K, 2))
    eta = _eta(rng, B, K, P)
    dist = rng.uniform(0.5, 2.0, size=(B, K, P))
    jp = jcol.make_pair_index(N, dtype=jnp.float64)
    tp = tcol.make_pair_index(N, dtype=F64)
    got = tb.collision_lower_bounds_state(T(eta), T(dist), T(pos), tp,
                                          min_distance=0.93)
    want = jax.vmap(lambda e, d, p: jb.collision_lower_bounds_state(
        e, d, p, jp, min_distance=0.93))(*map(jnp.asarray, (eta, dist, pos)))
    _close(got, want)

    sc = tb.row_scaling_state(K, h, dtype=F64)
    _close_tree(sc, jb.row_scaling_state(K, h, dtype=jnp.float64))
    for col_enabled in (True, False):
        rho = tb.rho_pattern_masks(sc, STATIC, T(2.6), T(2.5), n_steps=K,
                                   n_pairs=P, col_enabled=col_enabled,
                                   dtype=F64)
        _close_tree(rho, _rho(STATIC, N, K, col_enabled, jnp.float64))
    _close(tb._inf_norm(lo._replace(col=T(dist)), 1),
           jax.vmap(jb._inf_norm)(jlo._replace(col=jnp.asarray(dist))))


def test_channel_path_matches_jax():
    rng = np.random.default_rng(2)
    B, N, K, h = 3, 4, 8, 0.2
    jrho = _rho(STATIC, N, K, False, jnp.float64)
    rho = tb.RowVals(*map(T, jrho))
    sigma = 1e-6
    D, Bm = tb.assemble_channel(rho, h=h, sigma=T(sigma))
    jD, jB = jb.assemble_channel(jrho, h=h, sigma=sigma)
    _close(D, jD)
    _close(Bm, jB)
    L, Eb = tb.factorize(D, Bm)
    jL, jEb = jb.factorize(jD, jB)
    _close(L, jL)
    _close(Eb, jEb)
    b = rng.normal(size=(B, K, 3, 2 * N))
    got = tb.solve_factorized_channel(L, Eb, T(b))
    want = jax.vmap(lambda bb: jb.solve_factorized_channel(jL, jEb, bb))(
        jnp.asarray(b))
    _close(got, want)
    x = _state(rng, B, N, K)
    s = tb.to_stacked(tb.StateVars(*map(T, x)))
    _close(s, jax.vmap(jb.to_stacked)(jb.StateVars(*map(jnp.asarray, x))))
    _close_tree(tb.from_stacked(s, N), x)


@pytest.mark.parametrize("ns_iters", [0, 2])
def test_xform_factors_match_jax(ns_iters):
    rng = np.random.default_rng(3 + ns_iters)
    B, N, K, h = 2, 3, 8, 0.2
    P = N * (N - 1) // 2
    jrho = _rho(STATIC, N, K, True, jnp.float64)
    rho = tb.RowVals(*map(T, jrho))
    eta = _eta(rng, B, K, P)
    E = np.asarray(jcol.make_pair_index(N, dtype=jnp.float64).E)
    D, C = tb.assemble_D(rho, T(eta), T(E), h=h, sigma=T(1e-6), n_vehicles=N)
    jD, jC = jax.vmap(lambda e: jb.assemble_D(jrho, e, jnp.asarray(E), h=h,
                                              sigma=1e-6, n_vehicles=N),
                      out_axes=(0, None))(jnp.asarray(eta))
    _close(D, jD)
    _close(C, jC)
    _close(tb.collision_blocks(rho.col, T(eta), T(E)),
           jax.vmap(lambda e: jb.collision_blocks(jrho.col, e,
                                                  jnp.asarray(E)))(
               jnp.asarray(eta)))
    M = rng.normal(size=(B, 6 * N, 5))
    _close(tb.slot_apply(C[1], T(M)), jb.slot_apply(jC[1], jnp.asarray(M)))
    _close(tb.slot_apply_vec(C[1], T(M[..., 0])),
           jb.slot_apply_vec(jC[1], jnp.asarray(M[..., 0])))
    _close(tb.bxbt(C[2], D[:, 3]), jb.bxbt(jC[2], jD[:, 3]))
    _close(tb._spd_inv(D[:, 1]), jb._spd_inv(jD[:, 1]))
    X = tb.factorize_X(D, C, ns_iters=ns_iters)
    jX = jax.vmap(lambda d: jb.factorize_X(d, jC, ns_iters=ns_iters))(jD)
    _close(X, jX)
    b = rng.normal(size=(B, K, 6 * N))
    _close(tb.solve_factorized_X(X, C, T(b)),
           jax.vmap(lambda x_, bb: jb.solve_factorized_X(x_, jC, bb))(
               jX, jnp.asarray(b)))


def _qp_inputs(N=4, K=10, B=3, seed=5):
    """Bounds, eta and warm starts for one phase-1 QP and one SCP-iteration
    QP, built with the JAX package (float64)."""
    rng = np.random.default_rng(seed)
    h = 0.2
    P = N * (N - 1) // 2
    problem = jcfg.ProblemConfig(n_vehicles=N, time_horizon=K * h,
                                 time_step=h, min_distance=0.8)
    p0 = rng.uniform(6, 14, size=(B, N, 2))
    pf = p0[:, ::-1] + rng.normal(scale=0.2, size=(B, N, 2))
    v0 = np.zeros((B, N, 2))
    lo, up = jax.vmap(lambda a, b, c, d: jb.build_bounds(
        a, b, c, d, n_vehicles=N, n_steps=K, h=h, limits=problem.limits,
        n_pairs=P))(*map(jnp.asarray, (p0, v0, pf, v0)))
    x0 = jax.vmap(lambda a, b: j_warm_state(jnp.zeros((N, K, 2)), a, b, h))(
        jnp.asarray(p0), jnp.asarray(v0))
    return problem, p0, v0, pf, lo, up, x0


def _solve_both(problem, lo, up, eta, x0, y0, col_enabled):
    jcfg_solver = jcfg.SolverConfig.production(
        pallas=False, problem=problem).replace(group=2)
    N, h = problem.n_vehicles, problem.time_step
    E = jcol.make_pair_index(N, dtype=jnp.float64).E
    jprm = jparams(jcfg_solver, jnp.float64)
    jres = jax.vmap(lambda l, u, e, x, y: jb.solve_qp_state(
        l, u, e, x, jprm, E, h=h, static=jcfg_solver.static_part(),
        n_vehicles=N, y_init=y, col_enabled=col_enabled))(lo, up, eta, x0, y0)
    _, tsolver = config_from_jax(problem, jcfg_solver)
    res = tb.solve_qp_state(
        rowvals_from_numpy(lo), rowvals_from_numpy(up), T(eta),
        tb.StateVars(*map(T, x0)), make_solver_params(tsolver, F64),
        T(np.asarray(E)), h=h, static=tsolver.static_part(), n_vehicles=N,
        y_init=rowvals_from_numpy(y0), col_enabled=col_enabled)
    return res, jres


def _check_qp(res, jres, rtol=1e-8):
    _close_tree(res.x, jres.x, rtol=rtol)
    _close_tree(res.y, jres.y, rtol=rtol)
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(jres.iters))
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(jres.converged))
    _close(res.prim_res, jres.prim_res, rtol=max(1e-6, 100 * rtol))


def test_phase1_qp_matches_jax():
    problem, p0, v0, pf, lo, up, x0 = _qp_inputs()
    B, K, P = p0.shape[0], problem.n_steps, problem.n_pairs
    eta0 = jnp.zeros((B, K, P, 2))
    y0 = jax.tree.map(jnp.zeros_like, lo)
    res, jres = _solve_both(problem, lo, up, eta0, x0, y0, False)
    _check_qp(res, jres)


def test_scp_iteration_qp_matches_jax():
    """The QP of an SCP iteration: linearized collision rows, warm start
    from the phase-1 solution, grouped X route (the Pallas sweep kernel in
    interpret mode on the JAX side, the plain version here)."""
    problem, p0, v0, pf, lo, up, x0 = _qp_inputs()
    B, K, P = p0.shape[0], problem.n_steps, problem.n_pairs
    N, h = problem.n_vehicles, problem.time_step
    eta0 = jnp.zeros((B, K, P, 2))
    y0 = jax.tree.map(jnp.zeros_like, lo)
    _, jres0 = _solve_both(problem, lo, up, eta0, x0, y0, False)
    a = jres0.x.a
    jp = jcol.make_pair_index(N, dtype=jnp.float64)
    prev, _ = jrollout(a, jnp.asarray(p0), jnp.asarray(v0), h)
    eta, dist = jax.vmap(lambda p: jcol.linearize(p, jp,
                                                  jax.random.key(0)))(prev)
    col_lo = jax.vmap(lambda e, d, p: jb.collision_lower_bounds_state(
        e, d, p, jp, min_distance=problem.min_distance + 0.13))(eta, dist,
                                                                prev)
    lo_it = lo._replace(col=col_lo)
    xw = jax.vmap(lambda aa, pp, vv: j_warm_state(aa, pp, vv, h))(
        a, jnp.asarray(p0), jnp.asarray(v0))
    res, jres = _solve_both(problem, lo_it, up, eta, xw, jres0.y, True)
    _check_qp(res, jres)


@pytest.mark.parametrize("N,change,expect", [
    (20, dict(), None),
    (21, dict(), None),
    (22, dict(), None),
    (20, dict(adaptive_rho=True), "grouped_X"),
    (20, dict(factor_form="L"), "grouped_L"),
    (20, dict(kernels=False, fused=False), "dense"),
    (20, dict(factor_dtype="bf16"), "bf16"),
    (30, dict(), None),
    (40, dict(), None),
    (4, dict(factor_form="L", kernels=False), "fused_L"),
])
def test_qp_route_matches_the_jax_router_or_raises(N, change, expect):
    """The grouped X route where the JAX router takes the grouped sweep
    kernel and the fused X route where it takes the fused ADMM-interval
    kernel, N >= 22 in float32 (banded.py:1210-1259); the L-only, dense and
    L-form fused routes where it takes those; adaptive rho routes as the
    shared rho does; bf16 factors (refused before their ROADMAP item was
    done) route as f32 factors do, since the JAX router's gates count the
    working dtype, and their factors are stored in bf16 there."""
    from ba_path_planning_torch.utils.config import SolverConfig
    static = SolverConfig.production().replace(**change).static_part()
    kw = dict(n_vehicles=N, n_steps=50, dtype=torch.float32)
    if expect == "bf16":
        assert static.factor_dtype == "bf16"
        assert tb.qp_route(static, col_enabled=False, **kw) == "channel"
        route = tb.qp_route(static, col_enabled=True, **kw)
        assert route == "grouped_X" and route in tb.BF16_ROUTES
    elif expect is None:
        assert tb.qp_route(static, col_enabled=False, **kw) == "channel"
        assert tb.qp_route(static, col_enabled=True, **kw) == (
            "fused_X" if N >= 22 else "grouped_X")
    elif expect in ("grouped_X", "grouped_L", "dense", "fused_L"):
        assert tb.qp_route(static, col_enabled=True, **kw) == expect
    else:
        with pytest.raises(NotImplementedError, match=expect):
            tb.qp_route(static, col_enabled=True, **kw)


def test_unported_solver_options_raise():
    """The polish and the CG method, refused before the slice that ported
    them, now run; a budget of two check intervals is served."""
    from ba_path_planning_torch.solvers.scp import SCPEngine
    from ba_path_planning_torch.utils.config import (ProblemConfig,
                                                     SolverConfig)
    problem = ProblemConfig(n_vehicles=3, time_horizon=2.0, time_step=0.2)
    prod = SolverConfig.production(problem=problem)
    z = torch.zeros((1, 3, 2), dtype=F64)
    polished = SCPEngine(problem, prod.replace(polish=True), dtype=F64,
                         device="cpu")
    carry = polished.start(z, z, z + 1.0, z)
    assert bool(torch.isfinite(carry.a).all())
    cg = SCPEngine(problem, prod.replace(method="cg", max_iter=50),
                   dtype=F64, device="cpu")
    res = cg.solve_batch(z, z, z + 1.0, z)
    assert bool(torch.isfinite(res.positions).all())
    assert int(res.status[0]) in (0, 1, 2)
    # a budget of two check intervals is served: a lane stops after the
    # first if its residuals pass there, else runs the second
    eng = SCPEngine(problem, prod.replace(max_iter=50), dtype=F64,
                    device="cpu")
    carry = eng.start(z, z, z + 1.0, z)
    assert int(carry.qp_iters) == (25 if bool(carry.qp_ok) else 50)


def test_apply_M_rho_pattern_and_b_scalar_stack_match_jax():
    """The reference application of M = P + sigma I + A^T rho A, the
    bound-driven rho pattern and the stacked B_k slot scalars, against the
    JAX package's, in float64; ``rho_pattern`` on the bounds of one
    scenario equals the structural ``rho_pattern_masks``."""
    rng = np.random.default_rng(9)
    B, N, K, h = 2, 4, 6, 0.2
    P = N * (N - 1) // 2
    lim = jcfg.ProblemConfig(n_vehicles=N).limits
    arrs = [rng.normal(size=(N, 2)) for _ in range(4)]
    lo, up = tb.build_bounds(*map(T, arrs), n_vehicles=N, n_steps=K, h=h,
                             limits=lim, n_pairs=P)
    jlo, jup = jb.build_bounds(*map(jnp.asarray, arrs), n_vehicles=N,
                               n_steps=K, h=h, limits=lim, n_pairs=P)
    sc = tb.row_scaling_state(K, h, dtype=F64)
    jsc = jb.row_scaling_state(K, h, dtype=jnp.float64)
    rho = tb.rho_pattern(lo, up, sc, STATIC, T(2.6), T(2.5), (K, P))
    jrho = jb.rho_pattern(jlo, jup, jsc, STATIC, 2.6, 2.5, (K, P))
    _close_tree(rho, jrho)
    masks = tb.rho_pattern_masks(sc, STATIC, T(2.6), T(2.5), n_steps=K,
                                 n_pairs=P, col_enabled=True, dtype=F64)
    _close_tree(rho, [torch.broadcast_to(m, r.shape)
                      for m, r in zip(masks, rho)], rtol=1e-15)

    x = _state(rng, B, N, K)
    eta = _eta(rng, B, K, P)
    E = np.asarray(jcol.make_pair_index(N, dtype=jnp.float64).E)
    got = tb.apply_M(tb.StateVars(*map(T, x)), rho, T(eta), T(E), h=h,
                     sigma=1e-6)
    want = jax.vmap(lambda xv, e: jb.apply_M(xv, jrho, e, jnp.asarray(E),
                                             h=h, sigma=1e-6))(
        jb.StateVars(*map(jnp.asarray, x)), jnp.asarray(eta))
    _close_tree(got, want)

    jmasks = _rho(STATIC, N, K, True, jnp.float64)
    s = tb._tridiag_scalars(tb.RowVals(*map(T, jmasks)), h=h, sigma=1e-6)
    js = jb._tridiag_scalars(jmasks, h=h, sigma=1e-6)
    _close(tb.b_scalar_stack(s), jb.b_scalar_stack(js))
