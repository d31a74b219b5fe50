"""PyTorch port, adaptive rho on every route of ``solve_qp_state``
(``solvers/banded.py``) and the per-lane rho planes of the fused ADMM
intervals (``ops/admm_fused.py``), held against the JAX package in float64.

With ``adaptive_rho`` each lane of the JAX package's vmapped loop carries
its own rho, and with it its own slot scalars and rho planes.  The JAX
package's kernel routes refuse those under ``vmap`` (its grouped sweeps,
NS chain and fused intervals take batch-shared ones), so the reference is
JAX's ``solve_qp_state`` run lane by lane, which is what each lane of its
vmapped loop computes, on the route that does the same algebra without a
kernel: the route itself for the plain routes, its grouped X route for the
fused X route, and its dense route for the resident and the fused L routes
(the JAX fused interval in interpret mode is ~1e-7 off its own dense route
in float64).  The dense route's vmapped JAX loop is held to its lane-by-lane
run as well.  Tolerances: equal iteration counts and convergence flags; x
and y within 1e-8 of each leaf's scale.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ba_path_planning_tpu.ops import collisions as jcol
from ba_path_planning_tpu.ops.pallas import admm_fused as jaf
from ba_path_planning_tpu.solvers import banded as jb
from ba_path_planning_tpu.solvers.admm import make_solver_params as jparams
from ba_path_planning_tpu.utils import config as jcfg

from ba_path_planning_torch.ops import admm_fused
from ba_path_planning_torch.solvers import banded as tb
from ba_path_planning_torch.utils.config import make_solver_params
from ba_path_planning_torch.utils.convert import (config_from_jax,
                                                  rowvals_from_numpy)

from test_torch_admm_fused import _interval_inputs, _iteration_qp, _rel
from test_torch_banded import _close_tree, _qp_inputs

F64 = torch.float64
H = 0.2
N, K, B = 3, 10, 3
# rho 30 is far above what these QPs want: lanes 1 and 2 adapt after one
# interval, lane 1 again later, lane 0 never (seed 5)
RHO, MAX_ITER = 30.0, 400

# route -> (the JAX options of the reference route, the port's change)
ROUTES = {
    "dense": (dict(), dict()),
    "grouped_X": (dict(group=2), dict()),
    "grouped_L": (dict(factor_form="L", group=2), dict()),
    "resident": (dict(factor_form="L"),
                 dict(kernels=True, group=-1)),
    "fused_X": (dict(group=2), dict(group=0, fused=True)),
    "fused_L": (dict(factor_form="L"), dict(fused=True)),
}


def _jax_cfg(problem, **change):
    return jcfg.SolverConfig.production(pallas=False, problem=problem).replace(
        **{"adaptive_rho": True, "rho": RHO, "max_iter": MAX_ITER, **change})


def _jax_lanes(jsolver, lo, up, eta, xw, y0, col_enabled=True):
    """JAX's solve_qp_state one lane at a time, stacked."""
    E = jcol.make_pair_index(N, dtype=jnp.float64).E
    prm = jparams(jsolver, jnp.float64)
    outs = [jb.solve_qp_state(
        *(jax.tree.map(lambda t: t[i], v) for v in (lo, up, eta, xw)), prm,
        E, h=H, static=jsolver.static_part(), n_vehicles=N,
        y_init=jax.tree.map(lambda t: t[i], y0), col_enabled=col_enabled)
        for i in range(lo.acc.shape[0])]
    return jax.tree.map(lambda *t: np.stack([np.asarray(a) for a in t]),
                        *outs)


def _port(tsolver, lo, up, eta, xw, y0, col_enabled=True):
    E = torch.as_tensor(np.array(jcol.make_pair_index(N).E), dtype=F64)
    return tb.solve_qp_state(
        rowvals_from_numpy(lo), rowvals_from_numpy(up),
        torch.as_tensor(np.array(eta), dtype=F64),
        tb.StateVars(*(torch.as_tensor(np.array(t), dtype=F64)
                       for t in xw)),
        make_solver_params(tsolver, F64), E, h=H,
        static=tsolver.static_part(), n_vehicles=N,
        y_init=rowvals_from_numpy(y0), col_enabled=col_enabled)


def _check(res, jres):
    np.testing.assert_array_equal(res.iters.numpy(), jres.iters)
    np.testing.assert_array_equal(res.converged.numpy(), jres.converged)
    _close_tree(res.x, jres.x, rtol=1e-8)
    _close_tree(res.y, jres.y, rtol=1e-8)


def _recorder(monkeypatch, eta):
    """Record, for every factorization of ``solve_qp_state``, the lanes it
    factorizes (found by their eta)."""
    calls, orig = [], tb._route_factors
    eta = np.asarray(eta).reshape(np.shape(eta)[0], -1)

    def rec(route, rho_b, eta_, *a, **kw):
        calls.append(sorted(int(np.argmin(np.abs(eta - e.numpy().reshape(
            1, -1)).max(1))) for e in eta_))
        return orig(route, rho_b, eta_, *a, **kw)
    monkeypatch.setattr(tb, "_route_factors", rec)
    return calls


@pytest.mark.parametrize("route", list(ROUTES))
def test_adaptive_rho_route_matches_jax(route, monkeypatch):
    """The QP of an SCP iteration (N=3, K=10, B=3): per-lane rho on every
    route, only the adapting lanes refactorized, against JAX lane by
    lane."""
    problem, lo, up, eta, xw, y0 = _iteration_qp(N=N, K=K, B=B, seed=5)
    jchange, tchange = ROUTES[route]
    jsolver = _jax_cfg(problem, **jchange)
    _, tsolver = config_from_jax(problem, _jax_cfg(problem))
    tsolver = tsolver.replace(**{**jchange, **tchange})
    assert tb.qp_route(tsolver.static_part(), n_vehicles=N, n_steps=K,
                       dtype=F64, col_enabled=True) == route
    calls = _recorder(monkeypatch, eta)
    res = _port(tsolver, lo, up, eta, xw, y0)
    _check(res, _jax_lanes(jsolver, lo, up, eta, xw, y0))
    # all lanes at the start, then only those that adapt: some, not all
    assert calls[0] == list(range(B)) and len(calls) >= 2
    adapted = set().union(*calls[1:])
    assert adapted and adapted != set(range(B)), calls


def test_adaptive_rho_channel_route_matches_jax(monkeypatch):
    """The collision-free phase-1 QP on per-lane channel factors."""
    problem, p0, v0, pf, lo, up, x0 = _qp_inputs(N=N, K=K, B=B, seed=5)
    eta0 = jnp.zeros((B, K, problem.n_pairs, 2))
    y0 = jax.tree.map(jnp.zeros_like, lo)
    jsolver = _jax_cfg(problem, rho=0.02)
    _, tsolver = config_from_jax(problem, jsolver)
    res = _port(tsolver, lo, up, eta0, x0, y0, col_enabled=False)
    _check(res, _jax_lanes(jsolver, lo, up, eta0, x0, y0, col_enabled=False))


def test_vmapped_jax_dense_route_equals_its_lanes():
    """JAX's vmapped loop (dense route, the one its vmap serves with a
    per-lane rho) computes what its lanes compute one by one."""
    problem, lo, up, eta, xw, y0 = _iteration_qp(N=N, K=K, B=B, seed=5)
    jsolver = _jax_cfg(problem)
    E = jcol.make_pair_index(N, dtype=jnp.float64).E
    prm = jparams(jsolver, jnp.float64)
    vm = jax.vmap(lambda l, u, e, x, y: jb.solve_qp_state(
        l, u, e, x, prm, E, h=H, static=jsolver.static_part(), n_vehicles=N,
        y_init=y))(lo, up, eta, xw, y0)
    lanes = _jax_lanes(jsolver, lo, up, eta, xw, y0)
    np.testing.assert_array_equal(np.asarray(vm.iters), lanes.iters)
    for a, b in zip(list(vm.x) + list(vm.y), list(lanes.x) + list(lanes.y)):
        assert _rel(np.asarray(a), b) <= 1e-8


def test_shared_rho_path_builds_no_lane_rho():
    """Without adaptive rho the rho leaves stay batch-shared (no (B, ...)
    rho tensors) and the channel factors are computed once for the
    batch."""
    problem, p0, v0, pf, lo, up, x0 = _qp_inputs(N=N, K=K, B=B, seed=5)
    _, tsolver = config_from_jax(problem, jcfg.SolverConfig.production(
        pallas=False, problem=problem))
    seen = []
    orig = tb._route_factors

    def rec(route, rho_b, *a, **kw):
        seen.append((route, tuple(rho_b.acc.shape)))
        out = orig(route, rho_b, *a, **kw)
        seen.append(tuple(out[0].shape))
        return out
    tb._route_factors = rec
    try:
        eta0 = jnp.zeros((B, K, problem.n_pairs, 2))
        _port(tsolver, lo, up, eta0, x0, jax.tree.map(jnp.zeros_like, lo),
              col_enabled=False)
    finally:
        tb._route_factors = orig
    assert seen == [("channel", (K, 1)), (K, 3, 3)]


def _lane_rho(inp, rhos):
    """Per-lane rho leaves (B, 1, K', 1) and (B, K, P), one rho a lane."""
    prm = inp["prm"]
    scaling = tb.row_scaling_state(inp["K"], H, dtype=prm.rho.dtype)
    cfg = jcfg.SolverConfig.production(pallas=False)
    return tb.rho_pattern_masks(
        scaling, cfg.static_part(), torch.as_tensor(rhos, dtype=prm.rho.dtype),
        prm.col_rho_boost, n_steps=inp["K"], n_pairs=inp["P"],
        col_enabled=True, dtype=prm.rho.dtype)


@pytest.mark.parametrize("form", ["X", "L"])
def test_fused_plain_with_lane_rho_matches_pallas_interpret(form):
    """The plain versions of both fused intervals with one rho plane a lane
    (and, in the X form, one set of slot scalars a lane) against the Pallas
    interval in interpret mode, run a lane at a time with that lane's
    planes: N=4, K=10, B=4, float32, 12 iterations, every leaf within 5e-4
    (the tolerance of ``test_torch_admm_fused.py``)."""
    inp = _interval_inputs()
    Bn, Kn, Nn = inp["eta"].shape[0], inp["K"], inp["N"]
    rhos = np.array([2.6, 0.4, 9.0, 2.6][:Bn], np.float32)
    rho = _lane_rho(inp, rhos)
    prm = inp["prm"]
    D, C = tb.assemble_D(rho, inp["eta"], inp["E"], h=H, sigma=prm.sigma,
                         n_vehicles=Nn)
    assert C.shape == (Bn, Kn - 1, 3, 3)
    step = dict(h=H, sigma=prm.sigma, alpha=prm.alpha, lam=prm.col_penalty,
                n_iters=12)
    if form == "X":
        X = torch.stack([tb.factorize_X(D[i:i + 1], C[i], ns_iters=2)[0]
                         for i in range(Bn)])
        out = admm_fused.admm_interval_fused_X(
            X, C, inp["eta"], inp["E"], inp["lower"], inp["upper"], inp["x"],
            inp["z"], inp["y"], rho, **step)
    else:
        Linv, Eb = tb.factorize(D, tb.slot_dense(C, 2 * Nn))
        out = admm_fused.admm_interval_fused(
            Linv, Eb, inp["eta"], inp["E"], inp["lower"], inp["upper"],
            inp["x"], inp["z"], inp["y"], rho, **step)
    for i in range(Bn):
        want = _jax_lane_interval(inp, rho, i, X[i] if form == "X" else
                                  (Linv[i], Eb[i]), C[i], form, 12)
        for got, w in zip(
                [t[i] for part in out for t in part],
                [t for part in want for t in part]):
            assert _rel(got, w) < 5e-4


def _jax_lane_interval(inp, rho, i, factors, C, form, n_iters):
    """The Pallas interval in interpret mode on lane ``i`` alone, with that
    lane's rho planes."""
    Nn, Kn, prm = inp["N"], inp["K"], inp["prm"]

    def j(t):
        return jnp.asarray(t.numpy())

    def jrv(rv):
        return jb.RowVals(*(j(t[i:i + 1]) for t in rv))
    jrho = jb.RowVals(*(j(getattr(rho, f)[i, 0]) for f in
                        ("dyn_p", "dyn_v", "jerk", "acc", "vbox", "pbox")),
                      col=j(rho.col[i]))
    l_s, _ = jaf.bound_planes(jrv(inp["lower"]), -jnp.inf)
    u_s, _ = jaf.bound_planes(jrv(inp["upper"]), jnp.inf)
    zs, zc = jaf.rowvals_to_planes(jrv(inp["z"]))
    ys, yc = jaf.rowvals_to_planes(jrv(inp["y"]))
    rho_sk, rho_c = jaf.rho_planes(jrho, jb._LOOSE_RHO)
    fpar = jnp.asarray([H, float(prm.sigma), float(prm.alpha),
                        float(prm.col_penalty)], jnp.float32)
    x0 = j(tb.to_stacked(tb.StateVars(*(t[i:i + 1] for t in inp["x"]))))
    ipar = jnp.asarray([n_iters], jnp.int32)
    if form == "X":
        E2b, E2bT = jaf.pair_matrices_block(Nn, jnp.float32)
        out = jaf._fused_batched_X(
            fpar, ipar, j(C).reshape(Kn - 1, 9), j(factors)[None],
            jaf.eta_to_block(j(inp["eta"][i:i + 1])), l_s, u_s,
            j(inp["lower"].col[i:i + 1]), x0, zs, zc, ys, yc, rho_sk, rho_c,
            E2b, E2bT, interpret=True, group=1)
    else:
        E2, E2T, Sx, SxT = jaf.pair_matrices(Nn, jnp.float32)
        P = inp["P"]
        out = jaf._fused_batched(
            fpar, ipar, j(factors[0])[None], j(factors[1])[None],
            j(inp["eta"][i:i + 1]).reshape(1, Kn, 2 * P), l_s, u_s,
            j(inp["lower"].col[i:i + 1]), x0, zs, zc, ys, yc, rho_sk, rho_c,
            E2, E2T, Sx, SxT, interpret=True)
    xp, zsp, zcp, ysp, ycp = (np.array(t) for t in out)
    return ([t[0] for t in tb.from_stacked(torch.as_tensor(xp), Nn)],
            [t[0] for t in jaf.planes_to_rowvals(zsp, zcp, Nn, jb.RowVals)],
            [t[0] for t in jaf.planes_to_rowvals(ysp, ycp, Nn, jb.RowVals)])
