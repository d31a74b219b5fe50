"""PyTorch port: ``solve_qp_state`` with a budget of many check intervals
against the JAX package in float64, on every route this slice adds and on
the X-form routes with ``SolverConfig.latency()``: equal per-lane iteration
counts and ``converged`` flags (a lane that has stopped keeps its state while
the others go on, as under the JAX ``vmap``), x and y within 1e-8.  The
Pallas bodies of the fused routes take their pair-coupling products in
float32 whatever the working type, so those routes are held to 1e-6.

The JAX side reaches its Pallas kernels in interpret mode: the grouped and
fused ones by their own CPU switch, the resident one under
``pltpu.force_tpu_interpret_mode()``, lane by lane.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ba_path_planning_tpu.ops import collisions as jcol
from ba_path_planning_tpu.ops.rollout import rollout as jrollout
from ba_path_planning_tpu.solvers import banded as jb
from ba_path_planning_tpu.solvers.admm import make_solver_params as jparams
from ba_path_planning_tpu.solvers.scp import _warm_state as j_warm_state
from ba_path_planning_tpu.utils import config as jcfg

from ba_path_planning_torch.solvers import banded as tb
from ba_path_planning_torch.utils.config import make_solver_params
from ba_path_planning_torch.utils.convert import (config_from_jax,
                                                  rowvals_from_numpy)

from test_torch_banded import F64, T, _check_qp

REFERENCE = jcfg.SolverConfig(method="direct", polish=False,
                              adaptive_rho=False, max_iter=500)
LATENCY = jcfg.SolverConfig.latency(pallas=False)
# route -> (JAX solver, does the JAX side need the TPU interpret mode, the
# lanes solved).  The TPU interpret mode is slow: the resident route gets
# three intervals and two lanes, one that stops after the first interval and
# one that spends the budget.
ROUTES = {
    "grouped_L": (REFERENCE.replace(group=2), False, [0, 1, 2, 3]),
    "resident": (REFERENCE.replace(pallas=True, group=-1, max_iter=75), True,
                 [1, 3]),
    "dense": (REFERENCE, False, [0, 1, 2, 3]),
    "fused_L": (REFERENCE.replace(fused=True), False, [0, 1, 2, 3]),
    "grouped_X": (LATENCY.replace(group=2), False, [0, 1, 2, 3]),
    "fused_X": (LATENCY.replace(fused=True), False, [0, 1, 2, 3]),
}


def _solve_both(problem, jsolver, interpret, lo, up, eta, x0, y0,
                col_enabled):
    N, h = problem.n_vehicles, problem.time_step
    E = jcol.make_pair_index(N, dtype=jnp.float64).E
    jprm = jparams(jsolver, jnp.float64)
    def one(l, u, e, x, y):
        return jb.solve_qp_state(l, u, e, x, jprm, E, h=h,
                                 static=jsolver.static_part(), n_vehicles=N,
                                 y_init=y, col_enabled=col_enabled)
    if interpret:
        # the TPU interpret mode does not go under vmap: lane by lane
        with pltpu.force_tpu_interpret_mode():
            one = jax.jit(one)
            lanes = [jax.tree.map(np.asarray, one(*jax.tree.map(
                lambda t: t[b], (lo, up, eta, x0, y0))))
                for b in range(eta.shape[0])]
        jres = jax.tree.map(lambda *ts: np.stack(ts), *lanes)
    else:
        jres = jax.tree.map(np.asarray, jax.vmap(one)(lo, up, eta, x0, y0))
    _, tsolver = config_from_jax(problem, jsolver)
    res = tb.solve_qp_state(
        rowvals_from_numpy(lo), rowvals_from_numpy(up), T(eta),
        tb.StateVars(*map(T, x0)), make_solver_params(tsolver, F64),
        T(np.asarray(E)), h=h, static=tsolver.static_part(), n_vehicles=N,
        y_init=rowvals_from_numpy(y0), col_enabled=col_enabled)
    return res, jres, tsolver


def _scp_iteration_inputs(problem, p0, v0, lo, x0, a):
    """Collision rows linearized about the rollout of ``a`` (B, N, K, 2),
    with the warm start an SCP iteration gives its QP."""
    N, h = problem.n_vehicles, problem.time_step
    jp = jcol.make_pair_index(N, dtype=jnp.float64)
    prev, _ = jrollout(a, jnp.asarray(p0), jnp.asarray(v0), h)
    eta, dist = jax.vmap(lambda p: jcol.linearize(p, jp,
                                                  jax.random.key(0)))(prev)
    col_lo = jax.vmap(lambda e, d, p: jb.collision_lower_bounds_state(
        e, d, p, jp, min_distance=problem.min_distance))(eta, dist, prev)
    xw = jax.vmap(lambda aa, pp, vv: j_warm_state(aa, pp, vv, h))(
        a, jnp.asarray(p0), jnp.asarray(v0))
    return lo._replace(col=col_lo), eta, xw


def _inputs():
    """Four scenarios of three vehicles (K=10, h=0.5, R=1.0): in the first
    three two vehicles swap sides while the third crosses their line ever
    closer to the middle; in the last the vehicles move side by side and
    never meet.  Their QPs need different numbers of check intervals."""
    N, K, h, B = 3, 10, 0.5, 4
    problem = jcfg.ProblemConfig(n_vehicles=N, time_horizon=K * h,
                                 time_step=h, min_distance=1.0)
    p0, pf = np.zeros((B, N, 2)), np.zeros((B, N, 2))
    for b in range(B - 1):
        p0[b] = [[6.0, 10.0], [14.0, 10.0], [10.0, 5.0 + b]]
        pf[b] = [[14.0, 10.1 + 0.2 * b], [6.0, 9.9], [10.0, 15.0 - b]]
    p0[-1] = [[5.0, 5.0], [10.0, 5.0], [15.0, 5.0]]
    pf[-1] = p0[-1] + [0.0, 3.0]
    v0 = np.zeros_like(p0)
    lo, up = jax.vmap(lambda a, b, c, d: jb.build_bounds(
        a, b, c, d, n_vehicles=N, n_steps=K, h=h, limits=problem.limits,
        n_pairs=problem.n_pairs))(*map(jnp.asarray, (p0, v0, pf, v0)))
    x0 = jax.vmap(lambda a, b: j_warm_state(jnp.zeros((N, K, 2)), a, b, h))(
        jnp.asarray(p0), jnp.asarray(v0))
    return problem, p0, v0, lo, up, x0


@pytest.fixture(scope="module")
def phase1():
    """Inputs and the phase-1 (collision-free) solutions of :func:`_inputs`
    with the reference-compatible solver, from the port and from JAX."""
    problem, p0, v0, lo, up, x0 = _inputs()
    B, K, P = p0.shape[0], problem.n_steps, problem.n_pairs
    eta0 = jnp.zeros((B, K, P, 2))
    y0 = jax.tree.map(jnp.zeros_like, lo)
    res, jres, _ = _solve_both(problem, REFERENCE, False, lo, up, eta0, x0,
                               y0, False)
    return problem, p0, v0, lo, up, x0, res, jres


def test_phase1_early_exit_matches_jax(phase1):
    """The channel route with max_iter=500 in intervals of 25: lanes stop
    after different numbers of intervals, one of them after the first."""
    *_, res, jres = phase1
    _check_qp(res, jres)
    assert int(res.iters.min()) == 25 and len(set(res.iters.tolist())) > 1
    assert bool(res.converged[res.iters < 500].all())


@pytest.mark.parametrize("route", list(ROUTES))
def test_early_exit_matches_jax_on_every_route(phase1, route):
    problem, p0, v0, lo, up, x0, _, jres0 = phase1
    jsolver, interpret, lanes = ROUTES[route]
    lo_it, eta, xw = _scp_iteration_inputs(problem, p0, v0, lo, x0,
                                           jnp.asarray(jres0.x.a))
    y0 = jax.tree.map(jnp.asarray, jres0.y)
    lo_it, up, eta, xw, y0 = jax.tree.map(
        lambda t: t[np.array(lanes)], (lo_it, up, eta, xw, y0))
    res, jres, tsolver = _solve_both(problem, jsolver, interpret, lo_it, up,
                                     eta, xw, y0, True)
    assert tb.qp_route(tsolver.static_part(), n_vehicles=problem.n_vehicles,
                       n_steps=problem.n_steps, dtype=F64,
                       col_enabled=True) == route
    _check_qp(res, jres, rtol=1e-6 if route.startswith("fused") else 1e-8)
    check = jsolver.check_interval
    assert all(int(i) % check == 0 and check <= int(i)
               for i in res.iters)


def test_lanes_stop_at_different_intervals(phase1):
    """Lanes that need different numbers of intervals: each lane's count,
    flag and state are its own, whatever batch it is solved in."""
    problem, p0, v0, lo, up, x0, _, jres0 = phase1
    a = np.array(jres0.x.a)
    lo_it, eta, xw = _scp_iteration_inputs(problem, p0, v0, lo, x0,
                                           jnp.asarray(a))
    y0 = jax.tree.map(jnp.asarray, jres0.y)
    res, jres, _ = _solve_both(problem, REFERENCE.replace(group=2), False,
                               lo_it, up, eta, xw, y0, True)
    _check_qp(res, jres)
    assert len(set(res.iters.tolist())) > 1, res.iters
    # a lane solved alone gives what it gave in the batch
    one = slice(int(res.iters.argmin()), int(res.iters.argmin()) + 1)
    cut = lambda t: jax.tree.map(lambda v: v[one], t)      # noqa: E731
    alone, _, _ = _solve_both(problem, REFERENCE.replace(group=2), False,
                              cut(lo_it), cut(up), eta[one], cut(xw),
                              cut(y0), True)
    assert torch.equal(alone.iters, res.iters[one])
    assert torch.equal(alone.x.a, res.x.a[one])


def test_budget_not_a_multiple_of_the_interval(phase1):
    """max_iter=30 in intervals of 25 runs two intervals where the first
    does not converge: the loop goes on while ``iters < max_iter``."""
    problem, p0, v0, lo, up, x0, _, jres0 = phase1
    lo_it, eta, xw = _scp_iteration_inputs(problem, p0, v0, lo, x0,
                                           jnp.asarray(jres0.x.a))
    y0 = jax.tree.map(jnp.asarray, jres0.y)
    res, jres, _ = _solve_both(problem, REFERENCE.replace(max_iter=30),
                               False, lo_it, up, eta, xw, y0, True)
    _check_qp(res, jres)
    assert set(res.iters.tolist()) <= {25, 50} and 50 in res.iters.tolist()
