"""PyTorch port, modules 12-14: one SCP step started from a JAX carry, and
the whole slice (``solve_compacted``) against the JAX engine.

The JAX side runs ``SolverConfig.production(pallas=False).replace(group=2)``
in float64: the production X-form math on the CPU, with the grouped Pallas
sweep kernel in interpret mode.  The degenerate-pair angles of the JAX
engine are injected into the port, so both draw the same directions.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ba_path_planning_tpu.ops import collisions as jcol
from ba_path_planning_tpu.solvers.scp import SCPEngine as JEngine
from ba_path_planning_tpu.utils import config as jcfg

from ba_path_planning_torch.parallel.mesh import ShardedSCPSolver
from ba_path_planning_torch.solvers.scp import SCPEngine
from ba_path_planning_torch.utils.convert import (carry_from_numpy,
                                                  config_from_jax)

F64 = torch.float64


class JaxAngles:
    """The JAX engine's degenerate-pair draws for lane ``l`` at SCP
    iteration ``it``: fold_in(key_l, it), then fold_in(., pair id)."""

    def __init__(self, keys, n_vehicles, n_steps):
        self.keys = keys
        pairs = jcol.make_pair_index(n_vehicles)
        self.pair_id = jnp.asarray(
            np.asarray(pairs.i_idx).astype(np.uint32) * np.uint32(65536)
            + np.asarray(pairs.j_idx).astype(np.uint32))
        self.K = n_steps

    def __call__(self, lane_ids, it):
        def one(key, i):
            sub = jax.random.fold_in(key, i)
            pk = jax.vmap(lambda p: jax.random.fold_in(sub, p))(self.pair_id)
            return jax.vmap(lambda k_: jax.random.uniform(
                k_, (self.K,), dtype=jnp.float64, maxval=2.0 * jnp.pi),
                out_axes=-1)(pk)
        keys = self.keys[np.asarray(lane_ids.cpu())]
        out = jax.vmap(one)(keys, jnp.asarray(np.asarray(it.cpu())))
        return torch.as_tensor(np.array(out), dtype=F64)


def _problem(N=3):
    return jcfg.ProblemConfig(n_vehicles=N, time_horizon=2.0, time_step=0.2,
                              min_distance=0.8, max_iterations=15,
                              stop_mode="feasible", goal_project=True)


def _scenarios(B, N, seed):
    """Swap-and-cross layouts around (10, 10): most lanes need the SCP loop;
    the last one is spread out and feasible from the start."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, N, endpoint=False)
    p0 = np.zeros((B, N, 2))
    pf = np.zeros((B, N, 2))
    for b in range(B):
        r = 1.2 + 0.1 * b
        rot = rng.uniform(0, np.pi)
        base = np.stack([np.cos(ang + rot), np.sin(ang + rot)], -1) * r
        p0[b] = 10 + base + rng.normal(scale=0.05, size=(N, 2))
        pf[b] = 10 - base + rng.normal(scale=0.05, size=(N, 2))
    p0[-1] = 10 + np.stack([np.arange(N) * 1.5, np.zeros(N)], -1)
    pf[-1] = p0[-1] + np.array([0.0, 1.0])
    return p0, pf


def _jax_solver(problem):
    return jcfg.SolverConfig.production(pallas=False,
                                        problem=problem).replace(group=2)


def test_one_scp_step_from_jax_carry():
    problem = _problem()
    N, K = problem.n_vehicles, problem.n_steps
    B = 4
    p0, pf = _scenarios(B, N, seed=0)
    v0 = np.zeros_like(p0)
    jeng = JEngine(problem, _jax_solver(problem), dtype=jnp.float64)
    start, step, finalize = jeng.start_step_finalize_fns()
    keys = jax.random.split(jax.random.key(7), B)
    args = [jnp.asarray(a) for a in (p0, v0, pf, v0)]
    jcarry = jax.vmap(start)(*args, keys)
    assert not bool(np.all(np.asarray(jcarry.feasible_initial)))
    jnext = jax.vmap(step)(jcarry, *args, keys, jcarry.it + 1)

    tp, ts = config_from_jax(problem, _jax_solver(problem))
    eng = SCPEngine(tp, ts, dtype=F64, device="cpu")
    carry = carry_from_numpy(jax.tree.map(np.asarray, jcarry))
    targs = eng.as_inputs(p0, v0, pf, v0)
    nxt = eng.step(carry, *targs, torch.arange(B), carry.it + 1,
                   angle_fn=JaxAngles(keys, N, K))
    for name in ("it", "converged", "stop", "qp_iters", "qp_ok",
                 "feasible_initial"):
        np.testing.assert_array_equal(getattr(nxt, name).numpy(),
                                      np.asarray(getattr(jnext, name)),
                                      err_msg=name)
    scale = float(np.max(np.abs(np.asarray(jnext.a))))
    assert float(np.max(np.abs(nxt.a.numpy() - np.asarray(jnext.a)))) \
        <= 1e-8 * scale
    for got, want in zip(nxt.y, jnext.y):
        want = np.asarray(want)
        assert float(np.max(np.abs(got.numpy() - want))) \
            <= 1e-8 * max(float(np.max(np.abs(want))), 1.0)
    res = eng.finalize(nxt, *targs)
    jres = jax.vmap(finalize)(jnext, *args)
    np.testing.assert_allclose(res.positions.numpy(),
                               np.asarray(jres.positions), atol=1e-8)


@pytest.mark.parametrize("N,B,chunk", [(3, 6, 2), (4, 4, 4)])
def test_solve_compacted_matches_jax_engine(N, B, chunk):
    """Equal statuses and SCP iteration counts, positions within 1e-3
    (docs/DESIGN.md section 7)."""
    problem = _problem(N)
    p0, pf = _scenarios(B, N, seed=N)
    v0 = np.zeros_like(p0)
    keys = jax.random.split(jax.random.key(3), B)
    want = JEngine(problem, _jax_solver(problem),
                   dtype=jnp.float64).solve_batch(p0, v0, pf, v0, keys)

    tp, ts = config_from_jax(problem, _jax_solver(problem))
    solver = ShardedSCPSolver(tp, ts, dtype=F64, device="cpu")
    angles = JaxAngles(keys, N, tp.n_steps)
    compacted = solver.solve_compacted(p0, v0, pf, v0, chunk=chunk,
                                       angle_fn=angles)
    uncompacted = solver.engine.solve_batch(p0, v0, pf, v0, angle_fn=angles)
    for got in (compacted, uncompacted):
        for name in ("status", "iterations", "feasible_final",
                     "qp_iterations"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)),
                                          err_msg=name)
        np.testing.assert_allclose(got.positions.numpy(),
                                   np.asarray(want.positions), atol=1e-3)
    assert max(np.asarray(want.iterations)) >= 1     # the SCP loop ran
    assert solver.last_timing["loop_rounds"] == int(
        np.asarray(want.iterations).max())


def test_default_ns_precision_matches_jax_engine():
    """``SolverConfig.production().replace(ns_precision="default")`` (one
    matrix-unit pass for the Newton-Schulz products where a card runs
    them) at N=4, K=10 on the CPU, where both packages take those products
    in full precision: equal statuses and SCP iteration counts, positions
    within 1e-3, as the production path above."""
    N, B = 4, 4
    problem = _problem(N)
    p0, pf = _scenarios(B, N, seed=11)
    v0 = np.zeros_like(p0)
    keys = jax.random.split(jax.random.key(5), B)
    jsolver = _jax_solver(problem).replace(ns_precision="default")
    want = JEngine(problem, jsolver,
                   dtype=jnp.float64).solve_batch(p0, v0, pf, v0, keys)
    tp, ts = config_from_jax(problem, jsolver)
    assert ts.ns_precision == "default" and ts.ns_iters > 0
    got = SCPEngine(tp, ts, dtype=F64, device="cpu").solve_batch(
        p0, v0, pf, v0, angle_fn=JaxAngles(keys, N, tp.n_steps))
    for name in ("status", "iterations", "feasible_final"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.positions.numpy(),
                               np.asarray(want.positions), atol=1e-3)
    assert max(np.asarray(want.iterations)) >= 1     # the SCP loop ran
