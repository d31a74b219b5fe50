"""PyTorch port: the uncompacted ``ShardedSCPSolver.solve`` (with and
without ``microbatch``) and ``solve_compacted(step_iters=2)`` against the
JAX package's ``ShardedSCPSolver`` on a one-device mesh, on the inputs and
with the injected degenerate-pair draws of ``tests/test_torch_scp.py``:
equal statuses, SCP and QP iteration counts and ``feasible_final``,
positions within 1e-3 (docs/DESIGN.md section 7).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ba_path_planning_tpu.parallel import mesh as jmesh

from ba_path_planning_torch.parallel.mesh import (ShardedSCPSolver,
                                                  pad_to_multiple)
from ba_path_planning_torch.utils.convert import config_from_jax

from test_torch_scp import JaxAngles, _jax_solver, _problem, _scenarios

N, B = 3, 4


def _inputs():
    problem = _problem(N)
    p0, pf = _scenarios(B, N, seed=11)
    keys = jax.random.split(jax.random.key(5), B)
    return problem, p0, np.zeros_like(p0), pf, keys


def _jax_solver_on_one_device(problem, **kw):
    return jmesh.ShardedSCPSolver(
        problem, _jax_solver(problem),
        mesh=jmesh.make_mesh(jax.devices()[:1]), dtype=jnp.float64, **kw)


def _port_solver(problem, **kw):
    tp, ts = config_from_jax(problem, _jax_solver(problem))
    return ShardedSCPSolver(tp, ts, dtype=torch.float64, device="cpu", **kw)


def _assert_same(got, want):
    for name in ("status", "iterations", "qp_iterations", "feasible_final"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.positions.numpy(),
                               np.asarray(want.positions), atol=1e-3)
    assert int(np.asarray(want.iterations).max()) >= 2   # the SCP loop ran


@pytest.mark.parametrize("microbatch", [None, 2])
def test_solve_matches_jax_sharded_solve(microbatch):
    problem, p0, v0, pf, keys = _inputs()
    want = _jax_solver_on_one_device(problem, microbatch=microbatch).solve(
        p0, v0, pf, v0, keys)
    solver = _port_solver(problem, microbatch=microbatch)
    got = solver.solve(p0, v0, pf, v0, angle_fn=JaxAngles(keys, N,
                                                          problem.n_steps))
    _assert_same(got, want)


def test_solve_microbatches_are_lanes_of_one_batch():
    """A microbatch passes its lanes' global ids, so each lane draws what it
    draws in the whole batch; a batch that is no multiple of it is refused."""
    problem, p0, v0, pf, keys = _inputs()
    angles = JaxAngles(keys, N, problem.n_steps)
    whole = _port_solver(problem).solve(p0, v0, pf, v0, angle_fn=angles)
    split = _port_solver(problem, microbatch=1).solve(p0, v0, pf, v0,
                                                      angle_fn=angles)
    for a, b in zip(whole, split):
        if a.is_floating_point():
            torch.testing.assert_close(a, b, rtol=0, atol=1e-7)
        else:
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="multiple of microbatch"):
        _port_solver(problem, microbatch=3).solve(p0, v0, pf, v0,
                                                  angle_fn=angles)
    assert [pad_to_multiple(n, 4) for n in (1, 4, 5)] == \
        [jmesh.pad_to_multiple(n, 4) for n in (1, 4, 5)] == [4, 4, 8]


def test_solve_compacted_step_iters_matches_jax():
    problem, p0, v0, pf, keys = _inputs()
    jsolver = _jax_solver_on_one_device(problem)
    want = jsolver.solve_compacted(p0, v0, pf, v0, keys, chunk=2,
                                   step_iters=2)
    solver = _port_solver(problem)
    got = solver.solve_compacted(p0, v0, pf, v0, chunk=2, step_iters=2,
                                 angle_fn=JaxAngles(keys, N, problem.n_steps))
    _assert_same(got, want)
    assert solver.last_timing["loop_rounds"] == \
        jsolver.last_timing["loop_rounds"] == -(
            -int(np.asarray(want.iterations).max()) // 2)
