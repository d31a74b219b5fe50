"""PyTorch port: the reference-compatible ``SCP`` class against the JAX
package's on the two-vehicle swap of ``tests/test_pallas_kernels.py``: equal
status and SCP iteration count, positions within 1e-3 (docs/DESIGN.md
section 7), in float64 and in the facade's default float32.  No pair of the
swap is degenerate, so the engines' different angle sources draw nothing.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ba_path_planning_tpu.solvers.scp import SCP as JaxSCP

from ba_path_planning_torch.solvers.scp import SCP, SCPEngine
from ba_path_planning_torch.utils.config import ProblemConfig, SolverConfig
from ba_path_planning_torch.utils.convert import config_from_jax

P0 = np.array([[6.0, 10.0], [14.0, 10.0]])
PF = np.array([[14.0, 10.1], [6.0, 9.9]])
ARGS = dict(n_vehicles=2, time_horizon=6.0, time_step=0.5, min_distance=1.0)


def _run(cls, **kw):
    scp = cls(**ARGS, verbose=False, **kw)
    scp.set_initial_states(P0)
    scp.set_final_states(PF.reshape(-1), np.zeros(4))
    traj = scp.generate_trajectories(max_iterations=8)
    return scp, traj


@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float64, torch.float64),
                                           (None, None)])
def test_facade_matches_the_jax_facade(jdtype, tdtype, capsys):
    want_scp, want = _run(JaxSCP, dtype=jdtype)
    got_scp, got = _run(SCP, dtype=tdtype, device="cpu")
    assert "Trajectory generation completed in" in capsys.readouterr().out
    assert got_scp.K == want_scp.K == 12
    assert set(got) == {"positions", "velocities", "accelerations"}
    for name, arr in got.items():
        assert isinstance(arr, np.ndarray) and arr.shape == (2, 12, 2)
        assert arr.dtype == (np.float32 if tdtype is None else np.float64)
        np.testing.assert_allclose(arr, np.asarray(want[name]), atol=1e-3,
                                   err_msg=name)
    res, jres = got_scp.result, want_scp.result
    assert int(res.status) == int(jres.status)
    assert int(res.iterations) == int(jres.iterations) >= 1
    assert bool(res.feasible_final) and bool(jres.feasible_final)
    assert bool(res.feasible_initial) == bool(jres.feasible_initial)
    if tdtype is not None:
        assert int(res.qp_iterations) == int(jres.qp_iterations)


def test_facade_defaults_are_the_reference_solver():
    """The facade's default solver and problem are the JAX facade's: the
    direct method on L-form factors, hard collision rows, 2000 iterations
    checked every 25, stopping on step-norm convergence."""
    scp = SCP(**ARGS, verbose=False, device="cpu")
    _, want = config_from_jax(ProblemConfig(),
                              JaxSCP(**ARGS, verbose=False)._solver_cfg)
    assert scp._solver_cfg == want
    cfg = scp._solver_cfg
    assert (cfg.method, cfg.factor_form, cfg.max_iter, cfg.check_interval,
            cfg.col_penalty) == ("direct", "L", 2000, 25, float("inf"))
    problem = scp._engine(15, 0).problem
    assert (problem.stop_mode, problem.goal_project,
            problem.max_iterations) == ("reference", False, 15)
    assert scp._engine(15, 0) is scp._engine(15, 0)      # cached


def test_facade_prints_and_guards(capsys):
    scp = SCP(3, 2.0, 0.2, 0.5, [0, 0, 10, 10], device="cpu")
    out = capsys.readouterr().out
    for line in ("SCP Problem initialized", "Number of timesteps: 10",
                 "Timestep: 0.2", "Minimum distance between vehicles: 0.5",
                 "Space dimensions: [0, 0, 10, 10]"):
        assert line in out
    with pytest.raises(ValueError, match="initial and final"):
        scp.generate_trajectories()
    scp.set_initial_states(np.arange(6.0))
    assert scp.initial_positions.shape == (6,)
    assert not scp.initial_velocities.any()
    for plot in (scp.visualize_trajectories, scp.visualize_time_snapshots):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            plot()


def test_engine_solve_is_one_lane_of_solve_batch():
    problem = ProblemConfig(**ARGS, max_iterations=8)
    solver = dataclasses.replace(SCP(**ARGS, verbose=False,
                                     device="cpu")._solver_cfg, max_iter=200)
    eng = SCPEngine(problem, solver, dtype=torch.float64, device="cpu")
    z = np.zeros((2, 2))
    one = eng.solve(P0, z, PF, z)
    both = eng.solve_batch(np.stack([P0, P0 + 1.0]), np.stack([z, z]),
                           np.stack([PF, PF + 1.0]), np.stack([z, z]))
    assert one.positions.shape == (2, 12, 2) and one.status.dim() == 0
    for a, b in zip(one, both):
        assert torch.equal(a, b[0])
