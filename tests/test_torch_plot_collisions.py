"""PyTorch port, ``plot-collisions`` (``viz/plot_collisions.py``): the
per-step minimum pairwise distance against the JAX package's
``collision_profile`` in float64 (1e-12), and the CLI at N=3 with 4 trials
writing its figure on the CPU."""

import argparse

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ba_path_planning_tpu.ops.collisions import make_pair_index
from ba_path_planning_tpu.viz import plot_collisions as jplot

from ba_path_planning_torch.viz import plot_collisions as tplot


def test_collision_profile_matches_jax():
    pos = np.random.default_rng(0).uniform(0, 20, (5, 4, 7, 2))
    want = jplot.collision_profile(pos.astype(np.float32))
    want64 = jplot.collision_profile(pos, make_pair_index(4, jnp.float64))
    assert want64.dtype == np.float64
    got = tplot.collision_profile(torch.tensor(pos))
    assert got.dtype == torch.float64 and got.shape == (5, 7)
    np.testing.assert_allclose(got.numpy(), want64, rtol=0, atol=1e-12)
    got32 = tplot.collision_profile(torch.tensor(pos, dtype=torch.float32))
    np.testing.assert_allclose(got32.numpy(), want, rtol=0, atol=1e-5)


def test_analyse_solves_and_profiles_on_the_cpu():
    args = argparse.Namespace(n_vehicles=3, trials=4, min_distance=0.6,
                              time_horizon=2.0, time_step=0.2,
                              max_iterations=15, seed=0)
    problem, out, profiles = tplot.analyse(args, device="cpu")
    assert profiles.shape == (4, problem.n_steps)
    feas = out.feasible_final
    assert bool(feas.any())
    # a lane the solver calls collision-free keeps the checker's distance
    assert float(profiles[feas].min()) >= 0.6 - 0.01 - 1e-6


def test_plot_collisions_cli(tmp_path):
    pytest.importorskip("matplotlib")
    out = tmp_path / "col.png"
    rc = tplot.main(["--n-vehicles", "3", "--trials", "4", "--time-horizon",
                     "2.0", "--min-distance", "0.6", "--out-path", str(out)],
                    device="cpu")
    assert rc == 0
    assert out.exists() and out.stat().st_size > 0
