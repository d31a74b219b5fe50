"""PyTorch port, the parallel axes over ``torch.distributed``
(``parallel/pair_sharded.py``, ``parallel/horizon_sharded.py``,
``parallel/mesh.py``, ``parallel/distributed.py``): 2 or 4 ranks spawned on
the CPU, each joining a gloo group, in float64, held against the JAX
package.

* Pairs: the pair-sharded solve of one N=6 scenario (15 pairs; 4 ranks pad
  one inert pair), with and without the polish, against JAX's unsharded
  ``SCPEngine.solve``: equal SCP iterations and status, positions and
  accelerations within 1e-9 (the bar of ``tests/test_pair_sharded.py``).
* Horizon: the K-sharded rollout, feasibility and linearization against
  JAX's on a 4-device virtual mesh (non-degenerate pairs, as JAX's test).
* Scenarios: the scenario-parallel ``solve`` and ``solve_compacted``
  across 2 ranks against the one-rank port (1e-7) and JAX's
  ``ShardedSCPSolver`` on a 2-device mesh (equal counts and statuses,
  positions within 1e-3, as ``tests/test_torch_batch_solve.py``).
* ``host_local_slice``, ``make_global_batch`` and ``scaling_report``.

Every spawned run must join within RUN_TIMEOUT seconds and fails past it:
a hung rendezvous fails the test instead of holding the suite.
"""

import multiprocessing as mp
import socket
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ba_path_planning_tpu.ops import collisions as jcol
from ba_path_planning_tpu.ops.rollout import rollout as jrollout
from ba_path_planning_tpu.parallel import horizon_sharded as jhs
from ba_path_planning_tpu.parallel import mesh as jmesh
from ba_path_planning_tpu.scenarios import generate_scenario
from ba_path_planning_tpu.solvers.scp import SCPEngine as JEngine
from ba_path_planning_tpu.utils import config as jcfg

from ba_path_planning_torch.parallel.mesh import ShardedSCPSolver
from ba_path_planning_torch.parallel.pair_sharded import (
    PairShardedSCPSolver, padded_pair_index, shard_pairs)
from ba_path_planning_torch.utils.convert import config_from_jax

import test_torch_parallel_worker as worker
from test_torch_scp import JaxAngles, _jax_solver, _problem, _scenarios

RUN_TIMEOUT = 120.0       # seconds a spawned run may take


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(tmp_path, world, job, inp, problem=None, solver=None):
    """Run ``job`` on ``world`` gloo ranks; the ranks' outputs, in rank
    order.  Fails if a rank fails or the run outlasts RUN_TIMEOUT."""
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=worker.run,
                         args=(r, world, port, job, inp, problem, solver,
                               str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RUN_TIMEOUT
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{job}: {len(hung)} rank(s) past {RUN_TIMEOUT} s"
    assert [p.exitcode for p in procs] == [0] * world, job
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


# -- pairs -------------------------------------------------------------------

def _pair_problem():
    return jcfg.ProblemConfig(n_vehicles=6, time_horizon=4.0, time_step=0.2,
                              min_distance=0.8, max_iterations=10,
                              stop_mode="feasible")


def _pair_solver(polish):
    return jcfg.SolverConfig(method="direct", adaptive_rho=False,
                             polish=polish, max_iter=60, check_interval=30,
                             rho=1.6, collision_margin=0.05)


def test_padded_pair_index_has_inert_pads_and_even_shares():
    """15 pairs padded to 16 for 4 shards: the pad's E column is zero and it
    is invalid; the shares tile the pairs."""
    pi = padded_pair_index(6, 4, dtype=torch.float64, device="cpu")
    assert pi.E.shape == (6, 16) and int(pi.valid.sum()) == 15
    assert not bool(pi.E[:, 15].any()) and not bool(pi.valid[15])
    shares = [shard_pairs(pi, r, 4) for r in range(4)]
    assert all(s.E.shape == (6, 4) for s in shares)
    assert torch.equal(torch.cat([s.i_idx for s in shares]), pi.i_idx)


@pytest.mark.parametrize("polish", [False, True])
@pytest.mark.parametrize("world", [2, 4])
def test_pair_sharded_matches_jax_unsharded(tmp_path, world, polish):
    problem, jsolver = _pair_problem(), _pair_solver(polish)
    seed, key = (3, 7) if not polish else (5, 9)
    sc = generate_scenario(jax.random.key(seed), n_vehicles=6,
                           min_distance=0.8)
    v0 = jnp.zeros((6, 2), jnp.float64)
    base = JEngine(problem, jsolver, dtype=jnp.float64).solve(
        sc.initial, v0, sc.final, v0, key=jax.random.key(key))
    tp, ts = config_from_jax(problem, jsolver)
    inp = {k: np.array(a, np.float64) for k, a in
           zip(("p0", "v0", "pf", "vf"), (sc.initial, v0, sc.final, v0))}
    outs = _spawn(tmp_path, world, "pairs", inp, tp, ts)
    for got in outs:
        assert int(got["iterations"]) == int(base.iterations)
        assert int(got["status"]) == int(base.status)
        assert bool(got["feasible_final"]) == bool(base.feasible_final)
        np.testing.assert_allclose(got["positions"],
                                   np.asarray(base.positions), atol=1e-9)
        np.testing.assert_allclose(got["accelerations"],
                                   np.asarray(base.accelerations), atol=1e-9)
    # every rank holds the replicated result
    for got in outs[1:]:
        np.testing.assert_array_equal(got["positions"], outs[0]["positions"])


def test_pair_sharded_on_one_rank_is_the_engine():
    """Without a process group the mesh is one rank: the padded index has
    no pad, and the solve is the engine's own (same draws, same route)."""
    problem, jsolver = _pair_problem(), _pair_solver(False)
    tp, ts = config_from_jax(problem, jsolver)
    sc = generate_scenario(jax.random.key(3), n_vehicles=6, min_distance=0.8)
    args = [np.array(a, np.float64) for a in (sc.initial, sc.final)]
    v0 = np.zeros((6, 2))
    ps = PairShardedSCPSolver(tp, ts, dtype=torch.float64, device="cpu")
    assert ps.mesh.size == 1 and ps.mesh.collective_group is None
    got = ps.solve(args[0], v0, args[1], v0)
    from ba_path_planning_torch.solvers.scp import SCPEngine
    want = SCPEngine(tp, ps.solver, dtype=torch.float64,
                     device="cpu").solve(args[0], v0, args[1], v0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# -- horizon -----------------------------------------------------------------

def test_horizon_sharded_matches_jax_on_a_4_device_mesh(tmp_path):
    rng = np.random.default_rng(2)
    N, K, h = 4, 32, 0.2
    a = rng.normal(size=(N, K, 2)) * 0.3
    p0 = rng.uniform(0, 20, (N, 2))
    v0 = rng.normal(size=(N, 2))
    mesh = jhs.make_horizon_mesh(jax.devices()[:4])
    ja, jp0, jv0 = (jnp.asarray(t) for t in (a, p0, v0))
    jpos, jvel = jhs.rollout_ksharded(ja, jp0, jv0, h, mesh)
    positions = np.asarray(jrollout(ja, jp0, jnp.zeros((N, 2)), h)[0])
    pairs = jcol.make_pair_index(N, dtype=jnp.float64)
    radii = (0.5, 30.0)               # one feasible, one clearly infeasible
    jfeas = [bool(jhs.check_feasible_ksharded(jnp.asarray(positions), pairs,
                                              r, mesh)) for r in radii]
    assert jfeas == [True, False]
    jeta, jdist = jhs.linearize_ksharded(jnp.asarray(positions), pairs,
                                         jax.random.key(3), mesh)
    inp = dict(a=a, p0=p0, v0=v0, h=np.array(h), positions=positions,
               radii=np.array(radii), angle=np.zeros((K, 6)))
    for got in _spawn(tmp_path, 4, "horizon", inp):
        np.testing.assert_allclose(got["pos"], np.asarray(jpos), atol=1e-10)
        np.testing.assert_allclose(got["vel"], np.asarray(jvel), atol=1e-10)
        assert got["feasible"].tolist() == jfeas
        np.testing.assert_allclose(got["eta"], np.asarray(jeta), atol=1e-12)
        np.testing.assert_allclose(got["dist"], np.asarray(jdist),
                                   atol=1e-12)


def test_horizon_sharded_refuses_a_k_no_multiple_of_the_ranks():
    from ba_path_planning_torch.parallel import horizon_sharded as hs
    from ba_path_planning_torch.parallel.mesh import Mesh
    with pytest.raises(ValueError, match="not divisible"):
        hs.rollout_ksharded(torch.zeros(2, 10, 2), torch.zeros(2, 2),
                            torch.zeros(2, 2), 0.2, Mesh(None, 0, 4))


# -- scenarios ---------------------------------------------------------------

def test_scenario_parallel_solves_match_one_rank_and_jax(tmp_path):
    N, B = 3, 4
    problem = _problem(N)
    p0, pf = _scenarios(B, N, seed=11)
    v0 = np.zeros_like(p0)
    keys = jax.random.split(jax.random.key(5), B)
    jsolver = _jax_solver(problem)
    jsh = jmesh.ShardedSCPSolver(problem, jsolver,
                                 mesh=jmesh.make_mesh(jax.devices()[:2]),
                                 dtype=jnp.float64)
    want = jsh.solve(p0, v0, pf, v0, keys)
    want_c = jsh.solve_compacted(p0, v0, pf, v0, keys, chunk=2, step_iters=2)
    angles = JaxAngles(keys, N, problem.n_steps)
    lanes = torch.arange(B)
    table = np.stack([np.array(angles(lanes, torch.full((B,), i)))
                      for i in range(problem.max_iterations)], axis=1)
    tp, ts = config_from_jax(problem, jsolver)
    one = ShardedSCPSolver(tp, ts, dtype=torch.float64, device="cpu")
    tangles = worker.TableAngles(table)
    ref = one.solve(p0, v0, pf, v0, angle_fn=tangles)
    ref_c = one.solve_compacted(p0, v0, pf, v0, chunk=2, step_iters=2,
                                angle_fn=tangles)
    inp = dict(p0=p0, v0=v0, pf=pf, vf=v0, angles=table)
    outs = _spawn(tmp_path, 2, "scenarios", inp, tp, ts)
    for got in outs:
        for prefix, j, r in (("solve_", want, ref),
                             ("compacted_", want_c, ref_c)):
            for name in ("status", "iterations", "qp_iterations",
                         "feasible_final"):
                np.testing.assert_array_equal(got[prefix + name],
                                              np.asarray(getattr(j, name)))
                np.testing.assert_array_equal(got[prefix + name],
                                              getattr(r, name).numpy())
            np.testing.assert_allclose(got[prefix + "positions"],
                                       np.asarray(j.positions), atol=1e-3)
            np.testing.assert_allclose(got[prefix + "positions"],
                                       r.positions.numpy(), atol=1e-7)
        # each rank compacts its own two lanes, as JAX's shard-local rounds
        assert int(got["loop_rounds"]) <= jsh.last_timing["loop_rounds"]
    assert int(np.asarray(want.iterations).max()) >= 2   # the loop ran


def test_scenario_parallel_refuses_uneven_batches():
    from ba_path_planning_torch.parallel.mesh import Mesh
    tp, ts = config_from_jax(_problem(3), _jax_solver(_problem(3)))
    sh = ShardedSCPSolver(tp, ts, dtype=torch.float64, device="cpu",
                          mesh=Mesh(None, 0, 2))
    z = np.zeros((3, 3, 2))
    with pytest.raises(ValueError, match="not divisible by 2 ranks"):
        sh.solve(z, z, z, z)
    with pytest.raises(ValueError, match="multiple of the rank count"):
        sh.solve_compacted(np.zeros((6, 3, 2)), *[np.zeros((6, 3, 2))] * 3,
                           chunk=3)


# -- plumbing ------------------------------------------------------------------

def test_distributed_helpers_on_two_ranks(tmp_path):
    problem = jcfg.ProblemConfig(n_vehicles=3, time_horizon=2.0,
                                 time_step=0.2, min_distance=0.8,
                                 max_iterations=3)
    tp, ts = config_from_jax(problem, _jax_solver(problem))
    outs = _spawn(tmp_path, 2, "helpers", {}, tp, ts)
    for r, got in enumerate(outs):
        assert got["slice"].tolist() == [5 * r, 5 * r + 5]
        np.testing.assert_array_equal(got["glob0"],
                                      np.repeat([0.0, 1.0], 2)[:, None]
                                      * np.ones((4, 3)))
        assert got["glob1"].tolist() == [0, 10, 1, 11]
        assert got["glob2"].tolist() == [True, True, False, True]
        assert int(got["n_processes"]) == 2
        assert int(got["n_devices_total"]) == 1      # both on the CPU
        assert got["one"][0] == 2 and got["one"][1] > 0
        assert got["one"][2] == pytest.approx(1.0)
        assert got["group"][0] == 4 and got["group"][1] > 0
        assert got["group"][2] == 1.0                 # a shared device
    np.testing.assert_array_equal(outs[0]["one"], outs[1]["one"])


def test_init_distributed_names_its_backend():
    from ba_path_planning_torch.parallel.distributed import (
        host_local_slice, init_distributed)
    with pytest.raises(ValueError, match="backend"):
        init_distributed("mpi")
    init_distributed("gloo")          # one process: nothing to join
    assert not torch.distributed.is_initialized()
    assert host_local_slice(10) == (0, 10)
