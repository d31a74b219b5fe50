"""Headline benchmark of the PyTorch port: collision-free scenario solves
per second on one GPU (the torch twin of the repository's ``bench.py``).

    python -m ba_path_planning_torch.bench

Workload: ``bench.py``'s.  N=20 vehicles, T=10 s, h=0.2 (K=50), R=0.8,
20x20 box, at most 15 SCP iterations, ``stop_mode="feasible"`` with the exact
goal projection, ``SolverConfig.production()``; B=4096 scenarios solved by
``ShardedSCPSolver.solve_compacted`` in chunks of 512, on the card.  A full
warm-up run on seed 0 comes first, then the timed run on fresh scenarios
(seed 100).  A solve counts (ok) when its trajectory is collision-free and
ends within 5 cm of its goal.

Prints ``bench.py``'s JSON line on stdout,

  {"metric": "scenario_solves_per_sec", "value": ..., "unit": "solves/s",
   "vs_baseline": null}

and ``bench.py``'s summary on stderr, field for field.  ``vs_baseline`` is
null: ``bench.py`` divides by a per-chip rate set for a TPU slice, and the
port states no TPU rate.

Where the port cannot do what ``bench.py`` does:
  * the scenarios are drawn on the host by ``torch.Generator`` before the
    clock starts (``bench.py`` draws them on the device inside its timed
    run); a seed gives other scenarios than JAX's PRNG;
  * p50 latency: 10 solves of ``SCPEngine(problem, SolverConfig.latency())``,
    the first skipped, each clock stopped after ``torch.cuda.synchronize()``;
  * ``p50_ondevice_solve_ms``: ``bench.py`` runs M solves in one ``lax.map``
    dispatch on the device and takes the slope between M=4 and M=24, which
    differences away the dispatch cost.  The port has no such dispatch: M
    sequential calls of ``SCPEngine.solve_fn()`` run with one synchronize at
    the end, and the slope (t(24) - t(4)) / 20, the median of 3, is the
    per-solve time of that loop.  It includes the host's time, since the QP
    loop reads one flag per check interval from the card.  The field keeps
    its name so that the line has ``bench.py``'s fields.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

BATCH, CHUNK = 4096, 512
GOAL_TOL = 0.05                        # [m]


def headline_problem():
    """``bench.py``'s problem."""
    from .utils.config import ProblemConfig
    return ProblemConfig(n_vehicles=20, time_horizon=10.0, time_step=0.2,
                         min_distance=0.8, max_iterations=15,
                         stop_mode="feasible", goal_project=True)


def measure(problem, *, batch: int, chunk: int, device=None,
            lat_runs: int = 10, slope_m: tuple[int, int] = (4, 24),
            slope_reps: int = 3) -> tuple[dict, str]:
    """Run the benchmark on ``device`` (None: the card); returns the JSON
    line as a dict and the summary line."""
    import torch

    from .models.double_integrator import DoubleIntegrator2D
    from .parallel.mesh import ShardedSCPSolver
    from .scenarios import generate_scenario_batch
    from .solvers.scp import SCPEngine
    from .utils.config import SolverConfig, resolve_device

    device = resolve_device(device)
    f32 = torch.float32
    n_dev = 1

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def scenarios(seed, m):
        sc = generate_scenario_batch(seed, m,
                                     n_vehicles=problem.n_vehicles,
                                     min_distance=problem.min_distance,
                                     dtype=f32, device=device)
        return sc.initial, torch.zeros_like(sc.initial), sc.final

    sh = ShardedSCPSolver(problem, SolverConfig.production(problem=problem),
                          dtype=f32, device=device)

    def run(seed):
        p0, v0, pf = scenarios(seed, batch)
        sync()
        t0 = time.perf_counter()
        out = sh.solve_compacted(p0, v0, pf, v0, chunk=chunk)
        sync()
        return time.perf_counter() - t0, out, pf

    run(0)                            # warm-up: kernel build, handles
    dt, res, res_pf = run(100)

    status = res.status.cpu().numpy()
    ff = res.feasible_final.cpu().numpy()
    model = DoubleIntegrator2D(n_steps=problem.n_steps,
                               time_step=problem.time_step)
    pK, _ = model.terminal_state(res.positions, res.velocities,
                                 res.accelerations)
    goal_err = torch.linalg.vector_norm(pK - res_pf, dim=-1).amax(-1)
    goal_err = goal_err.cpu().numpy()
    ok = int((ff & (goal_err < GOAL_TOL)).sum())
    solves_per_sec = ok / dt

    lat_engine = SCPEngine(problem, SolverConfig.latency(), dtype=f32,
                           device=device)
    lat = []
    for i in range(lat_runs):
        p0, v0, pf = scenarios(50 + i, 1)
        sync()
        t0 = time.perf_counter()
        lat_engine.solve(p0[0], v0[0], pf[0], v0[0])
        sync()
        lat.append(time.perf_counter() - t0)
    p50_latency_ms = float(np.median(lat[1:]) * 1e3)   # skip the first call

    solve_one = lat_engine.solve_fn()

    def run_seq(m, seed):
        p0, v0, pf = scenarios(seed, m)
        sync()
        t0 = time.perf_counter()
        for s in range(m):
            solve_one(p0[s], v0[s], pf[s], v0[s])
        sync()
        return time.perf_counter() - t0

    m1, m2 = slope_m
    for m in (m1, m2):
        run_seq(m, 200 + m)                            # warm-up
    slopes = []
    for r in range(slope_reps):
        t1 = run_seq(m1, 300 + 10 * r)
        t2 = run_seq(m2, 400 + 10 * r)
        slopes.append((t2 - t1) / (m2 - m1))
    ondevice_p50_ms = float(np.median(slopes) * 1e3)

    line = {
        "metric": "scenario_solves_per_sec",
        "value": round(solves_per_sec, 2),
        "unit": "solves/s",
        "vs_baseline": None,
    }
    summary = (
        f"# batch={batch} devices={n_dev} wall={dt:.3f}s "
        f"ok={ok}/{batch} (collision_free={int(ff.sum())}, "
        f"goal<5cm={int((goal_err < GOAL_TOL).sum())}, "
        f"goal_err p50={float(np.median(goal_err)):.3f} "
        f"p99={float(np.percentile(goal_err, 99)):.3f}) "
        f"statuses={np.bincount(status, minlength=3).tolist()} "
        f"mean_scp_iters={float(res.iterations.float().mean()):.3f} "
        f"mean_qp_iters={float(res.qp_iterations.float().mean()):.0f} "
        f"p50_single_scenario_latency_ms={p50_latency_ms:.1f} "
        f"p50_ondevice_solve_ms={ondevice_p50_ms:.2f}")
    return line, summary


def main():
    line, summary = measure(headline_problem(), batch=BATCH, chunk=CHUNK)
    print(json.dumps(line))
    print(summary, file=sys.stderr)


if __name__ == "__main__":
    main()
