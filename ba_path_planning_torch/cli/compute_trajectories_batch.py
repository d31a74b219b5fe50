"""Batch benchmark CLI of the PyTorch port: the reference's
``compute-trajectories-batch`` workload, with the sequential trial loop
replaced by one batched solve on the GPU (counterpart of
``ba_path_planning_tpu.cli.compute_trajectories_batch``: the same flags,
defaults and outputs).

    python -m ba_path_planning_torch.cli.compute_trajectories_batch \\
        --ns 18 20 --trials-per-n 16 --results-dir results/trial_1

Output keeps the reference's compatibility schema: a timestamped JSON
``{meta, runs, summary}`` document (``schema_version: "1.0"``) and a flat
CSV with columns ``N, trial_index, status, time_sec, K, T, h, error``, so
the boxplot tool consumes either implementation's results.

Semantics notes:
  * per-trial ``time_sec`` is the measured batch wall time distributed over
    scenarios in proportion to their SCP iteration counts (uniform phases
    split equally); it sums to the true wall time (meta ``timing_mode:
    per_scenario_iter_weighted``)
  * ``status`` is "success" when the solve produced a collision-free
    trajectory that reaches its goal within 5 cm, else "error" with the
    cause
  * the scenarios of N come from the ``torch.Generator`` seed
    ``rng_seed + 1000 * N``, recorded per trial; they are not the JAX CLI's
    scenarios for the same seed, so a ``--resume-dir`` written by the JAX
    CLI is refused (its run identity has no ``engine``)
  * everything runs on one device, the card unless ``main`` is given
    another ``device``; ``--dtype float64`` needs ``device="cpu"``, since
    the kernels take float32 only
"""

from __future__ import annotations

import argparse
import csv
import json
import time
from datetime import datetime
from pathlib import Path

import numpy as np

ENGINE = "ba_path_planning_torch"

DEFAULT_CONFIG = {
    "Ns": [18, 20],                 # robot counts to test
    "trials_per_N": 10,             # trials for each N
    "time_horizon": 10.0,           # [s]
    "time_step": 0.2,               # [s]
    "min_distance": 0.8,            # [m]
    "space_dims": [0, 0, 20, 20],
    "max_iterations": 15,
    "rng_seed": 0,
    "results_dir": "data/trial_xxx",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", type=str, default=None, help="YAML config file")
    p.add_argument("--ns", type=int, nargs="+", default=None)
    p.add_argument("--trials-per-n", type=int, default=None)
    p.add_argument("--time-horizon", type=float, default=None)
    p.add_argument("--time-step", type=float, default=None)
    p.add_argument("--min-distance", type=float, default=None)
    p.add_argument("--max-iterations", type=int, default=None)
    p.add_argument("--rng-seed", type=int, default=None)
    p.add_argument("--results-dir", type=str, default=None)
    p.add_argument("--dtype", choices=["float32", "float64"],
                   default="float32")
    p.add_argument("--solver", choices=["production", "reference"],
                   default="production",
                   help="'production': tuned direct solver, goal-directed "
                        "stopping; 'reference': step-norm stopping with "
                        "hard collision constraints (reference semantics)")
    p.add_argument("--stop-mode", choices=["feasible", "reference"],
                   default=None, help="override the SCP stopping rule")
    p.add_argument("--resume-dir", type=str, default=None,
                   help="checkpoint directory: chunks of scenarios are "
                        "saved as they complete and a rerun with the same "
                        "directory (and config) skips finished chunks; a "
                        "killed run resumes instead of restarting "
                        "(utils.checkpoint.ChunkedRun)")
    p.add_argument("--resume-chunk", type=int, default=None,
                   help="scenarios per checkpoint chunk (default "
                        "256 x device count)")
    return p


def _merge_config(args) -> dict:
    cfg = dict(DEFAULT_CONFIG)
    if args.config:
        from ..utils.config import load_yaml
        cfg.update(load_yaml(args.config) or {})
    for key, attr in [("Ns", "ns"), ("trials_per_N", "trials_per_n"),
                      ("time_horizon", "time_horizon"),
                      ("time_step", "time_step"),
                      ("min_distance", "min_distance"),
                      ("max_iterations", "max_iterations"),
                      ("rng_seed", "rng_seed"),
                      ("results_dir", "results_dir")]:
        v = getattr(args, attr)
        if v is not None:
            cfg[key] = v
    return cfg


def run_batch_for_n(n: int, cfg: dict, dtype, solver_kind: str = "production",
                    stop_mode: str | None = None,
                    resume_dir: str | None = None,
                    resume_chunk: int | None = None,
                    device=None) -> list[dict]:
    """Solve all trials for one vehicle count as one batch on ``device``
    (None: the card)."""
    import torch

    from ..models.double_integrator import DoubleIntegrator2D
    from ..parallel.mesh import ShardedSCPSolver, pad_to_multiple
    from ..scenarios import generate_scenario_batch
    from ..solvers.scp import SCPResult
    from ..utils.config import ProblemConfig, SolverConfig, resolve_device

    device = resolve_device(device)
    if stop_mode is None:
        stop_mode = "feasible" if solver_kind == "production" else "reference"
    problem = ProblemConfig(
        n_vehicles=n, time_horizon=cfg["time_horizon"],
        time_step=cfg["time_step"], min_distance=cfg["min_distance"],
        space_dims=tuple(cfg["space_dims"]),
        max_iterations=cfg["max_iterations"], stop_mode=stop_mode,
        # exact terminal projection in goal-directed mode: the emitted
        # trajectory hits p[K] = pf to float roundoff (the reference's hard
        # terminal equality)
        goal_project=(stop_mode == "feasible"))

    trials = int(cfg["trials_per_N"])
    n_dev = 1
    padded = pad_to_multiple(trials, n_dev)

    seed = int(cfg["rng_seed"]) if cfg["rng_seed"] is not None else 0
    scenario_seed = seed + 1000 * n       # echoes ref's seed+1000*N+trial
    sc = generate_scenario_batch(scenario_seed, padded, n_vehicles=n,
                                 min_distance=cfg["min_distance"],
                                 dtype=dtype, device=device)
    v0 = torch.zeros_like(sc.initial)

    if solver_kind == "production":
        solver_cfg = SolverConfig.production(problem=problem)
    else:
        # hard collision constraints, reference-style inner solver budget
        solver_cfg = SolverConfig.production(problem=problem).replace(
            collision_margin=0.0, col_penalty=float("inf"), max_iter=500,
            check_interval=100)
    # the degenerate-pair draws are keyed by (scenario seed, lane, SCP
    # iteration)
    solver = ShardedSCPSolver(problem, solver_cfg, dtype=dtype,
                              device=device, seed=scenario_seed)

    if resume_dir is not None:
        # Chunk-granular resumable run: every chunk is persisted as it
        # completes; a rerun with the same directory + config skips
        # finished chunks (a config mismatch refuses).  Wall time here is
        # accumulated across invocations in walls.json.
        from ..utils.checkpoint import ChunkedRun
        chunk = resume_chunk if resume_chunk else 256 * n_dev
        chunk = max(n_dev, (min(chunk, padded) // n_dev) * n_dev)
        # chunk size, padded total and device count are part of the run
        # identity (other chunk boundaries would duplicate or skip scenario
        # ranges), and so is the engine: the JAX CLI draws other scenarios
        # for the same seed
        ident = {"N": n, "trials": trials, "seed": seed,
                 "solver": solver_kind, "stop_mode": stop_mode,
                 "chunk": chunk, "padded": padded, "n_dev": n_dev,
                 "engine": ENGINE,
                 **{k: cfg[k] for k in ("time_horizon", "time_step",
                                        "min_distance", "max_iterations")}}
        run_dir = Path(resume_dir) / f"N{n}"
        ck = ChunkedRun(run_dir, ident)
        walls_path = run_dir / "walls.json"
        walls = (json.loads(walls_path.read_text())
                 if walls_path.exists() else {})
        for idx, (lo, hi) in ck.pending(padded, chunk):
            tc = time.perf_counter()
            out = solver.solve_compacted(
                sc.initial[lo:hi], v0[lo:hi], sc.final[lo:hi], v0[lo:hi],
                lane_ids=torch.arange(lo, hi, device=device))
            ck.save_chunk(idx, out)
            walls[str(idx)] = time.perf_counter() - tc
            walls_path.write_text(json.dumps(walls))
            print(f"  chunk {idx}: scenarios [{lo}, {hi}) saved "
                  f"({walls[str(idx)]:.2f} s)", flush=True)
        res = ck.merge(SCPResult, total=padded, chunk=chunk)
        wall = float(sum(walls.values()))
        timing = {}
    else:
        def run():
            out = solver.solve_compacted(sc.initial, v0, sc.final, v0)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return out

        # the first run (kernel build, library handles) is not timed
        run()
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
        timing = solver.last_timing
        res = SCPResult(*(t.cpu().numpy() for t in res))

    ok = sc.ok.cpu().numpy()
    p0_h, pf_h = sc.initial.cpu().numpy(), sc.final.cpu().numpy()
    # pre-feasibility screen from the dynamics model: a goal farther than the
    # vehicle can travel within the horizon makes the QP infeasible by
    # construction; report it as the cause instead of a bare solver failure
    model = DoubleIntegrator2D(n_steps=problem.n_steps,
                               time_step=problem.time_step)
    reachable = model.reachable(p0_h, pf_h, problem.vel_max,
                                problem.acc_max).all(axis=-1)
    # terminal goal attainment: the reference enforces p[K] = pf as a hard
    # equality; the batched solver reports the achieved terminal error and
    # a trial only counts as success when the goal is actually hit
    pK, _ = model.terminal_state(res.positions, res.velocities,
                                 res.accelerations)
    goal_err = np.linalg.norm(pK - pf_h, axis=-1).max(axis=-1)
    GOAL_TOL = 0.05                    # [m]
    # Per-scenario time proxy: the batch has no per-lane clocks, but the
    # compaction loop knows how much wall time went into the SCP-iteration
    # loop against the batch-uniform phases (initial QP, rollout,
    # feasibility), and each loop dispatch costs the same per occupied
    # lane-iteration.  The loop wall is distributed over lanes in proportion
    # to their SCP iteration counts and the rest equally, over the reported
    # rows only; the proxy sums to the measured wall.
    iters = np.asarray(res.iterations, dtype=float)
    loop_s = float(timing.get("loop_s", 0.0))
    base_s = max(wall - loop_s, 0.0)
    weight_sum = float(iters[:trials].sum())
    per_iter = loop_s / weight_sum if weight_sum > 0 else 0.0
    time_sec = base_s / trials + per_iter * iters
    rows = []
    for t in range(trials):
        gen_ok = bool(ok[t])
        feasible = bool(res.feasible_final[t])
        success = gen_ok and feasible
        err = None
        if not gen_ok:
            err = "scenario generation failed"
        elif not reachable[t]:
            success = False
            err = "goal unreachable within horizon (dynamics pre-screen)"
        elif not feasible:
            err = f"not collision-free (status={int(res.status[t])})"
        elif goal_err[t] >= GOAL_TOL:
            success = False
            err = f"goal missed by {goal_err[t]:.3f} m"
        rows.append({
            "N": n,
            "trial_index": t,
            "status": "success" if success else "error",
            "time_sec": float(time_sec[t]),
            "error": err,
            "K": problem.n_steps,
            "T": problem.time_horizon,
            "h": problem.time_step,
            "scp_iterations": int(res.iterations[t]),
            "qp_iterations": int(res.qp_iterations[t]),
            "scp_status": int(res.status[t]),
            "goal_error_m": float(goal_err[t]),
            "seed": scenario_seed,
        })
    return rows


def summarize(runs: list[dict], ns: list[int]) -> dict:
    summary = {}
    for n in ns:
        times = [r["time_sec"] for r in runs
                 if r["N"] == n and r["status"] == "success"]
        errors = sum(1 for r in runs
                     if r["N"] == n and r["status"] != "success")
        if times:
            summary[str(n)] = {
                "count": len(times),
                "errors": errors,
                "min": float(np.min(times)),
                "max": float(np.max(times)),
                "mean": float(np.mean(times)),
                "median": float(np.median(times)),
                "p25": float(np.percentile(times, 25)),
                "p75": float(np.percentile(times, 75)),
                "std": float(np.std(times, ddof=1)) if len(times) > 1 else 0.0,
            }
        else:
            summary[str(n)] = {"count": 0, "errors": errors, "min": None,
                               "max": None, "mean": None, "median": None,
                               "p25": None, "p75": None, "std": None}
    return summary


def main(argv=None, *, device=None) -> int:
    """The CLI; ``device`` (None: the card) is for callers in Python."""
    args = build_parser().parse_args(argv)
    cfg = _merge_config(args)

    import torch
    dtype = torch.float64 if args.dtype == "float64" else torch.float32

    Path(cfg["results_dir"]).mkdir(parents=True, exist_ok=True)
    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    json_path = Path(cfg["results_dir"]) / f"scp_benchmark_{stamp}.json"
    csv_path = Path(cfg["results_dir"]) / f"scp_benchmark_{stamp}.csv"

    print("------ WOW SCP Benchmark (GPU batched, PyTorch) ------")
    print(f"Robot counts: {cfg['Ns']}, Trials per N: {cfg['trials_per_N']}")
    print(f"T={cfg['time_horizon']}s, h={cfg['time_step']}s, "
          f"R={cfg['min_distance']}m, space={cfg['space_dims']}")
    print(f"Max SCP iterations: {cfg['max_iterations']}")
    print()

    all_results = {
        "meta": {
            "timestamp": stamp,
            "description": ("SCP timing benchmark for multiple N; batched "
                            "GPU execution (PyTorch and CUDA), per-trial "
                            "time is the batch wall time distributed over "
                            "scenarios by their SCP iteration counts (sums "
                            "to wall time)."),
            "config": cfg,
            "schema_version": "1.0",
            "timing_mode": "per_scenario_iter_weighted",
            "engine": ENGINE,
        },
        "runs": [],
        "summary": {},
    }

    for n in cfg["Ns"]:
        print(f"==> N = {n}")
        rows = run_batch_for_n(n, cfg, dtype, solver_kind=args.solver,
                               stop_mode=args.stop_mode,
                               resume_dir=args.resume_dir,
                               resume_chunk=args.resume_chunk, device=device)
        all_results["runs"].extend(rows)
        succ = sum(1 for r in rows if r["status"] == "success")
        mean_t = float(np.mean([r["time_sec"] for r in rows]))
        print(f"  {succ}/{len(rows)} collision-free, "
              f"amortized {mean_t*1e3:.2f} ms/solve")
        print()

    all_results["summary"] = summarize(all_results["runs"], cfg["Ns"])

    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(all_results, f, indent=2)
    print(f"Saved JSON: {json_path}")

    fieldnames = ["N", "trial_index", "status", "time_sec", "K", "T", "h",
                  "error"]
    with open(csv_path, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames, extrasaction="ignore")
        w.writeheader()
        for r in all_results["runs"]:
            w.writerow({k: r.get(k) for k in fieldnames})
    print(f"Saved CSV:  {csv_path}")

    print("\nSummary (success-only times):")
    for n in cfg["Ns"]:
        s = all_results["summary"][str(n)]
        print(f"  N={n}: count={s['count']}, errors={s['errors']}, "
              f"mean={s['mean']}, median={s['median']}, p25={s['p25']}, "
              f"p75={s['p75']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
