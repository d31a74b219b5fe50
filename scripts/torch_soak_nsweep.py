#!/usr/bin/env python3
"""The round-record run of the PyTorch port: a soak at the bench
configuration and a sweep over the vehicle count, each solved by
``ShardedSCPSolver.solve_compacted`` with ``SolverConfig.production`` in
float32 (the counterpart of ``scripts/soak_and_nsweep.py``):

    python3 scripts/torch_soak_nsweep.py [--ns N ...] [--batch B]
        [--out docs/soak_nsweep_h100.json] [--device cuda] [--seed 100]

The problem is K=50 (T=10, h=0.2), R=0.8, at most 15 SCP iterations,
``stop_mode="feasible"``, zero start and goal velocities.  The soak is N=20,
B=4096, chunk 512; the sweep is (N, B, chunk) = (10, 1024, 512),
(20, 1024, 512), (30, 2048, 128), (40, 2048, 128), (50, 2048, 128) and
(60, 2048, 128).  ``--ns`` picks the sweep's vehicle counts (the soak runs
at N=20 where 20 is among them, else at the first), ``--batch`` sets every
batch (a chunk is cut to it).  Each configuration runs once on scenarios of
seed 0 to warm up, then once, timed, on fresh scenarios of ``--seed``
(``solves_per_sec``: collision-free lanes over the wall of that solve).
So the rate is not quite the JAX record's: that script draws its scenarios
on the device inside its timer, where this one draws them on the host
before the timer; and at N = 60 this one times only lanes whose draw
succeeded (:func:`scenarios`), a sample conditioned on a feasible draw.
Both time seed 100 once.

The record has the keys of ``docs/soak_nsweep_v5e.json`` (``soak`` and
``n_sweep[]`` of ``N``, ``batch``, ``chunk``, ``solves_per_sec``,
``collision_free``, ``mean_scp_iters``) and, for each configuration, the
mean QP iterations, the route of the collision QPs, the peak device memory,
the wall, the kernel launches of the timed run and the lanes that are not
collision-free; at the top, ``card``: the card's name and power limit as
nvidia-smi gives them.  The configurations that the JAX package validated
(the soak and N = 10 .. 40 at the record's batches) are held to its
record: every lane collision-free, mean SCP iterations within SCP_BAR of
JAX's.  The script writes the record, then exits 1 if one of them missed.
Without a card it fails unless ``--device cpu`` is given.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

T_HORIZON, H, R, MAX_SCP = 10.0, 0.2, 0.8, 15
SOAK = (20, 4096, 512)
SWEEP = ((10, 1024, 512), (20, 1024, 512), (30, 2048, 128), (40, 2048, 128),
         (50, 2048, 128), (60, 2048, 128))
WARMUP_SEED = 0
# lanes a draw of scenarios takes after its first batch: the host's
# rejection loop costs less a lane in wide batches
DRAW_BATCH = 2048
# the JAX package's record (docs/soak_nsweep_v5e.json): (N, batch) -> mean
# SCP iterations, every lane collision-free; its constants were validated
# up to N = 40 only (SolverConfig.production's docstring), so N = 50 and 60
# carry no bar
JAX_RECORD = {(20, 4096): 1.33, (10, 1024): 1.04, (20, 1024): 1.33,
              (30, 2048): 1.76, (40, 2048): 2.35}
SCP_BAR = 0.05


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_counters():
    """The launch counter of every kernel wrapper, by kernel."""
    from ba_path_planning_torch.ops import (admm_fused, banded_solve,
                                            group_solve, ns_chain)
    return {"ns_chain": ns_chain.factorize_X_chain_batched,
            "group_solve_x": group_solve.solve_factorized_grouped_X,
            "admm_fused_x": admm_fused.admm_interval_fused_X,
            "admm_fused_x_wide": admm_fused.admm_interval_fused_X.wide,
            "group_solve_l": group_solve.solve_factorized_grouped_L,
            "banded_solve": banded_solve.solve_factorized_dense,
            "admm_fused_l": admm_fused.admm_interval_fused}


def scenarios(seed, B, N, device):
    """B scenarios of N vehicles R apart, drawn by
    ``generate_scenario_batch`` (its own ``torch.Generator``): a batch of B
    from ``seed``, then, while lanes are missing, batches of
    max(B, DRAW_BATCH) from ``seed + 1``, ``seed + 2``, ...; the lanes whose
    rejection sampling succeeded are kept in order until there are B.  Up
    to N = 50 the first batch succeeds whole; at N = 60 about 3.6% of the
    lanes do (the four start circles hold about 59 vehicles 0.8 m apart
    when filled at random, as in the JAX package's generator).  Returns
    (initial, final, lanes drawn) with the positions float32 on
    ``device``."""
    import torch
    from ba_path_planning_torch.scenarios.generator import (
        generate_scenario_batch)
    init, final, drawn, size = [], [], 0, B
    while sum(len(p) for p in init) < B:
        sc = generate_scenario_batch(seed + len(init), size, n_vehicles=N,
                                     min_distance=R, dtype=torch.float32,
                                     device="cpu")
        init.append(sc.initial[sc.ok])
        final.append(sc.final[sc.ok])
        drawn, size = drawn + size, max(B, DRAW_BATCH)
    return (torch.cat(init)[:B].to(device), torch.cat(final)[:B].to(device),
            drawn)


def run_cfg(N, B, chunk, *, device="cuda", seed=100, solver=None,
            warmup=True):
    """One configuration: a warm-up solve of B scenarios of WARMUP_SEED
    (unless ``warmup`` is false: a caller whose own solves warmed the card
    skips it), then a timed solve of B fresh scenarios of ``seed``
    (:func:`scenarios`, drawn before the timer starts: on the host they
    take seconds, minutes at N = 60).  ``solver`` defaults to
    ``SolverConfig.production(problem=...)``.  Returns the configuration's
    record."""
    import torch
    from ba_path_planning_torch.models.double_integrator import (
        DoubleIntegrator2D)
    from ba_path_planning_torch.parallel.mesh import ShardedSCPSolver
    from ba_path_planning_torch.solvers.banded import qp_route
    from ba_path_planning_torch.utils.config import (ProblemConfig,
                                                     SolverConfig)
    device = torch.device(device)
    cuda = device.type == "cuda"
    problem = ProblemConfig(n_vehicles=N, time_horizon=T_HORIZON,
                            time_step=H, min_distance=R,
                            max_iterations=MAX_SCP, stop_mode="feasible")
    if solver is None:
        solver = SolverConfig.production(problem=problem)
    sh = ShardedSCPSolver(problem, solver, dtype=torch.float32,
                          device=device)
    route = qp_route(solver.static_part(), n_vehicles=N,
                     n_steps=problem.n_steps, dtype=torch.float32,
                     col_enabled=True)

    def solve(p0, pf):
        v0 = torch.zeros_like(p0)
        out = sh.solve_compacted(p0, v0, pf, v0, chunk=chunk)
        if cuda:
            torch.cuda.synchronize(device)
        return out

    if warmup:
        solve(*scenarios(WARMUP_SEED, B, N, device)[:2])
    p0, pf, draws = scenarios(seed, B, N, device)
    counters = kernel_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = solve(p0, pf)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches - before[k] for k, fn in counters.items()}

    model = DoubleIntegrator2D(n_steps=problem.n_steps, time_step=H)
    pK, _ = model.terminal_state(out.positions, out.velocities,
                                 out.accelerations)
    goal_err = torch.linalg.vector_norm(pK - pf, dim=-1).amax(-1)
    ff = out.feasible_final
    if tuple(out.positions.shape) != (B, N, problem.n_steps, 2) or not bool(
            torch.isfinite(out.positions).all()):
        raise RuntimeError(f"N={N}: positions {tuple(out.positions.shape)} "
                           "not of the batch's shape or not finite")
    free = int(ff.sum())
    return dict(
        N=N, batch=B, chunk=chunk, solves_per_sec=free / wall,
        collision_free=free,
        mean_scp_iters=float(out.iterations.float().mean()),
        mean_qp_iters=float(out.qp_iterations.float().mean()),
        goal_exact=int((goal_err < 0.05).sum()),
        route=route, wall_s=wall, seed=seed, scenario_draws=draws,
        peak_mem_gib=(torch.cuda.max_memory_allocated(device) / 2 ** 30
                      if cuda else None),
        launches=launches, timing=sh.last_timing,
        missed_lanes=torch.nonzero(~ff).flatten().tolist())


def _config(n):
    """(N, batch, chunk) of the sweep for N vehicles; an N the sweep does
    not hold takes the batch and chunk of its route's configurations."""
    for cfg in SWEEP:
        if cfg[0] == n:
            return cfg
    return (n, 1024, 512) if n <= 21 else (n, 2048, 128)


def bar_misses(rec):
    """What a configuration that the JAX record validated misses of it (an
    empty list where it holds or where no bar applies)."""
    want = JAX_RECORD.get((rec["N"], rec["batch"]))
    if want is None:
        return []
    misses = []
    if rec["collision_free"] != rec["batch"]:
        misses.append(f"collision-free {rec['collision_free']}/"
                      f"{rec['batch']}, lanes {rec['missed_lanes']}")
    if abs(rec["mean_scp_iters"] - want) > SCP_BAR:
        misses.append(f"mean SCP iterations {rec['mean_scp_iters']:.4f}, "
                      f"JAX {want} +- {SCP_BAR}")
    return misses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ns", type=int, nargs="+",
                    help="the sweep's vehicle counts (default: "
                    + " ".join(str(n) for n, _, _ in SWEEP) + ")")
    ap.add_argument("--batch", type=int, help="every configuration's batch")
    ap.add_argument("--out", default=str(ROOT / "docs/soak_nsweep_h100.json"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=100)
    args = ap.parse_args(argv)
    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_soak_nsweep.py: no CUDA device (pass "
                         "--device cpu to run on the CPU)")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    sweep = list(SWEEP) if args.ns is None else [_config(n) for n in args.ns]
    ns = [n for n, _, _ in sweep]
    configs = [(SOAK[0] if SOAK[0] in ns else ns[0],) + SOAK[1:]] + sweep
    if args.batch:
        configs = [(n, args.batch, min(c, args.batch))
                   for n, _, c in configs]
    card = card_line() if device.type == "cuda" else None
    print(f"card: {card or device}; torch {torch.__version__}", flush=True)
    rec = {"card": card, "device": str(device),
           "torch": torch.__version__, "soak": None, "n_sweep": []}
    misses = []
    for i, (n, b, c) in enumerate(configs):
        r = run_cfg(n, b, c, device=device, seed=args.seed)
        label = "soak" if i == 0 else "nsweep"
        print(f"{label}: {json.dumps(r)}", flush=True)
        misses += [f"N={n} B={b}: {m}" for m in bar_misses(r)]
        if i == 0:
            rec["soak"] = r
        else:
            rec["n_sweep"].append(r)
    rec["bar_misses"] = misses
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"saved {args.out}", flush=True)
    for m in misses:
        print(f"below the JAX record: {m}", flush=True)
    return 1 if misses else 0


if __name__ == "__main__":
    sys.exit(main())
