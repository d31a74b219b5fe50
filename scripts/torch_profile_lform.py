#!/usr/bin/env python3
"""Where the time goes on the paths of the PyTorch/CUDA port
(``ba_path_planning_torch``), on one GPU.

    python3 scripts/torch_profile_lform.py [--route grouped_L] [--batch 128]
                                           [--max-iter 250]
    python3 scripts/torch_profile_lform.py --route production [-N 30]

``--route grouped_L``, ``resident`` or ``fused_L``: the reference-compatible
path.  Builds the N=20, K=50 problem and solver of the ``SCP`` class on that
kernel route, runs phase 1 over ``--batch`` generated scenarios, and then
measures one SCP iteration of every lane (``SCPEngine.step``).  The QP budget
of that iteration is cut to ``--max-iter`` ADMM iterations (intervals of 25
with early exit, as on the full path) so that the trace stays small; an ADMM
iteration costs what it costs on the full path.

``--route production``: the ``chip_smoke.py`` main path for ``-N`` vehicles
(``solve_compacted`` at the ``bench.py`` configuration with
``SolverConfig.production()``: 2048 scenarios in chunks of 128, or 1024 in
chunks of 512 up to N = 21), the whole solve.

Either is run three times untraced and once under ``torch.profiler``.  Prints
the walls, the device-busy time (the sum of the kernel times: everything runs
on one stream), the idle share under tracing, the launches, and the kernels
that take most of the device time.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def lform_step(args):
    """(what is measured, the function measured) for an L-form route."""
    import torch
    import chip_smoke
    from ba_path_planning_torch.scenarios.generator import (
        generate_scenario_batch)
    from ba_path_planning_torch.solvers.scp import SCPEngine
    change, _ = chip_smoke.FACADE_ROUTES[args.route]
    problem = chip_smoke._problem(20, facade=True)
    solver = chip_smoke._facade_solver(**change).replace(
        max_iter=args.max_iter)
    eng = SCPEngine(problem, solver, dtype=torch.float32)
    sc = generate_scenario_batch(100, args.batch, n_vehicles=20,
                                 min_distance=chip_smoke.R)
    v0 = torch.zeros_like(sc.initial)
    inputs = (sc.initial, v0, sc.final, v0)
    lanes = torch.arange(args.batch, device=eng.device)
    carry = eng.start(*inputs)

    def step():
        out = eng.step(carry, *inputs, lanes, carry.it + 1)
        qp_iters = (out.qp_iters - carry.qp_iters).float()
        return (f"QP iterations mean {float(qp_iters.mean()):.1f} max "
                f"{int(qp_iters.max())}")
    return (f"route {args.route}, N=20 K={chip_smoke.K_STEPS} "
            f"B={args.batch} f32, one SCP iteration of every lane, QP budget "
            f"{args.max_iter}", step)


def production_solve(args):
    """(what is measured, the function measured) for the production path."""
    import torch
    import chip_smoke
    from ba_path_planning_torch.parallel.mesh import ShardedSCPSolver
    from ba_path_planning_torch.scenarios.generator import (
        generate_scenario_batch)
    from ba_path_planning_torch.utils.config import SolverConfig
    n_veh = args.n_vehicles
    B, chunk = (1024, 512) if n_veh <= 21 else (2048, 128)
    problem = chip_smoke._problem(n_veh)
    sh = ShardedSCPSolver(problem, SolverConfig.production(problem=problem),
                          dtype=torch.float32)
    sc = generate_scenario_batch(100, B, n_vehicles=n_veh,
                                 min_distance=chip_smoke.R,
                                 dtype=torch.float32)
    v0 = torch.zeros_like(sc.initial)

    def solve():
        out = sh.solve_compacted(sc.initial, v0, sc.final, v0, chunk=chunk)
        return (f"feasible {int(out.feasible_final.sum())}/{B}, mean SCP "
                f"iterations {float(out.iterations.float().mean()):.3f}")
    solve()                                  # library handles, allocator
    return (f"production path N={n_veh} K={chip_smoke.K_STEPS} B={B} "
            f"chunk={chunk} f32", solve)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--route", default="grouped_L",
                    choices=("grouped_L", "resident", "fused_L",
                             "production"))
    ap.add_argument("-N", "--n-vehicles", type=int, default=30,
                    help="vehicles of the production path")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--max-iter", type=int, default=250)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures on a GPU only")
    import chip_smoke
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke._card_line()
    what, fn = (production_solve if args.route == "production"
                else lform_step)(args)
    torch.cuda.synchronize()

    def timed():
        t0 = time.perf_counter()
        said = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, said

    walls = [timed()[0] for _ in range(3)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced, said = timed()

    def device_us(e):       # the attribute's name differs between versions
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    # kernels and copies only: the host-side operator rows repeat their time
    rows = [(e.key, device_us(e) / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"{card}; torch {torch.__version__}; {what}: {said}")
    print(f"untraced walls (s): {[round(w, 4) for w in walls]}; traced wall "
          f"{traced:.4f} s; device busy {busy / 1e3:.4f} s; idle share under "
          f"tracing {1 - busy / 1e3 / traced:.3f}; device launches "
          f"{sum(r[2] for r in rows)}")
    for key, ms, count in rows[:args.top]:
        print(f"  {ms:10.3f} ms {100 * ms / busy:5.1f}%  x{count:<7d} "
              f"{key[:90]}")


if __name__ == "__main__":
    main()
