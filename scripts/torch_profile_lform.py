#!/usr/bin/env python3
"""Where the time goes on the reference-compatible path of the PyTorch/CUDA
port (``ba_path_planning_torch``), on one GPU.

    python3 scripts/torch_profile_lform.py [--route grouped_L] [--batch 128]
                                           [--max-iter 250]

Builds the N=20, K=50 problem and solver of the ``SCP`` class on the kernel
route asked for (``grouped_L``, ``resident`` or ``fused_L``), runs phase 1
over ``--batch`` generated scenarios, and then times one SCP iteration of
every lane (``SCPEngine.step``) three times untraced and once under
``torch.profiler``.  The QP budget of that iteration is cut to ``--max-iter``
ADMM iterations (intervals of 25 with early exit, as on the full path) so
that the trace stays small; an ADMM iteration costs what it costs on the
full path.  Prints the walls, the device-busy time (the sum of the kernel
times: everything runs on one stream), the idle share under tracing, the
launches, and the kernels that take most of the device time.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--route", default="grouped_L",
                    choices=("grouped_L", "resident", "fused_L"))
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--max-iter", type=int, default=250)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures on a GPU only")
    import chip_smoke
    from ba_path_planning_torch.scenarios.generator import (
        generate_scenario_batch)
    from ba_path_planning_torch.solvers.scp import SCPEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke._card_line()
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
    torch.cuda.synchronize()

    def step():
        t0 = time.perf_counter()
        out = eng.step(carry, *inputs, lanes, carry.it + 1)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    walls = [step()[0] for _ in range(3)]
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced, out = step()
    qp_iters = (out.qp_iters - carry.qp_iters).float()
    from torch.autograd import DeviceType

    def device_us(e):       # the attribute's name differs between versions
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    # kernels and copies only: the host-side operator rows repeat their time
    rows = [(e.key, device_us(e) / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"{card}; torch {torch.__version__}; route {args.route}, N=20 "
          f"K={chip_smoke.K_STEPS} B={args.batch} f32, one SCP iteration of "
          f"every lane, QP budget {args.max_iter}: QP iterations mean "
          f"{float(qp_iters.mean()):.1f} max {int(qp_iters.max())}")
    print(f"untraced walls (s): {[round(w, 4) for w in walls]}; traced wall "
          f"{traced:.4f} s; device busy {busy / 1e3:.4f} s; idle share under "
          f"tracing {1 - busy / 1e3 / traced:.3f}; device launches "
          f"{sum(r[2] for r in rows)}")
    for key, ms, count in rows[:args.top]:
        print(f"  {ms:10.3f} ms {100 * ms / busy:5.1f}%  x{count:<7d} "
              f"{key[:90]}")


if __name__ == "__main__":
    main()
