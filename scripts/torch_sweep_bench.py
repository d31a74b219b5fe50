#!/usr/bin/env python3
"""Time the grouped sweep kernels of the PyTorch port on one GPU.

    python3 scripts/torch_sweep_bench.py [--cases X:20:512,...] [--root DIR]

Each case (form X or L, N, B; K=50) is built and checked as ``chip_smoke.py``
builds and checks it: the X form on the NS factors of production blocks,
the L form on the block Cholesky factors of the reference-compatible
solver, both through ``chip_smoke._sweep_check`` (the kernel against its
plain version, CUDA-event times of both, the check at the ADMM loop's
scale).  Each case prints one JSON line: the launch plan, the kernel's ms,
its stream bound (every block read in both sweeps, ``chip_smoke._bound_ms``)
and its share of it, and for the L form the bound that counts only Linv's
lower triangle.  The first line names the card and its power limit.

The package and ``chip_smoke.py`` are imported from the checkout the script
lies in, or from the one given by ``--root``; to compare two versions on
the same card, run the script for each checkout in turns in one call.
"""

import argparse
import json
import sys
from pathlib import Path

CASES = ("X:20:512,X:20:128,X:20:64,X:20:1,L:20:512,L:20:64,L:20:1,"
         "L:30:128,L:40:128")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default=CASES)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_sweep_bench.py: no CUDA device")
    import chip_smoke as cs
    from ba_path_planning_torch.ops import group_solve, ns_chain
    from ba_path_planning_torch.solvers import banded
    card = cs._card_line()
    print(f"card: {card}; root {args.root}", flush=True)
    dev, K = torch.device("cuda", 0), cs.K_STEPS
    plan_fn = getattr(group_solve, "sweep_plan", None)
    for case in args.cases.split(","):
        form, N, B = case.split(":")
        N, B = int(N), int(B)
        n = 6 * N
        if form == "X":
            D, C, b, b_admm, _ = cs._case(N, B, dev, seed=B)
            F = ns_chain.factorize_X_chain_plain(D, C, ns_iters=2)
            kernel = group_solve.solve_factorized_grouped_X
            plain = group_solve.solve_factorized_grouped_X_plain
        else:
            D, C, b, b_admm, _ = cs._case(N, B, dev, seed=1000 + N + B,
                                          solver=cs._facade_solver())
            F = banded.factorize(D, banded.slot_dense(C, 2 * N))[0]
            kernel = group_solve.solve_factorized_grouped_L
            plain = group_solve.solve_factorized_grouped_L_plain
        del D
        err, ms, _ = cs._sweep_check(f"{form} N={N} B={B}", kernel, plain,
                                     (F, C), b, b_admm)
        flops = B * (2 if form == "X" else 4) * K * 2 * n * n
        bound = cs._bound_ms(B * K * (2 * n * n + 2 * n) * 4, flops)[0]
        line = {"form": form, "N": N, "B": B, "K": K, "ms": ms,
                "stream_bound_ms": bound, "share": bound / ms,
                "max_abs_err": err, "card": card}
        if form == "L":
            line["nonzero_stream_bound_ms"] = cs._bound_ms(
                B * K * (n * (n + 1) + 2 * n) * 4, B * 4 * K * n * (n + 1))[0]
        if plan_fn is not None:
            line["plan"] = plan_fn(B, K, n)._asdict()
        print(json.dumps(line), flush=True)
        del F, b, b_admm


if __name__ == "__main__":
    main()
