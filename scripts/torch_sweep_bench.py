#!/usr/bin/env python3
"""Time the sweep kernels and the X-form fused interval of the PyTorch port
on one GPU.

    python3 scripts/torch_sweep_bench.py [--cases X:20:512,...] [--root DIR]
                                         [--time-only]

Each case (form, N, B; K=50) is built and checked as ``chip_smoke.py``
builds and checks it: the X-form sweep (form X) on the NS factors of
production blocks, the L-only sweep (L) and the dense (Linv, Eb) sweep (D)
on the block Cholesky factors of the reference-compatible solver, through
``chip_smoke._sweep_check`` (the kernel against its plain version,
CUDA-event times of both, the check at the ADMM loop's scale); the X-form
fused ADMM interval (F, 25 iterations) and the L-form one (FL, on the
factors of the reference-compatible solver) through
``chip_smoke.fused_check``.
Each case prints one JSON line: the launch plan, the kernel's ms, its
stream bound (every block read in both sweeps, ``chip_smoke._bound_ms``)
and its share of it, and the bound that counts only what the sweeps need
of each block (Linv's lower triangle; X's upper one).  The first line
names the card and its power limit.

The package and ``chip_smoke.py`` are imported from the checkout the script
lies in, or from the one given by ``--root``; to compare two versions on
the same card, run the script for each checkout in turns in one call.
``--time-only`` times the fused interval (F) from the same warm start
without checking it, for diagnostic builds whose results are not meant to
be right (say, with the factor copies or the products switched off).
"""

import argparse
import json
import sys
from pathlib import Path

CASES = ("X:20:512,X:20:128,X:20:64,X:20:1,L:20:512,L:20:64,L:20:1,"
         "L:30:128,L:40:128,D:20:512,D:20:64,D:20:1,F:30:128,F:40:128,"
         "FL:20:128,FL:20:64")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default=CASES)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--time-only", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_sweep_bench.py: no CUDA device")
    import inspect
    import chip_smoke as cs
    from ba_path_planning_torch.ops import (admm_fused, banded_solve,
                                            group_solve, ns_chain)
    from ba_path_planning_torch.solvers import banded
    card = cs._card_line()
    print(f"card: {card}; root {args.root}", flush=True)
    dev, K = torch.device("cuda", 0), cs.K_STEPS
    plan_fn = getattr(group_solve, "sweep_plan", None)
    for case in args.cases.split(","):
        form, N, B = case.split(":")
        N, B = int(N), int(B)
        n = 6 * N
        if form == "F":
            D, C, _, _, kw = cs._case(N, B, dev, seed=N)
            kw["X"] = ns_chain.factorize_X_chain_plain(D, C, ns_iters=2)
            del D
            if args.time_only:
                x = kw.pop("x")
                z = banded.tree_map(torch.clamp, banded.apply_A(
                    x, kw["eta"], kw["E"], cs.H), kw["lower"], kw["upper"])
                y = banded.tree_map(torch.zeros_like, z)
                ms = cs._time_ms(lambda: admm_fused.admm_interval_fused_X(
                    **kw, x=x, z=z, y=y, n_iters=25))
                print(json.dumps({"form": form, "N": N, "B": B, "K": K,
                                  "iterations": 25, "ms": ms,
                                  "checked": False, "card": card}),
                      flush=True)
                del kw, x, z, y
                continue
            stats = cs.fused_check(
                f"F N={N} B={B}", admm_fused.admm_interval_fused_X,
                admm_fused.admm_interval_fused_X_plain, kw, N, K * n * n,
                needed_floats=K * n * (n + 1) // 2)
            print(json.dumps({"form": form, "N": N, "B": B, "K": K,
                              "iterations": 25, "ms": stats["ms"],
                              "stream_bound_ms": stats["stream_bound_ms"],
                              "share": stats["stream_bound_ms"] / stats["ms"],
                              "nonzero_stream_bound_ms":
                                  stats["nonzero_stream_bound_ms"],
                              "max_abs_err": stats["max_abs_err"],
                              "card": card}), flush=True)
            del kw
            continue
        if form == "FL":
            D, C, _, _, kw = cs._case(N, B, dev, seed=1000 + N + B,
                                      solver=cs._facade_solver())
            Linv, Eb = banded.factorize(D, banded.slot_dense(C, 2 * N))
            del D, kw["C"]
            kw.update(Linv=Linv, Eb=Eb)
            stats = cs.fused_check(
                f"FL N={N} B={B}", admm_fused.admm_interval_fused,
                admm_fused.admm_interval_fused_plain, kw, N,
                (2 * K - 1) * n * n)
            print(json.dumps({"form": form, "N": N, "B": B, "K": K,
                              "iterations": 25, "ms": stats["ms"],
                              "stream_bound_ms": stats["stream_bound_ms"],
                              "share": stats["stream_bound_ms"] / stats["ms"],
                              "max_abs_err": stats["max_abs_err"],
                              "card": card}), flush=True)
            del kw, Linv, Eb
            continue
        if form == "X":
            D, C, b, b_admm, _ = cs._case(N, B, dev, seed=B)
            factors = (ns_chain.factorize_X_chain_plain(D, C, ns_iters=2), C)
            kernel = group_solve.solve_factorized_grouped_X
            plain = group_solve.solve_factorized_grouped_X_plain
        else:
            D, C, b, b_admm, _ = cs._case(N, B, dev, seed=1000 + N + B,
                                          solver=cs._facade_solver())
            Linv, Eb = banded.factorize(D, banded.slot_dense(C, 2 * N))
            if form == "L":
                factors = (Linv, C)
                kernel = group_solve.solve_factorized_grouped_L
                plain = group_solve.solve_factorized_grouped_L_plain
            else:
                factors = (Linv, Eb)
                kernel = banded_solve.solve_factorized_dense
                plain = banded_solve.solve_factorized_dense_plain
        del D
        err, ms, _ = cs._sweep_check(f"{form} N={N} B={B}", kernel, plain,
                                     factors, b, b_admm)
        # blocks streamed: 2K of X_k or Linv_k (X, L), 4K - 2 (D)
        blocks = 4 * K - 2 if form == "D" else 2 * K
        flops = B * (4 if form == "L" else 2) * blocks // 2 * 2 * n * n
        bound = cs._bound_ms(B * (blocks * n * n + 2 * K * n) * 4, flops)[0]
        line = {"form": form, "N": N, "B": B, "K": K, "ms": ms,
                "stream_bound_ms": bound, "share": bound / ms,
                "max_abs_err": err, "card": card}
        if form in ("L", "D"):
            # Linv's lower triangle only
            tri = K * n * (n + 1) // 2
            need = 2 * tri + (2 * (K - 1) * n * n if form == "D" else 0)
            line["nonzero_stream_bound_ms"] = cs._bound_ms(
                B * (need + 2 * K * n) * 4, flops * need // (blocks * n * n))[0]
        if plan_fn is not None:
            pform = {"X": "X", "L": "L", "D": "dense"}[form]
            if "form" in inspect.signature(plan_fn).parameters:
                line["plan"] = plan_fn(B, K, n, pform)._asdict()
            elif form != "D":
                line["plan"] = plan_fn(B, K, n)._asdict()
        print(json.dumps(line), flush=True)
        del factors, b, b_admm


if __name__ == "__main__":
    main()
