"""Readings of the comparison that decides ``correct``, for setting its
limits: the program's and the lower-precision control's, on the seeds
given, at the cell's own size.

    python3 -m port_bench.control --workload <name> --seeds 1,2,3 \
        [--program-only] [--witness] [--out <file.json>]

For each seed it draws the cell's pool as a run does, solves every pool
batch once with the program (one call each, as the loop makes them), draws
the sample a run would draw from those answers, and solves the sampled
scenarios with the reference in float64.  The program's readings compare
its answers with that solve.  The control is the reference put in the
program's place in the nearest precision below the configuration's
(float32 with every matrix product on TF32 operands); its readings compare
its answers for the same scenarios with the same float64 solve; the share
of answers that are not ok is of every pool batch's answers for the
program, and of the sample for the control.  The benchmark's own runs never
run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import registry, run
from .reference import judge, scp

CONTROL = scp.Numerics(torch.float32, tf32=True)
# the reference in the configuration's own precision: a second witness of
# how far float32 arithmetic alone moves the answers from float64
WITNESS = scp.Numerics(torch.float32, tf32=False)


def readings_for_seed(cell: registry.Cell, solver, seed: int, device,
                      others=(("control", CONTROL),)) -> dict:
    """{"program": readings, "<other>": readings, ..., "per_answer": ...}
    for one seed: the program's and those of the reference in each of the
    arithmetics ``others`` ((name, Numerics) pairs) in its place;
    ``solver`` is the program's, built once."""
    config, traffic = cell.config, cell.traffic
    spec = scp.from_config(config)
    dtype = getattr(torch, config["dtype"])
    pool = run.draw_pool(config, traffic, seed)
    inputs = [(p0.to(device, dtype), pf.to(device, dtype))
              for p0, pf in pool]
    t0 = time.perf_counter()
    calls = [run._call(solver, inputs, b, traffic["chunk"])
             for b in range(len(pool))]
    t_prog = time.perf_counter() - t0
    t0 = time.perf_counter()
    values, prog, keys, ref = run.compare(spec, config, pool, calls, seed,
                                          traffic["check_sample"], device)
    n_ans = sum(c.iterations.numel() for c in calls)
    values["not_ok_pct"] = 100.0 * (
        1 - run.count_ok(spec, pool, calls, device) / n_ans)
    p0 = torch.stack([pool[b][0][lane] for b, lane in keys])
    pf = torch.stack([pool[b][1][lane] for b, lane in keys])
    out = {"seed": seed, "sample": len(keys), "program_s": t_prog,
           "reference_s": time.perf_counter() - t0, "program": values}
    per = {"ref_iterations": ref.iterations.tolist(),
           "ref_status": ref.status.tolist(),
           "program_gap_m": judge.gaps(prog["positions"],
                                       ref.positions).tolist(),
           "program_iterations": prog["iterations"].tolist(),
           "program_status": prog["status"].tolist()}
    out["per_answer"] = per
    for name, num in others:
        t0 = time.perf_counter()
        alt = run.solve_reference(spec, config, pool, keys, device, num)
        out[f"{name}_s"] = time.perf_counter() - t0
        out[name] = judge.readings(
            {"positions": alt.positions, "iterations": alt.iterations,
             "status": alt.status}, ref)
        ok = judge.ok(alt.accelerations.to(device), p0, pf, spec)
        out[name]["not_ok_pct"] = 100.0 * float((~ok).double().mean())
        per[f"{name}_gap_m"] = judge.gaps(alt.positions,
                                          ref.positions).tolist()
        per[f"{name}_iterations"] = alt.iterations.tolist()
        per[f"{name}_status"] = alt.status.tolist()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program-only", action="store_true")
    ap.add_argument("--witness", action="store_true",
                    help="also the reference in float32 with exact products")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_bench.control: needs a CUDA device", file=sys.stderr)
        return 3
    cell = registry.cell(args.workload)
    solver = run.build_solver(cell.config, "cuda:0")
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        others = () if args.program_only else (("control", CONTROL),)
        if args.witness:
            others += (("witness", WITNESS),)
        r = readings_for_seed(cell, solver, seed, "cuda:0", others)
        rows.append(r)
        print(json.dumps({k: v for k, v in r.items() if k != "per_answer"}),
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
