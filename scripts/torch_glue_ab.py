#!/usr/bin/env python3
"""The host-bound paths of the PyTorch/CUDA port in two checkouts, in
turns, on one GPU: what running the ADMM iteration in hand-written kernels
(``ops/admm_steps.py``) changes end to end.

    python3 scripts/torch_glue_ab.py --roots <parent> <change> \
        [--turns 0,1,1,0]
        [--parts production,latency,bench,facade,facade_bf16,
                 facade_bf16_all,phase1,fused_paths]
        [--out build/glue_ab.json]

For each turn, in the checkout it names (every measurement a process of
its own, started in that checkout, so each runs the code it finds there):

* ``scripts/torch_profile_lform.py --route production -N 20``: the N=20,
  B=1024 production solve (chunk 512), three untraced walls and one traced
  solve: device launches, device busy time, idle share under tracing;
* ``--route latency -N 20``: the bench twin's single latency solve, the
  same numbers;
* ``python -m ba_path_planning_torch.bench``: the bench twin (N=20,
  B=4096, chunk 512): its rate, p50 single-scenario latency and the slope
  of sequential solves;
* this script's ``--facade ROUTE`` for ``grouped_L`` and ``resident``: the
  reference-compatible path as ``chip_smoke.py`` runs it
  (``SCPEngine.solve_batch`` of 64 N=20 scenarios, three times in one
  process): the first and a warm solve's wall, a traced solve's device
  time in the sweep kernels and in all kernels, statuses, mean and max QP
  iterations;
* ``--facade ROUTE --bf16`` for ``grouped_L`` (part ``facade_bf16``),
  ``resident`` and ``fused_L`` (part ``facade_bf16_all``): the same on
  bf16 factors with the SCP loop cut to ``chip_smoke.BF16_FACADE_SCP``, as
  ``chip_smoke.py``'s bf16 paths run it (its QPs do not converge on bf16
  factors, so every lane runs the whole ADMM budget of each SCP
  iteration); the fused route's kernel time is ``fused_device_s``;
* this script's ``--round-record``: the round record's N=10 and N=20
  configurations (B=1024, chunk 512) as ``scripts/torch_soak_nsweep.py``
  runs them (``run_cfg``: a warm-up solve, then one timed solve): the
  wall, phase 1's seconds and the loop's (``last_timing``), collision-free
  lanes and mean SCP iterations;
* this script's ``--fused-paths`` (part ``fused_paths``, not in the
  default parts): the production paths on the fused X route as
  ``run_cfg`` runs them, N=30 and N=40 at B=2048, chunk 128, and N=30 at
  B=256, chunk 128, with adaptive rho and polish (``chip_smoke.py``'s
  adaptive path's solver), each timed FUSED_PATH_RUNS times after a
  warm-up: walls, the loop's dispatches, the kernel launches.

``--parts`` picks the measurements (the default list above but
``fused_paths``).  Prints one line a
measurement and writes every record to ``--out``.
"""

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path


def facade(route, root, bf16=False):
    """The reference-compatible solve on ``route`` with the code of the
    checkout ``root`` (``bf16``: on bf16 factors, the SCP loop cut as
    ``chip_smoke.py`` cuts it), three times in one process: the first
    solve's wall (``wall_s``, the process's first use of every kernel and
    library included), the second's (``warm_wall_s``), and the third under
    ``torch.profiler``: the device time of its sweep kernels
    (``sweep_device_s``) and of all its kernels (``busy_s``); prints one
    JSON line."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import chip_smoke
    from ba_path_planning_torch.scenarios.generator import (
        generate_scenario_batch)
    from ba_path_planning_torch.solvers.scp import SCPEngine
    change = chip_smoke.FACADE_ROUTES[route][0]
    problem = chip_smoke._problem(20, facade=True)
    if bf16:
        change = dict(change, factor_dtype="bf16")
        problem = problem.replace(
            max_iterations=chip_smoke.BF16_FACADE_SCP)
    eng = SCPEngine(problem, chip_smoke._facade_solver(**change),
                    dtype=torch.float32)
    sc = generate_scenario_batch(100, chip_smoke.FACADE_B, n_vehicles=20,
                                 min_distance=chip_smoke.R,
                                 dtype=torch.float32)
    v0 = torch.zeros_like(sc.initial)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.solve_batch(sc.initial, v0, sc.final, v0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.solve_batch(sc.initial, v0, sc.final, v0)
        torch.cuda.synchronize()
    device = [(e.key, getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0)))
              for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    print(json.dumps({
        "route": route, "factors": "bf16" if bf16 else "f32",
        "wall_s": walls[0], "warm_wall_s": walls[1],
        "sweep_device_s": sum(us for key, us in device
                              if "sweep_kernel" in key) / 1e6,
        "fused_device_s": sum(us for key, us in device
                              if "admm_fused_l_kernel" in key) / 1e6,
        "busy_s": sum(us for _, us in device) / 1e6,
        "statuses": np.bincount(out.status.cpu().numpy(),
                                minlength=3).tolist(),
        "mean_scp_iters": float(out.iterations.float().mean()),
        "mean_qp_iters": float(out.qp_iterations.float().mean()),
        "max_qp_iters": int(out.qp_iterations.max())}))


def round_record(root):
    """The round record's N=10 and N=20 configurations with the code of the
    checkout ``root``; prints one JSON line each."""
    sys.path.insert(0, root)
    sys.path.insert(0, str(Path(root) / "scripts"))
    import torch_soak_nsweep
    for n_veh in (10, 20):
        rec = torch_soak_nsweep.run_cfg(n_veh, 1024, 512)
        print(json.dumps({k: rec[k] for k in (
            "N", "batch", "chunk", "wall_s", "timing", "collision_free",
            "mean_scp_iters", "mean_qp_iters")}), flush=True)


# timed solves of each configuration of ``--fused-paths``
FUSED_PATH_RUNS = 3


def fused_paths(root):
    """The production paths on the fused X route with the code of the
    checkout ``root``; prints one JSON line each."""
    sys.path.insert(0, root)
    sys.path.insert(0, str(Path(root) / "scripts"))
    import torch_soak_nsweep as tsn
    from ba_path_planning_torch.utils.config import (ProblemConfig,
                                                     SolverConfig)
    problem = ProblemConfig(n_vehicles=30, time_horizon=tsn.T_HORIZON,
                            time_step=tsn.H, min_distance=tsn.R,
                            max_iterations=tsn.MAX_SCP, stop_mode="feasible")
    adaptive = SolverConfig.production(problem=problem).replace(
        adaptive_rho=True, polish=True, max_iter=100)
    for n_veh, B, solver, label in ((30, 2048, None, "production"),
                                    (40, 2048, None, "production"),
                                    (30, 256, adaptive, "adaptive")):
        recs = [tsn.run_cfg(n_veh, B, 128, solver=solver, warmup=not i)
                for i in range(FUSED_PATH_RUNS)]
        print(json.dumps({
            "N": n_veh, "batch": B, "chunk": 128, "solver": label,
            "walls_s": [r["wall_s"] for r in recs],
            "loop_dispatches": recs[0]["timing"]["loop_dispatches"],
            "loop_lanes_dispatched":
                recs[0]["timing"]["loop_lanes_dispatched"],
            "collision_free": recs[0]["collision_free"],
            "mean_scp_iters": recs[0]["mean_scp_iters"],
            "launches": recs[0]["launches"]}), flush=True)


def _run(root, argv, timeout=1200):
    proc = subprocess.run(argv, cwd=root, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{argv} in {root} exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout, proc.stderr


def _profile(root, route):
    out, _ = _run(root, [sys.executable, "scripts/torch_profile_lform.py",
                         "--route", route, "-N", "20", "--top", "8"])
    m = re.search(r"untraced walls \(s\): \[([^\]]*)\]; traced wall "
                  r"([\d.]+) s; device busy ([\d.]+) s; idle share under "
                  r"tracing ([\d.]+); device launches (\d+)", out)
    walls = [float(w) for w in m.group(1).split(",")]
    return dict(walls_s=walls, traced_wall_s=float(m.group(2)),
                busy_s=float(m.group(3)), idle_share=float(m.group(4)),
                device_launches=int(m.group(5)), text=out)


def _bench(root):
    out, err = _run(root, [sys.executable, "-m", "ba_path_planning_torch.bench"])
    line = json.loads(out.strip().splitlines()[-1])
    summary = err.strip().splitlines()[-1]
    num = {k: float(v) for k, v in re.findall(
        r"(wall|p50_single_scenario_latency_ms|p50_ondevice_solve_ms|"
        r"mean_scp_iters)=([\d.]+)", summary)}
    ok = re.search(r" ok=(\d+)/(\d+)", summary)
    return dict(solves_per_s=line["value"], ok=int(ok.group(1)),
                batch=int(ok.group(2)), **num, summary=summary)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", nargs="+")
    ap.add_argument("--turns", default="0,1,1,0")
    ap.add_argument("--parts", default="production,latency,bench,facade,"
                    "facade_bf16,phase1")
    ap.add_argument("--out", default="build/glue_ab.json")
    ap.add_argument("--facade", help=argparse.SUPPRESS)
    ap.add_argument("--bf16", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--round-record", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--fused-paths", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.facade:
        return facade(args.facade, args.roots[0], args.bf16)
    if args.round_record:
        return round_record(args.roots[0])
    if args.fused_paths:
        return fused_paths(args.roots[0])
    parts = set(args.parts.split(","))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    here = Path(__file__).resolve()
    records = []
    for turn in (int(t) for t in args.turns.split(",")):
        root = str(Path(args.roots[turn]).resolve())
        rec = dict(turn=turn, root=root, card=card)
        for route in ("production", "latency"):
            if route not in parts:
                continue
            rec[route] = _profile(root, route)
            r = rec[route]
            print(f"[{turn}] {route}: walls {r['walls_s']} s, traced "
                  f"{r['traced_wall_s']} s, busy {r['busy_s']} s, idle "
                  f"{r['idle_share']}, device launches "
                  f"{r['device_launches']}", flush=True)
        if "bench" in parts:
            rec["bench"] = _bench(root)
            print(f"[{turn}] bench twin: {rec['bench']['summary']} "
                  f"solves/s={rec['bench']['solves_per_s']}", flush=True)
        for route, part in (("grouped_L", "facade"), ("resident", "facade"),
                            ("grouped_L", "facade_bf16"),
                            ("resident", "facade_bf16_all"),
                            ("fused_L", "facade_bf16_all")):
            if part not in parts and not (part == "facade_bf16"
                                          and "facade_bf16_all" in parts):
                continue
            bf16 = part.startswith("facade_bf16")
            out, _ = _run(root, [sys.executable, str(here), "--facade",
                                 route, "--roots", root]
                          + (["--bf16"] if bf16 else []))
            key = route + ("_bf16" if bf16 else "")
            rec[key] = json.loads(out.strip().splitlines()[-1])
            print(f"[{turn}] reference-compatible {key}: "
                  f"{json.dumps(rec[key])}", flush=True)
        if "phase1" in parts:
            out, _ = _run(root, [sys.executable, str(here), "--round-record",
                                 "--roots", root])
            rec["round_record"] = [json.loads(ln) for ln in
                                   out.strip().splitlines()
                                   if ln.startswith("{")]
            for r in rec["round_record"]:
                print(f"[{turn}] round record N={r['N']} B={r['batch']}: "
                      f"wall {r['wall_s']:.4f} s, phase 1 "
                      f"{r['timing']['phase1_s']:.4f} s, loop "
                      f"{r['timing']['loop_s']:.4f} s, collision-free "
                      f"{r['collision_free']}, mean SCP "
                      f"{r['mean_scp_iters']:.4f}", flush=True)
        if "fused_paths" in parts:
            out, _ = _run(root, [sys.executable, str(here), "--fused-paths",
                                 "--roots", root])
            rec["fused_paths"] = [json.loads(ln) for ln in
                                  out.strip().splitlines()
                                  if ln.startswith("{")]
            for r in rec["fused_paths"]:
                print(f"[{turn}] fused-route path {r['solver']} N={r['N']} "
                      f"B={r['batch']}: walls {r['walls_s']} s, dispatches "
                      f"{r['loop_dispatches']} ({r['loop_lanes_dispatched']} "
                      f"lanes), collision-free {r['collision_free']}, "
                      f"launches {r['launches']}", flush=True)
        records.append(rec)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(card=card, records=records),
                                         indent=1))
    print(f"card: {card}; records in {args.out}")


if __name__ == "__main__":
    main()
