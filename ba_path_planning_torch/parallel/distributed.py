"""Multi-process execution (counterpart of
``ba_path_planning_tpu.parallel.distributed``): one process a device over
``torch.distributed``, the caller naming the backend, plus the
scaling-efficiency report.

The batched SCP workload is scenario-parallel with no steady-state
communication, so scaling is data parallelism: each rank feeds and solves
its slice of the global batch (:func:`host_local_slice`) and the solvers
gather the result (``parallel/mesh.py``).  NCCL serves one card a rank;
gloo serves CPU tensors and, where several ranks share one card (NCCL
refuses two ranks on one device), CUDA tensors.  Nothing picks a backend
on its own.

    python -m ba_path_planning_torch.parallel.distributed --backend nccl \\
        --init-method tcp://localhost:29500 --world-size 4 --rank R
"""

from __future__ import annotations

import argparse
import json
import time
from datetime import timedelta

import torch
import torch.distributed as dist

from ..scenarios import generate_scenario_batch
from ..utils.config import ProblemConfig, SolverConfig, resolve_device
from ..utils.dist import all_reduce, gather_rows
from .mesh import Mesh, ShardedSCPSolver, make_mesh


def init_distributed(backend: str, init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     timeout_s: float = 120.0) -> None:
    """Join the process group (a no-op for one process): ``backend``
    ("nccl", or "gloo" for CPU tensors and for ranks that share a card),
    the rendezvous address ``init_method`` (``tcp://host:port``), the world
    size and this process's rank, and the rendezvous and collective
    timeout in seconds."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    if (world_size is None or world_size <= 1) and init_method is None:
        return
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))


def host_local_slice(total_batch: int,
                     mesh: Mesh | None = None) -> tuple[int, int]:
    """[lo, hi) of the global scenario batch owned by this rank."""
    mesh = mesh if mesh is not None else make_mesh()
    per = total_batch // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def make_global_batch(host_arrays, mesh: Mesh | None = None):
    """The global (B_local * size, ...) tensors, on every rank, from each
    rank's (B_local, ...) tensors (a tuple of them, or one), in rank
    order."""
    mesh = mesh if mesh is not None else make_mesh()

    def build(t):
        return gather_rows(torch.as_tensor(t), mesh.rank, mesh.size,
                           mesh.collective_group)
    if isinstance(host_arrays, (tuple, list)):
        return type(host_arrays)(build(t) for t in host_arrays)
    return build(host_arrays)


def _run(solver: ShardedSCPSolver, problem: ProblemConfig, B: int, seed: int,
         dtype, device) -> dict:
    """One timed solve of B fresh scenarios (after a warm-up on others)."""
    def run(s):
        sc = generate_scenario_batch(s, B, n_vehicles=problem.n_vehicles,
                                     min_distance=problem.min_distance,
                                     dtype=dtype, device=device)
        v0 = torch.zeros_like(sc.initial)
        res = solver.solve(sc.initial, v0, sc.final, v0)
        return int(res.feasible_final.sum())
    run(seed)                                # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    ok = run(seed + 100)                     # fresh scenarios
    dt = time.perf_counter() - t0
    return {"batch": B, "wall_sec": dt, "solves_per_sec": B / dt,
            "collision_free_per_sec": ok / dt, "collision_free_frac": ok / B}


def scaling_report(problem: ProblemConfig,
                   solver: SolverConfig | None = None,
                   per_chip_batch: int = 128, seed: int = 0,
                   dtype=torch.float32, device=None) -> dict:
    """Solves/s of one rank alone ("1chip": rank 0 solves ``per_chip_batch``
    scenarios while the others wait) and, in a process group of several
    ranks, of all of them on ``per_chip_batch`` scenarios each
    (f"{size}ranks").  Ranks that share one card are reported as such
    (``shared_device``): on one card the report is the one-device
    configuration plus the ranks that share it.  Every rank calls it and
    gets the same record."""
    device = resolve_device(device)
    mesh = make_mesh()
    group = mesh.collective_group
    f64 = dict(dtype=torch.float64, device=device)   # the collectives' data
    dev_id = float(device.index or 0) if device.type == "cuda" else -1.0
    devs = gather_rows(torch.tensor([dev_id], **f64), mesh.rank, mesh.size,
                       group)
    out = {"n_processes": mesh.size,
           "n_devices_total": len(set(devs.tolist())),
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "per_chip_batch": per_chip_batch, "configs": {}}
    keys = ("batch", "wall_sec", "solves_per_sec", "collision_free_per_sec",
            "collision_free_frac")
    one = torch.zeros(len(keys), **f64)
    if mesh.rank == 0:
        solo = ShardedSCPSolver(problem, solver, dtype=dtype, device=device,
                                mesh=Mesh(None, 0, 1))
        rec = _run(solo, problem, per_chip_batch, seed, dtype, device)
        one = torch.tensor([rec[k] for k in keys], **f64)
    # rank 0's record on every rank (the other ranks add zeros)
    out["configs"]["1chip"] = dict(
        zip(keys, all_reduce(one, "sum", group).tolist()), devices=1)
    out["configs"]["1chip"]["batch"] = per_chip_batch
    if mesh.size > 1:
        sh = ShardedSCPSolver(problem, solver, dtype=dtype, device=device,
                              mesh=mesh)
        rec = _run(sh, problem, per_chip_batch * mesh.size, seed, dtype,
                   device)
        # the slowest rank's wall sets the group's rate
        wall = float(all_reduce(torch.tensor([rec["wall_sec"]], **f64),
                                "max", group)[0])
        B = per_chip_batch * mesh.size
        ok_frac = rec["collision_free_frac"]
        out["configs"][f"{mesh.size}ranks"] = {
            "devices": mesh.size, "batch": B, "wall_sec": wall,
            "solves_per_sec": B / wall,
            "collision_free_per_sec": ok_frac * B / wall,
            "collision_free_frac": ok_frac,
            "shared_device": out["n_devices_total"] < mesh.size}
    base = out["configs"]["1chip"]["solves_per_sec"]
    for rec in out["configs"].values():
        ideal = base * rec["devices"]
        rec["scaling_efficiency"] = rec["solves_per_sec"] / ideal
        rec["throughput_retention"] = rec["solves_per_sec"] / base
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--backend", required=True, choices=("nccl", "gloo"))
    p.add_argument("--init-method", default=None,
                   help="rendezvous, tcp://host:port")
    p.add_argument("--world-size", type=int, default=1)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="this rank's device (default: cuda:<rank>)")
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument("--n-vehicles", type=int, default=20)
    p.add_argument("--time-horizon", type=float, default=10.0)
    p.add_argument("--time-step", type=float, default=0.2)
    p.add_argument("--min-distance", type=float, default=0.8)
    p.add_argument("--per-chip-batch", type=int, default=128)
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)
    init_distributed(args.backend, args.init_method, args.world_size,
                     args.rank, args.timeout)
    problem = ProblemConfig(n_vehicles=args.n_vehicles,
                            time_horizon=args.time_horizon,
                            time_step=args.time_step,
                            min_distance=args.min_distance)
    device = args.device or f"cuda:{args.rank}"
    rec = scaling_report(problem, per_chip_batch=args.per_chip_batch,
                         device=device)
    if args.rank == 0:
        text = json.dumps(rec, indent=2)
        print(text)
        if args.out:
            from pathlib import Path
            Path(args.out).write_text(text)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
