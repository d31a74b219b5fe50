"""The rank processes of ``test_torch_parallel.py``: each joins a gloo
process group on the CPU, runs one job of the port's parallel axes on its
share and writes what it got to ``<out>/rank<r>.npz``.  No JAX here, so a
rank starts quickly; the tests hold the outputs to the JAX package.  The
module holds no tests of its own."""

import numpy as np
import torch
import torch.distributed as dist

F64 = torch.float64


class TableAngles:
    """Degenerate-pair angles from a table (B, iterations, K, P): the draws
    of lane ``l`` at SCP iteration ``it``."""

    def __init__(self, table):
        self.table = table

    def __call__(self, lane_ids, it):
        return torch.as_tensor(self.table[lane_ids.cpu().numpy(),
                                          it.cpu().numpy()], dtype=F64)


def _result(res) -> dict:
    return {f: getattr(res, f).numpy() for f in res._fields}


def _pairs(inp, problem, solver):
    from ba_path_planning_torch.parallel.pair_sharded import (
        PairShardedSCPSolver)
    ps = PairShardedSCPSolver(problem, solver, dtype=F64, device="cpu")
    return _result(ps.solve(*(inp[k] for k in ("p0", "v0", "pf", "vf"))))


def _horizon(inp, problem, solver):
    from ba_path_planning_torch.ops.collisions import make_pair_index
    from ba_path_planning_torch.parallel import horizon_sharded as hs
    a, p0, v0 = (torch.as_tensor(inp[k]) for k in ("a", "p0", "v0"))
    pos, vel = hs.rollout_ksharded(a, p0, v0, float(inp["h"]))
    out = {"pos": hs.gather_k(pos, -2).numpy(),
           "vel": hs.gather_k(vel, -2).numpy()}
    positions = torch.as_tensor(inp["positions"])
    pairs = make_pair_index(positions.shape[-3], dtype=F64)
    out["feasible"] = np.array([bool(hs.check_feasible_ksharded(
        positions, pairs, float(r))) for r in inp["radii"]])
    eta, d = hs.linearize_ksharded(positions, pairs,
                                   torch.as_tensor(inp["angle"]))
    out["eta"] = hs.gather_k(eta, -3).numpy()
    out["dist"] = hs.gather_k(d, -2).numpy()
    return out


def _scenarios(inp, problem, solver):
    from ba_path_planning_torch.parallel.mesh import ShardedSCPSolver
    angles = TableAngles(inp["angles"])
    args = [inp[k] for k in ("p0", "v0", "pf", "vf")]
    sh = ShardedSCPSolver(problem, solver, dtype=F64, device="cpu")
    out = {"solve_" + k: v for k, v in _result(
        sh.solve(*args, angle_fn=angles)).items()}
    out.update({"compacted_" + k: v for k, v in _result(sh.solve_compacted(
        *args, chunk=2, step_iters=2, angle_fn=angles)).items()})
    out["loop_rounds"] = np.array(sh.last_timing["loop_rounds"])
    return out


def _helpers(inp, problem, solver):
    from ba_path_planning_torch.parallel import distributed as pd
    rank = dist.get_rank()
    lo, hi = pd.host_local_slice(10)
    local = (torch.full((2, 3), float(rank)),
             torch.tensor([rank, 10 + rank]),
             torch.tensor([rank % 2 == 0, True]))
    glob = pd.make_global_batch(local)
    rep = pd.scaling_report(problem, solver, per_chip_batch=2, dtype=F64,
                            device="cpu")
    one, grp = rep["configs"]["1chip"], rep["configs"].get(
        f"{dist.get_world_size()}ranks", {})
    return {"slice": np.array([lo, hi]), "glob0": glob[0].numpy(),
            "glob1": glob[1].numpy(), "glob2": glob[2].numpy(),
            "n_processes": np.array(rep["n_processes"]),
            "n_devices_total": np.array(rep["n_devices_total"]),
            "one": np.array([one["batch"], one["solves_per_sec"],
                             one["scaling_efficiency"]]),
            "group": np.array([grp["batch"], grp["solves_per_sec"],
                               float(grp["shared_device"])])}


JOBS = {"pairs": _pairs, "horizon": _horizon, "scenarios": _scenarios,
        "helpers": _helpers}


def run(rank, world, port, job, inp, problem, solver, out_dir):
    """One rank: join the group, run ``job`` and write its outputs."""
    from ba_path_planning_torch.parallel.distributed import init_distributed
    torch.set_num_threads(1)
    init_distributed("gloo", f"tcp://127.0.0.1:{port}", world, rank,
                     timeout_s=60)
    try:
        out = JOBS[job](inp, problem, solver)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
