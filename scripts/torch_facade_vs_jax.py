#!/usr/bin/env python3
"""The reference-compatible ``SCP`` class of the PyTorch port against the
JAX package's, on the CPU, at the full N=20, K=50 shape of the port's GPU
smoke run (one scenario of the port's generator, float32, both classes with
their default solver).

    JAX_PLATFORMS=cpu python3 scripts/torch_facade_vs_jax.py [--seed 7]

Prints each side's status, SCP and QP iteration counts, whether the final
trajectory is collision-free, the largest position difference between the
two and the JAX trajectory's smallest pairwise distance.  About a minute.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    import numpy as np
    import torch
    import jax
    jax.config.update("jax_platforms", "cpu")
    from ba_path_planning_tpu.solvers.scp import SCP as JaxSCP
    from ba_path_planning_torch.scenarios.generator import (
        generate_scenario_batch)
    from ba_path_planning_torch.solvers.scp import SCP

    N, T, h, R = 20, 10.0, 0.2, 0.8
    sc = generate_scenario_batch(args.seed, 1, n_vehicles=N, min_distance=R,
                                 dtype=torch.float64, device="cpu")
    pos = {}
    for name, cls, kw in (("torch", SCP, dict(device="cpu")),
                          ("jax", JaxSCP, {})):
        scp = cls(N, T, h, R, verbose=False, **kw)
        scp.set_initial_states(sc.initial[0].numpy())
        scp.set_final_states(sc.final[0].numpy())
        t0 = time.time()
        scp.generate_trajectories()
        r = scp.result
        print(f"{name}: status={int(r.status)} scp_iterations="
              f"{int(r.iterations)} qp_iterations={int(r.qp_iterations)} "
              f"collision_free={bool(r.feasible_final)} every_qp_converged="
              f"{bool(r.qp_converged_all)} ({time.time() - t0:.1f} s on the "
              f"CPU)", flush=True)
        pos[name] = np.asarray(scp.trajectories["positions"], np.float64)
    d = pos["jax"][:, None] - pos["jax"][None]
    dist = np.linalg.norm(d, axis=-1) + 1e9 * np.eye(N)[:, :, None]
    print(f"max position difference {np.abs(pos['torch'] - pos['jax']).max():.3e} m; "
          f"smallest pairwise distance of the JAX trajectory "
          f"{dist.min():.4f} m (R = {R}, feasibility bar R - 0.01)")


if __name__ == "__main__":
    main()
