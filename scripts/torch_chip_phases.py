#!/usr/bin/env python3
"""Run chosen phases of ``chip_smoke.py`` on one GPU, to time them apart:

    python3 scripts/torch_chip_phases.py [lane] [adaptive] [parity] [cg]

``lane``: both fused ADMM intervals with one rho a lane, against their
plain versions; ``adaptive``: the adaptive-rho paths (N=20 and N=30
production with adaptive rho and polish, and the reference-compatible
solver with adaptive rho on its fused L route); ``parity``: the certified
oracle trajectories in float64; ``cg``: ``SCPEngine(problem)`` with the
default ``SolverConfig()``.  Prints each phase's lines and its seconds.
"""

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from ba_path_planning_torch.ops import (admm_fused, banded_solve,  # noqa: E402
                                        cuda_build, group_solve, ns_chain)


def main(which):
    if not torch.cuda.is_available():
        raise SystemExit("torch_chip_phases.py: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs._card_line()
    print(card, flush=True)
    cuda_build.load_kernels()
    counters = {"ns_chain": ns_chain.factorize_X_chain_batched,
                "group_solve_x": group_solve.solve_factorized_grouped_X,
                "admm_fused_x": admm_fused.admm_interval_fused_X,
                "admm_fused_x_wide": admm_fused.admm_interval_fused_X.wide,
                "group_solve_l": group_solve.solve_factorized_grouped_L,
                "banded_solve": banded_solve.solve_factorized_dense,
                "admm_fused_l": admm_fused.admm_interval_fused}
    phases = {
        "lane": lambda: cs.lane_rho_phase(dev),
        "adaptive": lambda: [cs.adaptive_path(dev, card, *path, counters)
                             for path in cs.ADAPTIVE_PATHS]
        + [cs.facade_path(dev, card, "fused_L", counters, adaptive=True)],
        "parity": lambda: cs.parity_phase(counters),
        "cg": lambda: cs.cg_phase(dev, counters),
    }
    for name in which or list(phases):
        t0 = time.perf_counter()
        phases[name]()
        print(f"[{name}: {time.perf_counter() - t0:.1f} s]", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
