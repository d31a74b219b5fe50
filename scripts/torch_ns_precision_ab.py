#!/usr/bin/env python3
"""The production main path at each ``ns_precision`` of the solver, in turns
within one process on one GPU: ``"high"`` (what ``SolverConfig.production()``
sets; the NS chain on the tensor cores as three TF32 passes), ``"highest"``
(FP32 products) and ``"default"`` (served by the three-pass kernel,
``banded.NS_KERNEL_PRECISION``):

    python3 scripts/torch_ns_precision_ab.py [--f64] [--factors] [--lanes]
                                             [N ...]      (default N: 30 40)

For each N it runs ``chip_smoke.main_path`` (2048 scenarios in chunks of
128; 1024 in chunks of 512 at N <= 21) in the TURNS high, highest, default,
default, highest, high and prints that function's line for each (wall,
lanes ok, mean SCP and QP iterations, launches), then the counts of each
precision side by side.  A run below the path's own 99% bar is reported
and the script exits 1 after the last run.
``--f64`` adds the same scenarios solved in float64 by the plain PyTorch
versions (no kernel takes float64), for the iteration counts that neither
rounding of float32 moves.  ``--factors`` first prints, for 32 scenarios
of ``chip_smoke._case``, how far a solve M x = b with each chain's factors
(float64 chain, plain float32, kernel at "highest" and at "high") is from
the solve with exact factors, for a right-hand side at the ADMM loop's
scale.  ``--lanes`` first walks the same scenarios through both chains
in step, one SCP iteration of every unfinished lane at a time, and prints
the lanes whose iteration counts differ with their feasibility margin (see
:func:`lane_margins`; with ``--f64`` the float64 plain versions walk along).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


# the precisions in turns, each solving the same scenarios
TURNS = ("high", "highest", "default", "default", "highest", "high")


def f64_counts(dev, n_veh, B, chunk):
    """Lanes ok and mean SCP and QP iterations of the path in float64."""
    import torch
    import chip_smoke as cs
    from ba_path_planning_torch.parallel.mesh import ShardedSCPSolver
    from ba_path_planning_torch.scenarios.generator import (
        generate_scenario_batch)
    from ba_path_planning_torch.utils.config import SolverConfig
    problem = cs._problem(n_veh)
    solver = SolverConfig.production(kernels=False, problem=problem)
    sh = ShardedSCPSolver(problem, solver, dtype=torch.float64, device=dev)
    sc = generate_scenario_batch(100, B, n_vehicles=n_veh, min_distance=cs.R,
                                 dtype=torch.float32, device=dev)
    p0, pf = sc.initial.double(), sc.final.double()
    v0 = torch.zeros_like(p0)
    out = sh.solve_compacted(p0, v0, pf, v0, chunk=chunk)
    torch.cuda.synchronize()
    print(f"float64, plain versions: N={n_veh} B={B} "
          f"feasible={int(out.feasible_final.sum())}/{B} "
          f"mean_scp_iters={float(out.iterations.float().mean()):.3f} "
          f"mean_qp_iters={float(out.qp_iterations.float().mean()):.2f}",
          flush=True)


def factor_quality(dev, n_veh):
    """Relative error (Frobenius, and the worst (b, k) block) of
    ``solve_factorized_X`` in float64 with each chain's X against the exact
    inverse chain (``ns_iters=0`` in float64)."""
    import chip_smoke as cs
    from ba_path_planning_torch.ops import ns_chain
    from ba_path_planning_torch.solvers import banded
    D, C, _, b_admm, _ = cs._case(n_veh, 32, dev, seed=n_veh)
    D64, C64, rhs = D.double(), C.double(), b_admm.double()
    want = banded.solve_factorized_X(
        banded.factorize_X(D64, C64, ns_iters=0), C64, rhs)
    chains = {
        "float64 chain": banded.factorize_X(D64, C64, ns_iters=2),
        "plain float32": ns_chain.factorize_X_chain_plain(D, C, ns_iters=2),
        "kernel highest": ns_chain.factorize_X_chain_batched(
            D, C, ns_iters=2, ns_precision="highest"),
        "kernel high": ns_chain.factorize_X_chain_batched(
            D, C, ns_iters=2, ns_precision="high")}
    parts = []
    for name, X in chains.items():
        got = banded.solve_factorized_X(X.double(), C64, rhs)
        parts.append(f"{name} {float((got - want).norm() / want.norm()):.3e}"
                     f" (block {cs._block_rel(got, want, 1):.3e})")
    print(f"N={n_veh}: solve at the ADMM scale against exact factors: "
          + "; ".join(parts), flush=True)


def lane_margins(dev, n_veh, B, chunk, with_f64):
    """Which lanes take another number of SCP iterations under "high" than
    under "highest" (and, ``with_f64``, than the plain versions in
    float64), and how close to the stopping rule they are.

    All engines start from the same float32 phase 1 (it runs no chain) and
    step the same chunks of lanes one SCP iteration at a time.  After each
    iteration the stopping rule of ``stop_mode="feasible"`` looks at the
    goal-projected rollout: the lane stops when its smallest pair distance
    is at least R - FEAS_SLACK.  The margin printed is that distance minus
    that threshold, in metres.  For each lane whose counts under "high" and
    "highest" differ it prints the first iteration after which one chain
    stopped and the other went on, both margins there, and how far apart
    the two iterates are (largest difference of an acceleration over the
    largest acceleration).  A summary for each pair of engines sets those
    beside all lanes: how many lanes differ and in which direction, how far
    apart the iterates are after the first iteration, and the gap of the
    margins."""
    import torch
    import chip_smoke as cs
    from ba_path_planning_torch.ops.collisions import (FEAS_SLACK,
                                                       min_pairwise_distance)
    from ba_path_planning_torch.ops.rollout import rollout
    from ba_path_planning_torch.scenarios.generator import (
        generate_scenario_batch)
    from ba_path_planning_torch.solvers.banded import tree_map
    from ba_path_planning_torch.solvers.scp import SCPEngine, _goal_projected
    from ba_path_planning_torch.utils.config import SolverConfig
    problem = cs._problem(n_veh)
    production = SolverConfig.production(problem=problem)
    engines = {p: SCPEngine(problem, production.replace(ns_precision=p),
                            dtype=torch.float32, device=dev)
               for p in ("high", "highest")}
    if with_f64:
        engines["float64"] = SCPEngine(
            problem, SolverConfig.production(kernels=False, problem=problem),
            dtype=torch.float64, device=dev)
    names = list(engines)
    pairs = [(a, b) for i, a in enumerate(names) for b in names[i + 1:]]
    sc = generate_scenario_batch(100, B, n_vehicles=n_veh, min_distance=cs.R,
                                 dtype=torch.float32, device=dev)
    v0 = torch.zeros_like(sc.initial)
    args = (sc.initial, v0, sc.final, v0)
    start = engines["high"].start(*args)
    rounds = problem.max_iterations
    nan = float("nan")
    margin = {p: torch.full((B, rounds), nan, device=dev) for p in names}
    apart = {ab: torch.full((B, rounds), nan, device=dev) for ab in pairs}
    iters = {p: torch.zeros(B, dtype=torch.int32, device=dev) for p in names}

    def cast(t, eng):
        return t.to(eng.dtype) if t.is_floating_point() else t
    for lo in range(0, B, chunk):
        ids = torch.arange(lo, min(lo + chunk, B), device=dev)
        part = {p: [cast(a[lo:lo + chunk], eng) for a in args]
                for p, eng in engines.items()}
        carry = {p: tree_map(lambda t: cast(t[lo:lo + chunk], eng), start)
                 for p, eng in engines.items()}
        for r in range(1, rounds + 1):
            live = {p: (c.it < r) & ~c.stop & ~c.feasible_initial
                    for p, c in carry.items()}
            if not any(bool(v.any()) for v in live.values()):
                break
            for p, eng in engines.items():
                c = carry[p] = eng.step(carry[p], *part[p], ids, r)
                pos, _ = rollout(_goal_projected(c.a, *part[p], problem),
                                 part[p][0], part[p][1], cs.H)
                m = min_pairwise_distance(pos, eng.pairs).float() - (
                    cs.R - FEAS_SLACK)
                margin[p][ids, r - 1] = torch.where(live[p], m,
                                                    torch.full_like(m, nan))
            for a, b in pairs:
                d = (carry[a].a - carry[b].a).abs().flatten(1).amax(-1)
                d = (d / carry[b].a.abs().flatten(1).amax(-1)).float()
                apart[a, b][ids, r - 1] = torch.where(
                    live[a] & live[b], d, torch.full_like(d, nan))
        for p, c in carry.items():
            iters[p][ids] = c.it
    margin = {p: t.cpu() for p, t in margin.items()}
    apart = {ab: t.cpu() for ab, t in apart.items()}
    iters = {p: t.cpu() for p, t in iters.items()}
    print(f"N={n_veh} B={B}: mean SCP iterations "
          + ", ".join(f"{p} {float(iters[p].float().mean()):.3f}"
                      for p in names), flush=True)
    q = torch.tensor([0.5, 0.9, 0.99])

    def quantiles(t):
        return "/".join(f"{v:.2e}" for v in t.quantile(q).tolist())
    for a, b in pairs:
        differ = torch.nonzero(iters[a] != iters[b]).flatten().tolist()
        more = int((iters[a] > iters[b]).sum())
        print(f"{a} against {b}: {len(differ)} lanes differ, {more} take "
              f"more iterations under {a}, {len(differ) - more} under {b}",
              flush=True)
        flips = []
        for lane in differ:
            # the first iteration after which exactly one of them goes on
            r = int(min(iters[a][lane], iters[b][lane])) - 1
            flips.append((float(margin[a][lane, r]),
                          float(margin[b][lane, r])))
            if (a, b) == ("high", "highest"):
                print(f"  lane {lane}: iterations {int(iters[a][lane])} and "
                      f"{int(iters[b][lane])}; after iteration {r + 1} "
                      f"margins {flips[-1][0]:+.3e} and {flips[-1][1]:+.3e} "
                      f"m, iterates apart {float(apart[a, b][lane, r]):.3e}",
                      flush=True)
        both = ~torch.isnan(margin[a]) & ~torch.isnan(margin[b])
        gap = (margin[a] - margin[b])[both]
        closer = torch.tensor([min(abs(x), abs(y)) for x, y in flips])
        print(f"  the {int(both.sum())} lane-iterations that both ran: "
              f"iterates apart after iteration 1, quantiles 50/90/99% "
              f"{quantiles(apart[a, b][:, 0][both[:, 0]])}; margin {a} - {b} "
              f"mean {float(gap.mean()):+.3e} m, median "
              f"{float(gap.median()):+.3e} m, |gap| quantiles "
              f"{quantiles(gap.abs())} m; on the differing lanes the margin "
              f"nearer to the threshold, quantiles "
              f"{quantiles(closer) if flips else 'none'} m; share of all "
              f"lane-iterations of {b} within 3e-3 m of the threshold "
              f"{float((margin[b][both].abs() <= 3e-3).float().mean()):.1%}",
              flush=True)


def main():
    import torch
    import chip_smoke as cs
    from ba_path_planning_torch.ops import (admm_fused, banded_solve,
                                            group_solve, ns_chain)
    from ba_path_planning_torch.utils.config import SolverConfig
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs._card_line()
    counters = {"ns_chain": ns_chain.factorize_X_chain_batched,
                "group_solve_x": group_solve.solve_factorized_grouped_X,
                "admm_fused_x": admm_fused.admm_interval_fused_X,
                "admm_fused_x_wide": admm_fused.admm_interval_fused_X.wide,
                "group_solve_l": group_solve.solve_factorized_grouped_L,
                "banded_solve": banded_solve.solve_factorized_dense,
                "admm_fused_l": admm_fused.admm_interval_fused}
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    missed = []
    for n_veh in [int(a) for a in args] or [30, 40]:
        B, chunk = (1024, 512) if n_veh <= 21 else (2048, 128)
        if "--factors" in sys.argv[1:]:
            factor_quality(dev, n_veh)
        if "--lanes" in sys.argv[1:]:
            lane_margins(dev, n_veh, B, chunk, "--f64" in sys.argv[1:])
        if "--f64" in sys.argv[1:]:
            f64_counts(dev, n_veh, B, chunk)
        production = SolverConfig.production(problem=cs._problem(n_veh))
        for precision in TURNS:
            print(f"ns_precision={precision}:", flush=True)
            try:
                cs.main_path(dev, card, n_veh, B, chunk, counters,
                             solver=production.replace(ns_precision=precision),
                             label=f"N={n_veh} ns_precision={precision}")
            except AssertionError as err:      # the path's 99% bar
                missed.append(f"N={n_veh} {precision}: {err}")
        for precision in dict.fromkeys(TURNS):
            last = cs.PATH_STATS[f"N={n_veh} ns_precision={precision}"]
            print(f"N={n_veh} ns_precision={precision}: ok {last['ok']}/{B}, "
                  f"mean SCP iterations {last['mean_scp_iters']:.4f}, mean QP "
                  f"iterations {last['mean_qp_iters']:.3f}", flush=True)
    for m in missed:
        print(f"below the 99% bar: {m}", flush=True)
    if missed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
