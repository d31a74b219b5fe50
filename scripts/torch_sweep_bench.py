#!/usr/bin/env python3
"""Time the sweep kernels, the X-form fused interval and the NS chain of
the PyTorch port on one GPU.

    python3 scripts/torch_sweep_bench.py [--cases X:20:512,...] [--root DIR]
                                         [--time-only] [--graph] [--bf16]
                                         [--tiers] [--plans] [--seed S]

Each case (form, N, B; K=50, or a fourth field for cases S, X, NS and A:
``S:1024:1:6``) is built and checked as ``chip_smoke.py`` builds and
checks it (cases NS and X repeat the inputs of at most DISTINCT
scenarios, fewer where their assembly would not fit): the NS chain's
kernel (case NS: ``chain_interior`` at ``ns_precision="high"``, the
anchors apart, on production blocks, against the plain ``factorize_X``,
beside which it is timed, and the bound of its three TF32 passes), the
X-form sweep (form X) on the NS factors of
production blocks, the L-only sweep (L) and the dense (Linv, Eb) sweep (D)
on the block Cholesky factors of the reference-compatible solver, through
``chip_smoke._sweep_check`` (the kernel against its plain version,
CUDA-event times of both, the check at the ADMM loop's scale); the X-form
fused ADMM interval (F, 25 iterations; FR with one rho a lane, its factors
those of M / rho scaled back, as the solver makes them; a fourth field
sets their horizon, ``F:584:2:2``) and the L-form one (FL, on the factors
of the reference-compatible solver) through ``chip_smoke.fused_check``; the ADMM stages of ``ops/admm_steps.py``
through ``chip_smoke._steps_check``, then timed alone: ``admm_rhs`` and
``admm_update`` (S) and the channel interval of 25 iterations (C; CL with
one rho a lane), beside the bounds of ``utils/profiling.admm_stage_cost``
(for the channel interval the collision-free count, and the count with
eta's pair terms beside it, where the checkout has both).  Case LAT
(``LAT:20:64``) runs the bench twin (``bench.measure``) on its headline
problem at N vehicles, B scenarios in one chunk, and prints the batch's
wall, the p50 of single ``SolverConfig.latency()`` solves and the slope of
sequential ones (host time included).  Case A (``A:20:512``, a fourth
field for K: ``A:1024:1:6``) assembles the QP's diagonal blocks D through
``chip_smoke.assemble_case``: the one-pass kernel against the plain
``banded.assemble_D``, checked, timed in turns, beside the bound of D
written once.
Each case prints one JSON line: the launch plan, the kernel's ms, its
stream bound (every block read in both sweeps, ``chip_smoke._bound_ms``)
and its share of it, and the bound that counts only what the sweeps need
of each block (Linv's lower triangle; X's upper one).  The first line
names the card and its power limit.

The package and ``chip_smoke.py`` are imported from the checkout the script
lies in, or from the one given by ``--root``; to compare two versions on
the same card, run the script for each checkout in turns in one call.
``--time-only`` times the fused intervals (F, FL) without checking them,
for diagnostic builds whose results are not meant to be right (say, with
the factor copies or the products switched off).
``--graph`` also times each stage of case S from replays of a CUDA graph
of 20 calls (``graph_ms``: the fastest and slowest of 5 replays, a call),
the device's time without the host's launch cost, which sets the CUDA-event
time at small batches; its lines name admm_rhs's plan (``rhs_plan``: the
table or the direct form, the k-tile).  ``--bf16`` runs the sweep cases
(X, L, D) on their factors stored in bf16 (``banded.compress_factors``,
as ``SolverConfig.factor_dtype="bf16"`` stores them), checked against the
plain version on the same bf16 factors, and times the kernel on the bf16
and on the float32 factors in turns (bf16, f32, bf16, f32: ``ms`` and
``f32_ms`` the fastest of each, ``bf16_ms_runs`` and ``f32_ms_runs`` all
four); the bounds then count 2 bytes an element on the padded rows.  With
``--bf16`` the L-form fused interval (FL) runs on bf16 (Linv, Eb) as well,
checked as ``chip_smoke.py`` checks it, and is timed on both factor types
from one state in the same turns.  ``--tiers`` times cases X, L, NS and F
on each tier of their kernel in turns (the plan's first: ``ms``; every
tier, each checked, in ``ms_by_tier``: the sweeps' "cluster" and "wide",
the NS chain's output tile, 0 for one block a scenario, the fused
interval's "one_block" and "wide"), where the checkout has tiers (with
``--bf16`` on the bf16 factors and their plans); case F then states its
stream bound as the (2K - 1) whole blocks an iteration streams, and
whether the wide tier's result equals the one-block tier's bit for bit
(``wide_equals_one_block``; both read whole bands above n = 512).
``--plans`` times cases X and L on their wide tier under other
plans too (``wide_plans``: each count of blocks an SM, the bands from 2
rows to the largest two stages allow, two stages and as many as fit),
and case F under other counts of blocks a scenario (``fused_wide_plans``:
one and two blocks an SM, each spread from 2 to the card's), each checked
(X and F: equal to the plan's result; L: within SWEEP_TOL of the
plain version, and equal to the plan's where its blocks are the plan's),
in one JSON line (``plans_ms``).  Cases L and D, like X, repeat the inputs of at most
DISTINCT scenarios.  ``--seed`` adds S to the seed of the inputs of cases X, L
and D (another draw of the same shapes).
"""

import argparse
import json
import sys
from pathlib import Path

CASES = ("X:20:512,X:20:128,X:20:64,X:20:1,L:20:512,L:20:64,L:20:1,"
         "L:30:128,L:40:128,D:20:512,D:20:64,D:20:1,F:30:128,F:40:128,"
         "FL:20:128,FL:20:64")


def _graph_ms(fn, calls=20, replays=5):
    """(fastest, slowest) ms a call of ``fn`` over ``replays`` replays of a
    CUDA graph of ``calls`` calls."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    ms = []
    for _ in range(replays):
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(stop) / calls)
    return min(ms), max(ms)


def _time_adaptive(cs, fn, budget_ms=2000.0):
    """CUDA-event ms of a call of ``fn`` (``chip_smoke._time_ms``) over as
    many calls, 2 to 20, as fit in about ``budget_ms``."""
    once = cs._time_ms(fn, reps=1)
    return cs._time_ms(fn, reps=max(2, min(20, int(budget_ms / once))))


# scenarios of their own in a case of cases NS and X, at most, and the
# most collision-block elements (B K n^2 P) their assembly may take; a
# larger batch repeats theirs (the assembly of eight scenarios at N = 342,
# K = 50 would not fit on the card)
DISTINCT, ASSEMBLY_ELEMS = 8, 3e13


def _case(cs, N, B, K, dev, seed, solver=None):
    """``chip_smoke._case``'s D, C, b and b_admm for B scenarios (of
    ``solver``'s rho pattern; default production): those of at most
    DISTINCT scenarios (fewer where their assembly would pass
    ASSEMBLY_ELEMS), repeated."""
    import torch
    n, P = 6 * N, N * (N - 1) // 2
    own = max(1, min(B, DISTINCT, int(ASSEMBLY_ELEMS / (K * n * n * P))))
    D, C, b, b_admm, _ = cs._case(N, own, dev, seed=seed, n_steps=K,
                                  solver=solver)
    if B > own:
        idx = torch.arange(B, device=dev) % own
        D, b, b_admm = D[idx], b[idx], b_admm[idx]
    return D, C, b, b_admm


def wide_plans(gs, B, K, n, form="X", esize=4):
    """Plans of the wide tier of ``form`` beside ``sweep_plan``'s: for one
    and two blocks an SM (the card's blocks shared out as the plan shares
    them), bands of 2, 4, 8, 16 and 32 rows and the largest of which two
    stages fit, each with two stages and with as many as fit."""
    row = gs.sweep_row_bytes(n, esize)
    out = []
    for per_sm in (1, 2):
        spread = max(1, min(gs.SMS * per_sm // B, n // 2))
        rows = gs.sweep_wide_rows(n, spread)
        room = (gs.SMEM_SM // per_sm - 1024) - gs.sweep_wide_smem_bytes(
            n, rows, 0, 0, row, form)
        top = min(gs.SWEEP_MAX_BAND, rows, room // (2 * row)) // 2 * 2
        for band in sorted({b for b in (2, 4, 8, 16, 32) if b <= top}
                           | ({top} if top >= 2 else set())):
            for stages in sorted({2, min(gs.SWEEP_MAX_STAGES,
                                         room // (band * row))}):
                out.append(gs.SweepPlan(1, band, stages,
                                        gs.sweep_wide_smem_bytes(
                                            n, rows, band, stages, row, form),
                                        per_sm, spread))
    return out


def fused_wide_plans(af, B, K, N):
    """Plans of the fused X interval's wide tier beside its plan's: one
    and two blocks an SM, each with 2, 4, 8, 16, 33 and 66 blocks a
    scenario and as many as the card holds (at least a row pair a
    block)."""
    out = []
    for per_sm in (1, 2):
        most = min(af.SMS * per_sm // B, 3 * N)
        for spread in sorted({s for s in (2, 4, 8, 16, 33, 66) if s <= most}
                             | {most}):
            plan = af.fused_wide_fit(K, N, spread, per_sm)
            if plan is not None:
                out.append(plan)
    return out


def _fused_tiers(cs, af, N, B, K, kw, card, plans):
    """Case F with ``--tiers``: the fused X interval on its one-block and
    its wide tier, each checked (``chip_smoke.fused_check``, the stream
    bound of the (2K - 1) whole blocks an iteration streams), the wide
    result against the one-block one bit for bit, then both timed in turns,
    twice; with ``plans`` the wide tier under :func:`fused_wide_plans` too,
    each equal to the plan's result.  Returns the JSON line."""
    import torch
    from ba_path_planning_torch.solvers import banded
    n = 6 * N
    tiers = {}
    first = bool(af.fused_x_plan(B, K, N).spread)
    for wide in (first, not first):
        tiers["wide" if wide else "one_block"] = af.fused_x_plan(
            B, K, N, _wide=wide)
    stats = {}
    for name, plan in tiers.items():
        stats[name] = cs.fused_check(
            f"F N={N} B={B} K={K} {name} tier",
            lambda p=plan, **a: af.admm_interval_fused_X(**a, _plan=p),
            af.admm_interval_fused_X_plain, dict(kw), N, K * n * n,
            stream_floats=(2 * K - 1) * n * n)
    x = kw.pop("x")
    z = banded.tree_map(torch.clamp, banded.apply_A(
        x, kw["eta"], kw["E"], cs.H), kw["lower"], kw["upper"])
    y = banded.tree_map(torch.zeros_like, z)
    state = dict(x=x, z=z, y=y, n_iters=25)

    def run(plan):
        return cs._rows(af.admm_interval_fused_X(**kw, **state, _plan=plan))
    results = {name: run(plan) for name, plan in tiers.items()}
    same = all(torch.equal(a, b) for a, b in zip(results["wide"],
                                                  results["one_block"]))
    runs = {name: [] for name in tiers}
    for _ in range(2):
        for name, plan in tiers.items():
            runs[name].append(_time_adaptive(
                cs, lambda p=plan: af.admm_interval_fused_X(**kw, **state,
                                                            _plan=p)))
    bound = stats["wide"]["stream_bound_ms"]
    line = {"form": "F", "N": N, "B": B, "K": K, "iterations": 25,
            "ms": min(next(iter(runs.values()))),
            "ms_by_tier": {k: min(v) for k, v in runs.items()},
            "ms_runs_by_tier": runs, "stream_bound_ms": bound,
            "share_by_tier": {k: bound / min(v) for k, v in runs.items()},
            "plain_ms": stats["wide"]["plain_ms"],
            "max_abs_err": {k: st["max_abs_err"] for k, st in stats.items()},
            "wide_equals_one_block": same,
            "plans": {k: p._asdict() for k, p in tiers.items()},
            "card": card}
    if plans:
        want = results["wide"]
        times = {}
        for plan in [tiers["wide"]] + [q for q in fused_wide_plans(
                af, B, K, N) if q != tiers["wide"]]:
            got = run(plan)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"F N={N} B={B} K={K}: plan "
                                     f"{tuple(plan)} differs")
            times[f"{plan.spread}x{plan.per_sm}"] = _time_adaptive(
                cs, lambda p=plan: af.admm_interval_fused_X(**kw, **state,
                                                            _plan=p))
        line.update(plans_ms=times, plan_key="spread x per_sm")
    del results
    return line


def _ns_case(cs, ns_chain, N, B, K, dev, card, tiers):
    """Case NS: the chain's kernel (the interior, anchors apart) at
    ``ns_precision="high"`` on production blocks against the plain
    ``factorize_X``, on the plan's tier and, with ``tiers``, on each other
    tier in turns.  Returns the JSON line."""
    import inspect
    import torch
    n = 6 * N
    D, C = _case(cs, N, B, K, dev, seed=N)[:2]
    Xp = ns_chain.factorize_X_chain_plain(D, C, ns_iters=2)
    plain_ms = _time_adaptive(
        cs, lambda: ns_chain.factorize_X_chain_plain(D, C, ns_iters=2))
    head = ns_chain.anchor_head(D, C)
    plan_fn = getattr(ns_chain, "ns_chain_plan", None)
    runs = {}
    if plan_fn is None or "_plan" not in inspect.signature(
            ns_chain.chain_interior).parameters:
        runs[None] = lambda: ns_chain.chain_interior(
            D, C, head, ns_iters=2, ns_precision="high")
    else:
        first = plan_fn(B, n).tile
        others = getattr(ns_chain, "NS_TILES", (0, 64, 128))
        for tile in [first] + ([t for t in others if t != first]
                               if tiers else []):
            runs[tile] = (
                lambda p=plan_fn(B, n, _tile=tile): ns_chain.chain_interior(
                    D, C, head, ns_iters=2, ns_precision="high", _plan=p))
    errs = {}
    for tile, fn in runs.items():
        X = ns_chain.anchor_tail(fn(), D, C)
        torch.cuda.synchronize()
        errs[tile] = cs._block_rel(X, Xp, 2)
        if not errs[tile] <= cs.NS_TOL:
            raise AssertionError(f"NS N={N} B={B} K={K} tile {tile}: "
                                 f"{errs[tile]:.3e}")
        del X
    times = {tile: [] for tile in runs}
    for _ in range(2):
        for tile, fn in runs.items():
            times[tile].append(_time_adaptive(cs, fn))
    # the checkout's count of the interior's operations (a checkout
    # without one prints no bound)
    from ba_path_planning_torch.utils import profiling
    count = getattr(profiling, "ns_chain_interior_flops", None)
    bound = (3 * count(B, K, n) / cs.TF32_FLOP_S * 1e3 if count else None)
    first = next(iter(runs))
    ms = min(times[first])
    return {"form": "NS", "N": N, "B": B, "K": K, "tile": first, "ms": ms,
            "ms_per_step": ms / (K - 4), "ms_by_tier": {
                str(t): min(v) for t, v in times.items()},
            "ms_runs_by_tier": {str(t): v for t, v in times.items()},
            "plain_ms": plain_ms, "bound_ms": bound,
            "share": bound / ms if bound else None,
            "bound_by": "operations (three TF32 passes)",
            "max_block_rel": {str(t): e for t, e in errs.items()},
            "card": card}


def _latency_case(N, B, card):
    """Case LAT: the bench twin's figures (``bench.measure``) on its
    headline problem at N vehicles, B scenarios solved in one chunk: the
    batch's wall, the p50 of single ``SolverConfig.latency()`` solves and
    the slope of sequential ones.  Returns the JSON line."""
    import dataclasses
    import re
    from ba_path_planning_torch import bench
    problem = dataclasses.replace(bench.headline_problem(), n_vehicles=N)
    _, summary = bench.measure(problem, batch=B, chunk=B)
    fields = {key: float(re.search(rf" {key}=([0-9.]+)", summary).group(1))
              for key in ("wall", "p50_single_scenario_latency_ms",
                          "p50_ondevice_solve_ms")}
    ok = re.search(r" ok=(\d+/\d+) ", summary).group(1)
    return {"form": "LAT", "N": N, "B": B, **fields, "ok": ok,
            "card": card}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default=CASES)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--time-only", action="store_true")
    ap.add_argument("--graph", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--tiers", action="store_true")
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--seed", type=int, default=0,
                    help="added to the seed of the inputs of cases X, L and D")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_sweep_bench.py: no CUDA device")
    import inspect
    import chip_smoke as cs
    from ba_path_planning_torch.utils import profiling
    # the card's peaks, which chip_smoke.main() sets before its phases
    cs.HBM_BYTES_S, cs.FP32_FLOP_S, cs.TF32_FLOP_S = (
        profiling.H100_PEAK_HBM_BYTES, profiling.H100_PEAK_FP32_FLOPS,
        profiling.H100_PEAK_TF32_FLOPS)
    from ba_path_planning_torch.ops import (admm_fused, banded_solve,
                                            group_solve, ns_chain)
    from ba_path_planning_torch.solvers import banded
    card = cs._card_line()
    print(f"card: {card}; root {args.root}", flush=True)
    from ba_path_planning_torch.ops import cuda_build
    cuda_build.load_kernels()
    # what ptxas reports of each kernel (registers, spills, shared memory)
    print("ptxas: " + " | ".join(
        ln.strip() for ln in cuda_build.build_info["log"].splitlines()
        if ln.endswith(".cu:") or "Compiling entry" in ln
        or "registers" in ln or "spill" in ln), flush=True)
    dev = torch.device("cuda", 0)
    plan_fn = getattr(group_solve, "sweep_plan", None)
    for case in args.cases.split(","):
        form, N, B, *steps = case.split(":")
        N, B = int(N), int(B)
        K = int(steps[0]) if steps else cs.K_STEPS
        n = 6 * N
        if form in ("S", "C", "CL"):
            from ba_path_planning_torch.ops import admm_steps
            err, factors, c, rows, _ = cs._steps_check(
                f"{form} N={N} B={B}", N, B, dev, phase1=form != "S",
                lane_rho=cs._lane_rho(B, seed=21) if form == "CL" else None,
                **({"n_steps": K} if steps else {}))
            work = admm_steps.Rows(*(t.clone() for t in rows))
            if form == "S":
                b = admm_steps.admm_rhs(rows, c)
                xt = group_solve.solve_factorized_grouped_X(*factors, b)
                timed = {"admm_rhs": lambda: admm_steps.admm_rhs(rows, c),
                         "admm_update": lambda: admm_steps.admm_update(
                             xt, work, c)}
            else:
                timed = {"admm_channel_interval":
                         lambda: admm_steps.admm_channel_interval(
                             *factors, work, c, 25)}
                one = cs._time_ms(lambda: admm_steps.admm_channel_interval(
                    *factors, work, c, 1), 20)
            for key, fn in timed.items():
                ms = cs._time_ms(fn, 20)
                cost = profiling.admm_stage_cost(key, N, K)
                bound = cs._bound_ms(B * cost["hbm_bytes"],
                                     B * cost["flops"])[0]
                line = {"form": form, "kernel": key, "N": N, "B": B,
                        "K": K, "ms": ms, "bound_ms": bound,
                        "share": bound / ms, "max_abs_err": err,
                        "card": card}
                if form == "S" and args.graph:
                    line["graph_ms"] = _graph_ms(fn)
                if key == "admm_rhs":
                    plan = getattr(admm_steps, "rhs_plan", None)
                    line["plan"] = (plan(B, K, N)._asdict() if plan else
                                    {"k_tile": admm_steps.row_plan(B, K, N),
                                     "table": False})
                if form != "S":     # one iteration, and each further one
                    line.update(ms_1_iteration=one,
                                ms_per_further_iteration=(ms - one) / 24)
                    try:            # the collision-free count, where known
                        free = profiling.admm_stage_cost(key, N, K,
                                                         eta_terms=False)
                    except TypeError:
                        free = None
                    if free is not None:
                        fb = cs._bound_ms(B * free["hbm_bytes"],
                                          B * free["flops"])
                        line.update(bound_ms=fb[0], bound_by=fb[1],
                                    share=fb[0] / ms,
                                    bound_ms_with_eta_terms=bound)
                print(json.dumps(line), flush=True)
            del factors, c, rows, work
            continue
        if form == "NS":
            print(json.dumps(_ns_case(cs, ns_chain, N, B, K, dev, card,
                                      args.tiers)), flush=True)
            continue
        if form == "LAT":
            print(json.dumps(_latency_case(N, B, card)), flush=True)
            continue
        if form == "A":
            print(json.dumps({"form": "A", **cs.assemble_case(
                dev, N, K, B, seed=N + args.seed), "card": card}),
                  flush=True)
            torch.cuda.empty_cache()
            continue
        if form in ("F", "FR"):
            lane_rho = cs._lane_rho(B, seed=N) if form == "FR" else None
            D, C, _, _, kw = cs._case(N, B, dev, seed=N, n_steps=K,
                                      lane_rho=lane_rho)
            if lane_rho is None:
                kw["X"] = ns_chain.factorize_X_chain_plain(D, C, ns_iters=2)
            else:
                from ba_path_planning_torch.utils.config import SolverConfig
                C1 = banded.unit_slot_scalars(
                    SolverConfig.production(problem=cs._problem(
                        N, n_steps=K)).static_part(),
                    n_steps=K, h=cs.H, device=dev)
                scale = lane_rho.reshape(-1, 1, 1, 1)
                kw["X"] = ns_chain.factorize_X_chain_plain(
                    D / scale, C1, ns_iters=2) / scale
            del D
            if (args.tiers or args.plans) and form == "F" and hasattr(
                    admm_fused, "fused_x_plan"):
                print(json.dumps(_fused_tiers(cs, admm_fused, N, B, K, kw,
                                              card, args.plans)),
                      flush=True)
                del kw
                torch.cuda.empty_cache()
                continue
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
                f"{form} N={N} B={B}", admm_fused.admm_interval_fused_X,
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
            factors = {"f32": (Linv, Eb)}
            esize, ld = 4, n
            if args.bf16:
                factors["bf16"] = banded.compress_factors(Linv, Eb)
                esize, ld = 2, factors["bf16"][0].stride(-2)
            key = "bf16" if args.bf16 else "f32"
            line = {"form": form, "N": N, "B": B, "K": K, "iterations": 25,
                    "card": card}
            if args.time_only:
                line["checked"] = False
            else:
                stats = cs.fused_check(
                    f"FL N={N} B={B}" + (f" bf16 (rows of {ld})"
                                         if args.bf16 else ""),
                    admm_fused.admm_interval_fused,
                    admm_fused.admm_interval_fused_plain,
                    dict(kw, Linv=factors[key][0], Eb=factors[key][1]), N,
                    (2 * K - 1) * n * ld, factor_bytes=esize)
                line.update(ms=stats["ms"],
                            stream_bound_ms=stats["stream_bound_ms"],
                            max_abs_err=stats["max_abs_err"])
            if args.bf16 or args.time_only:
                # each factor type from one state, in turns
                x = kw.pop("x")
                z = banded.tree_map(torch.clamp, banded.apply_A(
                    x, kw["eta"], kw["E"], cs.H), kw["lower"], kw["upper"])
                y = banded.tree_map(torch.zeros_like, z)
                runs = {name: [] for name in factors}
                for _ in range(2):
                    for name, fac in factors.items():
                        runs[name].append(cs._time_ms(
                            lambda: admm_fused.admm_interval_fused(
                                *fac, **kw, x=x, z=z, y=y, n_iters=25)))
                line.update(ms=min(runs[key]), ms_runs=runs[key])
                if args.bf16:
                    line.update(f32_ms=min(runs["f32"]),
                                f32_ms_runs=runs["f32"],
                                factor_dtype="bf16", row_stride=ld)
                del x, z, y
            line["stream_bound_ms"] = cs._bound_ms(
                25 * B * 2 * (2 * K - 1) * n * ld * esize, 0)[0]
            line["share"] = line["stream_bound_ms"] / line["ms"]
            plan_fn = getattr(admm_fused, "fused_plan", None)
            if plan_fn is not None:
                line["plan"] = plan_fn(K, N, "L", esize=esize)._asdict()
            print(json.dumps(line), flush=True)
            del kw, Linv, Eb, factors
            continue
        if form == "X":
            D, C, b, b_admm = _case(cs, N, B, K, dev, seed=B + args.seed)
            factors = (ns_chain.factorize_X_chain_plain(D, C, ns_iters=2), C)
            kernel = group_solve.solve_factorized_grouped_X
            plain = group_solve.solve_factorized_grouped_X_plain
        else:
            D, C, b, b_admm = _case(cs, N, B, K, dev,
                                    seed=1000 + N + B + args.seed,
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
            del Linv, Eb
        del D
        # the factor blocks (the slot scalars of X and L stay float32)
        n_fac = 2 if form == "D" else 1
        ops, esize, ld = factors, 4, n
        if args.bf16:
            ops = (banded.compress_factors(*factors[:n_fac])
                   + tuple(factors[n_fac:]))
            esize, ld = 2, ops[0].stride(-2)
        tag = f"{form} N={N} B={B} K={K}" + (f" bf16 (rows of {ld})"
                                             if args.bf16 else "")
        # each tier of the X and L forms, where the checkout's kernel takes
        # a plan
        tiers = {}
        if (args.tiers and form in ("X", "L")
                and "_plan" in inspect.signature(kernel).parameters):
            first = bool(group_solve.sweep_plan(B, K, n, form,
                                                esize=esize).spread)
            for wide in (first, not first):
                plan = group_solve.sweep_plan(B, K, n, form, esize=esize,
                                              _wide=wide)
                tiers["wide" if wide else "cluster"] = (
                    plan, lambda *f, p=plan: kernel(*f, _plan=p))
        for name, (plan, fn) in tiers.items():
            cs._sweep_check(f"{tag} {name} tier", fn, plain, ops, b, b_admm,
                            reps=2)
        err, ms, _ = cs._sweep_check(tag, kernel, plain, ops, b, b_admm)
        # blocks streamed: 2K of X_k or Linv_k (X, L), 4K - 2 (D)
        blocks = 4 * K - 2 if form == "D" else 2 * K
        flops = B * (4 if form == "L" else 2) * blocks // 2 * 2 * n * n
        bound = cs._bound_ms(B * (blocks * n * ld * esize + 2 * K * n * 4),
                             flops)[0]
        line = {"form": form, "N": N, "B": B, "K": K, "ms": ms,
                "stream_bound_ms": bound, "share": bound / ms,
                "max_abs_err": err, "card": card}
        if args.bf16:
            runs = {"bf16": [], "f32": []}
            for _ in range(2):
                for key, fac in (("bf16", ops), ("f32", factors)):
                    runs[key].append(cs._time_ms(lambda: kernel(*fac, b),
                                                 reps=20))
            line.update(ms=min(runs["bf16"]), f32_ms=min(runs["f32"]),
                        bf16_ms_runs=runs["bf16"], f32_ms_runs=runs["f32"],
                        factor_dtype="bf16", row_stride=ld)
            line["share"] = bound / line["ms"]
        if tiers:
            # each tier in turns, twice
            runs = {name: [] for name in tiers}
            for _ in range(2):
                for name, (plan, fn) in tiers.items():
                    runs[name].append(_time_adaptive(
                        cs, lambda: fn(*ops, b)))
            line.update(ms=min(next(iter(runs.values()))),
                        ms_by_tier={k: min(v) for k, v in runs.items()},
                        ms_runs_by_tier=runs,
                        plans={k: p._asdict() for k, (p, _) in tiers.items()})
            line["share"] = bound / line["ms"]
        if form in ("X", "L") and args.plans:
            # X: every plan's result equal to the plan's; L: within
            # SWEEP_TOL of the plain version, and equal to the plan's where
            # its blocks are the plan's (the bands only split the rows,
            # summed in the same order)
            base = group_solve.sweep_plan(B, K, n, form, esize=esize,
                                          _wide=True)
            want = kernel(*ops, b, _plan=base)
            ref = plain(*ops, b)
            times = {}
            for plan in [base] + [q for q in wide_plans(
                    group_solve, B, K, n, form, esize) if q != base]:
                got = kernel(*ops, b, _plan=plan)
                torch.cuda.synchronize()
                same = plan.spread == base.spread
                if ((form == "X" or same) and not torch.equal(got, want)) or (
                        cs._block_rel(got, ref, 1) > cs.SWEEP_TOL):
                    raise AssertionError(f"{tag}: plan {tuple(plan)} differs")
                times[str(tuple(plan))] = _time_adaptive(
                    cs, lambda p=plan: kernel(*ops, b, _plan=p))
            line.update(plans_ms=times, plan_ms=times[str(tuple(base))],
                        plan_fields=list(base._fields))
        if form in ("L", "D"):
            # Linv's lower triangle only
            tri = K * n * (n + 1) // 2
            need = 2 * tri + (2 * (K - 1) * n * n if form == "D" else 0)
            line["nonzero_stream_bound_ms"] = cs._bound_ms(
                B * (need * esize * ld // n + 2 * K * n * 4),
                flops * need // (blocks * n * n))[0]
        if plan_fn is not None and not tiers:
            pform = {"X": "X", "L": "L", "D": "dense"}[form]
            if "esize" in inspect.signature(plan_fn).parameters:
                line["plan"] = plan_fn(B, K, n, pform, esize=esize)._asdict()
            elif "form" in inspect.signature(plan_fn).parameters:
                line["plan"] = plan_fn(B, K, n, pform)._asdict()
            elif form != "D":
                line["plan"] = plan_fn(B, K, n)._asdict()
        print(json.dumps(line), flush=True)
        # the next case's assembly may need the card's memory (N = 1024)
        del factors, ops, b, b_admm
        tiers.clear()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
