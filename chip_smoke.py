#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. checks for a CUDA device and prints it, with the name and power limit
   that nvidia-smi reports, and the TF32 switches (both off);
2. builds the CUDA kernels from ``ba_path_planning_torch/csrc``;
3. kernel phases, each kernel against its plain PyTorch version on the card
   at the main path's shapes (K=50, f32), with the stated tolerance on the
   relative error of every (b, k) block, and CUDA-event times of both:
   the NS chain and the sweep at N=20 (B=64, the chunk B=512 and the
   tail chunk B=128 of the compaction's later rounds); the NS
   chain at N=30 and N=40 (B=128, where its operands are streamed from
   global memory), each at ``ns_precision`` "high" (tensor cores, what the
   production solver runs) and "highest" (FP32), with the kernel and the
   exact anchors timed apart; the fused ADMM interval at N=30 and N=40
   (B=128), with the bound of its whole blocks and of their upper
   triangles; on the factors of the reference-compatible solver (rho 0.1,
   hard collision rows) the L-only sweep and the dense (Linv, Eb) sweep at
   N=20 (B=64, 512 and 1, the ``SCP`` class's batch), the L-only sweep at
   N=30 and N=40 (B=128), the L-form fused interval at N=20 (B=64 and 128,
   penalty weight +inf) and its wide instantiation at K=3, N=90; the three
   sweeps print the launch plan they ran (``group_solve.sweep_plan``);
4. reference phases: one SCP step of 8 scenarios through the kernels on the
   card against the plain versions on the CPU, both float32, at N=20 and
   N=30 with the production solver and at N=20 with the
   reference-compatible solver on its L-only sweep route;
5. main paths, each solved by ``solve_compacted`` from scenarios made from a
   seed, at the ``bench.py`` configuration (T=10, h=0.2, R=0.8, production
   solver): N=20 with 1024 scenarios in chunks of 512 (the grouped sweep
   route), N=30 and N=40 with 2048 scenarios in chunks of 128 (the fused
   route), and N=20 once more with ``SolverConfig.latency()`` (early-exit
   intervals on the grouped sweep route).  At least 99% of a path's
   scenarios must be collision-free with goal error < 5 cm;
6. the reference-compatible path at N=20: ``SCPEngine.solve_batch`` over
   FACADE_B scenarios with the ``SCP`` class's solver (L-form factors, hard
   collision rows, up to 2000 ADMM iterations per QP in intervals of 25,
   ``stop_mode="reference"``), once per kernel route (L-only sweeps, dense
   sweeps, L-form fused interval), the routes held against each other, and
   one ``SCP(...).generate_trajectories()`` call through the single-scenario
   CLI (``cli/compute_trajectories.py --no-viz``);
7. the entry points: the bench twin ``ba_path_planning_torch.bench`` at its
   own size (N=20, B=4096, chunk 512; its JSON line and summary are printed;
   at least 99% of the lanes ok), and the batch CLI
   (``cli/compute_trajectories_batch.py``): production at N=20 and N=30 with
   256 trials each, the same with ``--resume-dir`` twice (the second run
   solves nothing and gives the same rows), and ``--solver reference`` at
   N=20 with 64 trials; the schema-1.0 JSON and CSV are checked, and at
   least 99% of each production N must succeed.

The launch counters are set to 0 just before each path and read just after:
each path must launch the kernels of its route and no other.  Any failed
phase raises, so the exit code is not 0.  The last two lines are one JSON
object on the kernels and ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_HORIZON, H, R = 10.0, 0.2, 0.8
K_STEPS = int(T_HORIZON / H)
# (N, scenarios, chunk) of each main path
MAIN_PATHS = ((20, 1024, 512), (30, 2048, 128), (40, 2048, 128))
B_LARGE = 128                      # kernel phases at N=30/40: one chunk
FACADE_B = 64                      # scenarios of the reference-compatible path
REF_FACADE_ITERS = 500             # QP budget of its reference phase
HBM_BYTES_S, FP32_FLOP_S = 3.35e12, 67e12    # H100 SXM data sheet
TF32_FLOP_S = 495e12                         # dense, tensor cores
NS_TOL, SWEEP_TOL, REF_TOL = 1e-4, 1e-5, 5e-3
FUSED_TOL = 2e-4                   # one fused iteration: x, z per block
ADMM_ERR_RATIO = 4.0
# Routes of one path against each other.  Each QP stops at a relative
# residual of 1e-3, so two routes' positions may differ by that share of the
# 20 m box, 2e-2 m; FP32 rounding over thousands of ADMM iterations can move
# a borderline lane to another SCP iteration count, so the bar is positions
# within ROUTE_TOL, equal status and equal SCP iteration count on at least
# ROUTE_SHARE of the lanes.
ROUTE_TOL, ROUTE_SHARE = 2e-2, 0.9
# the batch CLI's outputs (schema 1.0)
CLI_ROW_KEYS = ["N", "trial_index", "status", "time_sec", "error", "K", "T",
                "h", "scp_iterations", "qp_iterations", "scp_status",
                "goal_error_m", "seed"]
CLI_CSV_COLUMNS = ["N", "trial_index", "status", "time_sec", "K", "T", "h",
                   "error"]
CLI_TRIALS, CLI_REF_TRIALS = 256, 64


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 5) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _zero(counters):
    for fn in counters.values():
        fn.launches = 0


def _read(counters):
    return {key: fn.launches for key, fn in counters.items()}


def _check_route(what, launches, route):
    """Each kernel of ``route`` launched, no other."""
    for kname, n_launch in launches.items():
        if (n_launch > 0) != (kname in route):
            raise AssertionError(f"{what} launched {kname} {n_launch} times; "
                                 f"its route is {sorted(route)}")


def _problem(n_veh, facade=False, n_steps=K_STEPS):
    """The bench.py problem, or the ``SCP`` class's (``facade``): the same
    but for the stopping rule and the goal projection; ``n_steps`` cuts
    the horizon."""
    from ba_path_planning_torch.utils.config import ProblemConfig
    problem = ProblemConfig(n_vehicles=n_veh, time_horizon=n_steps * H,
                            time_step=H, min_distance=R, max_iterations=15)
    return problem if facade else problem.replace(stop_mode="feasible",
                                                  goal_project=True)


def _facade_solver(**route):
    """The ``SCP`` class's default solver, on the kernel route ``route``."""
    from ba_path_planning_torch.utils.config import SolverConfig
    return SolverConfig(method="direct", polish=False, adaptive_rho=False,
                        max_iter=2000).replace(**route)


def _bound_ms(n_bytes, n_flops, flop_s=FP32_FLOP_S):
    """The least time the card could take: the bytes over the memory rate
    or the operations over the peak rate of the unit that executes them
    (the FP32 rate unless ``flop_s`` says otherwise), whichever is larger."""
    t_b, t_f = n_bytes / HBM_BYTES_S * 1e3, n_flops / flop_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def _case(n_veh, B, dev, seed, solver=None, n_steps=K_STEPS):
    """Main-path-shaped inputs of the kernels (``n_steps`` steps), float32
    on the card: bounds
    of random start and goal positions, collision rows of random unit
    directions about the start positions (row 0 vacuous), the rho pattern of
    ``solver`` (default: production for ``n_veh`` vehicles), the diagonal
    blocks D and slot scalars C, a random right-hand side b, one at the
    scale the ADMM loop feeds, b_admm = A^T (rho * A x) for a random state
    x, and the arguments of the fused-interval wrappers but for the factors
    and the state."""
    import numpy as np
    import torch
    from ba_path_planning_torch.ops.collisions import (make_pair_index,
                                                       pairwise_diffs)
    from ba_path_planning_torch.solvers import banded
    from ba_path_planning_torch.solvers.scp import _warm_state
    from ba_path_planning_torch.utils.config import (SolverConfig,
                                                     make_solver_params)
    K, P, f32 = n_steps, n_veh * (n_veh - 1) // 2, torch.float32
    problem = _problem(n_veh, n_steps=n_steps)
    if solver is None:
        solver = SolverConfig.production(problem=problem)
    prm = make_solver_params(solver, f32, dev)
    rng = np.random.default_rng(seed)
    rho = banded.rho_pattern_masks(
        banded.row_scaling_state(K, H, dtype=f32, device=dev),
        solver.static_part(), prm.rho, prm.col_rho_boost, n_steps=K,
        n_pairs=P, col_enabled=True, dtype=f32)
    eta = torch.as_tensor(rng.normal(size=(B, K, P, 2)), dtype=f32,
                          device=dev)
    eta = eta / torch.linalg.vector_norm(eta, dim=-1, keepdim=True)
    pairs = make_pair_index(n_veh, f32, dev)
    D, C = banded.assemble_D(rho, eta, pairs.E, h=H, sigma=prm.sigma,
                             n_vehicles=n_veh)
    x = banded.StateVars(*(torch.as_tensor(
        rng.normal(size=(B, n_veh, K, 2)) * scale, dtype=f32, device=dev)
        for scale in (1.0, 5.0, 2.0)))
    rz = banded.tree_map(torch.mul, rho, banded.apply_A(x, eta, pairs.E, H))
    b_admm = banded.to_stacked(banded.apply_AT(rz, eta, pairs.E, H))
    b = torch.as_tensor(rng.normal(size=(B, K, 6 * n_veh)), dtype=f32,
                        device=dev)
    p0, pf = (torch.as_tensor(rng.uniform(2.0, 18.0, (B, n_veh, 2)),
                              dtype=f32, device=dev) for _ in range(2))
    v0 = torch.zeros_like(p0)
    lower, upper = banded.build_bounds(p0, v0, pf, v0, n_vehicles=n_veh,
                                       n_steps=K, h=H, limits=problem.limits,
                                       n_pairs=P)
    rest = p0[..., None, :].expand(B, n_veh, K, 2).contiguous()
    dist = torch.linalg.vector_norm(pairwise_diffs(rest, pairs), dim=-1)
    lower = lower._replace(col=banded.collision_lower_bounds_state(
        eta, dist, rest, pairs, min_distance=R + solver.collision_margin))
    x_rest = _warm_state(torch.zeros((B, n_veh, K, 2), dtype=f32, device=dev),
                         p0, v0, H)
    interval = dict(C=C, eta=eta, E=pairs.E, lower=lower, upper=upper,
                    x=x_rest, rho=rho, h=H, sigma=prm.sigma, alpha=prm.alpha,
                    lam=prm.col_penalty)
    return D, C, b, b_admm, interval


def _block_rel(got, want, block_dims):
    """Largest relative error of any (b, k) block: max |got - want| over the
    block over max |want| over the same block."""
    dims = tuple(range(-block_dims, 0))
    diff = (got - want).abs().amax(dim=dims)
    return float((diff / want.abs().amax(dim=dims)).max())


def _stat(err, ms, plain_ms, shape, n_bytes, n_flops, stream_bytes,
          library_ms=None, flop_s=FP32_FLOP_S):
    """One kernel's numbers for the ``kernels`` line.  ``n_bytes`` counts
    every input read once and every output written once, ``n_flops`` the
    matrix-vector (or matrix-matrix) operations that the kernel's unit
    executes, ``flop_s`` that unit's peak rate; ``stream_bytes`` is what
    the algorithm streams when the factors, too large to stay on the chip,
    are read again at every sweep."""
    bound_ms, bound_by = _bound_ms(n_bytes, n_flops, flop_s)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "stream_bound_ms": _bound_ms(stream_bytes, n_flops, flop_s)[0],
            "library_ms": library_ms, "timed_at": shape}


def ns_check(n_veh, D, C, tag):
    """NS chain: the kernel route (exact anchors + interior kernel) against
    the plain factorize_X, both on the card, at the production solver's
    ``ns_precision="high"`` (tensor cores, three TF32 passes) and at
    "highest" (FP32 FMAs); the kernel and the anchors are also timed apart.
    A precision's ``bound_ms`` is that of the unit it runs on: "high"
    executes three TF32 passes on the tensor cores, so its operations are
    3 x the FP32 count at the dense TF32 rate; the FP32 count at the FP32
    rate stands beside it as ``fp32_bound_ms``, the figure that compares
    with the other kernels' and with earlier revisions'.
    Returns (X of "high", stats of "high")."""
    import torch
    from ba_path_planning_torch.ops import ns_chain
    Xp = ns_chain.factorize_X_chain_plain(D, C, ns_iters=2)
    # against float64, where the chain's FP32 rounding shows
    X64 = ns_chain.factorize_X_chain_plain(D.double(), C.double(), ns_iters=2)
    p_err = _block_rel(Xp.double(), X64, 2)
    ns_plain_ms = _time_ms(
        lambda: ns_chain.factorize_X_chain_plain(D, C, ns_iters=2))
    head, done = ns_chain.anchor_head(D, C), Xp.clone()
    anchors_ms = _time_ms(lambda: (ns_chain.anchor_head(D, C),
                                   ns_chain.anchor_tail(done, D, C)))
    B, K, n = D.shape[:3]
    # interior steps 3..K-2, 2 Newton-Schulz iterations of two n^3 products
    flops = B * (K - 4) * 2 * 4 * n ** 3
    out = {}
    for precision in ("highest", "high"):
        def route():
            return ns_chain.factorize_X_chain_batched(
                D, C, ns_iters=2, ns_precision=precision)
        X = route()
        torch.cuda.synchronize()
        ns_abs = float((X - Xp).abs().max())
        ns_rel = _block_rel(X, Xp, 2)
        k_err = _block_rel(X.double(), X64, 2)
        ns_ms = _time_ms(route)
        kernel_ms = _time_ms(lambda: ns_chain.chain_interior(
            D, C, head, ns_iters=2, ns_precision=precision))
        fp32_bound = flops / FP32_FLOP_S * 1e3
        # the operations executed and the peak rate of their unit
        done, rate = ((3 * flops, TF32_FLOP_S) if precision == "high"
                      else (flops, FP32_FLOP_S))
        bound = done / rate * 1e3
        unit = ("three TF32 passes at 495" if precision == "high"
                else "FP32 at 67")
        print(f"{tag}: factorize_X_chain_batched ns_precision={precision} "
              f"N={n_veh} B={B} max_block_rel={ns_rel:.3e} (tol {NS_TOL:g}) "
              f"max_abs={ns_abs:.3e}; against float64: kernel {k_err:.3e}, "
              f"plain f32 {p_err:.3e}; route={ns_ms:.3f} ms = kernel "
              f"{kernel_ms:.3f} ms + anchors {anchors_ms:.3f} ms; "
              f"library factorize_X={ns_plain_ms:.3f} ms; kernel at "
              f"{flops / kernel_ms / 1e9:.1f} TFLOP/s of FP32-equivalent "
              f"operations; bound of the unit it runs on "
              f"({unit} TFLOP/s) {bound:.3f} ms ({bound / kernel_ms:.0%} of "
              f"the kernel); FP32 operation bound {fp32_bound:.3f} ms "
              f"({fp32_bound / kernel_ms:.0%})", flush=True)
        if not ns_rel <= NS_TOL:
            raise AssertionError(f"NS chain kernel ({precision}) disagrees: "
                                 f"{ns_rel:.3e}")
        # the one library call of the same function is the plain factorize_X
        out[precision] = X, dict(
            _stat(ns_abs, ns_ms, ns_plain_ms, f"N={n_veh} K={K} B={B}",
                  2 * B * K * n * n * 4, done, 2 * B * K * n * n * 4,
                  library_ms=ns_plain_ms, flop_s=rate),
            precision=precision, kernel_ms=kernel_ms, anchors_ms=anchors_ms,
            fp32_bound_ms=fp32_bound)
    out["high"][1]["fp32_kernel_ms"] = out["highest"][1]["kernel_ms"]
    out["high"][1]["fp32_route_ms"] = out["highest"][1]["ms"]
    return out["high"]


def _sweep_check(tag, kernel, plain, factors, b, b_admm):
    """A sweep kernel against its plain version on the card: every (b, k)
    block within SWEEP_TOL on a random right-hand side; on one at the ADMM
    loop's scale, where the solve cancels ~2500x and FP32 itself is off by
    ~1e-5, within ADMM_ERR_RATIO of the plain FP32 version's error against
    float64.  Returns (max abs error, kernel ms, plain ms)."""
    import torch
    x, xp = kernel(*factors, b), plain(*factors, b)
    torch.cuda.synchronize()
    sw_abs, sw_rel = float((x - xp).abs().max()), _block_rel(x, xp, 1)
    sw_ms = _time_ms(lambda: kernel(*factors, b), reps=20)
    sw_plain_ms = _time_ms(lambda: plain(*factors, b), reps=3)
    x64 = plain(*(f.double() for f in factors), b_admm.double())
    adm_err = _block_rel(kernel(*factors, b_admm).double(), x64, 1)
    adm_plain_err = _block_rel(plain(*factors, b_admm).double(), x64, 1)
    print(f"{tag}: max_block_rel={sw_rel:.3e} (tol {SWEEP_TOL:g}) "
          f"max_abs={sw_abs:.3e} kernel={sw_ms:.3f} ms "
          f"plain={sw_plain_ms:.3f} ms; ADMM-scale b against float64: kernel "
          f"max_block_rel={adm_err:.3e}, plain f32 {adm_plain_err:.3e} (limit "
          f"{ADMM_ERR_RATIO:g}x plain)", flush=True)
    if not sw_rel <= SWEEP_TOL:
        raise AssertionError(f"{tag}: kernel disagrees: {sw_rel:.3e}")
    if not adm_err <= ADMM_ERR_RATIO * adm_plain_err:
        raise AssertionError(f"{tag}: kernel is off at the ADMM scale: "
                             f"{adm_err:.3e} vs plain {adm_plain_err:.3e}")
    return sw_abs, sw_ms, sw_plain_ms


def _plan(b, form):
    """The launch plan of the sweep kernel of ``form`` for right-hand sides
    b."""
    from ba_path_planning_torch.ops.group_solve import sweep_plan
    plan = sweep_plan(*b.shape, form)
    return ", ".join(f"{k}={v}" for k, v in plan._asdict().items())


def kernel_phase(dev, B):
    """N=20: the NS chain and the X-form sweep kernel."""
    from ba_path_planning_torch.ops import group_solve
    D, C, b, b_admm, _ = _case(20, B, dev, seed=B)
    X, ns_stats = ns_check(20, D, C, f"kernel phase B={B}")
    del D
    sw_abs, sw_ms, sw_plain_ms = _sweep_check(
        f"kernel phase B={B} N=20 K={K_STEPS} f32: "
        f"solve_factorized_grouped_X ({_plan(b, 'X')})",
        group_solve.solve_factorized_grouped_X,
        group_solve.solve_factorized_grouped_X_plain, (X, C), b, b_admm)
    n = 6 * 20
    return {"ns_chain": ns_stats,
            "group_solve_x": _stat(
                sw_abs, sw_ms, sw_plain_ms, f"N=20 K={K_STEPS} B={B}",
                B * K_STEPS * (n * n + 2 * n) * 4, B * 2 * K_STEPS * 2 * n * n,
                B * K_STEPS * (2 * n * n + 2 * n) * 4)}


def _rows(out):
    """(B, K, .) rows of an interval's (x, z, y): x stacked, and z and y as
    their static plane and collision rows side by side."""
    import torch
    from ba_path_planning_torch.ops.admm_fused import static_plane
    from ba_path_planning_torch.solvers.banded import to_stacked
    x, z, y = out
    K = z.col.shape[-2]

    def rows(rv):
        return torch.cat([static_plane(rv, K).flatten(-2), rv.col], -1)
    return to_stacked(x), rows(z), rows(y)


def _interval_f64(plain, kw, state, n_iters):
    """The plain interval in float64 on float32 inputs ``kw`` and state."""
    from ba_path_planning_torch.solvers.banded import tree_map

    def up(v):
        if isinstance(v, tuple):
            return tree_map(lambda t: t.double(), v)
        return v.double() if hasattr(v, "double") else v
    return plain(**{k: up(v) for k, v in kw.items()},
                 **{k: up(v) for k, v in state.items()}, n_iters=n_iters)


def fused_check(tag, kernel, plain, kw, n_veh, factor_floats,
                needed_floats=None):
    """A fused ADMM-interval kernel against its plain version on the
    arguments ``kw`` (factors included; ``factor_floats`` is their size per
    scenario, ``needed_floats`` what of it has to be read, where that is
    less: Linv without its zero half, X as its upper triangle).  The
    interval starts from a warm state, as
    an SCP iteration finds it: one float64 plain interval from x at rest,
    z = clip(A x, l, u) and y = 0.  Returns the kernel's stats."""
    import torch
    from ba_path_planning_torch.solvers import banded
    x = kw.pop("x")
    z = banded.tree_map(torch.clamp,
                        banded.apply_A(x, kw["eta"], kw["E"], H),
                        kw["lower"], kw["upper"])
    warm = _interval_f64(plain, kw, dict(x=x, z=z, y=banded.tree_map(
        torch.zeros_like, z)), 25)
    state = dict(zip("xzy", (banded.tree_map(lambda t: t.float(), v)
                             for v in warm)))
    errs, k64, p64 = {}, {}, {}
    for n_iters in (1, 25):
        got = _rows(kernel(**kw, **state, n_iters=n_iters))
        want = _rows(plain(**kw, **state, n_iters=n_iters))
        ref = _rows(_interval_f64(plain, kw, state, n_iters))
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(g).all()) for g in got):
            raise AssertionError(f"{tag}: non-finite output")
        errs[n_iters] = [_block_rel(g, w, 1) for g, w in zip(got, want)]
        k64[n_iters] = [_block_rel(g.double(), r, 1) for g, r in zip(got, ref)]
        p64[n_iters] = [_block_rel(w.double(), r, 1)
                        for w, r in zip(want, ref)]
        if n_iters == 1:
            abs_err = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
        del got, want, ref
    fu_ms = _time_ms(lambda: kernel(**kw, **state, n_iters=25))
    fu_plain_ms = _time_ms(lambda: plain(**kw, **state, n_iters=25), reps=2)
    B, K = kw["eta"].shape[:2]
    n, P = 6 * n_veh, n_veh * (n_veh - 1) // 2
    stream = 25 * B * 2 * factor_floats * 4
    gbs = stream / (fu_ms * 1e-3) / 1e9
    stream_ms = stream / HBM_BYTES_S * 1e3
    sparse = "" if needed_floats is None else (
        f", {stream_ms * needed_floats / factor_floats:.3f} ms reading only "
        "the triangle of each block that the sweeps need")

    def fmt(v):
        return "[" + ", ".join(f"{e:.3e}" for e in v) + "]"
    print(f"{tag} N={n_veh} B={B} K={K} f32 lam={float(kw['lam']):g}, block "
          f"errors of (x, z, y) after 1 and 25 iterations: against plain "
          f"{fmt(errs[1])} (x, z tol {FUSED_TOL:g}), max_abs={abs_err:.3e}; "
          f"{fmt(errs[25])}; against float64 kernel {fmt(k64[1])}, "
          f"{fmt(k64[25])}, plain f32 {fmt(p64[1])}, {fmt(p64[25])} (limit "
          f"{ADMM_ERR_RATIO:g}x plain); 25 iterations: kernel={fu_ms:.3f} ms "
          f"({gbs:.0f} GB/s of dense factor reads; streaming bound "
          f"{stream_ms:.3f} ms, {stream_ms / fu_ms:.0%} of the kernel"
          f"{sparse}) plain={fu_plain_ms:.3f} ms", flush=True)
    # x and z agree to a few ulps' worth of the sweeps; y = y + rho (zr - z)
    # multiplies the rounding of zr by rho (up to ~5e3 on the equality rows),
    # so its blocks are FP32-limited even after one iteration and are held
    # to the plain FP32 version's error against float64, as after 25
    if not max(errs[1][:2]) <= FUSED_TOL:
        raise AssertionError(f"{tag} disagrees: {fmt(errs[1])}")
    for n_iters in (1, 25):
        for ek, ep in zip(k64[n_iters], p64[n_iters]):
            if not ek <= ADMM_ERR_RATIO * ep:
                raise AssertionError(
                    f"{tag} is off after {n_iters} iterations: "
                    f"{fmt(k64[n_iters])} vs plain {fmt(p64[n_iters])}")
    # in: factors, eta, two static bound planes, collision bounds, and the
    # state (x, static z and y, collision z and y); out: the state
    rows = K * (12 * n_veh * 2 + 2 * P)
    io = factor_floats + K * (2 * P + 2 * 12 * n_veh + P) + 2 * (K * n + rows)
    stats = _stat(abs_err, fu_ms, fu_plain_ms,
                  f"N={n_veh} K={K} B={B}, 25 iterations", B * io * 4,
                  25 * B * 2 * 2 * factor_floats, stream)
    if needed_floats is not None:
        stats["nonzero_stream_bound_ms"] = (
            stream_ms * needed_floats / factor_floats)
    return stats


def large_phase(dev, n_veh):
    """N=30 or N=40, B=128: the NS chain (global-memory layout) and the
    fused X-form ADMM interval on its factors."""
    from ba_path_planning_torch.ops.admm_fused import (
        admm_interval_fused_X, admm_interval_fused_X_plain, fused_plan)
    D, C, _, _, kw = _case(n_veh, B_LARGE, dev, seed=n_veh)
    X, ns_stats = ns_check(n_veh, D, C, "large phase")
    del D
    kw["X"] = X
    n = 6 * n_veh
    plan = fused_plan(K_STEPS, n_veh, "X")
    # X_k is symmetric: its upper triangle, read once, serves both products
    # (the packed mode), so the second bound counts that triangle
    stats = fused_check(
        f"large phase: admm_interval_fused_X (ring of {plan.stages} stages "
        f"of {plan.band_rows} rows, packed={plan.packed})",
        admm_interval_fused_X,
        admm_interval_fused_X_plain, kw, n_veh, K_STEPS * n * n,
        needed_floats=K_STEPS * n * (n + 1) // 2)
    return {"ns_chain": ns_stats, "admm_fused_x": stats}


def lform_phase(dev, n_veh, B, dense=False, fused=False, l_only=True,
                n_steps=K_STEPS):
    """The L-form family on the factors of the reference-compatible solver
    (float32 block Cholesky on the card, as the path computes them) at
    ``n_steps`` steps: the L-only sweep (unless not ``l_only``); with
    ``dense`` the dense (Linv, Eb) sweep; with ``fused`` the L-form fused
    interval, whose penalty weight is this solver's +inf."""
    from ba_path_planning_torch.ops import admm_fused, banded_solve, group_solve
    from ba_path_planning_torch.solvers import banded
    D, C, b, b_admm, kw = _case(n_veh, B, dev, seed=1000 + n_veh + B,
                                solver=_facade_solver(), n_steps=n_steps)
    Linv, Eb = banded.factorize(D, banded.slot_dense(C, 2 * n_veh))
    del D
    K, n = n_steps, 6 * n_veh
    tag = f"L-form phase B={B} N={n_veh} K={K} f32"
    shape = f"N={n_veh} K={K} B={B}"
    out = {}
    if l_only:
        err, ms, plain_ms = _sweep_check(
            f"{tag}: solve_factorized_grouped_L ({_plan(b, 'L')})",
            group_solve.solve_factorized_grouped_L,
            group_solve.solve_factorized_grouped_L_plain, (Linv, C), b,
            b_admm)
        out["group_solve_l"] = _stat(
            err, ms, plain_ms, shape, B * K * (n * n + 2 * n) * 4,
            B * 4 * K * 2 * n * n, B * K * (2 * n * n + 2 * n) * 4)
        # the stream without the zero half of Linv
        out["group_solve_l"]["nonzero_stream_bound_ms"] = _bound_ms(
            B * K * (n * (n + 1) + 2 * n) * 4, B * 4 * K * n * (n + 1))[0]
    if dense:
        err, ms, plain_ms = _sweep_check(
            f"{tag}: solve_factorized_dense ({_plan(b, 'dense')})",
            banded_solve.solve_factorized_dense,
            banded_solve.solve_factorized_dense_plain, (Linv, Eb), b, b_admm)
        fl = (2 * K - 1) * n * n
        out["banded_solve"] = _stat(
            err, ms, plain_ms, shape, B * (fl + 2 * K * n) * 4,
            B * (4 * K - 2) * 2 * n * n, B * (2 * fl + 2 * K * n) * 4)
        # the stream without the zero half of Linv
        out["banded_solve"]["nonzero_stream_bound_ms"] = _bound_ms(
            B * (2 * (K * n * (n + 1) // 2 + (K - 1) * n * n) + 2 * K * n) * 4,
            B * (4 * K - 2) * 2 * n * n)[0]
    if fused:
        kw.update(Linv=Linv, Eb=Eb)
        del kw["C"]
        out["admm_fused_l"] = fused_check(
            "L-form phase: admm_interval_fused", admm_fused.admm_interval_fused,
            admm_fused.admm_interval_fused_plain, kw, n_veh,
            (2 * K - 1) * n * n,
            needed_floats=K * n * (n + 1) // 2 + (K - 1) * n * n)
    return out


def reference_phase(dev, n_veh, facade=False):
    """One SCP step of 8 lanes from the same phase-1 carry: the kernels on
    the card (f32) against the plain versions on the CPU (f32, and f64 for
    information).  Tolerance: one step's f32 accelerations move by 5e-4
    (relative) under 1e-7 input noise on the CPU, so 5e-3 leaves 10x.  That
    bar holds the card with FP32 products in the NS chain
    (``ns_precision="highest"``).  The production solver's "high" rounds
    the chain's products otherwise than FP32 does (three TF32 passes; a
    block is about 5e-6 from float64, no further than with FP32), and the
    step's 5000x amplification turns that into a difference of the size of
    FP32's own distance from float64; so "high" is held to float64 instead,
    and must be no further from it than the CPU f32 step is.  The kernel
    reads 0.49x and 0.32x of that limit at N=20 and N=30; a revision that
    let the tensor core sum the 8-deep steps in its truncating accumulator
    passed NS_TOL and read 2.9x and 2.6x, which this limit refuses.
    ``facade``: the reference-compatible problem and solver on the L-only
    sweep route instead of the production configuration; its QP runs until
    it converges, with the budget cut from 2000 to REF_FACADE_ITERS
    iterations to bound the CPU's share of the run, and equal per-lane
    iteration counts are asserted too."""
    import torch
    from ba_path_planning_torch.scenarios.generator import (
        generate_scenario_batch)
    from ba_path_planning_torch.solvers.banded import tree_map
    from ba_path_planning_torch.solvers.scp import SCPEngine
    from ba_path_planning_torch.utils.config import SolverConfig
    problem = _problem(n_veh, facade)
    solver = (_facade_solver(kernels=True, max_iter=REF_FACADE_ITERS)
              if facade else SolverConfig.production(problem=problem))
    sc = generate_scenario_batch(5, 8, n_vehicles=n_veh, min_distance=R,
                                 dtype=torch.float64, device="cpu")
    v0 = torch.zeros_like(sc.initial)
    args = (sc.initial, v0, sc.final, v0)
    engines = {"cpu64": SCPEngine(problem, solver, dtype=torch.float64,
                                  device="cpu"),
               "cpu32": SCPEngine(problem, solver, dtype=torch.float32,
                                  device="cpu"),
               "gpu32": SCPEngine(problem, solver, dtype=torch.float32,
                                  device=dev)}
    if not facade:
        engines["gpu32_fp32_chain"] = SCPEngine(
            problem, solver.replace(ns_precision="highest"),
            dtype=torch.float32, device=dev)
    carry = engines["cpu64"].start(*args)
    if facade:      # QPs of up to 2000 iterations: leave the float64 step out
        del engines["cpu64"]
    carry = carry._replace(feasible_initial=torch.zeros_like(
        carry.feasible_initial))              # make every lane step
    out = {}
    for key, eng in engines.items():
        c = tree_map(lambda t: t.to(eng.device, eng.dtype)
                      if t.is_floating_point() else t.to(eng.device), carry)
        out[key] = eng.step(c, *eng.as_inputs(*args),
                            torch.arange(8, device=eng.device), c.it + 1)

    def rel(a, ref):
        ref = ref.double().cpu()
        return float((a.double().cpu() - ref).abs().max()) / float(
            ref.abs().max())
    # the card with FP32 products everywhere, against the CPU in f32
    fp32_key = "gpu32" if facade else "gpu32_fp32_chain"
    err = rel(out[fp32_key].a, out["cpu32"].a)
    qp = {key: (c.qp_iters - carry.qp_iters.to(c.qp_iters.device)).tolist()
          for key, c in out.items()}
    ok = all(bool(torch.equal(out[key].stop.cpu(), out["cpu32"].stop))
             and qp[key] == qp["cpu32"]
             and bool(torch.isfinite(out[key].a).all())
             for key in out if key.startswith("gpu32"))
    line = (f"reference phase: one SCP step, 8 lanes, N={n_veh}, "
            f"{'reference-compatible' if facade else 'production'} solver: "
            f"card f32 (FP32 products) vs CPU f32 plain max_rel(a)={err:.3e} "
            f"(tol {REF_TOL:g}), equal stop flags and QP iterations={ok}; "
            f"QP iterations card {qp['gpu32']} CPU f32 {qp['cpu32']}")
    if not facade:
        high64 = rel(out["gpu32"].a, out["cpu64"].a)
        cpu64 = rel(out["cpu32"].a, out["cpu64"].a)
        line += (f"; against CPU f64: card f32 with ns_precision=high "
                 f"{high64:.3e}, card f32 with FP32 products "
                 f"{rel(out[fp32_key].a, out['cpu64'].a):.3e}, CPU f32 "
                 f"{cpu64:.3e} (limit for high: the CPU f32 figure; it reads "
                 f"{high64 / cpu64:.2f}x); high vs CPU f32 "
                 f"{rel(out['gpu32'].a, out['cpu32'].a):.3e}")
        ok = ok and high64 <= cpu64
    print(line, flush=True)
    if not (err <= REF_TOL and ok):
        raise AssertionError(f"card and CPU reference disagree: {err:.3e}")


def _production_route(n_veh):
    """The kernels of the production solver at N=n_veh, as the JAX router
    routes: grouped sweeps up to N=21, the fused interval above."""
    return ({"ns_chain", "admm_fused_x"} if n_veh >= 22
            else {"ns_chain", "group_solve_x"})


def main_path(dev, card, n_veh, B, chunk, counters, latency=False):
    """``solve_compacted`` over B scenarios at the bench.py configuration
    (``latency``: with ``SolverConfig.latency()``, three 9-iteration
    intervals with early exit, for the production solver); returns the
    launch counts of this path alone."""
    import numpy as np
    import torch
    from ba_path_planning_torch.models.double_integrator import (
        DoubleIntegrator2D)
    from ba_path_planning_torch.parallel.mesh import ShardedSCPSolver
    from ba_path_planning_torch.scenarios.generator import (
        generate_scenario_batch)
    from ba_path_planning_torch.utils.config import SolverConfig
    problem = _problem(n_veh)
    solver = (SolverConfig.latency() if latency
              else SolverConfig.production(problem=problem))
    sh = ShardedSCPSolver(problem, solver, dtype=torch.float32, device=dev)

    def scenarios(seed, n):
        sc = generate_scenario_batch(seed, n, n_vehicles=n_veh,
                                     min_distance=R, dtype=torch.float32,
                                     device=dev)
        if not bool(sc.ok.all()):
            raise AssertionError("scenario generation gave up on a lane")
        return sc.initial, sc.final

    # warm-up (library handles, allocator) on other scenarios
    p0, pf = scenarios(1, chunk)
    z = torch.zeros_like(p0)
    sh.solve_compacted(p0, z, pf, z, chunk=chunk)
    torch.cuda.synchronize()

    p0, pf = scenarios(100, B)
    v0 = torch.zeros_like(p0)
    torch.cuda.reset_peak_memory_stats(dev)
    _zero(counters)
    t0 = time.perf_counter()
    out = sh.solve_compacted(p0, v0, pf, v0, chunk=chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read(counters)

    K = problem.n_steps
    if tuple(out.positions.shape) != (B, n_veh, K, 2):
        raise AssertionError(f"positions shape {tuple(out.positions.shape)}")
    if not bool(torch.isfinite(out.positions).all()):
        raise AssertionError("non-finite positions")
    model = DoubleIntegrator2D(n_steps=K, time_step=H)
    pK, _ = model.terminal_state(out.positions, out.velocities,
                                 out.accelerations)
    goal_err = torch.linalg.vector_norm(pK - pf, dim=-1).amax(-1)
    ff = out.feasible_final
    ok = int((ff & (goal_err < 0.05)).sum())
    status = np.bincount(out.status.cpu().numpy(), minlength=3).tolist()
    print(f"main path{' (latency solver)' if latency else ''}: B={B} "
          f"chunk={chunk} N={n_veh} K={K} R={R} f32 on "
          f"{card}: wall={wall:.3f} s solves/s={ok / wall:.1f} "
          f"ok={ok}/{B} collision_free={int(ff.sum())} "
          f"goal<5cm={int((goal_err < 0.05).sum())} statuses={status} "
          f"mean_scp_iters={float(out.iterations.float().mean()):.3f} "
          f"mean_qp_iters={float(out.qp_iterations.float().mean()):.2f} "
          f"peak_mem={torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
          f"timing={json.dumps(sh.last_timing)} launches={launches}",
          flush=True)
    _check_route(f"N={n_veh} main path", launches, _production_route(n_veh))
    if ok < int(np.ceil(0.99 * B)):
        raise AssertionError(f"only {ok}/{B} collision-free and goal-exact")
    return launches


# route of the reference-compatible path -> (solver options, its kernel)
FACADE_ROUTES = {
    "grouped_L": (dict(kernels=True), "group_solve_l"),
    "resident": (dict(kernels=True, group=-1), "banded_solve"),
    "fused_L": (dict(kernels=True, group=-1, fused=True), "admm_fused_l"),
}


def facade_path(dev, card, route, counters):
    """The reference-compatible path on one kernel route: one
    ``SCPEngine.solve_batch`` over FACADE_B scenarios at N=20 with the
    ``SCP`` class's problem and solver (no device given: the engine runs on
    the card).  Returns the result and the launch counts of this path."""
    import numpy as np
    import torch
    from ba_path_planning_torch.scenarios.generator import (
        generate_scenario_batch)
    from ba_path_planning_torch.solvers.banded import qp_route
    from ba_path_planning_torch.solvers.scp import SCPEngine
    n_veh, B = 20, FACADE_B
    change, kernel = FACADE_ROUTES[route]
    problem, solver = _problem(n_veh, facade=True), _facade_solver(**change)
    took = qp_route(solver.static_part(), n_vehicles=n_veh, n_steps=K_STEPS,
                    dtype=torch.float32, col_enabled=True)
    if took != route:
        raise AssertionError(f"options {change} route {took}, not {route}")
    eng = SCPEngine(problem, solver, dtype=torch.float32)
    sc = generate_scenario_batch(100, B, n_vehicles=n_veh, min_distance=R,
                                 dtype=torch.float32)
    if eng.device.type != "cuda" or not sc.initial.is_cuda \
            or not bool(sc.ok.all()):
        raise AssertionError("the engine or its scenarios are not on the card")
    v0 = torch.zeros_like(sc.initial)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero(counters)
    t0 = time.perf_counter()
    out = eng.solve_batch(sc.initial, v0, sc.final, v0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read(counters)
    if tuple(out.positions.shape) != (B, n_veh, K_STEPS, 2):
        raise AssertionError(f"positions shape {tuple(out.positions.shape)}")
    if not all(bool(torch.isfinite(t).all()) for t in out
               if t.is_floating_point() and t is not out.rel_step):
        raise AssertionError("non-finite output")
    status = np.bincount(out.status.cpu().numpy(), minlength=3).tolist()
    print(f"reference-compatible path, route {route}: B={B} N={n_veh} "
          f"K={K_STEPS} R={R} f32 on {card}: wall={wall:.3f} s "
          f"statuses={status} "
          f"collision_free={int(out.feasible_final.sum())}/{B} "
          f"mean_scp_iters={float(out.iterations.float().mean()):.3f} "
          f"mean_qp_iters={float(out.qp_iterations.float().mean()):.1f} "
          f"max_qp_iters={int(out.qp_iterations.max())} "
          f"qp_converged_all={int(out.qp_converged_all.sum())}/{B} "
          f"peak_mem={torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
          f"launches={launches}", flush=True)
    _check_route(f"route {route}", launches, {kernel})
    return out, launches


def facade_call(counters):
    """One ``SCP(...).generate_trajectories()`` call, one scenario of N=20,
    through the single-scenario CLI with no device given (the card), the
    class's solver on its L-only sweep route.  Returns the launch counts."""
    import numpy as np
    from ba_path_planning_torch.cli import compute_trajectories
    from ba_path_planning_torch.solvers.scp import SCP
    planners = []
    solve = SCP.generate_trajectories

    def recording(self, *args, **kwargs):
        planners.append(self)
        return solve(self, *args, **kwargs)
    SCP.generate_trajectories = recording
    _zero(counters)
    try:
        rc = compute_trajectories.main(
            ["--n-vehicles", "20", "--time-horizon", str(T_HORIZON),
             "--no-viz", "--seed", "7"])
    finally:
        SCP.generate_trajectories = solve
    launches = _read(counters)
    if rc != 0 or len(planners) != 1:
        raise AssertionError(f"compute_trajectories exited {rc}")
    scp = planners[0]
    pos = scp.trajectories["positions"]
    if pos.shape != (20, K_STEPS, 2) or not np.isfinite(pos).all() \
            or scp._device.type != "cuda":
        raise AssertionError("the SCP class gave no trajectory on the card")
    _check_route("the SCP class", launches, {"group_solve_l"})
    print(f"SCP class (compute_trajectories CLI): status="
          f"{int(scp.result.status)} collision_free="
          f"{bool(scp.result.feasible_final)} qp_iters="
          f"{int(scp.result.qp_iterations)} launches={launches}", flush=True)
    return launches


def bench_phase(dev, counters):
    """The bench twin at the size of its ``main()``: at least 99% of the
    lanes ok, and the production route's kernels at N=20 (the NS chain and
    the X-form sweep) the only ones launched.  Returns the launch counts."""
    import re
    from ba_path_planning_torch import bench
    _zero(counters)
    line, summary = bench.measure(bench.headline_problem(), batch=bench.BATCH,
                                  chunk=bench.CHUNK, device=dev)
    launches = _read(counters)
    print(json.dumps(line), flush=True)
    print(summary, flush=True)
    print(f"bench twin launches={launches}", flush=True)
    ok, batch = map(int, re.search(r" ok=(\d+)/(\d+) ", summary).groups())
    if batch != bench.BATCH or ok < -(-99 * batch // 100):
        raise AssertionError(f"bench twin: only {ok}/{batch} ok")
    _check_route("the bench twin", launches, _production_route(20))
    return launches


def _batch_output(results_dir, ns, trials, min_success=None):
    """The schema-1.0 JSON and CSV of one batch CLI run in ``results_dir``;
    with ``min_success``, that share of each N's trials must succeed.
    Returns the JSON's rows."""
    import csv
    import math
    (js,), (cs,) = (sorted(results_dir.glob(f"scp_benchmark_*.{x}"))
                    for x in ("json", "csv"))
    doc = json.loads(js.read_text())
    meta = doc["meta"]
    if set(doc) != {"meta", "runs", "summary"} \
            or meta["schema_version"] != "1.0" \
            or meta["engine"] != "ba_path_planning_torch" \
            or meta["timing_mode"] != "per_scenario_iter_weighted" \
            or set(doc["summary"]) != {str(n) for n in ns}:
        raise AssertionError(f"{js.name}: not the batch CLI's schema")
    runs = doc["runs"]
    if len(runs) != len(ns) * trials \
            or any(list(r) != CLI_ROW_KEYS for r in runs) \
            or not all(math.isfinite(r["time_sec"]) and r["time_sec"] >= 0
                       for r in runs):
        raise AssertionError(f"{js.name}: rows are not the batch CLI's")
    with open(cs, newline="") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames != CLI_CSV_COLUMNS or len(list(reader)) != \
                len(runs):
            raise AssertionError(f"{cs.name}: not the batch CLI's CSV")
    for n in ns:
        rows = [r for r in runs if r["N"] == n]
        succ = sum(r["status"] == "success" for r in rows)
        ms = 1e3 * sum(r["time_sec"] for r in rows) / trials
        print(f"batch CLI {results_dir.name} N={n}: {succ}/{trials} success, "
              f"amortized {ms:.3f} ms/solve, mean SCP iterations "
              f"{sum(r['scp_iterations'] for r in rows) / trials:.3f}",
              flush=True)
        if min_success is not None and succ < math.ceil(min_success * trials):
            raise AssertionError(f"batch CLI N={n}: only {succ}/{trials} "
                                 "success")
    return runs


def batch_cli_phase(counters):
    """The batch CLI with no device given (the card), in a temporary
    directory: production at N=20 and 30, the same twice with
    ``--resume-dir``, and ``--solver reference`` at N=20.  Returns the
    launch counts, summed."""
    import tempfile
    from ba_path_planning_torch.cli import compute_trajectories_batch as cli
    total = {}

    def run(name, argv, route):
        _zero(counters)
        rc = cli.main(argv + ["--results-dir", str(tmp / name)])
        launches = _read(counters)
        print(f"batch CLI {name}: exit {rc} launches={launches}", flush=True)
        if rc != 0:
            raise AssertionError(f"batch CLI {name} exited {rc}")
        _check_route(f"batch CLI {name}", launches, route)
        for key, n in launches.items():
            total[key] = total.get(key, 0) + n

    prod = ["--ns", "20", "30", "--trials-per-n", str(CLI_TRIALS)]
    prod_route = _production_route(20) | _production_route(30)
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        run("production", prod, prod_route)
        straight = _batch_output(tmp / "production", (20, 30), CLI_TRIALS,
                                 min_success=0.99)
        resume = prod + ["--resume-dir", str(tmp / "checkpoints")]
        run("resumed", resume, prod_route)
        first = _batch_output(tmp / "resumed", (20, 30), CLI_TRIALS,
                              min_success=0.99)
        chunks = {c: c.stat().st_mtime_ns
                  for c in (tmp / "checkpoints").rglob("chunk_*.npz")}
        run("resumed_again", resume, set())
        again = _batch_output(tmp / "resumed_again", (20, 30), CLI_TRIALS)
        if not chunks or chunks != {
                c: c.stat().st_mtime_ns
                for c in (tmp / "checkpoints").rglob("chunk_*.npz")}:
            raise AssertionError("the resumed run saved a chunk again")
        if again != first:
            raise AssertionError("the resumed run gave other rows")
        same = sum(a["status"] == b["status"]
                   and a["scp_iterations"] == b["scp_iterations"]
                   for a, b in zip(first, straight))
        print(f"batch CLI: {len(chunks)} chunks saved once; the rerun gives "
              f"the same rows; status and SCP iterations as the run without "
              f"checkpoints on {same}/{len(first)} rows", flush=True)
        run("reference", ["--solver", "reference", "--ns", "20",
                          "--trials-per-n", str(CLI_REF_TRIALS)],
            _production_route(20))
        _batch_output(tmp / "reference", (20,), CLI_REF_TRIALS)
    return total


def facade_agreement(results):
    """The three routes compute the same algebra: hold them against each
    other, lane by lane."""
    import torch
    names = list(results)
    base = results[names[0]]
    for other in names[1:]:
        res = results[other]
        same = base.status == res.status
        same_it = same & (base.iterations == res.iterations)
        diff = (base.positions - res.positions).abs().flatten(1).amax(-1)
        print(f"routes {names[0]} vs {other}: equal status on "
              f"{int(same.sum())}/{same.numel()} lanes, equal status and SCP "
              f"iterations on {int(same_it.sum())}; max position difference "
              f"on those {float(diff[same_it].max()):.3e} m, on all lanes "
              f"{float(diff.max()):.3e} m (tol {ROUTE_TOL:g} m on "
              f"{ROUTE_SHARE:.0%} of lanes)", flush=True)
        close = same_it & (diff <= ROUTE_TOL)
        if int(close.sum()) < ROUTE_SHARE * same.numel():
            raise AssertionError(f"routes {names[0]} and {other} disagree")


def main():
    if not (ROOT / "ba_path_planning_torch").is_dir():
        raise SystemExit("chip_smoke.py: run it from a checkout of the repo")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; this script runs "
                         "only on a GPU")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = _card_line()
    print(f"device: {name}; nvidia-smi: {card}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    from ba_path_planning_torch.ops import (admm_fused, banded_solve,
                                            cuda_build, group_solve, ns_chain)

    t0 = time.perf_counter()
    cuda_build.load_kernels()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({cuda_build.build_info['path']})", flush=True)
    print("nvcc/ptxas:", " | ".join(
        ln.strip() for ln in cuda_build.build_info["log"].splitlines()
        if ln.endswith(".cu:") or "registers" in ln or "spill" in ln
        or "error" in ln), flush=True)

    t_phase = [time.perf_counter()]

    def lap(what):
        t_phase.append(time.perf_counter())
        print(f"[{what}: {t_phase[-1] - t_phase[-2]:.1f} s]", flush=True)

    # the N=20 main path's chunk of 512 and its tail chunk of 128 (each its
    # own sweep plan), and the clusters of a small batch
    kstats = kernel_phase(dev, 512)
    for B in (128, 64):
        kstats["group_solve_x"][f"ms_at_B{B}"] = (
            kernel_phase(dev, B)["group_solve_x"]["ms"])
    lstats = {n_veh: large_phase(dev, n_veh) for n_veh in (30, 40)}
    for key in ("ms", "bound_ms", "stream_bound_ms",
                "nonzero_stream_bound_ms"):
        lstats[40]["admm_fused_x"][f"{key}_at_N30"] = (
            lstats[30]["admm_fused_x"][key])
    small = lform_phase(dev, 20, FACADE_B, dense=True, fused=True)
    fstats = lform_phase(dev, 20, 512, dense=True)
    fstats.update(admm_fused_l=lform_phase(dev, 20, B_LARGE,
                                           fused=True)["admm_fused_l"])
    # the batches the reference-compatible paths below launch the kernels
    # at, the SCP class's B=1 among them
    single = lform_phase(dev, 20, 1, dense=True)
    for kname, at in (("admm_fused_l", small), ("group_solve_l", small),
                      ("banded_solve", small), ("group_solve_l", single),
                      ("banded_solve", single)):
        B = FACADE_B if at is small else 1
        for key in ("ms", "stream_bound_ms"):
            fstats[kname][f"{key}_at_B{B}"] = at[kname][key]
    for n_veh in (30, 40):
        lform_phase(dev, n_veh, B_LARGE)
    # the wide instantiation of the L-form fused interval (n = 540 > 512),
    # where the router sends short horizons
    lform_phase(dev, 90, 8, fused=True, l_only=False, n_steps=3)
    lap("kernel phases")
    for n_veh in (20, 30):
        reference_phase(dev, n_veh)
    reference_phase(dev, 20, facade=True)
    lap("reference phases")

    # the launch count of each wrapper, summed over the paths below; each
    # path sets the counts to 0 before it runs and reads them after
    counters = {"ns_chain": ns_chain.factorize_X_chain_batched,
                "group_solve_x": group_solve.solve_factorized_grouped_X,
                "admm_fused_x": admm_fused.admm_interval_fused_X,
                "group_solve_l": group_solve.solve_factorized_grouped_L,
                "banded_solve": banded_solve.solve_factorized_dense,
                "admm_fused_l": admm_fused.admm_interval_fused}
    launches = dict.fromkeys(counters, 0)

    def add(path_launches):
        for key, n in path_launches.items():
            launches[key] += n
    for n_veh, B, chunk in MAIN_PATHS:
        add(main_path(dev, card, n_veh, B, chunk, counters))
    add(main_path(dev, card, *MAIN_PATHS[0], counters, latency=True))
    lap("production main paths")
    results = {}
    for route in FACADE_ROUTES:
        results[route], path_launches = facade_path(dev, card, route,
                                                    counters)
        add(path_launches)
    facade_agreement(results)
    add(facade_call(counters))
    lap("reference-compatible paths")
    add(bench_phase(dev, counters))
    lap("bench twin")
    add(batch_cli_phase(counters))
    lap("batch CLI")

    pallas = "ba_path_planning_tpu/ops/pallas/"
    csrc = "ba_path_planning_torch/csrc/"
    # key -> (wrapper, source, Pallas bodies replaced, stats)
    rows = {
        "ns_chain": ("factorize_X_chain_batched", "ns_chain.cu",
                     ["ns_chain.py:105"], lstats[40]["ns_chain"]),
        "group_solve_x": ("solve_factorized_grouped_X", "group_solve_x.cu",
                          ["group_solve.py:424"], kstats["group_solve_x"]),
        "admm_fused_x": ("admm_interval_fused_X", "admm_fused_x.cu",
                         ["admm_fused.py:637", "admm_fused.py:432"],
                         lstats[40]["admm_fused_x"]),
        "group_solve_l": ("solve_factorized_grouped_L", "group_solve_l.cu",
                          ["group_solve.py:241"], fstats["group_solve_l"]),
        "banded_solve": ("solve_factorized_dense", "banded_solve.cu",
                         ["banded_solve.py:116", "banded_solve.py:30",
                          "group_solve.py:57"], fstats["banded_solve"]),
        "admm_fused_l": ("admm_interval_fused", "admm_fused_l.cu",
                         ["admm_fused.py:162"], fstats["admm_fused_l"]),
    }
    kernels = []
    for key, (wrapper, src, replaces, stats) in rows.items():
        entry = {"name": wrapper, "route": "cuda", "source": csrc + src,
                 "replaces": pallas + replaces[0], "launches": launches[key],
                 **stats}
        if len(replaces) > 1:
            entry["also_replaces"] = [pallas + r for r in replaces[1:]]
        if launches[key] < 1:
            raise AssertionError(f"no path launched {wrapper}")
        kernels.append(entry)
    print(f"chip_smoke wall: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}))


if __name__ == "__main__":
    main()
