#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. checks for a CUDA device and prints it, with the name and power limit
   that nvidia-smi reports, and the TF32 switches (both off);
2. builds the CUDA kernels from ``ba_path_planning_torch/csrc``;
3. kernel phases, each kernel against its plain PyTorch version on the card
   at the main path's shapes (K=50, f32), with the stated tolerance on the
   relative error of every (b, k) block, and CUDA-event times of both:
   the NS chain and the sweep at N=20 (B=64 and the chunk B=512); the NS
   chain at N=30 and N=40 (B=128, where it works out of global memory);
   the fused ADMM interval at N=30 and N=40 (B=128);
4. reference phases: one SCP step of 8 scenarios through the kernels on the
   card against the plain versions on the CPU, both float32, at N=20 and
   N=30;
5. main paths, each solved by ``solve_compacted`` from scenarios made from a
   seed, at the ``bench.py`` configuration (T=10, h=0.2, R=0.8, production
   solver): N=20 with 1024 scenarios in chunks of 512 (the grouped sweep
   route), N=30 and N=40 with 2048 scenarios in chunks of 128 (the fused
   route).  The launch counters are set to 0 just before each path and read
   just after: each path must launch the kernels of its route and no other,
   and at least 99% of its scenarios must be collision-free with goal error
   < 5 cm.

Any failed phase raises, so the exit code is not 0.  The last two lines are
one JSON object on the kernels and ``{"ok": true, "device": {...}}``.
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
NS_TOL, SWEEP_TOL, REF_TOL = 1e-4, 1e-5, 5e-3
FUSED_TOL = 2e-4                   # one fused iteration: x, z per block
ADMM_ERR_RATIO = 4.0


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


def _problem(n_veh):
    from ba_path_planning_torch.utils.config import ProblemConfig
    return ProblemConfig(n_vehicles=n_veh, time_horizon=T_HORIZON,
                         time_step=H, min_distance=R, max_iterations=15,
                         stop_mode="feasible", goal_project=True)


def _case(n_veh, B, dev, seed):
    """Main-path-shaped inputs of the kernels, float32 on the card: bounds
    of random start and goal positions, collision rows of random unit
    directions about the start positions (row 0 vacuous), the production
    rho pattern of ``n_veh`` vehicles, the diagonal blocks D and slot
    scalars C, a random right-hand side b, one at the scale the ADMM loop
    feeds, b_admm = A^T (rho * A x) for a random state x, and the arguments
    of ``admm_interval_fused_X`` but for the factors and its state."""
    import numpy as np
    import torch
    from ba_path_planning_torch.ops.collisions import (make_pair_index,
                                                       pairwise_diffs)
    from ba_path_planning_torch.solvers import banded
    from ba_path_planning_torch.solvers.scp import _warm_state
    from ba_path_planning_torch.utils.config import (SolverConfig,
                                                     make_solver_params)
    K, P, f32 = K_STEPS, n_veh * (n_veh - 1) // 2, torch.float32
    problem = _problem(n_veh)
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


def ns_check(n_veh, D, C, tag):
    """NS chain: kernel route (exact anchors + interior kernel) against the
    plain factorize_X, both on the card.  Returns (X, stats)."""
    import torch
    from ba_path_planning_torch.ops import ns_chain
    X = ns_chain.factorize_X_chain_batched(D, C, ns_iters=2)
    Xp = ns_chain.factorize_X_chain_plain(D, C, ns_iters=2)
    torch.cuda.synchronize()
    ns_abs = float((X - Xp).abs().max())
    ns_rel = _block_rel(X, Xp, 2)
    # against float64, where the chain's FP32 rounding shows
    X64 = ns_chain.factorize_X_chain_plain(D.double(), C.double(), ns_iters=2)
    k_err, p_err = _block_rel(X.double(), X64, 2), _block_rel(Xp.double(),
                                                              X64, 2)
    del X64
    ns_ms = _time_ms(
        lambda: ns_chain.factorize_X_chain_batched(D, C, ns_iters=2))
    ns_plain_ms = _time_ms(
        lambda: ns_chain.factorize_X_chain_plain(D, C, ns_iters=2))
    print(f"{tag}: factorize_X_chain_batched N={n_veh} B={D.shape[0]} "
          f"max_block_rel={ns_rel:.3e} (tol {NS_TOL:g}) max_abs={ns_abs:.3e}; "
          f"against float64: kernel {k_err:.3e}, plain f32 {p_err:.3e}; "
          f"kernel={ns_ms:.3f} ms plain={ns_plain_ms:.3f} ms", flush=True)
    if not ns_rel <= NS_TOL:
        raise AssertionError(f"NS chain kernel disagrees: {ns_rel:.3e}")
    return X, (ns_abs, ns_ms, ns_plain_ms)


def kernel_phase(dev, B):
    """N=20: the NS chain and the sweep kernel."""
    import torch
    from ba_path_planning_torch.ops import group_solve
    D, C, b, b_admm, _ = _case(20, B, dev, seed=B)
    X, ns_stats = ns_check(20, D, C, f"kernel phase B={B}")
    del D
    x = group_solve.solve_factorized_grouped_X(X, C, b)
    xp = group_solve.solve_factorized_grouped_X_plain(X, C, b)
    torch.cuda.synchronize()
    sw_abs = float((x - xp).abs().max())
    sw_rel = _block_rel(x, xp, 1)
    sw_ms = _time_ms(lambda: group_solve.solve_factorized_grouped_X(X, C, b),
                     reps=20)
    sw_plain_ms = _time_ms(
        lambda: group_solve.solve_factorized_grouped_X_plain(X, C, b), reps=5)
    # at the ADMM loop's scale the solve cancels ~2500x, so FP32 itself is
    # off by ~1e-5 there: hold the kernel to the plain FP32 version's error
    # against float64
    x64 = group_solve.solve_factorized_grouped_X_plain(
        X.double(), C.double(), b_admm.double())
    adm_err = _block_rel(group_solve.solve_factorized_grouped_X(
        X, C, b_admm).double(), x64, 1)
    adm_plain_err = _block_rel(group_solve.solve_factorized_grouped_X_plain(
        X, C, b_admm).double(), x64, 1)
    print(f"kernel phase B={B} N=20 K={K_STEPS} f32: "
          f"solve_factorized_grouped_X max_block_rel={sw_rel:.3e} "
          f"(tol {SWEEP_TOL:g}) "
          f"max_abs={sw_abs:.3e} kernel={sw_ms:.3f} ms "
          f"plain={sw_plain_ms:.3f} ms; ADMM-scale b against float64: "
          f"kernel max_block_rel={adm_err:.3e}, plain f32 "
          f"{adm_plain_err:.3e} (limit {ADMM_ERR_RATIO:g}x plain)", flush=True)
    if not sw_rel <= SWEEP_TOL:
        raise AssertionError(f"sweep kernel disagrees: {sw_rel:.3e}")
    if not adm_err <= ADMM_ERR_RATIO * adm_plain_err:
        raise AssertionError(f"sweep kernel is off at the ADMM scale: "
                             f"{adm_err:.3e} vs plain {adm_plain_err:.3e}")
    return {"ns_chain": ns_stats,
            "group_solve_x": (sw_abs, sw_ms, sw_plain_ms)}


def _rows(out):
    """(B, K, .) rows of an interval's (x, z, y): x stacked, and z and y as
    their static plane and collision rows side by side."""
    import torch
    from ba_path_planning_torch.ops.admm_fused import static_plane
    from ba_path_planning_torch.solvers.banded import to_stacked
    x, z, y = out

    def rows(rv):
        return torch.cat([static_plane(rv, K_STEPS).flatten(-2), rv.col], -1)
    return to_stacked(x), rows(z), rows(y)


def _interval_f64(kw, state, n_iters):
    """The plain interval in float64 on float32 inputs ``kw`` and state."""
    from ba_path_planning_torch.ops.admm_fused import (
        admm_interval_fused_X_plain)
    from ba_path_planning_torch.solvers.banded import tree_map

    def up(v):
        if isinstance(v, tuple):
            return tree_map(lambda t: t.double(), v)
        return v.double() if hasattr(v, "double") else v
    return admm_interval_fused_X_plain(
        **{k: up(v) for k, v in kw.items()}, **{k: up(v) for k, v in
                                                state.items()},
        n_iters=n_iters)


def large_phase(dev, n_veh):
    """N=30 or N=40, B=128: the NS chain (global-memory layout) and the
    fused ADMM interval on its factors.  The interval starts from a warm
    state, as an SCP iteration finds it: one float64 plain interval from x
    at rest, z = clip(A x, l, u) and y = 0."""
    import torch
    from ba_path_planning_torch.ops.admm_fused import (
        admm_interval_fused_X, admm_interval_fused_X_plain)
    from ba_path_planning_torch.solvers import banded
    D, C, _, _, kw = _case(n_veh, B_LARGE, dev, seed=n_veh)
    X, ns_stats = ns_check(n_veh, D, C, "large phase")
    del D
    kw["X"] = X
    x = kw.pop("x")
    z = banded.tree_map(torch.clamp,
                        banded.apply_A(x, kw["eta"], kw["E"], H),
                        kw["lower"], kw["upper"])
    warm = _interval_f64(kw, dict(x=x, z=z, y=banded.tree_map(
        torch.zeros_like, z)), 25)
    state = dict(zip("xzy", (banded.tree_map(lambda t: t.float(), v)
                             for v in warm)))
    errs, k64, p64 = {}, {}, {}
    for n_iters in (1, 25):
        got = _rows(admm_interval_fused_X(**kw, **state, n_iters=n_iters))
        want = _rows(admm_interval_fused_X_plain(**kw, **state,
                                                 n_iters=n_iters))
        ref = _rows(_interval_f64(kw, state, n_iters))
        torch.cuda.synchronize()
        errs[n_iters] = [_block_rel(g, w, 1) for g, w in zip(got, want)]
        k64[n_iters] = [_block_rel(g.double(), r, 1) for g, r in zip(got, ref)]
        p64[n_iters] = [_block_rel(w.double(), r, 1)
                        for w, r in zip(want, ref)]
        if n_iters == 1:
            abs_err = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
        del got, want, ref
    fu_ms = _time_ms(lambda: admm_interval_fused_X(**kw, **state, n_iters=25))
    fu_plain_ms = _time_ms(
        lambda: admm_interval_fused_X_plain(**kw, **state, n_iters=25),
        reps=2)
    n = 6 * n_veh
    gbs = 2 * K_STEPS * n * n * 4 * 25 * B_LARGE / (fu_ms * 1e-3) / 1e9

    def fmt(v):
        return "[" + ", ".join(f"{e:.3e}" for e in v) + "]"
    print(f"large phase: admm_interval_fused_X N={n_veh} B={B_LARGE} "
          f"K={K_STEPS} f32, block errors of (x, z, y) after 1 and 25 "
          f"iterations: against plain {fmt(errs[1])} (x, z tol "
          f"{FUSED_TOL:g}), max_abs={abs_err:.3e}; {fmt(errs[25])}; against "
          f"float64 kernel {fmt(k64[1])}, {fmt(k64[25])}, plain f32 "
          f"{fmt(p64[1])}, {fmt(p64[25])} (limit {ADMM_ERR_RATIO:g}x plain); "
          f"25 iterations: kernel={fu_ms:.3f} ms ({gbs:.0f} GB/s of factor "
          f"reads) plain={fu_plain_ms:.3f} ms", flush=True)
    # x and z agree to a few ulps' worth of the sweeps; y = y + rho (zr - z)
    # multiplies the rounding of zr by rho (up to ~5e3 on the equality rows),
    # so its blocks are FP32-limited even after one iteration and are held
    # to the plain FP32 version's error against float64, as after 25
    if not max(errs[1][:2]) <= FUSED_TOL:
        raise AssertionError(f"fused kernel disagrees: {fmt(errs[1])}")
    for n_iters in (1, 25):
        for ek, ep in zip(k64[n_iters], p64[n_iters]):
            if not ek <= ADMM_ERR_RATIO * ep:
                raise AssertionError(
                    f"fused kernel is off after {n_iters} iterations: "
                    f"{fmt(k64[n_iters])} vs plain {fmt(p64[n_iters])}")
    return {"ns_chain": ns_stats,
            "admm_fused_x": (abs_err, fu_ms, fu_plain_ms)}


def reference_phase(dev, n_veh):
    """One SCP step of 8 lanes from the same phase-1 carry: the kernels on
    the card (f32) against the plain versions on the CPU (f32, and f64 for
    information).  Tolerance: one step's f32 accelerations move by 5e-4
    (relative) under 1e-7 input noise on the CPU, so 5e-3 leaves 10x."""
    import torch
    from ba_path_planning_torch.scenarios.generator import (
        generate_scenario_batch)
    from ba_path_planning_torch.solvers.banded import tree_map
    from ba_path_planning_torch.solvers.scp import SCPEngine
    from ba_path_planning_torch.utils.config import SolverConfig
    problem = _problem(n_veh)
    solver = SolverConfig.production(problem=problem)
    sc = generate_scenario_batch(5, 8, n_vehicles=n_veh, min_distance=R,
                                 dtype=torch.float64)
    v0 = torch.zeros_like(sc.initial)
    args = (sc.initial, v0, sc.final, v0)
    engines = {"cpu64": SCPEngine(problem, solver, dtype=torch.float64),
               "cpu32": SCPEngine(problem, solver, dtype=torch.float32),
               "gpu32": SCPEngine(problem, solver, dtype=torch.float32,
                                  device=dev)}
    carry = engines["cpu64"].start(*args)
    carry = carry._replace(feasible_initial=torch.zeros_like(
        carry.feasible_initial))              # make every lane step
    out = {}
    for key, eng in engines.items():
        c = tree_map(lambda t: t.to(eng.device, eng.dtype)
                      if t.is_floating_point() else t.to(eng.device), carry)
        out[key] = eng.step(c, *eng.as_inputs(*args),
                            torch.arange(8, device=eng.device), c.it + 1)
    ref = out["cpu32"].a.double()

    def rel(a):
        return float((a.double().cpu() - ref).abs().max()) / float(
            ref.abs().max())
    err = rel(out["gpu32"].a)
    same_stop = bool(torch.equal(out["gpu32"].stop.cpu(), out["cpu32"].stop))
    print(f"reference phase: one SCP step, 8 lanes, N={n_veh}: card f32 vs "
          f"CPU f32 plain max_rel(a)={err:.3e} (tol {REF_TOL:g}), equal stop "
          f"flags={same_stop}; CPU f64 vs CPU f32 max_rel(a)="
          f"{rel(out['cpu64'].a):.3e}", flush=True)
    if not (err <= REF_TOL and same_stop
            and bool(torch.isfinite(out["gpu32"].a).all())):
        raise AssertionError(f"card and CPU reference disagree: {err:.3e}")


def main_path(dev, card, n_veh, B, chunk, counters):
    """``solve_compacted`` over B scenarios at the bench.py configuration;
    returns the launch counts of this path alone."""
    import numpy as np
    import torch
    from ba_path_planning_torch.models.double_integrator import (
        DoubleIntegrator2D)
    from ba_path_planning_torch.parallel.mesh import ShardedSCPSolver
    from ba_path_planning_torch.scenarios.generator import (
        generate_scenario_batch)
    from ba_path_planning_torch.utils.config import SolverConfig
    problem = _problem(n_veh)
    solver = SolverConfig.production(problem=problem)
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
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = sh.solve_compacted(p0, v0, pf, v0, chunk=chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {key: fn.launches for key, fn in counters.items()}

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
    print(f"main path: B={B} chunk={chunk} N={n_veh} K={K} R={R} f32 on "
          f"{card}: wall={wall:.3f} s solves/s={ok / wall:.1f} "
          f"ok={ok}/{B} collision_free={int(ff.sum())} "
          f"goal<5cm={int((goal_err < 0.05).sum())} statuses={status} "
          f"mean_scp_iters={float(out.iterations.float().mean()):.3f} "
          f"mean_qp_iters={float(out.qp_iterations.float().mean()):.2f} "
          f"peak_mem={torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
          f"timing={json.dumps(sh.last_timing)} launches={launches}",
          flush=True)
    # the route of the JAX router: grouped sweeps up to N=21, fused above
    route = ({"ns_chain", "admm_fused_x"} if n_veh >= 22
             else {"ns_chain", "group_solve_x"})
    for kname, n_launch in launches.items():
        if (n_launch > 0) != (kname in route):
            raise AssertionError(f"N={n_veh} main path launched {kname} "
                                 f"{n_launch} times; its route is {route}")
    if ok < int(np.ceil(0.99 * B)):
        raise AssertionError(f"only {ok}/{B} collision-free and goal-exact")
    return launches


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

    from ba_path_planning_torch.ops import (admm_fused, cuda_build,
                                            group_solve, ns_chain)

    t0 = time.perf_counter()
    cuda_build.load_kernels()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({cuda_build.build_info['path']})", flush=True)
    print("nvcc/ptxas:", " | ".join(
        ln.strip() for ln in cuda_build.build_info["log"].splitlines()
        if ln.endswith(".cu:") or "registers" in ln or "spill" in ln
        or "error" in ln), flush=True)

    kernel_phase(dev, 64)
    kstats = kernel_phase(dev, 512)
    lstats = {n_veh: large_phase(dev, n_veh) for n_veh in (30, 40)}
    for n_veh in (20, 30):
        reference_phase(dev, n_veh)

    counters = {"ns_chain": ns_chain.factorize_X_chain_batched,
                "group_solve_x": group_solve.solve_factorized_grouped_X,
                "admm_fused_x": admm_fused.admm_interval_fused_X}
    launches = dict.fromkeys(counters, 0)
    for n_veh, B, chunk in MAIN_PATHS:
        for key, n in main_path(dev, card, n_veh, B, chunk,
                                counters).items():
            launches[key] += n

    # (wrapper, source, Pallas body replaced, timed at, stats)
    rows = {
        "ns_chain": ("factorize_X_chain_batched",
                     "ba_path_planning_torch/csrc/ns_chain.cu",
                     "ba_path_planning_tpu/ops/pallas/ns_chain.py:105",
                     f"N=40 K=50 B={B_LARGE}", lstats[40]["ns_chain"]),
        "group_solve_x": ("solve_factorized_grouped_X",
                          "ba_path_planning_torch/csrc/group_solve_x.cu",
                          "ba_path_planning_tpu/ops/pallas/group_solve.py:424",
                          "N=20 K=50 B=512", kstats["group_solve_x"]),
        "admm_fused_x": ("admm_interval_fused_X",
                         "ba_path_planning_torch/csrc/admm_fused_x.cu",
                         "ba_path_planning_tpu/ops/pallas/admm_fused.py:637",
                         f"N=40 K=50 B={B_LARGE}, 25 iterations",
                         lstats[40]["admm_fused_x"]),
    }
    kernels = []
    for key, (wrapper, src, replaces, shape, stats) in rows.items():
        err, ms, plain_ms = stats
        kernels.append({"name": wrapper, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[key],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "timed_at": shape})
    kernels[-1]["also_replaces"] = \
        "ba_path_planning_tpu/ops/pallas/admm_fused.py:432"
    print(f"chip_smoke wall: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}))


if __name__ == "__main__":
    main()
