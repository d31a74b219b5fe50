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
   chain at N=30, 40, 50 and 60 (B=128, where its operands are streamed
   from global memory), each at ``ns_precision`` "high" (three TF32
   passes on the tensor cores, what the production solver runs, and its
   "default" too) and "highest" (FP32), with the kernel and the exact
   anchors timed apart;
   the fused ADMM interval at N=30, 40, 50 and 60 (B=128), with the bound
   of its whole blocks and of their upper triangles, and at the
   compaction's tail dispatch of B=32 on its wide tier; on the factors of the
   reference-compatible solver (rho 0.1,
   hard collision rows) the L-only sweep (its bounds count Linv's lower
   triangle, its stream of whole blocks beside them) and the dense
   (Linv, Eb) sweep at
   N=20 (B=64, 512 and 1, the ``SCP`` class's batch), the L-only sweep at
   N=30 and N=40 (B=128), the L-form fused interval at N=20 (B=64 and 128,
   penalty weight +inf) and its wide instantiation at K=3, N=90; the three
   sweeps print the launch plan they ran (``group_solve.sweep_plan``); both
   fused intervals again with one rho a lane (adaptive rho), read through
   their per-lane strides (the X form at N=30, B=128 and, on its wide tier,
   B=32, the L form at N=20, B=64); the grouped routes' kernels past
   N = 341 (``wide_kernel_phase``:
   the X-form sweep on its wide tier and the L-only sweep at N=342, B=2,
   and at N=1024, n=6144, B=1 with the horizon cut to K=6, and the NS
   chain at N=342, B=2 on its wide tier beside the plain factorize_X timed
   in the same run; before them the NS chain of one scenario at N=40 on
   its wide tier at both precisions; each line names the kernel's tier,
   one block a scenario, a cluster or the wide tier); the steps phase
   (``steps_phase``): the ADMM stages of
   ``ops/admm_steps.py``, admm_rhs and admm_update around the X-form sweep
   kernel (the grouped routes' iteration) at N=20 (B=512, 128, 64, 1),
   N=21 (B=128), N=10 (B=1024), N=200 (B=2, admm_rhs's direct form),
   N=342 (B=1) and N=1024 (B=1, K=6), and the collision-free channel
   interval (a random finite collision state, half its lower bounds
   finite) at N=20 (B=1024, 512, 132, 8, 64, 1), N=21 (B=128), N=10
   (B=1024) and N=40 (B=2048), each also with one rho a lane (B=64),
   against their plain versions after 1 and 25 iterations; each stage
   timed alone at each shape (admm_rhs and admm_update: device time under
   the profiler and CUDA events, beside the bound and the plan, admm_rhs's
   table or direct form), the channel interval beside its bound on
   the collision-free count and on the count with eta's pair terms; the
   device launches per ADMM iteration of one grouped X interval (at most
   4); the assemble phase (``assemble_phase``): the QP's diagonal blocks D
   by the one-pass kernel of ``ops/assemble_d.py`` against the plain
   ``banded.assemble_D`` at N=20 (B=512, 128, 1), N=40 (B=128, 32),
   N=342 (B=2), N=1024 (K=6, B=1) and N=268 (K=9, B=1), timed in turns
   beside the bound of D written once;
4. reference phases: one SCP step of 8 scenarios through the kernels on the
   card against the plain versions on the CPU, both float32, at N=20 and
   N=30 with the production solver and at N=20 with the
   reference-compatible solver on its L-only sweep route;
5. main paths, each solved by ``solve_compacted`` from scenarios made from a
   seed, at the ``bench.py`` configuration (T=10, h=0.2, R=0.8, production
   solver): N=20 with 1024 scenarios in chunks of 512 (the grouped sweep
   route), N=30 and N=40 with 2048 scenarios in chunks of 128 (the fused
   route), and N=20 once more with ``SolverConfig.latency()`` (early-exit
   intervals on the grouped sweep route) and once with
   ``ns_precision="default"`` (the three-pass NS kernel serves it).  At
   least 99% of a path's scenarios must be collision-free with goal error
   < 5 cm.  Then the soak / N-sweep twin
   (``scripts/torch_soak_nsweep.py:run_cfg``) at N=50 and N=60 with its
   batch cut to 256, chunk 128 (the fused route; counts printed, not
   barred); then the wide phase (``wide_phase``), the grouped routes at
   N=342, K=50 on 2 lanes: ``solve_qp_state`` with the production solver
   on ``grouped_X`` and with the ``SCP`` class's solver on ``grouped_L``
   (its QP budget cut to 50), each
   against the same call on the "graph" interval (``admm_iterations``
   around the same sweep kernel), and one ``solve_compacted`` with its
   SCP loop cut to 2 iterations from a lattice of starts (finite
   trajectories, three launches an ADMM iteration; feasibility printed);
   then the short-horizon phase (``short_phase``), where the router sends
   large fleets to the fused X interval: the kernel's wide tier against
   its plain version at N=584, K=2 (n=3504) and N=341, K=6 (B=2) and at
   N=268, K=9 (B=1), bit for bit across launches and against the
   one-block tier, both tiers timed in turns beside the whole blocks'
   stream bound, and one production ``solve_qp_state`` at N=341, K=6,
   B=2 on ``fused_X`` (the wide tier) against the same call on the plain
   interval;
6. the reference-compatible path at N=20: ``SCPEngine.solve_batch`` over
   FACADE_B scenarios with the ``SCP`` class's solver (L-form factors, hard
   collision rows, up to 2000 ADMM iterations per QP in intervals of 25,
   ``stop_mode="reference"``), once per kernel route (L-only sweeps, dense
   sweeps, L-form fused interval), the routes held against each other, and
   two ``SCP(...).generate_trajectories()`` calls through the
   single-scenario CLI (``cli/compute_trajectories.py --no-viz``): N=20 at
   T=10, and the CLI's own defaults, N=10 at T=100 (K=500);
7. the entry points: the bench twin ``ba_path_planning_torch.bench`` at its
   own size (N=20, B=4096, chunk 512; its JSON line and summary are printed;
   at least 99% of the lanes ok), and the batch CLI
   (``cli/compute_trajectories_batch.py``): production at N=20 and N=30 with
   256 trials each, the same with ``--resume-dir`` twice (the second run
   solves nothing and gives the same rows), and ``--solver reference`` at
   N=20 with 64 trials; the schema-1.0 JSON and CSV are checked, and at
   least 99% of each production N must succeed;
8. the adaptive-rho paths: ``solve_compacted`` with
   ``SolverConfig.production().replace(adaptive_rho=True, polish=True,
   max_iter=100)`` at N=20 (1024 scenarios, chunk 512, the grouped sweep
   route) and N=30 (256 scenarios, chunk 128, the fused X route), at least
   99% ok, and the reference-compatible solver with adaptive rho on its
   fused L route (64 scenarios at N=20);
9. the parity phase: the certified oracle trajectories of
   ``docs/parity_oracle_cache`` (N=20 and N=18) reproduced in float64 by
   the parity configuration of ``scripts/parity_full.py`` (the direct
   method to 1e-6 with the exact polish, the dense route): equal SCP
   iteration counts, positions and velocities within 1e-3;
10. the CG phase: ``SCPEngine(problem)`` with the default
   ``SolverConfig()`` (the CG method, adaptive rho, its polish) at N=20 on
   CG_B scenarios in float32 and in float64, the SCP loop cut to one
   iteration: valid statuses, equal on at least 90% of the lanes, and no
   hand-written kernel launched;
11. the bf16 kernel phase (``SolverConfig.factor_dtype="bf16"``): the four
   factor-streaming kernels on factors stored in bf16
   (``banded.compress_factors``, rows on a stride of 8 elements), each
   against its plain version on the same bf16 factors with the tolerances
   of the float32 checks and timed beside its float32 self (the ratio
   printed), its bound and stream bound at 2 bytes an element at every
   shape: the three sweeps at N=20 (B=512, 64, 1), N=21 and N=30 (B=128,
   padded rows), the L-form fused interval at N=20 (B=128, 64); first,
   ptxas's registers and spills of the instantiations of the L-form and
   dense sweeps and of the L-form fused interval, f32 and bf16, from the
   build log;
12. the bf16 paths: production with bf16 factors at N=20 (1024 scenarios,
   chunk 512, the grouped X route; at least 99% ok, printed beside the f32
   path), and the ``SCP`` class's solver in bf16 on its three kernel
   routes (B=64, the SCP loop cut to BF16_FACADE_SCP), printed beside the
   f32 routes;
13. the parallel phase: two ranks share the card over gloo on CUDA tensors
   (``parallel_phase``): the scenario-parallel ``solve_compacted``, the
   pair-sharded solve and ``rollout_ksharded``, each against its one-rank
   counterpart; a rank that fails or outlasts PARALLEL_TIMEOUT fails the
   run;
14. the modules phase (``modules_phase``): ``train-network`` at its defaults
   (8192 N=10 scenarios labelled by phase 1 on the card, the first 512 also
   on the CPU, 30 epochs; the rates held to the JAX runs of
   ``scripts/collision_net_jax_reference.py``; the npz reloaded), the
   solve and profile of ``plot-collisions`` at its defaults and the N=20
   main path's profile on the card against the CPU, the sanitizer
   (``utils/debug.checked``) on a clean and a poisoned N=20 solve and
   ``find_nan_lanes`` on a batch with one NaN lane, ``profiling.trace`` of
   an N=20 B=1024 solve (the file names the kernels) with the cost models
   beside the kernel phases, ``chol_inv`` and ``factorize_matmul`` against
   cuSOLVER (times of both), and ``NativeQP`` built by g++ against
   ``solve_qp`` on the card in float64.

The launch counters are set to 0 just before each path and read just after:
each path must launch the kernels of its route and no other (every
float32 solve on the direct method also runs phase 1 on the channel
interval; the fused X interval's wide tier counts apart, and a path
launches it where a dispatch's batch takes it; every route's QP but phase
1's assembles D in one launch, once a dispatch on the main paths).  Any
failed phase raises,
so the exit code is not 0.  The last four lines are the card's name and power limit, one JSON object on the
hand-written kernels with no Pallas body (``glue_kernels``), one on the
kernels of the nine Pallas bodies and ``{"ok": true, "device": {...}}``.
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
B_LARGE = 128                      # kernel phases at N=30..60: one chunk
B_TAIL = B_LARGE // 4              # and the compaction's tail dispatch of it
LARGE_NS = (30, 40, 50, 60)        # the fused route's widths in those phases
FACADE_B = 64                      # scenarios of the reference-compatible path
REF_FACADE_ITERS = 500             # QP budget of its reference phase
# the card's peaks (H100 SXM data sheet, dense): read in main() from the
# port's one copy, ``utils/profiling.py``, once the checkout is found
HBM_BYTES_S = FP32_FLOP_S = TF32_FLOP_S = None
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
# the adaptive-rho paths (N, scenarios, chunk) and the CG phase's lanes
ADAPTIVE_PATHS = ((20, 1024, 512), (30, 256, 128))
# the CG phase's lanes and SCP depth: phase 1 and one linearized QP a lane
# (a QP runs up to 4000 ADMM iterations of about 6 ms each on the card)
CG_B, CG_SCP_ITERATIONS = 16, 1


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


def _device_us(e):
    """Device time of a ``torch.profiler`` average, us (the attribute's
    name differs between versions)."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def _device_ms(fn, reps: int = 20):
    """Device time of one call of ``fn``: its kernels' time under
    ``torch.profiler`` over ``reps`` calls (after a warm-up call), divided
    by ``reps``, without the host's launch cost that CUDA events over
    back-to-back calls include; "not measured" where the profiler records
    no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(_device_us(e) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / reps if us else "not measured"


def _zero(counters):
    for fn in counters.values():
        fn.launches = 0


def _read(counters):
    return {key: fn.launches for key, fn in counters.items()}


def _check_route(what, launches, route, maybe=frozenset()):
    """Each kernel of ``route`` launched, no other (those of ``maybe`` may
    launch or not)."""
    for kname, n_launch in launches.items():
        if kname not in maybe and (n_launch > 0) != (kname in route):
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


def _bound_ms(n_bytes, n_flops, flop_s=None):
    """The least time the card could take: the bytes over the memory rate
    or the operations over the peak rate of the unit that executes them
    (the FP32 rate unless ``flop_s`` says otherwise), whichever is larger."""
    flop_s = flop_s or FP32_FLOP_S
    t_b, t_f = n_bytes / HBM_BYTES_S * 1e3, n_flops / flop_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def _case(n_veh, B, dev, seed, solver=None, n_steps=K_STEPS, lane_rho=None):
    """Main-path-shaped inputs of the kernels (``n_steps`` steps), float32
    on the card: bounds
    of random start and goal positions, collision rows of random unit
    directions about the start positions (row 0 vacuous), the rho pattern of
    ``solver`` (default: production for ``n_veh`` vehicles), the diagonal
    blocks D and slot scalars C, a random right-hand side b, one at the
    scale the ADMM loop feeds, b_admm = A^T (rho * A x) for a random state
    x, and the arguments of the fused-interval wrappers but for the factors
    and the state.  ``lane_rho`` (B,) gives each lane its own rho (adaptive
    rho): rho leaves and slot scalars C a lane."""
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
        solver.static_part(), prm.rho if lane_rho is None else lane_rho,
        prm.col_rho_boost, n_steps=K, n_pairs=P, col_enabled=True, dtype=f32)
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
          library_ms=None, flop_s=None):
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
    from ba_path_planning_torch.utils.profiling import (
        ns_chain_interior_flops)
    B, K, n = D.shape[:3]
    # interior steps 3..K-2, 2 Newton-Schulz iterations, the update's
    # upper triangle
    flops = ns_chain_interior_flops(B, K, n)
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
              f"N={n_veh} B={B} ({_ns_tier(B, n)}) "
              f"max_block_rel={ns_rel:.3e} (tol {NS_TOL:g}) "
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
            fp32_bound_ms=fp32_bound, tier=_ns_tier(B, n))
    out["high"][1]["fp32_kernel_ms"] = out["highest"][1]["kernel_ms"]
    out["high"][1]["fp32_route_ms"] = out["highest"][1]["ms"]
    return out["high"]


def _sweep_check(tag, kernel, plain, factors, b, b_admm, reps=20):
    """A sweep kernel against its plain version on the card: every (b, k)
    block within SWEEP_TOL on a random right-hand side; on one at the ADMM
    loop's scale, where the solve cancels ~2500x and FP32 itself is off by
    ~1e-5, within ADMM_ERR_RATIO of the plain FP32 version's error against
    float64.  The kernel is timed over ``reps`` calls.  Returns (max abs
    error, kernel ms, plain ms)."""
    import torch
    x, xp = kernel(*factors, b), plain(*factors, b)
    torch.cuda.synchronize()
    sw_abs, sw_rel = float((x - xp).abs().max()), _block_rel(x, xp, 1)
    sw_ms = _time_ms(lambda: kernel(*factors, b), reps=reps)
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
            "group_solve_x": dict(_stat(
                sw_abs, sw_ms, sw_plain_ms, f"N=20 K={K_STEPS} B={B}",
                B * K_STEPS * (n * n + 2 * n) * 4, B * 2 * K_STEPS * 2 * n * n,
                B * K_STEPS * (2 * n * n + 2 * n) * 4),
                tier=_sweep_tier(b.shape, "X"))}


# (N, B, K) of the wide kernel checks: the grouped routes past N = 341, the
# production QP's N=342 at the wide path's batch and N=1024 (n=6144, the
# widest the sweeps serve) with its horizon cut to K=6 (WIDE_STEP_SHAPES)
WIDE_KERNEL_SHAPES = ((342, 2, K_STEPS), (1024, 1, 6))
WIDE_X_REPS = 10        # timed calls of each sweep there and of the NS chain
# (N, B) of the NS chain's check of one scenario at the top of the
# production envelope, which its wide tier takes in tiles of 64
NS_SMALL = (40, 1)


def _ns_tier(B, n):
    """The NS chain's tier for B scenarios of n x n blocks, in words."""
    from ba_path_planning_torch.ops.ns_chain import ns_chain_plan
    plan = ns_chain_plan(B, n)
    if not plan.tile:
        return "one block a scenario"
    return (f"wide, tiles of {plan.tile} ({plan.tiles} and "
            f"{plan.upper_tiles} blocks a scenario a product)")


def _sweep_tier(shape, form, esize=4):
    """The sweep kernel's tier for right-hand sides of ``shape`` (B, K, n)
    and factors of ``esize`` bytes an element, in words."""
    from ba_path_planning_torch.ops.group_solve import sweep_plan
    plan = sweep_plan(*shape, form, esize=esize)
    if plan.spread:
        return (f"wide, {plan.spread} blocks a scenario, {plan.per_sm} an "
                "SM")
    return f"cluster of {plan.cluster}"


def wide_kernel_phase(dev):
    """The kernels of the grouped routes at WIDE_KERNEL_SHAPES, each
    against its plain version as at N=20: the X-form sweep on the plain
    NS factors (cuBLAS; its wide tier) and the L-only sweep on the block
    Cholesky factors of the ``SCP`` class's solver (float32 and bf16), each
    timed over WIDE_X_REPS calls beside its plain version and its stream
    bound; at N=342 also the NS
    chain's tensor-core route (its ``"high"``, the production solver's;
    its wide tier) against the plain chain, each timed
    over WIDE_X_REPS calls in the same run, the plain factorize_X being
    the one library call of the same function.  First the NS chain of one
    scenario at N=40 (NS_SMALL; the wide tier in tiles of 64) at both
    precisions (:func:`ns_check`).  Each line names the kernel's tier.
    Returns {kernel: {shape: its numbers}}."""
    import torch
    from ba_path_planning_torch.ops import group_solve, ns_chain
    from ba_path_planning_torch.utils.profiling import (
        ns_chain_interior_flops)
    out = {"ns_chain": {}, "group_solve_x": {}, "group_solve_l": {}}
    n_veh, B = NS_SMALL
    D, C = _case(n_veh, B, dev, seed=400 + n_veh)[:2]
    _, st = ns_check(n_veh, D, C, "wide kernel phase")
    out["ns_chain"][f"N={n_veh} K={K_STEPS} B={B}"] = dict(
        st, tier=_ns_tier(B, 6 * n_veh))
    del D, C
    for n_veh, B, K in WIDE_KERNEL_SHAPES:
        shape, n = f"N={n_veh} K={K} B={B}", 6 * n_veh
        D, C, b, b_admm, _ = _case(n_veh, B, dev, seed=B + n_veh, n_steps=K)
        Xp = ns_chain.factorize_X_chain_plain(D, C, ns_iters=2)
        if n_veh == WIDE_N:
            def route():
                return ns_chain.factorize_X_chain_batched(
                    D, C, ns_iters=2, ns_precision="high")
            X = route()
            torch.cuda.synchronize()
            err = _block_rel(X, Xp, 2)
            ms = _time_ms(route, reps=WIDE_X_REPS)
            head = ns_chain.anchor_head(D, C)
            kernel_ms = _time_ms(lambda: ns_chain.chain_interior(
                D, C, head, ns_iters=2, ns_precision="high"),
                reps=WIDE_X_REPS)
            del head
            plain_ms = _time_ms(lambda: ns_chain.factorize_X_chain_plain(
                D, C, ns_iters=2), reps=WIDE_X_REPS)
            flops = ns_chain_interior_flops(B, K, n)
            st = _stat(float((X - Xp).abs().max()), ms, plain_ms, shape,
                       2 * B * K * n * n * 4, 3 * flops,
                       2 * B * K * n * n * 4, library_ms=plain_ms,
                       flop_s=TF32_FLOP_S)
            st.update(kernel_ms=kernel_ms, tier=_ns_tier(B, n))
            out["ns_chain"][shape] = st
            print(f"wide kernel phase: factorize_X_chain_batched "
                  f"ns_precision=high N={n_veh} K={K} B={B} on the "
                  f"{st['tier']}: {ms:.3f} ms a call (anchors included; "
                  f"kernel {kernel_ms:.3f} ms), library factorize_X "
                  f"{plain_ms:.3f} ms in the same run (the kernel route "
                  f"{'faster' if ms < plain_ms else 'slower'}); "
                  f"max_block_rel={err:.3e} (tol {NS_TOL:g}); bound "
                  f"{st['bound_ms']:.3f} ms (three TF32 passes; "
                  f"{st['bound_ms'] / ms:.2%} of the route, "
                  f"{st['bound_ms'] / kernel_ms:.2%} of the kernel)",
                  flush=True)
            if not err <= NS_TOL:
                raise AssertionError(f"NS chain at N={n_veh} disagrees: "
                                     f"{err:.3e}")
            del X
        del D
        err, ms, sw_plain_ms = _sweep_check(
            f"wide kernel phase B={B} N={n_veh} K={K} f32: "
            f"solve_factorized_grouped_X ({_plan(b, 'X')})",
            group_solve.solve_factorized_grouped_X,
            group_solve.solve_factorized_grouped_X_plain, (Xp, C), b, b_admm,
            reps=WIDE_X_REPS)
        st = _stat(err, ms, sw_plain_ms, shape, B * K * (n * n + 2 * n) * 4,
                   B * 2 * K * 2 * n * n, B * K * (2 * n * n + 2 * n) * 4)
        st["tier"] = _sweep_tier(b.shape, "X")
        out["group_solve_x"][shape] = st
        print(f"wide kernel phase: solve_factorized_grouped_X N={n_veh} "
              f"K={K} B={B} on the {st['tier']}: {ms:.3f} ms, stream bound "
              f"{st['stream_bound_ms']:.3f} ms "
              f"({st['stream_bound_ms'] / ms:.1%}), plain {sw_plain_ms:.3f} "
              f"ms", flush=True)
        del Xp, b, b_admm
        lst = lform_phase(dev, n_veh, B, n_steps=K, reps=WIDE_X_REPS,
                          bf16=True)
        for key, esize in (("group_solve_l", 4), ("group_solve_l_bf16", 2)):
            st = dict(lst[key], tier=_sweep_tier((B, K, n), "L", esize))
            out.setdefault(key, {})[shape] = st
            ms, plain_ms = st["ms"], st["plain_ms"]
            whole = st["whole_block_stream_bound_ms"]
            print(f"wide kernel phase: solve_factorized_grouped_L N={n_veh} "
                  f"K={K} B={B} {'bf16' if esize == 2 else 'f32'} on the "
                  f"{st['tier']}: {ms:.3f} ms, stream bound of Linv's lower "
                  f"triangle {st['stream_bound_ms']:.3f} ms "
                  f"({st['stream_bound_ms'] / ms:.1%}; whole blocks "
                  f"{whole:.3f} ms, {whole / ms:.1%}), plain {plain_ms:.3f} "
                  f"ms in the same run (the kernel "
                  f"{'faster' if ms < plain_ms else 'slower'})", flush=True)
    for at in out.values():
        for st in at.values():
            st.pop("timed_at", None)
    return out


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
                needed_floats=None, factor_bytes=4, stream_floats=None):
    """A fused ADMM-interval kernel against its plain version on the
    arguments ``kw`` (factors included; ``factor_floats`` is their size per
    scenario in elements of ``factor_bytes`` bytes, ``needed_floats`` what
    of it has to be read, where that is less: Linv without its zero half,
    X as its upper triangle; ``stream_floats`` the elements a scenario
    streams an iteration, by default twice ``factor_floats``: the X form's
    sweeps apply 2K - 1 blocks).  The
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
    if stream_floats is None:
        stream_floats = 2 * factor_floats
    stream = 25 * B * stream_floats * factor_bytes
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
    io = (factor_floats * factor_bytes
          + 4 * (K * (2 * P + 2 * 12 * n_veh + P) + 2 * (K * n + rows)))
    stats = _stat(abs_err, fu_ms, fu_plain_ms,
                  f"N={n_veh} K={K} B={B}, 25 iterations", B * io,
                  25 * B * 2 * stream_floats, stream)
    if needed_floats is not None:
        stats["nonzero_stream_bound_ms"] = (
            stream_ms * needed_floats / factor_floats)
    return stats


def _lane_rho(B, seed):
    """One rho a lane (adaptive rho), spread over two decades around the
    production rho, float32 on the card."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return torch.as_tensor(2.6 * np.exp(rng.uniform(-2.3, 2.3, B)),
                           dtype=torch.float32, device="cuda")


def _wide_x_plan(dev, B, n_veh, tag):
    """The fused X interval's plan for B scenarios at N=n_veh, K=50 on this
    card, which must be its wide tier."""
    from ba_path_planning_torch.ops.admm_fused import fused_x_plan
    from ba_path_planning_torch.ops.cuda_build import device_sms
    plan = fused_x_plan(B, K_STEPS, n_veh, sms=device_sms(dev))
    if not plan.spread:
        raise AssertionError(f"{tag}: N={n_veh} B={B} off the wide tier: "
                             f"{plan}")
    return plan


def large_phase(dev, n_veh):
    """N=30 … 60, B=128: the NS chain (global-memory layout) and the
    fused X-form ADMM interval on its factors; then the interval at the
    compaction's tail dispatch of B=32 lanes (other scenarios), on the
    wide tier its plan takes there."""
    from ba_path_planning_torch.ops import ns_chain
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
    del kw, X
    D, C, _, _, kw = _case(n_veh, B_TAIL, dev, seed=1000 + n_veh)
    kw["X"] = ns_chain.factorize_X_chain_batched(D, C, ns_iters=2,
                                                 ns_precision="high")
    del D
    plan = _wide_x_plan(dev, B_TAIL, n_veh, "large phase")
    # the wide tier reads whole rows of every block, 2K - 1 a sweep
    wide = fused_check(
        f"large phase: admm_interval_fused_X on the wide tier "
        f"({plan.spread} blocks a scenario, {plan.per_sm} an SM, a ring of "
        f"{plan.stages} stages of {plan.band_rows} rows)",
        admm_interval_fused_X, admm_interval_fused_X_plain, kw, n_veh,
        K_STEPS * n * n, stream_floats=(2 * K_STEPS - 1) * n * n)
    wide["plan"] = plan._asdict()
    return {"ns_chain": ns_stats, "admm_fused_x": stats,
            "admm_fused_x_wide": wide}


def lane_rho_phase(dev):
    """Both fused intervals with one rho a lane, read through their
    per-lane strides: the X form at N=30, B=128 (the adaptive N=30 path's
    chunk; per-lane rho planes and slot scalars, its factors those of
    M / rho scaled back, as the solver makes them) and at its tail
    dispatch of B=32 (the wide tier), and the L form at N=20, B=64 (the
    reference-compatible path's batch), each against its plain version and
    the float64 interval as :func:`fused_check` holds them."""
    from ba_path_planning_torch.ops import admm_fused, ns_chain
    from ba_path_planning_torch.solvers import banded
    from ba_path_planning_torch.utils.config import SolverConfig
    out = {}
    n_veh = 30
    n = 6 * n_veh
    C1 = banded.unit_slot_scalars(
        SolverConfig.production(problem=_problem(n_veh)).static_part(),
        n_steps=K_STEPS, h=H, device=dev)

    def case(B, seed):
        lane_rho = _lane_rho(B, seed=seed)
        D, C, _, _, kw = _case(n_veh, B, dev, seed=seed, lane_rho=lane_rho)
        scale = lane_rho.reshape(-1, 1, 1, 1)
        kw["X"] = ns_chain.factorize_X_chain_batched(
            D / scale, C1, ns_iters=2, ns_precision="high") / scale
        return kw
    out["admm_fused_x"] = fused_check(
        "lane-rho phase: admm_interval_fused_X, one rho a lane",
        admm_fused.admm_interval_fused_X,
        admm_fused.admm_interval_fused_X_plain, case(B_LARGE, n_veh), n_veh, K_STEPS * n * n,
        needed_floats=K_STEPS * n * (n + 1) // 2)
    plan = _wide_x_plan(dev, B_TAIL, n_veh, "lane-rho phase")
    out["admm_fused_x_wide"] = fused_check(
        f"lane-rho phase: admm_interval_fused_X on the wide tier "
        f"({plan.spread} blocks a scenario), one rho a lane",
        admm_fused.admm_interval_fused_X,
        admm_fused.admm_interval_fused_X_plain, case(B_TAIL, 1000 + n_veh), n_veh, K_STEPS * n * n,
        stream_floats=(2 * K_STEPS - 1) * n * n)
    out["admm_fused_x_wide"]["plan"] = plan._asdict()
    n_veh, B = 20, FACADE_B
    lane_rho = _lane_rho(B, seed=n_veh) / 26.0       # around the facade's 0.1
    D, C, _, _, kw = _case(n_veh, B, dev, seed=1000 + n_veh + B,
                           solver=_facade_solver(), lane_rho=lane_rho)
    kw["Linv"], kw["Eb"] = banded.factorize(D, banded.slot_dense(C,
                                                                 2 * n_veh))
    del D, kw["C"]
    n = 6 * n_veh
    out["admm_fused_l"] = fused_check(
        "lane-rho phase: admm_interval_fused, one rho a lane",
        admm_fused.admm_interval_fused, admm_fused.admm_interval_fused_plain,
        kw, n_veh, (2 * K_STEPS - 1) * n * n,
        needed_floats=K_STEPS * n * (n + 1) // 2 + (K_STEPS - 1) * n * n)
    return out


# (N, B) of the ADMM stages' checks: the N=20 main path's chunk and its
# tail chunk, the reference-compatible batch, one scenario, the widest
# grouped route at its tail chunk, and the round record's N=10 batch; each
# stage is timed alone at each
STEP_SHAPES = ((20, 512), (20, 128), (20, 64), (20, 1), (21, 128),
               (10, 1024))
# (N, B, K) of the stages' checks and times at wide fleets: admm_rhs's
# direct form at its one earlier timed shape
# (N=200, B=2), the grouped routes' production QP at N=342 (B=1), and the
# widest N the sweeps serve, N=1024 (n=6144), its horizon cut to K=6 (its
# float32 X-form factors would take 7.5 GB a lane at K=50, their float64
# reference twice that)
WIDE_STEP_SHAPES = ((200, 2, K_STEPS), (342, 1, K_STEPS), (1024, 1, 6))
# (N, B) of the channel interval's checks and times: the N=20 main path's
# phase 1 over its 1024 lanes and its chunks, one batch a lane an SM, a few
# lanes, the reference-compatible batch, one scenario, the widest grouped
# route's tail chunk, the round record's N=10 batch and the N=40 path's
CHANNEL_SHAPES = ((20, 1024), (20, 512), (20, 132), (20, 8), (20, 64),
                  (20, 1), (21, 128), (10, 1024), (40, 2048))


def _plane_rows(rows):
    """(B, K, .) rows of a Rows state: x, and z and y as their static plane
    and collision rows side by side."""
    import torch
    return (rows.x, torch.cat([rows.zs.flatten(-2), rows.zc], -1),
            torch.cat([rows.ys.flatten(-2), rows.yc], -1))


def _channel_case(n_veh, B, dev, seed, lane_rho=None):
    """Phase 1's operands, float32 on the card, without collision blocks:
    bounds of random start and goal positions, x at rest, eta = 0, the
    collision-free QP's rho (``lane_rho``: one a lane) and its per-channel
    factors; the collision lower bounds about half -inf and half finite
    (phase 1 disables them all, and the kernel must serve any)."""
    import numpy as np
    import torch
    from ba_path_planning_torch.ops.collisions import make_pair_index
    from ba_path_planning_torch.solvers import banded
    from ba_path_planning_torch.solvers.scp import _warm_state
    from ba_path_planning_torch.utils.config import (SolverConfig,
                                                     make_solver_params)
    P, f32 = n_veh * (n_veh - 1) // 2, torch.float32
    problem = _problem(n_veh)
    solver = SolverConfig.production(problem=problem)
    prm = make_solver_params(solver, f32, dev)
    rng = np.random.default_rng(seed)
    p0, pf = (torch.as_tensor(rng.uniform(2.0, 18.0, (B, n_veh, 2)),
                              dtype=f32, device=dev) for _ in range(2))
    v0 = torch.zeros_like(p0)
    lower, upper = banded.build_bounds(p0, v0, pf, v0, n_vehicles=n_veh,
                                       n_steps=K_STEPS, h=H,
                                       limits=problem.limits, n_pairs=P)
    l_col = torch.as_tensor(rng.normal(size=(B, K_STEPS, P)), dtype=f32,
                            device=dev)
    off = torch.as_tensor(rng.uniform(size=(B, K_STEPS, P)) < 0.5,
                          device=dev)
    lower = lower._replace(col=l_col.masked_fill(off, -float("inf")))
    rho = banded.rho_pattern_masks(
        banded.row_scaling_state(K_STEPS, H, dtype=f32, device=dev),
        solver.static_part(), prm.rho if lane_rho is None else lane_rho,
        prm.col_rho_boost, n_steps=K_STEPS, n_pairs=P, col_enabled=False,
        dtype=f32)
    factors = banded.factorize(*banded.assemble_channel(rho, h=H,
                                                        sigma=prm.sigma))
    x = _warm_state(torch.zeros((B, n_veh, K_STEPS, 2), dtype=f32,
                                device=dev), p0, v0, H)
    return (factors, lower, upper, rho, torch.zeros((B, K_STEPS, P, 2),
                                                    dtype=f32, device=dev),
            make_pair_index(n_veh, f32, dev).E, x,
            dict(h=H, sigma=prm.sigma, alpha=prm.alpha, lam=prm.col_penalty))


def _steps_case(n_veh, B, dev, seed, phase1=False, lane_rho=None,
                n_steps=K_STEPS):
    """Inputs of one check interval as the path lays them out, float32 on
    the card: the rows, rho and bounds of :func:`_case` (collision rows
    disabled by a -inf lower bound take the loose rho, as on the sweep
    routes), and the grouped X route's factors from the NS-chain kernel
    (``lane_rho``: of M / rho with the unit slot scalars, as the solver
    factorizes them, and each lane's 1 / rho; from N = WIDE_N the plain
    chain's, cuBLAS, since the kernel takes seconds a lane there and the
    stages are what is checked); with ``phase1`` the
    collision-free QP's (:func:`_channel_case`; per-lane factors with
    ``lane_rho``).  The state is warm, as a solve finds it: one float64
    plain interval of 25 iterations from x at rest, z = clip(A x, l, u),
    y = 0; with ``phase1`` the collision rows of z and y are then drawn at
    random (the kernel must serve any finite collision state).  The sweep
    routes' inputs take ``n_steps`` steps.  Returns (factors, consts,
    rows, inv_rho, consts64)."""
    import numpy as np
    import torch
    from ba_path_planning_torch.ops import admm_steps, ns_chain
    from ba_path_planning_torch.solvers import banded
    from ba_path_planning_torch.utils.config import SolverConfig
    inv_rho = None
    if phase1:
        factors, lower, upper, rho, eta, E, x, step = _channel_case(
            n_veh, B, dev, seed, lane_rho)
    else:
        D, C, _, _, kw = _case(n_veh, B, dev, seed=seed, lane_rho=lane_rho,
                               n_steps=n_steps)
        static = SolverConfig.production(problem=_problem(n_veh)).static_part()
        lower, upper, eta, E, x = (kw[k] for k in ("lower", "upper", "eta",
                                                   "E", "x"))
        step = dict(h=H, sigma=kw["sigma"], alpha=kw["alpha"], lam=kw["lam"])
        rho = kw["rho"]
        rho = rho._replace(col=torch.where(
            torch.isinf(lower.col), torch.full_like(lower.col, 1e-6),
            rho.col.expand_as(lower.col)))
        if n_veh >= WIDE_N:
            factors = (ns_chain.factorize_X_chain_plain(D, C, ns_iters=2), C)
        elif lane_rho is None:
            factors = (ns_chain.factorize_X_chain_batched(D, C, ns_iters=2,
                                                          ns_precision="high"),
                       C)
        else:
            C1 = banded.unit_slot_scalars(static, n_steps=n_steps, h=H,
                                          device=dev)
            factors = (ns_chain.factorize_X_chain_batched(
                D / lane_rho.reshape(-1, 1, 1, 1), C1, ns_iters=2,
                ns_precision="high"), C1)
            inv_rho = 1.0 / lane_rho
        del D
    consts = admm_steps.row_consts(eta, E, lower, upper, rho, **step)

    def up(v):
        return banded.tree_map(lambda t: t.double(), v)
    consts64 = admm_steps.row_consts(
        eta.double(), E.double(), up(lower), up(upper), up(rho),
        **{k: (v.double() if hasattr(v, "double") else v)
           for k, v in step.items()})
    z = banded.tree_map(torch.clamp, banded.apply_A(x, eta, E, H),
                        lower, upper)
    rows = admm_steps.pack_state(up(x), up(z),
                                 banded.tree_map(torch.zeros_like, up(z)))
    f64 = tuple(t.double() for t in factors)
    _steps_run(rows, consts64, f64, 25, inv_rho, phase1, kernel=False)
    rows = admm_steps.Rows(*(t.float() for t in rows))
    if phase1:
        rng = np.random.default_rng(seed + 1)
        rows = rows._replace(**{k: torch.as_tensor(
            rng.normal(size=tuple(rows.zc.shape)), dtype=torch.float32,
            device=dev) for k in ("zc", "yc")})
    return factors, consts, rows, inv_rho, consts64


def _steps_run(rows, c, factors, n_iters, inv_rho, phase1, kernel=True):
    """``n_iters`` ADMM iterations on ``rows`` in place: with ``kernel``
    the path's launches (admm_rhs, the X-form sweep kernel, admm_update;
    or the channel interval), else the plain versions (for float64 inputs
    too)."""
    from ba_path_planning_torch.ops import admm_steps, group_solve
    from ba_path_planning_torch.solvers import banded
    if phase1:
        run = (admm_steps.admm_channel_interval if kernel
               else admm_steps.admm_channel_interval_plain)
        return run(*factors, rows, c, n_iters)
    rhs, solve, update = (
        (admm_steps.admm_rhs, group_solve.solve_factorized_grouped_X,
         admm_steps.admm_update) if kernel else
        (admm_steps.admm_rhs_plain, banded.solve_factorized_X,
         admm_steps.admm_update_plain))
    inv = None if inv_rho is None else inv_rho.to(rows.x.dtype)
    for _ in range(n_iters):
        update(solve(*factors, rhs(rows, c, inv)), rows, c)


def _steps_check(tag, n_veh, B, dev, phase1=False, lane_rho=None,
                 n_steps=K_STEPS):
    """The path's launches for 1 and 25 iterations against the plain
    versions on the same float32 inputs on the card: x and z within
    FUSED_TOL of plain after one iteration, and after 1 and 25 iterations
    every block no further from the float64 plain interval than
    ADMM_ERR_RATIO times the plain float32 version is (the sweep routes at
    ``n_steps`` steps).  Returns the largest absolute difference from plain
    after one iteration, and the inputs (factors, consts, rows,
    inv_rho)."""
    import torch
    from ba_path_planning_torch.ops import admm_steps
    factors, c, rows0, inv_rho, c64 = _steps_case(
        n_veh, B, dev, seed=2000 + n_veh + B, phase1=phase1,
        lane_rho=lane_rho, n_steps=n_steps)
    errs, k64, p64 = {}, {}, {}
    for n_iters in (1, 25):
        got, want = (admm_steps.Rows(*(t.clone() for t in rows0))
                     for _ in range(2))
        ref = admm_steps.Rows(*(t.double() for t in rows0))
        _steps_run(got, c, factors, n_iters, inv_rho, phase1)
        _steps_run(want, c, factors, n_iters, inv_rho, phase1, kernel=False)
        _steps_run(ref, c64, tuple(t.double() for t in factors), n_iters,
                   inv_rho, phase1, kernel=False)
        torch.cuda.synchronize()
        got, want, ref = (_plane_rows(r) for r in (got, want, ref))
        if not all(bool(torch.isfinite(g).all()) for g in got):
            raise AssertionError(f"{tag}: non-finite output")
        errs[n_iters] = [_block_rel(g, w, 1) for g, w in zip(got, want)]
        k64[n_iters] = [_block_rel(g.double(), r, 1)
                        for g, r in zip(got, ref)]
        p64[n_iters] = [_block_rel(w.double(), r, 1)
                        for w, r in zip(want, ref)]
        if n_iters == 1:
            abs_err = max(float((g - w).abs().max())
                          for g, w in zip(got, want))

    def fmt(v):
        return "[" + ", ".join(f"{e:.3e}" for e in v) + "]"
    K = K_STEPS if phase1 else n_steps
    print(f"{tag} N={n_veh} B={B} K={K} f32: block errors of (x, z, y) "
          f"after 1 and 25 iterations against plain {fmt(errs[1])} (x, z tol "
          f"{FUSED_TOL:g}), {fmt(errs[25])}, max_abs={abs_err:.3e}; against "
          f"float64 kernels {fmt(k64[1])}, {fmt(k64[25])}, plain f32 "
          f"{fmt(p64[1])}, {fmt(p64[25])} (limit {ADMM_ERR_RATIO:g}x plain)",
          flush=True)
    if not max(errs[1][:2]) <= FUSED_TOL:
        raise AssertionError(f"{tag} N={n_veh} B={B} disagrees: "
                             f"{fmt(errs[1])}")
    for n_iters in (1, 25):
        for ek, ep in zip(k64[n_iters], p64[n_iters]):
            if not ek <= ADMM_ERR_RATIO * ep:
                raise AssertionError(
                    f"{tag} N={n_veh} B={B} is off after {n_iters} "
                    f"iterations: {fmt(k64[n_iters])} vs plain "
                    f"{fmt(p64[n_iters])}")
    return abs_err, factors, c, rows0, inv_rho


def _launches_per_iteration(fn, n_iters):
    """Device kernels of one call of ``fn`` (after a warm-up call), counted
    by ``torch.profiler``, divided by ``n_iters``; "not measured" where
    the profiler records no device kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return kernels / n_iters if kernels else "not measured"


def _channel_stat(tag, err, ms, plain_ms, n_veh, B):
    """The channel interval's numbers at (N, B), 25 iterations: its bound
    on the collision-free count (``admm_stage_cost(...,
    eta_terms=False)``) and, beside it, the bound of the count with the
    pair terms of eta (the function of the kernel before eta = 0 was
    used)."""
    from ba_path_planning_torch.ops import admm_steps
    from ba_path_planning_torch.utils import profiling
    cost = profiling.admm_stage_cost("admm_channel_interval", n_veh, K_STEPS,
                                     eta_terms=False)
    eta_cost = profiling.admm_stage_cost("admm_channel_interval", n_veh,
                                         K_STEPS)
    st = _stat(err, ms, plain_ms, f"N={n_veh} K={K_STEPS} B={B}, 25 "
               "iterations", B * cost["hbm_bytes"], B * cost["flops"], 0)
    del st["stream_bound_ms"]
    st["bound_ms_with_eta_terms"], st["bound_by_with_eta_terms"] = _bound_ms(
        B * eta_cost["hbm_bytes"], B * eta_cost["flops"])
    st["plan"] = admm_steps.channel_plan(B, K_STEPS, n_veh)._asdict()
    print(f"steps phase: {tag} N={n_veh} B={B} 25 iterations kernel={ms:.4f}"
          f" ms plain="
          f"{'not timed' if plain_ms is None else f'{plain_ms:.3f} ms'}; "
          f"bound {st['bound_ms']:.4f} ms ({st['bound_by']}, collision-free "
          f"count; {st['bound_ms'] / ms:.1%} of the kernel), with the eta "
          f"terms {st['bound_ms_with_eta_terms']:.4f} ms "
          f"({st['bound_by_with_eta_terms']}; "
          f"{st['bound_ms_with_eta_terms'] / ms:.1%}); plan {st['plan']}",
          flush=True)
    return st


def _stage_line(key, st, plan):
    """One stage's times at one shape, as the steps phase prints them."""
    def ms(v):
        return v if isinstance(v, str) else f"{v:.4f} ms"
    share = "not measured" if st["share"] is None else f"{st['share']:.0%}"
    return (f"{key} {ms(st['ms'])} device (events {ms(st['events_ms'])}), "
            f"bound {ms(st['bound_ms'])} ({st['bound_by']}; {share} of it), "
            "plan " + ", ".join(f"{k}={plan[k]}" for k in plan))


def steps_phase(dev):
    """The ADMM stages (``ops/admm_steps.py``): admm_rhs and admm_update
    with the X-form sweep kernel between them (the grouped X route's
    iteration) and the channel interval, each against its plain version
    (:func:`_steps_check`) at STEP_SHAPES, WIDE_STEP_SHAPES and
    CHANNEL_SHAPES, and with one rho a lane (N=20, B=64); admm_rhs and
    admm_update timed alone at each of STEP_SHAPES and WIDE_STEP_SHAPES
    (device time, :func:`_device_ms`, and CUDA events;
    their plain versions at N=20, B=512), with their bound and plan, the
    interval at each of CHANNEL_SHAPES and with one rho a lane (its plain
    version at N=20, B=1024, phase 1's batch); the device launches per
    ADMM iteration of one grouped X interval of 25 iterations
    (``banded._interval_fn``, the packing of the state included) and of
    one channel interval.  Returns the stats of the ``glue_kernels``
    line."""
    import torch
    from ba_path_planning_torch.ops import admm_steps, group_solve
    from ba_path_planning_torch.solvers import banded
    from ba_path_planning_torch.utils import profiling
    out, at = {}, {"admm_rhs": {}, "admm_update": {}}
    for n_veh, B, K in ([s + (K_STEPS,) for s in STEP_SHAPES]
                        + list(WIDE_STEP_SHAPES)):
        abs_err, factors, c, rows, inv_rho = _steps_check(
            "steps phase: admm_rhs + sweep + admm_update", n_veh, B, dev,
            n_steps=K)
        # each stage alone: its device time, and CUDA events over
        # back-to-back calls (the host's launch cost included)
        b = admm_steps.admm_rhs(rows, c)
        xt = group_solve.solve_factorized_grouped_X(*factors, b)
        work = admm_steps.Rows(*(t.clone() for t in rows))
        shape = f"N={n_veh} B={B}" + ("" if K == K_STEPS else f" K={K}")
        rhs_plan = admm_steps.rhs_plan(B, K, n_veh)
        plans = {"admm_rhs": dict(
                     form="table" if rhs_plan.table else "direct",
                     k_tile=rhs_plan.k_tile),
                 "admm_update": dict(
                     k_tile=admm_steps.update_plan(B, K, n_veh))}
        for key, fn in (("admm_rhs", lambda: admm_steps.admm_rhs(rows, c)),
                        ("admm_update",
                         lambda: admm_steps.admm_update(xt, work, c))):
            cost = profiling.admm_stage_cost(key, n_veh, K)
            bound, by = _bound_ms(B * cost["hbm_bytes"], B * cost["flops"])
            device = _device_ms(fn)
            at[key][shape] = dict(
                plans[key], ms=device, events_ms=_time_ms(fn, 20),
                bound_ms=bound, bound_by=by,
                share=None if isinstance(device, str) else bound / device)
        print(f"steps phase: {shape} alone: "
              + "; ".join(_stage_line(key, at[key][shape], plans[key])
                          for key in at), flush=True)
        if (n_veh, B) == (20, 512):
            main = factors, c, rows, b, xt
        del factors, c, rows, b, xt, work
    _steps_check("steps phase: admm_rhs + sweep + admm_update, one rho a "
                 "lane", 20, FACADE_B, dev,
                 lane_rho=_lane_rho(FACADE_B, seed=20))
    factors, c, rows, b, xt = main
    bp = admm_steps.admm_rhs_plain(rows, c)
    torch.cuda.synchronize()
    rhs_err = float((b - bp).abs().max())
    work = admm_steps.Rows(*(t.clone() for t in rows))
    plain = admm_steps.Rows(*(t.clone() for t in rows))
    admm_steps.admm_update(xt, work, c)
    admm_steps.admm_update_plain(xt, plain, c)
    torch.cuda.synchronize()
    upd_err = max(float((g - w).abs().max())
                  for g, w in zip(_plane_rows(work), _plane_rows(plain)))
    timed = {
        "admm_rhs": (rhs_err, _time_ms(
            lambda: admm_steps.admm_rhs_plain(rows, c), 5)),
        "admm_update": (upd_err, _time_ms(
            lambda: admm_steps.admm_update_plain(xt, plain, c), 5))}
    for key, (err, plain_ms) in timed.items():
        # the device time, or the events' where the profiler saw none
        main_at = at[key]["N=20 B=512"]
        ms = (main_at["events_ms"] if isinstance(main_at["ms"], str)
              else main_at["ms"])
        cost = profiling.admm_stage_cost(key, 20, K_STEPS)
        out[key] = _stat(err, ms, plain_ms, f"N=20 K={K_STEPS} B=512",
                         512 * cost["hbm_bytes"], 512 * cost["flops"], 0)
        del out[key]["stream_bound_ms"]
        out[key]["ms_at"] = at[key]
        print(f"steps phase: {key} alone N=20 B=512 max_abs={err:.3e} "
              f"kernel={ms:.4f} ms plain={plain_ms:.3f} ms bound "
              f"{out[key]['bound_ms']:.4f} ms ({out[key]['bound_by']}; "
              f"{out[key]['bound_ms'] / ms:.0%} of the kernel)", flush=True)
    del main, c, rows, b, xt, work, plain
    ch_times = {}
    for n_veh, B, lane in ([s + (False,) for s in CHANNEL_SHAPES]
                           + [(20, FACADE_B, True)]):
        tag = ("admm_channel_interval, one rho a lane" if lane
               else "admm_channel_interval")
        err, ch_factors, ch_c, ch_rows, _ = _steps_check(
            f"steps phase: {tag}", n_veh, B, dev, phase1=True,
            lane_rho=_lane_rho(B, seed=21) if lane else None)
        work = admm_steps.Rows(*(t.clone() for t in ch_rows))
        ms = _time_ms(lambda: admm_steps.admm_channel_interval(
            *ch_factors, work, ch_c, 25))
        plain_ms = None
        if (n_veh, B, lane) == (20, 1024, False):
            plain_ms = _time_ms(lambda: admm_steps.admm_channel_interval_plain(
                *ch_factors, work, ch_c, 25), reps=1)
            ch = err, ch_factors
        st = _channel_stat(tag, err, ms, plain_ms, n_veh, B)
        key = f"N={n_veh} B={B}" + (" one rho a lane" if lane else "")
        ch_times[key] = {k: st[k] for k in ("ms", "bound_ms", "bound_by",
                                            "bound_ms_with_eta_terms")}
        if plain_ms is not None:
            out["admm_channel_interval"] = st
        del ch_factors, ch_c, ch_rows, work
    out["admm_channel_interval"]["ms_at"] = ch_times
    ch_err, ch_factors = ch
    # device launches per ADMM iteration of the path's intervals
    kw = _case(20, 512, dev, seed=77)[4]
    rho = kw["rho"]._replace(col=torch.where(
        torch.isinf(kw["lower"].col), torch.full_like(kw["lower"].col, 1e-6),
        kw["rho"].col.expand_as(kw["lower"].col)))
    z = banded.tree_map(torch.clamp,
                        banded.apply_A(kw["x"], kw["eta"], kw["E"], H),
                        kw["lower"], kw["upper"])
    y = banded.tree_map(torch.zeros_like, z)
    step = dict(h=H, sigma=kw["sigma"], alpha=kw["alpha"], lam=kw["lam"],
                n_iters=25)
    interval = banded._interval_fn("grouped_X", factors, rho, kw["lower"],
                                   kw["upper"], kw["eta"], kw["E"], 20, step)
    per_it = _launches_per_iteration(lambda: interval(kw["x"], z, y), 25)
    chan = banded._interval_fn("channel", ch_factors, rho, kw["lower"],
                               kw["upper"], kw["eta"], kw["E"], 20, step)
    per_ch = _launches_per_iteration(lambda: chan(kw["x"], z, y), 1)
    print(f"steps phase: device launches per ADMM iteration of one grouped_X "
          f"interval (N=20 B=512, 25 iterations, packing included): "
          f"{per_it if isinstance(per_it, str) else f'{per_it:.2f}'}; "
          f"device launches of one channel interval (25 iterations, packing "
          f"included): {per_ch}", flush=True)
    if not isinstance(per_it, str) and per_it > 4:
        raise AssertionError(f"{per_it} device launches per ADMM iteration")
    out["admm_rhs"]["launches_per_iteration_grouped_X"] = per_it
    out["admm_channel_interval"]["launches_per_interval"] = per_ch
    return out


# the shapes the routes assemble D at (N, K, B): the production chunk and
# its tail, one scenario, the fused route's chunk and tail at N=40, a short
# horizon and the grouped routes' wide shapes
ASSEMBLE_SHAPES = ((20, K_STEPS, 512), (20, K_STEPS, 128), (20, K_STEPS, 1),
                   (40, K_STEPS, 128), (40, K_STEPS, 32), (342, K_STEPS, 2),
                   (1024, 6, 1), (268, 9, 1))


def assemble_case(dev, n_veh, K, B, seed, reps=20):
    """The QP's diagonal blocks D at (N, K, B) on production rho rows (a
    third of the collision rows on the loose rho) and unit directions:
    ``ops.assemble_d.assemble_D_fused`` against
    the plain ``banded.assemble_D``, timed by CUDA events in turns
    (kernel, plain, plain, kernel; ``reps`` calls a timing, fewer for the
    plain version where it multiplies wide dense products), checked (every
    entry off the diagonal vehicle blocks equal, those within 1e-5 of the
    block's largest), beside the bound: D written once, eta and the
    collision rho read once."""
    import numpy as np
    import torch
    from ba_path_planning_torch.ops.assemble_d import assemble_D_fused
    from ba_path_planning_torch.ops.collisions import make_pair_index
    from ba_path_planning_torch.solvers import banded
    from ba_path_planning_torch.utils.config import SolverConfig
    rng = np.random.default_rng(seed)
    P = n_veh * (n_veh - 1) // 2
    E = make_pair_index(n_veh, device=dev).E
    rho = banded.rho_pattern_masks(
        banded.row_scaling_state(K, H, device=dev),
        SolverConfig.production().static_part(),
        torch.tensor(2.6, device=dev), torch.tensor(2.5, device=dev),
        n_steps=K, n_pairs=P, col_enabled=True)
    loose = torch.as_tensor(rng.uniform(size=(B, K, P)) < 0.3, device=dev)
    rho = rho._replace(col=torch.where(
        loose, torch.tensor(banded._LOOSE_RHO, device=dev),
        rho.col.expand(B, K, P)).contiguous())
    eta = rng.normal(size=(B, K, P, 2)).astype(np.float32)
    eta /= np.linalg.norm(eta, axis=-1, keepdims=True)
    eta = torch.as_tensor(eta, device=dev)
    sigma = torch.tensor(1e-6, device=dev)
    kw = dict(h=H, sigma=sigma, n_vehicles=n_veh)
    n = 6 * n_veh
    n_bytes = 4 * B * K * (n * n + 3 * P)
    bound = _bound_ms(n_bytes, 0)[0]
    plain_reps = max(1, min(reps, int(2e9 // max(1, B * K * 2 * n_veh * P))))
    plain = lambda: banded.assemble_D(rho, eta, E, **kw)    # noqa: E731
    out = {"N": n_veh, "K": K, "B": B, "bound_ms": bound,
           "bound_bytes": n_bytes}
    torch.cuda.empty_cache()
    kernel = lambda: assemble_D_fused(rho, eta, E, **kw)    # noqa: E731
    D, C = kernel()
    Dp, Cp = plain()
    r = torch.arange(n, device=dev)
    veh = torch.where((r >= 2 * n_veh) & (r < 4 * n_veh),
                      (r - 2 * n_veh) // 2, -1 - r)
    mask = (veh[:, None] == veh[None, :]).expand(D.shape)
    equal_off = bool(torch.equal(D[~mask], Dp[~mask])) and bool(
        torch.equal(C, Cp))
    diag_rel = float((D[mask] - Dp[mask]).abs().max()
                     / Dp[mask].abs().max())
    del D, C, Dp, Cp, mask
    torch.cuda.empty_cache()
    k_ms, p_ms = [], []
    for fn, to in ((kernel, k_ms), (plain, p_ms), (plain, p_ms),
                   (kernel, k_ms)):
        to.append(_time_ms(fn, reps if fn is kernel else plain_reps))
        torch.cuda.empty_cache()
    if not equal_off or diag_rel > 1e-5:
        raise AssertionError(f"assemble N={n_veh} K={K} B={B}: off-diagonal "
                             f"equal {equal_off}, diagonal {diag_rel:.3g}")
    return {**out, "ms": min(k_ms), "ms_runs": k_ms, "plain_ms": min(p_ms),
            "plain_ms_runs": p_ms, "share": bound / min(k_ms),
            "equal_off_diagonal": equal_off, "diag_max_rel": diag_rel}


def assemble_phase(dev):
    """The one-pass assembly of D against the plain version at
    :data:`ASSEMBLE_SHAPES` (:func:`assemble_case`), one line a shape."""
    stats = {}
    for i, (n_veh, K, B) in enumerate(ASSEMBLE_SHAPES):
        st = assemble_case(dev, n_veh, K, B, seed=40 + i)
        print(f"assemble phase: N={n_veh} K={K} B={B} kernel "
              f"{st['ms']:.4f} ms (in turns {st['ms_runs'][0]:.4f} / "
              f"{st['ms_runs'][1]:.4f}), plain {st['plain_ms']:.3f} ms "
              f"({st['plain_ms_runs'][0]:.3f} / {st['plain_ms_runs'][1]:.3f})"
              f"; bound {st['bound_ms']:.4f} ms (bytes: D once, eta and the "
              f"collision rho once): {100 * st['share']:.1f}%; off-diagonal "
              f"equal {st['equal_off_diagonal']}, diagonal blocks within "
              f"{st['diag_max_rel']:.2e}", flush=True)
        stats[f"N{n_veh}_K{K}_B{B}"] = st
    return stats


def lform_phase(dev, n_veh, B, dense=False, fused=False, l_only=True,
                n_steps=K_STEPS, reps=20, bf16=False):
    """The L-form family on the factors of the reference-compatible solver
    (float32 block Cholesky on the card, as the path computes them) at
    ``n_steps`` steps: the L-only sweep (unless not ``l_only``; timed over
    ``reps`` calls), with ``bf16`` also on the factors stored in bf16
    (:func:`_bf16_sweep`, ``group_solve_l_bf16``); with ``dense`` the dense
    (Linv, Eb) sweep; with ``fused`` the L-form fused interval, whose
    penalty weight is this solver's +inf."""
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
            b_admm, reps=reps)
        # Linv is lower triangular: the sweeps need n (n + 1) / 2 elements
        # of a block, read once (the bound) or at each of 2K steps (the
        # stream)
        tri = n * (n + 1) // 2
        out["group_solve_l"] = _stat(
            err, ms, plain_ms, shape, B * K * (tri + 2 * n) * 4,
            B * 4 * K * n * (n + 1), B * K * (2 * tri + 2 * n) * 4)
        # the stream of whole blocks, the zero half of Linv included
        out["group_solve_l"]["whole_block_stream_bound_ms"] = _bound_ms(
            B * K * (2 * n * n + 2 * n) * 4, B * 4 * K * 2 * n * n)[0]
    if bf16:
        out["group_solve_l_bf16"] = _bf16_sweep("L", (Linv,), C, b, b_admm,
                                                n_veh)
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


# the ADMM stages beside every sweep kernel (ops/admm_steps.py), and the
# phase-1 interval that every float32 solve on the direct method starts with
ROW_STAGES = {"admm_rhs", "admm_update"}
PHASE1 = {"admm_channel_interval"}
# the one-pass assembly of D: every route's QP but phase 1's
ASSEMBLE = {"assemble_d"}


def _production_route(n_veh, batches=(B_LARGE,)):
    """The kernels of the production solver at N=n_veh, as the JAX router
    routes (``banded.qp_route``): the grouped X sweep with the ADMM stages
    where it routes there (at K=50, N <= 21 and N >= 109, where the fused
    interval's factors pass its gate), else the fused interval, on the
    tier its plan takes at each of the dispatches' ``batches``
    (``admm_fused_x_wide`` the wide one); phase 1 on the channel
    interval; D assembled in one pass a QP but phase 1's."""
    import torch
    from ba_path_planning_torch.ops.admm_fused import fused_x_plan
    from ba_path_planning_torch.ops.cuda_build import device_sms
    from ba_path_planning_torch.solvers.banded import qp_route
    from ba_path_planning_torch.utils.config import SolverConfig
    route = qp_route(
        SolverConfig.production(problem=_problem(n_veh)).static_part(),
        n_vehicles=n_veh, n_steps=K_STEPS, dtype=torch.float32,
        col_enabled=True)
    if route != "fused_X":
        return PHASE1 | ASSEMBLE | {"ns_chain", "group_solve_x"} | ROW_STAGES
    sms = device_sms(torch.device("cuda"))
    return PHASE1 | ASSEMBLE | {"ns_chain"} | {
        "admm_fused_x_wide" if fused_x_plan(B, K_STEPS, n_veh, sms).spread
        else "admm_fused_x" for B in batches}


def _dispatch_batches(timing, chunk):
    """The batches of a ``solve_compacted``'s dispatches, read from its
    ``last_timing``: chunks of ``chunk`` lanes and tails of chunk // 4
    (``parallel/mesh.py``), each where the loop made one."""
    tail = chunk // 4
    n, lanes = timing["loop_dispatches"], timing["loop_lanes_dispatched"]
    tails = (chunk * n - lanes) // (chunk - tail)
    return tuple(B for B, count in ((chunk, n - tails), (tail, tails))
                 if count)


# the summary of each main path by its label, for the bf16 paths' lines
PATH_STATS = {}
# positions and feasibility of each main path, by the label of PATH_STATS
PATH_POSITIONS = {}


def main_path(dev, card, n_veh, B, chunk, counters, latency=False,
              solver=None, label=None):
    """``solve_compacted`` over B scenarios at the bench.py configuration
    (``latency``: with ``SolverConfig.latency()``, three 9-iteration
    intervals with early exit, for the production solver; ``solver``:
    another solver of the production route); returns the launch counts of
    this path alone and records its summary in PATH_STATS[label]."""
    import numpy as np
    import torch
    from ba_path_planning_torch.models.double_integrator import (
        DoubleIntegrator2D)
    from ba_path_planning_torch.parallel.mesh import ShardedSCPSolver
    from ba_path_planning_torch.scenarios.generator import (
        generate_scenario_batch)
    from ba_path_planning_torch.utils.config import SolverConfig
    problem = _problem(n_veh)
    if solver is None:
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
    mean_scp = float(out.iterations.float().mean())
    mean_qp = float(out.qp_iterations.float().mean())
    key = label or ("latency" if latency else f"N={n_veh}")
    PATH_STATS[key] = dict(
        ok=ok, B=B, statuses=status, mean_scp_iters=mean_scp,
        mean_qp_iters=mean_qp, wall=wall)
    PATH_POSITIONS[key] = (out.positions, ff)
    name = f" ({label})" if label else (" (latency solver)" if latency
                                         else "")
    print(f"main path{name}: B={B} "
          f"chunk={chunk} N={n_veh} K={K} R={R} f32 on "
          f"{card}: wall={wall:.3f} s solves/s={ok / wall:.1f} "
          f"ok={ok}/{B} collision_free={int(ff.sum())} "
          f"goal<5cm={int((goal_err < 0.05).sum())} statuses={status} "
          f"mean_scp_iters={mean_scp:.3f} mean_qp_iters={mean_qp:.2f} "
          f"peak_mem={torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
          f"timing={json.dumps(sh.last_timing)} launches={launches}",
          flush=True)
    _check_route(f"N={n_veh} main path{name}", launches,
                 _production_route(n_veh, _dispatch_batches(sh.last_timing,
                                                            chunk)))
    if launches["assemble_d"] != sh.last_timing["loop_dispatches"]:
        raise AssertionError(
            f"N={n_veh} main path{name}: D assembled "
            f"{launches['assemble_d']} times in "
            f"{sh.last_timing['loop_dispatches']} dispatches (once a QP, "
            f"never in phase 1)")
    if ok < int(np.ceil(0.99 * B)):
        raise AssertionError(f"only {ok}/{B} collision-free and goal-exact")
    return launches


# The wide phase: the grouped routes past N = 341 (N <= 341 was the fused
# kernels' limit while they kept a pair table), at the production QP's
# N=342, K=50 on WIDE_B lanes; the
# ``SCP`` class's QP budget cut from 2000 iterations to WIDE_FACADE_ITERS
# and the wide solve_compacted's SCP loop from 15 to WIDE_SCP iterations
WIDE_N, WIDE_B, WIDE_FACADE_ITERS, WIDE_SCP = 342, 2, 50, 2
# x of the stages' route against the "graph" interval (admm_iterations
# around the same sweep kernel), every (b, k) block after a whole QP
WIDE_QP_TOL = FUSED_TOL


def _graph_interval_kind(route, dtype, device, group=None):
    return "graph"


def wide_qp(dev, card, counters, label, solver, route, seed):
    """One ``banded.solve_qp_state`` at N=WIDE_N, K=50, B=WIDE_B on
    ``route`` from :func:`_case`'s inputs for ``seed`` (its bounds,
    collision rows and warm x), float32 on the card: through the row
    stages (admm_rhs, the route's sweep, admm_update;
    ``admm_iterations`` never reached), then
    the same call with ``banded.interval_kind`` naming "graph"
    (``admm_iterations`` around the same sweep kernel, replayed as a CUDA
    graph).  Equal iteration counts and convergence flags, x of every
    (b, k) block within WIDE_QP_TOL, three launches an ADMM iteration.
    Returns the launch counts of the row-stage solve."""
    import torch
    from ba_path_planning_torch.solvers import banded
    from ba_path_planning_torch.utils.config import make_solver_params
    f32 = torch.float32
    kw = _case(WIDE_N, WIDE_B, dev, seed=seed, solver=solver)[4]
    static = solver.static_part()
    took = banded.qp_route(static, n_vehicles=WIDE_N, n_steps=K_STEPS,
                           dtype=f32, col_enabled=True)
    if took != route:
        raise AssertionError(f"{label}: route {took}, not {route}")
    prm = make_solver_params(solver, f32, dev)

    def solve():
        return banded.solve_qp_state(
            kw["lower"], kw["upper"], kw["eta"], kw["x"], prm, kw["E"], h=H,
            static=static, n_vehicles=WIDE_N)
    plain_iterations = banded.admm_iterations

    def refuse(*args, **kwargs):
        raise AssertionError("admm_iterations reached")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero(counters)
    banded.admm_iterations = refuse
    try:
        t0 = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        banded.admm_iterations = plain_iterations
    launches = _read(counters)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    sweep = "group_solve_x" if route == "grouped_X" else "group_solve_l"
    iters = int(res.iters.max())
    per_it = (launches["admm_rhs"] + launches[sweep]
              + launches["admm_update"]) / max(iters, 1)
    kind = banded.interval_kind
    banded.interval_kind = _graph_interval_kind
    try:
        _zero(counters)
        t0 = time.perf_counter()
        ref = solve()
        torch.cuda.synchronize()
        wall_g = time.perf_counter() - t0
        graph_launches = _read(counters)
    finally:
        banded.interval_kind = kind
    got, want = (banded.to_stacked(r.x) for r in (res, ref))
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: non-finite x")
    err = _block_rel(got, want, 1)
    abs_err = float((got - want).abs().max())
    tier = _sweep_tier((WIDE_B, K_STEPS, 6 * WIDE_N), route[-1])
    print(f"wide phase: {label}: route {route} N={WIDE_N} K={K_STEPS} "
          f"B={WIDE_B} f32 on {card} (sweep on the {tier}): iterations "
          f"{res.iters.tolist()} "
          f"(graph interval {ref.iters.tolist()}), converged "
          f"{res.converged.tolist()} ({ref.converged.tolist()}); x against "
          f"the graph interval max_block_rel={err:.3e} (tol "
          f"{WIDE_QP_TOL:g}) max_abs={abs_err:.3e}; wall {wall:.3f} s "
          f"(graph interval {wall_g:.3f} s), peak_mem={peak:.2f} GiB; "
          f"launches per ADMM iteration {per_it:.2f}; launches={launches}; "
          f"graph interval's {graph_launches}", flush=True)
    if not (torch.equal(res.iters, ref.iters)
            and torch.equal(res.converged, ref.converged)):
        raise AssertionError(f"{label}: iteration counts differ from the "
                             "graph interval's")
    if not err <= WIDE_QP_TOL:
        raise AssertionError(f"{label}: x off the graph interval's: "
                             f"{err:.3e}")
    if not (launches["admm_rhs"] == launches["admm_update"] == iters
            == launches[sweep] and graph_launches["admm_rhs"] == 0
            and graph_launches["admm_update"] == 0):
        raise AssertionError(f"{label}: launches {launches}, graph "
                             f"{graph_launches}, {iters} iterations")
    return launches


def wide_path(dev, card, counters):
    """``ShardedSCPSolver.solve_compacted`` with the production solver at
    N=WIDE_N, K=50, WIDE_B lanes in one chunk, the SCP loop cut to
    WIDE_SCP iterations: starts on the first WIDE_N points of the 19 x 19
    lattice of 1 m pitch in the 20 m box (every start pair 1 m > R apart;
    the generator cannot place this many vehicles), goals a permutation of
    them a lane (``numpy.random.default_rng(WIDE_N)``).  It must run to its
    end with finite trajectories on the grouped X route (phase 1 on the
    channel interval, then the NS chain and three launches an ADMM
    iteration); feasibility is printed, not barred.  Returns the launch
    counts."""
    import numpy as np
    import torch
    from ba_path_planning_torch.parallel.mesh import ShardedSCPSolver
    from ba_path_planning_torch.utils.config import SolverConfig
    problem = _problem(WIDE_N).replace(max_iterations=WIDE_SCP)
    solver = SolverConfig.production(problem=problem)
    sh = ShardedSCPSolver(problem, solver, dtype=torch.float32, device=dev)
    g = np.arange(1, 20, dtype=np.float32)
    lattice = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    lattice = lattice[:WIDE_N]
    rng = np.random.default_rng(WIDE_N)
    p0 = torch.as_tensor(np.stack([lattice] * WIDE_B), device=dev)
    pf = torch.as_tensor(np.stack([lattice[rng.permutation(WIDE_N)]
                                   for _ in range(WIDE_B)]), device=dev)
    v0 = torch.zeros_like(p0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero(counters)
    t0 = time.perf_counter()
    out = sh.solve_compacted(p0, v0, pf, v0, chunk=WIDE_B)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read(counters)
    if tuple(out.positions.shape) != (WIDE_B, WIDE_N, K_STEPS, 2):
        raise AssertionError(f"positions shape {tuple(out.positions.shape)}")
    if not all(bool(torch.isfinite(t).all()) for t in (
            out.positions, out.velocities, out.accelerations)):
        raise AssertionError("wide path: non-finite trajectories")
    route = _production_route(WIDE_N)
    _check_route("the wide path", launches, route)
    per_it = (launches["admm_rhs"] + launches["group_solve_x"]
              + launches["admm_update"]) / launches["group_solve_x"]
    status = np.bincount(out.status.cpu().numpy(), minlength=3).tolist()
    print(f"wide phase: solve_compacted B={WIDE_B} chunk={WIDE_B} "
          f"N={WIDE_N} K={K_STEPS} R={R} f32, SCP loop cut to {WIDE_SCP}, on "
          f"{card}: route grouped_X ({sorted(route)}), launches per ADMM "
          f"iteration {per_it:.2f}, wall={wall:.3f} s "
          f"peak_mem={torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
          f"statuses={status} scp_iters={out.iterations.tolist()} "
          f"qp_iters={out.qp_iterations.tolist()} collision_free="
          f"{int(out.feasible_final.sum())}/{WIDE_B} "
          f"timing={json.dumps(sh.last_timing)} launches={launches}",
          flush=True)
    if per_it != 3:
        raise AssertionError(f"wide path: {per_it} launches an iteration")
    return launches


def wide_phase(dev, card, counters):
    """The grouped routes past N = 341 end to end: the production QP on
    ``grouped_X`` and the ``SCP`` class's QP on ``grouped_L`` (its QP
    budget cut to WIDE_FACADE_ITERS, two check intervals), each held
    against the "graph" interval (:func:`wide_qp`; bf16 factors there are
    the card tests'), and one wide solve_compacted (:func:`wide_path`).
    Returns the launch counts of the row-stage solves and the path."""
    from ba_path_planning_torch.solvers.scp import REFERENCE_SOLVER
    from ba_path_planning_torch.utils.config import SolverConfig
    total = {}
    for seed, (label, solver, route) in enumerate((
            ("production QP",
             SolverConfig.production(problem=_problem(WIDE_N)), "grouped_X"),
            (f"SCP class QP (budget cut to {WIDE_FACADE_ITERS})",
             REFERENCE_SOLVER.replace(kernels=True,
                                      max_iter=WIDE_FACADE_ITERS),
             "grouped_L")), 3420):
        for key, n in wide_qp(dev, card, counters, label, solver, route,
                              seed).items():
            total[key] = total.get(key, 0) + n
    for key, n in wide_path(dev, card, counters).items():
        total[key] = total.get(key, 0) + n
    return total


# The short-horizon phase: the production router sends short horizons over
# large fleets to the fused X interval (`banded.qp_route`), up to N = 584
# at K = 2 (n = 3504), N = 341 at K = 6 and N = 268 at K = 9; (N, B, K) of
# its kernel checks and of its production QP
SHORT_SHAPES = ((584, 2, 2), (341, 2, 6), (268, 1, 9))
SHORT_QP = (341, 2, 6)


def short_phase(dev, card, counters):
    """The X-form fused interval at SHORT_SHAPES on the tier its plan
    takes (the wide tier: each scenario over many SMs) against its plain
    version (:func:`fused_check`, on the factors of the solver's X-form
    route: the NS chain from K = 6, ``factorize_X`` below), timed beside
    the whole blocks' stream bound ((2K - 1) n^2 floats a scenario an
    iteration); bit for bit across two launches and against the one-block
    tier (both read whole bands), and both tiers timed in turns; then one
    production ``banded.solve_qp_state`` at SHORT_QP on ``fused_X`` (the
    NS chain and one fused launch an interval, on the wide tier), against
    the same call with the plain interval in the kernel's place: equal
    iteration counts and convergence flags, x of every (b, k) block within
    WIDE_QP_TOL.  Returns {shape: the kernel's numbers} and the launch
    counts of the QP."""
    import torch
    from ba_path_planning_torch.ops import admm_fused
    from ba_path_planning_torch.ops.cuda_build import device_sms
    from ba_path_planning_torch.solvers import banded
    from ba_path_planning_torch.utils.config import (SolverConfig,
                                                     make_solver_params)
    f32, out = torch.float32, {}

    def production(n_veh, K):
        solver = SolverConfig.production(problem=_problem(n_veh, n_steps=K))
        route = banded.qp_route(solver.static_part(), n_vehicles=n_veh,
                                n_steps=K, dtype=f32, col_enabled=True)
        if route != "fused_X":
            raise AssertionError(f"N={n_veh} K={K}: route {route}")
        return solver
    for n_veh, B, K in SHORT_SHAPES:
        solver = production(n_veh, K)
        D, C, _, _, kw = _case(n_veh, B, dev, seed=n_veh + K, solver=solver,
                               n_steps=K)
        kw["X"] = banded._factorize_X_routed(D, C, solver.static_part())
        del D
        n = 6 * n_veh
        plan = admm_fused.fused_x_plan(B, K, n_veh, sms=device_sms(dev))
        one = admm_fused.fused_x_plan(B, K, n_veh, sms=device_sms(dev),
                                      _wide=False)
        if not plan.spread:
            raise AssertionError(f"short phase: N={n_veh} K={K} B={B} "
                                 f"off the wide tier: {plan}")
        st = fused_check(
            f"short phase: admm_interval_fused_X on the wide tier "
            f"({plan.spread} blocks a scenario, {plan.per_sm} an SM, a "
            f"ring of {plan.stages} stages of {plan.band_rows} rows, "
            f"{plan.smem_bytes} B)", admm_fused.admm_interval_fused_X,
            admm_fused.admm_interval_fused_X_plain, dict(kw), n_veh,
            K * n * n, stream_floats=(2 * K - 1) * n * n)
        st.pop("timed_at", None)
        # both tiers from one state: bit for bit, then timed in turns
        x = kw.pop("x")
        z = banded.tree_map(torch.clamp, banded.apply_A(
            x, kw["eta"], kw["E"], H), kw["lower"], kw["upper"])
        state = dict(x=x, z=z, y=banded.tree_map(torch.zeros_like, z),
                     n_iters=25)

        def run(p):
            return _rows(admm_fused.admm_interval_fused_X(**kw, **state,
                                                          _plan=p))
        first, second, other = run(plan), run(plan), run(one)
        torch.cuda.synchronize()
        repeat = all(torch.equal(a, b) for a, b in zip(first, second))
        same = all(torch.equal(a, b) for a, b in zip(first, other))
        del first, second, other
        runs = {"wide": [], "one_block": []}
        for _ in range(2):
            for tier, p in (("wide", plan), ("one_block", one)):
                runs[tier].append(_time_ms(
                    lambda p=p: admm_fused.admm_interval_fused_X(
                        **kw, **state, _plan=p), reps=2))
        st.update(tier="wide", plan=plan._asdict(),
                  one_block_plan=one._asdict(), ms_runs_by_tier=runs,
                  one_block_ms=min(runs["one_block"]),
                  bit_for_bit_across_launches=repeat,
                  equal_to_one_block=same)
        out[f"N={n_veh} K={K} B={B}"] = st
        print(f"short phase: admm_interval_fused_X N={n_veh} K={K} B={B} "
              f"25 iterations on {card}: wide tier {st['ms']:.3f} ms "
              f"(in turns {runs['wide']}), one-block tier "
              f"{st['one_block_ms']:.3f} ms (in turns {runs['one_block']}), "
              f"plain {st['plain_ms']:.3f} ms, whole-block stream bound "
              f"{st['stream_bound_ms']:.3f} ms (wide "
              f"{st['stream_bound_ms'] / st['ms']:.2%}, one block "
              f"{st['stream_bound_ms'] / st['one_block_ms']:.2%}), bound "
              f"{st['bound_ms']:.3f} ms ({st['bound_by']}); bit for bit "
              f"across launches {repeat}, equal to the one-block tier "
              f"{same}", flush=True)
        if not (repeat and same):
            raise AssertionError(f"short phase: N={n_veh} K={K} B={B}: "
                                 f"bit for bit across launches {repeat}, "
                                 f"equal to the one-block tier {same}")
        if not st["ms"] < st["plain_ms"]:
            raise AssertionError(f"short phase: N={n_veh} K={K} B={B}: the "
                                 f"wide tier ({st['ms']:.3f} ms) is not "
                                 f"faster than plain ({st['plain_ms']:.3f})")
        del kw, x, z, state
        torch.cuda.empty_cache()

    n_veh, B, K = SHORT_QP
    solver = production(n_veh, K)
    static = solver.static_part()
    qp_plan = admm_fused.fused_x_plan(B, K, n_veh, sms=device_sms(dev))
    if not qp_plan.spread:
        raise AssertionError(f"short phase QP: off the wide tier: {qp_plan}")
    kw = _case(n_veh, B, dev, seed=3410, solver=solver, n_steps=K)[4]
    prm = make_solver_params(solver, f32, dev)

    def solve():
        return banded.solve_qp_state(
            kw["lower"], kw["upper"], kw["eta"], kw["x"], prm, kw["E"], h=H,
            static=static, n_vehicles=n_veh)
    torch.cuda.synchronize()
    _zero(counters)
    t0 = time.perf_counter()
    res = solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read(counters)
    kernel = admm_fused.admm_interval_fused_X
    admm_fused.admm_interval_fused_X = admm_fused.admm_interval_fused_X_plain
    try:
        t0 = time.perf_counter()
        ref = solve()
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
    finally:
        admm_fused.admm_interval_fused_X = kernel
    got, want = (banded.to_stacked(r.x) for r in (res, ref))
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("short phase QP: non-finite x")
    err = _block_rel(got, want, 1)
    intervals = -(-int(res.iters.max()) // solver.check_interval)
    print(f"short phase: production QP route fused_X N={n_veh} K={K} B={B} "
          f"f32 on {card}, the fused interval on the wide tier "
          f"({qp_plan.spread} blocks a scenario): iterations "
          f"{res.iters.tolist()} (plain interval {ref.iters.tolist()}), "
          f"converged {res.converged.tolist()} "
          f"({ref.converged.tolist()}); x against the plain interval "
          f"max_block_rel={err:.3e} (tol {WIDE_QP_TOL:g}); wall {wall:.3f} "
          f"s (plain interval {wall_p:.3f} s); launches={launches}",
          flush=True)
    out["production QP"] = {"N": n_veh, "K": K, "B": B, "wall_s": wall,
                            "plain_interval_wall_s": wall_p,
                            "max_block_rel": err, "tier": "wide",
                            "plan": qp_plan._asdict()}
    _check_route("the short phase's QP", launches,
                 {"ns_chain", "admm_fused_x_wide"} | ASSEMBLE)
    if not (torch.equal(res.iters, ref.iters)
            and torch.equal(res.converged, ref.converged)):
        raise AssertionError("short phase QP: iteration counts differ from "
                             "the plain interval's")
    if not err <= WIDE_QP_TOL:
        raise AssertionError(f"short phase QP: x off the plain interval's: "
                             f"{err:.3e}")
    if launches["admm_fused_x_wide"] != intervals:
        raise AssertionError(f"short phase QP: "
                             f"{launches['admm_fused_x_wide']} "
                             f"fused launches for {intervals} intervals")
    return out, launches


# (N, scenarios, chunk) of the soak / N-sweep twin's widest configurations
# in this run: its batch of 2048 cut to 256
SWEEP_PATHS = ((50, 256, 128), (60, 256, 128))


def sweep_phase(dev, card, counters):
    """``scripts/torch_soak_nsweep.py``'s ``run_cfg`` at N=50 and N=60 (its
    timed solve; the main paths above warmed the card): the production
    solver on the fused X route, with the NS chain's fully streamed layout
    and the packed-triangle fused interval at n = 300 and 360.  The counts
    are printed and not barred (the JAX package validated its constants up
    to N=40); each solve must give finite positions of the batch's shape
    and launch the kernels of its route and no other.  Returns the launch
    counts."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_soak_nsweep", ROOT / "scripts" / "torch_soak_nsweep.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    launches = dict.fromkeys(counters, 0)
    for n_veh, B, chunk in SWEEP_PATHS:
        _zero(counters)
        rec = twin.run_cfg(n_veh, B, chunk, device=dev, warmup=False)
        path = _read(counters)
        print(f"soak / N-sweep twin N={n_veh} B={B} chunk={chunk} on {card}: "
              f"{json.dumps(rec)}", flush=True)
        _check_route(f"N={n_veh} sweep path", path, _production_route(
            n_veh, _dispatch_batches(rec["timing"], chunk)))
        if rec["route"] != "fused_X":
            raise AssertionError(f"N={n_veh} routed {rec['route']}")
        for key, n in path.items():
            launches[key] += n
    return launches


# the certified oracle trajectories of ``scripts/parity_full.py`` and its
# engine configuration (``scripts/parity_full.py:114-117``)
ORACLES = ("docs/parity_oracle_cache/oracle_N20_seed7_K50.npz",
           "docs/parity_oracle_cache/oracle_N18_seed42_K50.npz")
ORACLE_VERSION = 5
PARITY_TOL = 1e-3                  # the repository's parity contract


def _parity_solver():
    from ba_path_planning_torch.utils.config import SolverConfig
    return SolverConfig(method="direct", eps_abs=1e-6, eps_rel=1e-6,
                        polish=True, rho=1.6, adaptive_rho=False,
                        max_iter=50000, check_interval=100)


def parity_phase(counters):
    """The parity contract on the card: each certified oracle trajectory
    of ``docs/parity_oracle_cache`` against ``SCPEngine.solve`` in float64
    with the parity configuration (the direct method to 1e-6, the exact
    active-set polish, the dense route: no sweep kernel, D by the one-pass
    assembly), from the oracle's own start and goal at rest.  Equal SCP iteration counts and max |dposition|
    and |dvelocity| within PARITY_TOL.  Returns the launch counts."""
    import numpy as np
    import torch
    from ba_path_planning_torch.solvers.banded import qp_route
    from ba_path_planning_torch.solvers.scp import SCPEngine
    from ba_path_planning_torch.utils.config import ProblemConfig
    solver = _parity_solver()
    total = {}
    for path in ORACLES:
        ref = np.load(ROOT / path)
        if int(ref["oracle_version"]) != ORACLE_VERSION:
            raise AssertionError(f"{path}: oracle_version "
                                 f"{int(ref['oracle_version'])}")
        n_veh = ref["p0"].shape[0]
        h = float(ref["h"])
        K = ref["positions"].shape[1]
        problem = ProblemConfig(n_vehicles=n_veh, time_horizon=K * h,
                                time_step=h, min_distance=float(ref["R"]),
                                max_iterations=int(ref["max_iterations"]))
        route = qp_route(solver.static_part(), n_vehicles=n_veh, n_steps=K,
                         dtype=torch.float64, col_enabled=True)
        eng = SCPEngine(problem, solver, dtype=torch.float64)
        p0, pf = ref["p0"], ref["pf"]
        v0 = np.zeros_like(p0)
        _zero(counters)
        t0 = time.perf_counter()
        res = eng.solve(p0, v0, pf, v0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read(counters)
        dpos = float(np.abs(res.positions.cpu().numpy()
                            - ref["positions"]).max())
        dvel = float(np.abs(res.velocities.cpu().numpy()
                            - ref["velocities"]).max())
        iters, want = int(res.iterations), int(ref["iterations"])
        print(f"parity phase {Path(path).name}: N={n_veh} K={K} f64 on the "
              f"card ({eng.device}), route {route}: SCP iterations {iters} "
              f"(oracle {want}), status {int(res.status)}, QP iterations "
              f"{int(res.qp_iterations)}, max |dposition|={dpos:.3e} m, max "
              f"|dvelocity|={dvel:.3e} m/s (contract {PARITY_TOL:g}); "
              f"engine {wall:.1f} s; launches={launches}", flush=True)
        _check_route(f"parity {path}", launches, ASSEMBLE)
        if eng.device.type != "cuda" or iters != want \
                or not (dpos <= PARITY_TOL and dvel <= PARITY_TOL):
            raise AssertionError(f"parity with {path} fails")
        for key, n in launches.items():
            total[key] = total.get(key, 0) + n
    return total


def adaptive_path(dev, card, n_veh, B, chunk, counters):
    """``solve_compacted`` with the production solver, adaptive rho over up
    to four intervals and the exact polish, at the bench.py configuration:
    the grouped sweep route at N=20 (the NS chain refactorizes the lanes
    whose rho adapts), the fused X route at N=30.  Returns the launch
    counts of the path."""
    import numpy as np
    import torch
    from ba_path_planning_torch.models.double_integrator import (
        DoubleIntegrator2D)
    from ba_path_planning_torch.parallel.mesh import ShardedSCPSolver
    from ba_path_planning_torch.scenarios.generator import (
        generate_scenario_batch)
    from ba_path_planning_torch.solvers.banded import solve_qp_state
    from ba_path_planning_torch.utils.config import SolverConfig
    problem = _problem(n_veh)
    solver = SolverConfig.production(problem=problem).replace(
        adaptive_rho=True, polish=True, max_iter=100)
    sh = ShardedSCPSolver(problem, solver, dtype=torch.float32, device=dev)
    sc = generate_scenario_batch(200 + n_veh, B, n_vehicles=n_veh,
                                 min_distance=R, dtype=torch.float32,
                                 device=dev)
    v0 = torch.zeros_like(sc.initial)
    torch.cuda.synchronize()
    _zero(counters)
    refac = solve_qp_state.refactorized_lanes
    t0 = time.perf_counter()
    out = sh.solve_compacted(sc.initial, v0, sc.final, v0, chunk=chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read(counters)
    refac = solve_qp_state.refactorized_lanes - refac
    K = problem.n_steps
    if not bool(torch.isfinite(out.positions).all()):
        raise AssertionError("non-finite positions")
    pK, _ = DoubleIntegrator2D(K, H).terminal_state(
        out.positions, out.velocities, out.accelerations)
    goal_ok = torch.linalg.vector_norm(pK - sc.final, dim=-1).amax(-1) < 0.05
    ok = int((out.feasible_final & goal_ok).sum())
    status = np.bincount(out.status.cpu().numpy(), minlength=3).tolist()
    print(f"adaptive-rho path (production, adaptive rho, polish, max_iter "
          f"100): B={B} chunk={chunk} N={n_veh} f32 on {card}: "
          f"wall={wall:.3f} s ok={ok}/{B} statuses={status} "
          f"mean_scp_iters={float(out.iterations.float().mean()):.3f} "
          f"mean_qp_iters={float(out.qp_iterations.float().mean()):.2f} "
          f"lanes refactorized after rho adapted={refac} "
          f"launches={launches}", flush=True)
    _check_route(f"adaptive N={n_veh} path", launches,
                 _production_route(n_veh, _dispatch_batches(sh.last_timing,
                                                            chunk)))
    if ok < int(np.ceil(0.99 * B)):
        raise AssertionError(f"only {ok}/{B} collision-free and goal-exact")
    return launches


def cg_phase(dev, counters, B=CG_B):
    """``SCPEngine(problem)`` with the default ``SolverConfig()`` (the CG
    method, adaptive rho, its polish) at N=20, K=50 on the card, the SCP
    loop cut to CG_SCP_ITERATIONS: B lanes in float32 and the same lanes in
    float64.  Finite results of the expected
    shape, valid statuses, equal statuses on at least ROUTE_SHARE of the
    lanes, and no hand-written kernel launched.  Prints the collision-free
    and QP-converged shares, ms per ADMM iteration and, from a profile of
    one check interval, device launches per ADMM iteration."""
    import numpy as np
    import torch
    from ba_path_planning_torch.scenarios.generator import (
        generate_scenario_batch)
    from ba_path_planning_torch.solvers import admm
    from ba_path_planning_torch.solvers.scp import SCPEngine
    n_veh = 20
    problem = _problem(n_veh, facade=True).replace(
        max_iterations=CG_SCP_ITERATIONS)
    sc = generate_scenario_batch(300, B, n_vehicles=n_veh, min_distance=R,
                                 dtype=torch.float64, device=dev)
    v0 = torch.zeros_like(sc.initial)
    out = {}
    _zero(counters)
    for dtype in (torch.float32, torch.float64):
        eng = SCPEngine(problem, dtype=dtype)
        if eng.solver.method != "cg" or eng.device.type != "cuda":
            raise AssertionError("SCPEngine(problem) is not the CG method "
                                 "on the card")
        its = admm.solve_qp_impl.iterations
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.solve_batch(sc.initial, v0, sc.final, v0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        its = admm.solve_qp_impl.iterations - its
        out[dtype] = res
        if tuple(res.positions.shape) != (B, n_veh, K_STEPS, 2) or not bool(
                torch.isfinite(res.positions).all()):
            raise AssertionError("CG phase: positions not finite or of "
                                 "another shape")
        st = res.status.cpu().numpy()
        if not np.isin(st, (0, 1, 2)).all():
            raise AssertionError(f"CG phase: invalid statuses {st}")
        print(f"CG phase (SCPEngine(problem), SolverConfig()): B={B} "
              f"N={n_veh} K={K_STEPS} {str(dtype)[6:]}: wall={wall:.1f} s "
              f"statuses={np.bincount(st, minlength=3).tolist()} "
              f"collision_free={int(res.feasible_final.sum())}/{B} "
              f"qp_converged_all={int(res.qp_converged_all.sum())}/{B} "
              f"mean_scp_iters={float(res.iterations.float().mean()):.2f} "
              f"mean_qp_iters={float(res.qp_iterations.float().mean()):.0f} "
              f"batch ADMM iterations={its} "
              f"({1e3 * wall / max(its, 1):.2f} ms each)", flush=True)
    launches = _read(counters)
    _check_route("CG phase", launches, set())
    same = out[torch.float32].status.cpu() == out[torch.float64].status.cpu()
    print(f"CG phase: float32 and float64 statuses equal on "
          f"{int(same.sum())}/{B} lanes (at least {ROUTE_SHARE:.0%}); "
          f"device launches per ADMM iteration "
          f"{_cg_launches_per_iteration(problem, sc, v0)}", flush=True)
    if int(same.sum()) < ROUTE_SHARE * B:
        raise AssertionError("CG phase: float32 and float64 disagree")
    return launches


def _cg_launches_per_iteration(problem, sc, v0):
    """Device kernels of one 5-iteration check interval of the CG method's
    QP (phase 1, float32, eager: a QP's first interval is not replayed),
    counted by ``torch.profiler``, per ADMM iteration; "not measured" where
    the profiler records no device kernel."""
    import torch
    from ba_path_planning_torch.ops.constraints import (ConstraintBlocks,
                                                        static_bounds)
    from ba_path_planning_torch.solvers import admm
    from ba_path_planning_torch.solvers.scp import SCPEngine
    from ba_path_planning_torch.utils.config import SolverConfig
    n_iters = 5
    eng = SCPEngine(problem, SolverConfig(max_iter=n_iters,
                                          check_interval=n_iters,
                                          polish=False), dtype=torch.float32)
    p0, v0_, pf = (t.float() for t in (sc.initial, v0, sc.final))
    lo, up = static_bounds(p0, v0_, pf, v0_, n_vehicles=problem.n_vehicles,
                           n_steps=problem.n_steps, h=H,
                           limits=problem.limits)
    B, K, P = p0.shape[0], problem.n_steps, eng.pairs.E.shape[1]
    inf = torch.full((B, K, P), float("inf"), device=p0.device)
    data = admm.QPData(eta=torch.zeros((B, K, P, 2), device=p0.device),
                       col_mask=torch.ones((), device=p0.device),
                       lower=ConstraintBlocks(col=-inf, **lo),
                       upper=ConstraintBlocks(col=inf, **up))

    def run():
        return admm.solve_qp_impl(
            data, eng.pairs.E, eng.Minv,
            torch.zeros((B, problem.n_vehicles, K, 2), device=p0.device),
            eng.solver_params, h=H, static=eng.solver_static)
    per = _launches_per_iteration(run, n_iters)
    return per if isinstance(per, str) else f"{per:.0f}"



# route of the reference-compatible path -> (solver options, its kernels)
FACADE_ROUTES = {
    "grouped_L": (dict(kernels=True),
                  {"group_solve_l"} | ROW_STAGES | PHASE1 | ASSEMBLE),
    "resident": (dict(kernels=True, group=-1),
                 {"banded_solve"} | ROW_STAGES | PHASE1 | ASSEMBLE),
    "fused_L": (dict(kernels=True, group=-1, fused=True),
                {"admm_fused_l"} | PHASE1 | ASSEMBLE),
}


def facade_path(dev, card, route, counters, adaptive=False,
                factor_dtype="f32", max_iterations=None):
    """The reference-compatible path on one kernel route: one
    ``SCPEngine.solve_batch`` over FACADE_B scenarios at N=20 with the
    ``SCP`` class's problem and solver (no device given: the engine runs on
    the card), with ``adaptive`` its rho adaptive, its factors stored in
    ``factor_dtype`` and its SCP loop cut to ``max_iterations``.  Returns
    the result and the launch counts of this path."""
    import numpy as np
    import torch
    from ba_path_planning_torch.scenarios.generator import (
        generate_scenario_batch)
    from ba_path_planning_torch.solvers.banded import qp_route
    from ba_path_planning_torch.solvers.scp import SCPEngine
    n_veh, B = 20, FACADE_B
    change, kernels = FACADE_ROUTES[route]
    problem = _problem(n_veh, facade=True)
    if max_iterations is not None:
        problem = problem.replace(max_iterations=max_iterations)
    solver = _facade_solver(**change, adaptive_rho=adaptive,
                            factor_dtype=factor_dtype)
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
    print(f"reference-compatible path, route {route}"
          f"{', adaptive rho' if adaptive else ''}"
          f"{', bf16 factors' if factor_dtype == 'bf16' else ''}"
          f"{'' if max_iterations is None else f', SCP loop cut to {max_iterations}'}"
          f": B={B} N={n_veh} "
          f"K={K_STEPS} R={R} f32 on {card}: wall={wall:.3f} s "
          f"statuses={status} "
          f"collision_free={int(out.feasible_final.sum())}/{B} "
          f"mean_scp_iters={float(out.iterations.float().mean()):.3f} "
          f"mean_qp_iters={float(out.qp_iterations.float().mean()):.1f} "
          f"max_qp_iters={int(out.qp_iterations.max())} "
          f"qp_converged_all={int(out.qp_converged_all.sum())}/{B} "
          f"peak_mem={torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
          f"launches={launches}", flush=True)
    _check_route(f"route {route}", launches, kernels)
    return out, launches


def facade_call(counters, defaults=False):
    """One ``SCP(...).generate_trajectories()`` call, one scenario of N=20
    and T=10 (``defaults``: the CLI's own defaults, N=10 and T=100, K=500),
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
    shape_args = [] if defaults else ["--n-vehicles", "20", "--time-horizon",
                                      str(T_HORIZON)]
    _zero(counters)
    t0 = time.perf_counter()
    try:
        rc = compute_trajectories.main(shape_args + ["--no-viz", "--seed",
                                                     "7"])
    finally:
        SCP.generate_trajectories = solve
    wall = time.perf_counter() - t0
    launches = _read(counters)
    if rc != 0 or len(planners) != 1:
        raise AssertionError(f"compute_trajectories exited {rc}")
    scp = planners[0]
    pos = scp.trajectories["positions"]
    want = (10, 500, 2) if defaults else (20, K_STEPS, 2)
    if pos.shape != want or not np.isfinite(pos).all() \
            or scp._device.type != "cuda":
        raise AssertionError("the SCP class gave no trajectory on the card")
    _check_route("the SCP class", launches, FACADE_ROUTES["grouped_L"][1])
    print(f"SCP class (compute_trajectories CLI{', its defaults' if defaults else ''}"
          f", N={want[0]} K={want[1]}): status="
          f"{int(scp.result.status)} scp_iters={int(scp.result.iterations)} "
          f"collision_free={bool(scp.result.feasible_final)} qp_iters="
          f"{int(scp.result.qp_iterations)} wall={wall:.2f} s "
          f"launches={launches}", flush=True)
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
        # its dispatches are the CLI's own: a tail of 32 lanes at N=30 may
        # take the fused interval's wide tier
        _check_route(f"batch CLI {name}", launches, route,
                     maybe={"admm_fused_x_wide"})
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


# bf16 factor storage: the sweeps at (N, B) (the N=20 paths' chunk, the
# reference-compatible batch and the SCP class's single scenario; N=21
# and N=30, whose rows lie on a padded stride), the L-form fused interval
# at N=20 and these batches
BF16_SWEEPS = ((20, 512), (20, 64), (20, 1), (21, 128), (30, 128))
BF16_FUSED_B = (128, 64)


def _bf16_sweep(form, factors, C, b, b_admm, n_veh):
    """A sweep kernel on bf16 factors (``compress_factors`` of the float32
    ``factors``) against its plain version on the same bf16 factors, as
    :func:`_sweep_check` holds the float32 ones; the kernel on the float32
    factors is timed beside it.  Returns the bf16 kernel's stats, with its
    bound at 2 bytes an element and ``f32_ms``."""
    import torch
    from ba_path_planning_torch.ops import banded_solve, group_solve
    from ba_path_planning_torch.solvers import banded
    kernel, plain = {
        "X": (group_solve.solve_factorized_grouped_X,
              group_solve.solve_factorized_grouped_X_plain),
        "L": (group_solve.solve_factorized_grouped_L,
              group_solve.solve_factorized_grouped_L_plain),
        "dense": (banded_solve.solve_factorized_dense,
                  banded_solve.solve_factorized_dense_plain)}[form]
    stored = banded.compress_factors(*factors)
    ops = stored + (() if form == "dense" else (C,))
    B, K, n = b.shape
    ld = stored[0].stride(-2)
    err, ms, plain_ms = _sweep_check(
        f"bf16 phase B={B} N={n_veh} K={K} (rows of {ld}): {kernel.__name__} "
        f"on bf16 factors ({_plan(b, form)}; bf16 plan: "
        f"{group_solve.sweep_plan(B, K, n, form, esize=2)})", kernel, plain,
        ops, b, b_admm)
    f32_ms = _time_ms(lambda: kernel(*factors, *ops[len(stored):], b),
                      reps=20)
    # factor blocks read once (X, L: K; dense: K + K - 1) and streamed at
    # every sweep step (X, L: 2K - 1; dense: 4K - 3), 2 bytes an element
    # on rows of ld; b read and x written in FP32
    # on rows of ld; b read and x written in FP32.  Linv is lower
    # triangular: the L form needs n (n + 1) / 2 elements of a block
    blocks, chain = ((K, 2 * K - 1) if form != "dense"
                     else (2 * K - 1, 4 * K - 3))
    vec = 2 * K * n * 4
    flops = {"X": 2 * K * 2, "L": 4 * K * 2, "dense": (4 * K - 2) * 2}[form]
    elems = (n + 1) * ld // 2 if form == "L" else n * ld
    ops_n = n * (n + 1) // 2 if form == "L" else n * n
    stats = _stat(err, ms, plain_ms, f"N={n_veh} K={K} B={B}",
                  B * (blocks * elems * 2 + vec), B * flops * ops_n,
                  B * (chain * elems * 2 + vec))
    stats.update(f32_ms=f32_ms, factor_dtype="bf16", row_stride=ld)
    what = "Linv's lower triangle " if form == "L" else ""
    if form == "L":
        stats["whole_block_stream_bound_ms"] = _bound_ms(
            B * (chain * n * ld * 2 + vec), B * flops * n * n)[0]
    print(f"  {kernel.__name__} B={B} N={n_veh}: bf16 {ms:.3f} ms beside "
          f"f32 {f32_ms:.3f} ms (bf16 / f32 {ms / f32_ms:.3f}); bound at 2 "
          f"bytes an element {stats['bound_ms']:.3f} ms, {what}streamed "
          f"{stats['stream_bound_ms']:.3f} ms "
          f"({stats['stream_bound_ms'] / ms:.0%} of the kernel)", flush=True)
    return stats


def _ptxas_of(fragment):
    """What ptxas reported (registers, spill stores and loads) of each
    kernel whose mangled name holds ``fragment``, from the build's log:
    {name: report}; empty where the library came from the cache."""
    import re
    from ba_path_planning_torch.ops import cuda_build
    out, name = {}, None
    for ln in cuda_build.build_info.get("log", "").splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", ln)
        if entry:
            name = entry.group(1) if fragment in entry.group(1) else None
        elif name and ("spill" in ln or "registers" in ln):
            out.setdefault(name, []).append(
                ln.split(":", 1)[-1].strip() if "ptxas" in ln
                else ln.strip())
    return {key: "; ".join(v) for key, v in out.items()}


def bf16_kernel_phase(dev):
    """The four factor-streaming kernels on bf16 factors: the X-form sweep
    on the production factors (the NS chain route), the L-only and dense
    sweeps and the L-form fused interval on the reference-compatible
    solver's block Cholesky, each against its plain version on the same
    bf16 factors, timed beside its float32 self.  Returns the stats of
    each kernel at its main-path shape (sweeps N=20 B=512, fused B=128),
    with the other shapes' times beside."""
    import re
    import torch
    from ba_path_planning_torch.ops import admm_fused, ns_chain
    from ba_path_planning_torch.solvers import banded
    # the instantiations of the L and dense forms (sweep_kernel<form, tier,
    # T, blocks an SM>) and of the L-form fused interval
    # (admm_fused_l_kernel<octets, T>)
    for label, fragment, pattern in (
            ("L-form sweep, tier n <=", "sweep_kernelILi1E",
             r"ILi1ELi(\d+)E(13__nv_bfloat16|f)(?:Li(\d+)E)?E"),
            ("dense sweep, tier n <=", "sweep_kernelILi2E",
             r"ILi2ELi(\d+)E(13__nv_bfloat16|f)(?:Li(\d+)E)?E"),
            ("L-form fused interval, column octets", "admm_fused_l_kernel",
             r"admm_fused_l_kernelILi(\d+)E(13__nv_bfloat16|f)()E")):
        for name, report in _ptxas_of(fragment).items():
            tier = re.search(pattern, name)
            what = (f"{label} {tier.group(1)}, "
                    f"{'bf16' if tier.group(2) != 'f' else 'f32'}"
                    + (f", {tier.group(3)} blocks an SM" if tier.group(3)
                       else "") if tier else name)
            print(f"bf16 phase: ptxas, {what}: {report}", flush=True)
    out = {}
    for n_veh, B in BF16_SWEEPS:
        D, C, b, b_admm, _ = _case(n_veh, B, dev, seed=3000 + n_veh + B)
        X = ns_chain.factorize_X_chain_batched(D, C, ns_iters=2)
        del D
        row = {"group_solve_x": _bf16_sweep("X", (X,), C, b, b_admm, n_veh)}
        del X
        D, C, b, b_admm, _ = _case(n_veh, B, dev, seed=4000 + n_veh + B,
                                   solver=_facade_solver())
        Linv, Eb = banded.factorize(D, banded.slot_dense(C, 2 * n_veh))
        del D
        row["group_solve_l"] = _bf16_sweep("L", (Linv,), C, b, b_admm,
                                           n_veh)
        row["banded_solve"] = _bf16_sweep("dense", (Linv, Eb), C, b, b_admm,
                                          n_veh)
        del Linv, Eb
        for key, stats in row.items():
            if (n_veh, B) == BF16_SWEEPS[0]:
                out[key] = stats
            else:
                at = f"N{n_veh}_B{B}" if n_veh != 20 else f"B{B}"
                out[key][f"ms_at_{at}"] = stats["ms"]
                out[key][f"f32_ms_at_{at}"] = stats["f32_ms"]
                out[key][f"stream_bound_ms_at_{at}"] = stats[
                    "stream_bound_ms"]
    n_veh, K, n = 20, K_STEPS, 120
    for B in BF16_FUSED_B:
        D, C, _, _, kw = _case(n_veh, B, dev, seed=5000 + B,
                               solver=_facade_solver())
        Linv, Eb = banded.factorize(D, banded.slot_dense(C, 2 * n_veh))
        del D, kw["C"]
        L16, E16 = banded.compress_factors(Linv, Eb)
        ld = L16.stride(-2)
        x = kw["x"]
        z = banded.tree_map(torch.clamp,
                            banded.apply_A(x, kw["eta"], kw["E"], H),
                            kw["lower"], kw["upper"])
        y = banded.tree_map(torch.zeros_like, z)
        f32_ms = _time_ms(lambda: admm_fused.admm_interval_fused(
            Linv, Eb, **{k: v for k, v in kw.items() if k != "x"}, x=x, z=z,
            y=y, n_iters=25))
        stats = fused_check(
            f"bf16 phase: admm_interval_fused on bf16 factors (rows of {ld}, "
            f"{admm_fused.fused_plan(K, n_veh, 'L', esize=2)})",
            admm_fused.admm_interval_fused,
            admm_fused.admm_interval_fused_plain,
            dict(kw, Linv=L16, Eb=E16), n_veh, (2 * K - 1) * n * ld,
            needed_floats=K * n * (n + 1) // 2 + (K - 1) * n * n,
            factor_bytes=2)
        stats.update(f32_ms=f32_ms, factor_dtype="bf16", row_stride=ld)
        print(f"  admm_interval_fused B={B} N={n_veh}: bf16 "
              f"{stats['ms']:.3f} ms beside f32 {f32_ms:.3f} ms "
              f"({f32_ms / stats['ms']:.2f}x); bound at 2 bytes an element "
              f"{stats['bound_ms']:.3f} ms, streamed "
              f"{stats['stream_bound_ms']:.3f} ms", flush=True)
        if B == BF16_FUSED_B[0]:
            out["admm_fused_l"] = stats
        else:
            out["admm_fused_l"][f"ms_at_B{B}"] = stats["ms"]
            out["admm_fused_l"][f"f32_ms_at_B{B}"] = f32_ms
            out["admm_fused_l"][f"stream_bound_ms_at_B{B}"] = stats[
                "stream_bound_ms"]
        del Linv, Eb, L16, E16
    return out


# the SCP loop of the reference-compatible solver in bf16: its QPs do not
# reach eps 1e-3 on bf16 factors, so every lane runs every SCP iteration at
# the full 2000 ADMM iterations; the loop is cut to this depth
BF16_FACADE_SCP = 2


def bf16_paths(dev, card, counters, f32_facade):
    """The bf16 paths: production with ``factor_dtype="bf16"`` at N=20
    (B=1024, chunk 512; the grouped X route: at least 99% ok, beside the
    f32 path's numbers) and the ``SCP`` class's solver in bf16 on its three
    kernel routes (B=64, its SCP loop cut to BF16_FACADE_SCP iterations,
    beside the f32 routes' statuses).  Returns the launch counts of each
    kernel on these paths."""
    import numpy as np
    from ba_path_planning_torch.utils.config import SolverConfig
    launches = {}

    def add(path):
        for key, n in path.items():
            launches[key] = launches.get(key, 0) + n
    n_veh, B, chunk = MAIN_PATHS[0]
    solver = SolverConfig.production(problem=_problem(n_veh)).replace(
        factor_dtype="bf16")
    add(main_path(dev, card, n_veh, B, chunk, counters, solver=solver,
                  label="bf16"))
    got, f32 = PATH_STATS["bf16"], PATH_STATS[f"N={n_veh}"]
    print(f"  bf16 beside f32: ok {got['ok']} / {f32['ok']}, statuses "
          f"{got['statuses']} / {f32['statuses']}, mean SCP iterations "
          f"{got['mean_scp_iters']:.3f} / {f32['mean_scp_iters']:.3f}, mean "
          f"QP iterations {got['mean_qp_iters']:.2f} / "
          f"{f32['mean_qp_iters']:.2f}, wall {got['wall']:.3f} / "
          f"{f32['wall']:.3f} s", flush=True)
    for route in FACADE_ROUTES:
        res, path = facade_path(dev, card, route, counters,
                                factor_dtype="bf16",
                                max_iterations=BF16_FACADE_SCP)
        add(path)
        ref = f32_facade[route]
        same = int((res.status == ref.status).sum())
        print(f"  route {route}, bf16 beside f32: statuses "
              f"{np.bincount(res.status.cpu().numpy(), minlength=3).tolist()}"
              f" / {np.bincount(ref.status.cpu().numpy(), minlength=3).tolist()}"
              f", equal status on {same}/{res.status.numel()} lanes, mean QP "
              f"iterations {float(res.qp_iterations.float().mean()):.1f} / "
              f"{float(ref.qp_iterations.float().mean()):.1f}", flush=True)
        if not all(bool(t.isfinite().all()) for t in res
                   if t.is_floating_point() and t is not res.rel_step):
            raise AssertionError(f"bf16 {route}: non-finite output")
    return launches


# two ranks share the card over gloo (NCCL refuses two ranks on one device)
PARALLEL_RANKS, PARALLEL_TIMEOUT = 2, 300.0
PARALLEL_PATH = (20, 512, 512)     # N, global scenarios, global chunk
PAIR_N, ROLLOUT_K = 20, 500
PAIR_TOL = 1e-6                    # metres, float64


def _pair_solver():
    """The pair-sharded solver of the JAX package's test
    (``tests/test_pair_sharded.py``)."""
    from ba_path_planning_torch.utils.config import SolverConfig
    return SolverConfig(method="direct", adaptive_rho=False, polish=False,
                        max_iter=60, check_interval=30, rho=1.6,
                        collision_margin=0.05)


def _parallel_rank(rank, world, port, inp, out_dir):
    """One rank of the parallel phase, on the card: the scenario-parallel
    ``solve_compacted``, the pair-sharded solve and the K-sharded rollout;
    rank 0 writes what it got."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from ba_path_planning_torch.ops.cuda_build import load_kernels
    from ba_path_planning_torch.parallel import horizon_sharded as hs
    from ba_path_planning_torch.parallel.distributed import init_distributed
    from ba_path_planning_torch.parallel.mesh import ShardedSCPSolver
    from ba_path_planning_torch.parallel.pair_sharded import (
        PairShardedSCPSolver)
    from ba_path_planning_torch.utils.config import SolverConfig
    dev = torch.device("cuda", 0)
    init_distributed("gloo", f"tcp://127.0.0.1:{port}", world, rank,
                     timeout_s=PARALLEL_TIMEOUT)
    load_kernels()
    out = {}
    n_veh, B, chunk = PARALLEL_PATH
    problem = _problem(n_veh)
    sh = ShardedSCPSolver(problem, SolverConfig.production(problem=problem),
                          dtype=torch.float32, device=dev)
    warm, args = ([torch.as_tensor(inp[pre + k], device=dev)
                   for k in ("p0", "pf")] for pre in ("warm_", ""))
    z = torch.zeros_like(args[0])
    sh.solve_compacted(warm[0], z, warm[1], z, chunk=chunk)   # warm-up

    torch.cuda.synchronize()
    dist.all_reduce(torch.zeros(1, device=dev))             # start together
    t0 = time.perf_counter()
    res = sh.solve_compacted(args[0], z, args[1], z, chunk=chunk)
    torch.cuda.synchronize()
    out["wall"] = np.array(time.perf_counter() - t0)
    for name in ("status", "iterations", "positions", "feasible_final"):
        out["scenario_" + name] = getattr(res, name).cpu().numpy()
    ps = PairShardedSCPSolver(_problem(PAIR_N), _pair_solver(),
                              dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    res = ps.solve(*(inp["pair_" + k] for k in ("p0", "v0", "pf", "vf")))
    torch.cuda.synchronize()
    out["pair_wall"] = np.array(time.perf_counter() - t0)
    for name in ("status", "iterations", "positions"):
        out["pair_" + name] = getattr(res, name).cpu().numpy()
    a, p0 = (torch.as_tensor(inp[k], device=dev) for k in ("roll_a", "roll_p0"))
    pos, vel = hs.rollout_ksharded(a, p0, torch.zeros_like(p0), H)
    out["roll_pos"] = hs.gather_k(pos, -2).cpu().numpy()
    out["roll_vel"] = hs.gather_k(vel, -2).cpu().numpy()
    if rank == 0:
        np.savez(f"{out_dir}/parallel.npz", **out)
    dist.destroy_process_group()


def parallel_phase(dev, card):
    """Two gloo ranks share the card, on CUDA tensors, through the entry
    points of ``parallel/``: the scenario-parallel
    ``ShardedSCPSolver.solve_compacted`` (N=20, B=512 global, chunk 512)
    against a one-rank solve (statuses and SCP counts equal on at least
    ROUTE_SHARE of the lanes, positions within ROUTE_TOL there: the sweep
    plans differ with the batch); ``PairShardedSCPSolver`` on one N=20
    scenario in float64 against ``SCPEngine`` on the dense route (equal
    status and SCP iterations, positions within PAIR_TOL); and
    ``rollout_ksharded`` at K=500 against ``rollout``.  Fails if a rank
    fails or outlasts PARALLEL_TIMEOUT."""
    import multiprocessing as mp
    import shutil
    import socket
    import numpy as np
    import torch
    from ba_path_planning_torch.ops.rollout import rollout
    from ba_path_planning_torch.parallel.mesh import ShardedSCPSolver
    from ba_path_planning_torch.scenarios.generator import (
        generate_scenario_batch)
    from ba_path_planning_torch.solvers.scp import SCPEngine
    from ba_path_planning_torch.utils.config import SolverConfig
    n_veh, B, chunk = PARALLEL_PATH
    sc, warm = (generate_scenario_batch(seed, B, n_vehicles=n_veh,
                                        min_distance=R, dtype=torch.float32,
                                        device="cpu") for seed in (600, 603))
    pair = generate_scenario_batch(601, 1, n_vehicles=PAIR_N, min_distance=R,
                                   dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(602)
    inp = {"p0": sc.initial.numpy(), "pf": sc.final.numpy(),
           "warm_p0": warm.initial.numpy(), "warm_pf": warm.final.numpy(),
           "pair_p0": pair.initial[0].numpy(),
           "pair_v0": np.zeros((PAIR_N, 2)), "pair_pf": pair.final[0].numpy(),
           "pair_vf": np.zeros((PAIR_N, 2)),
           "roll_a": rng.normal(size=(n_veh, ROLLOUT_K, 2)).astype(np.float32),
           "roll_p0": rng.uniform(2, 18, (n_veh, 2)).astype(np.float32)}
    out_dir = ROOT / "build" / "smoke_parallel"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_parallel_rank,
                         args=(r, PARALLEL_RANKS, port, inp, str(out_dir)))
             for r in range(PARALLEL_RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + PARALLEL_TIMEOUT
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    if hung or any(p.exitcode != 0 for p in procs):
        raise AssertionError(
            f"parallel phase: exit codes {[p.exitcode for p in procs]}, "
            f"{len(hung)} rank(s) past {PARALLEL_TIMEOUT:g} s")
    got = dict(np.load(out_dir / "parallel.npz"))
    ranks_s = time.perf_counter() - t0

    # one rank, here: the same scenarios, the same solvers
    problem = _problem(n_veh)
    one = ShardedSCPSolver(problem, SolverConfig.production(problem=problem),
                           dtype=torch.float32, device=dev)
    p0, pf = sc.initial.to(dev), sc.final.to(dev)
    z = torch.zeros_like(p0)
    t1 = time.perf_counter()
    ref = one.solve_compacted(p0, z, pf, z, chunk=chunk)
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t1
    same = ((ref.status.cpu().numpy() == got["scenario_status"])
            & (ref.iterations.cpu().numpy() == got["scenario_iterations"]))
    diff = np.abs(ref.positions.cpu().numpy()
                  - got["scenario_positions"]).reshape(B, -1).max(-1)
    close = same & (diff <= ROUTE_TOL)
    print(f"parallel phase ({PARALLEL_RANKS} gloo ranks sharing {card}; "
          f"ranks up and done in {ranks_s:.1f} s): scenario-parallel "
          f"solve_compacted N={n_veh} B={B} chunk={chunk}: wall "
          f"{float(got['wall']):.3f} s (one rank: {one_wall:.3f} s), "
          f"collision-free {int(got['scenario_feasible_final'].sum())}/{B}; "
          f"equal status and SCP iterations on {int(same.sum())}/{B} lanes, "
          f"max position difference on those {diff[same].max():.3e} m "
          f"(tol {ROUTE_TOL:g} m on {ROUTE_SHARE:.0%})", flush=True)
    if int(close.sum()) < ROUTE_SHARE * B:
        raise AssertionError("scenario-parallel solve disagrees with one "
                             "rank")
    eng = SCPEngine(_problem(PAIR_N), _pair_solver().replace(
        kernels=False, group=-1, fused=False), dtype=torch.float64,
        device=dev)
    pref = eng.solve(*(torch.as_tensor(inp["pair_" + k], device=dev)
                       for k in ("p0", "v0", "pf", "vf")))
    pdiff = float(np.abs(pref.positions.cpu().numpy()
                         - got["pair_positions"]).max())
    print(f"  pair-sharded N={PAIR_N} float64 (dense route): status "
          f"{int(got['pair_status'])} / {int(pref.status)}, SCP iterations "
          f"{int(got['pair_iterations'])} / {int(pref.iterations)}, max "
          f"position difference {pdiff:.3e} m (tol {PAIR_TOL:g}), "
          f"{float(got['pair_wall']):.2f} s", flush=True)
    if (int(got["pair_status"]) != int(pref.status)
            or int(got["pair_iterations"]) != int(pref.iterations)
            or not pdiff <= PAIR_TOL):
        raise AssertionError("pair-sharded solve disagrees with the engine")
    a, rp0 = (torch.as_tensor(inp[k], device=dev)
              for k in ("roll_a", "roll_p0"))
    pos, vel = rollout(a, rp0, torch.zeros_like(rp0), H)
    rdiff = float(np.abs(pos.cpu().numpy() - got["roll_pos"]).max())
    vdiff = float(np.abs(vel.cpu().numpy() - got["roll_vel"]).max())
    scale = float(pos.abs().max())
    print(f"  rollout_ksharded K={ROLLOUT_K} f32: max |position "
          f"difference| {rdiff:.3e} m of {scale:.1f} m, velocity "
          f"{vdiff:.3e} m/s", flush=True)
    if not (np.isfinite(got["roll_pos"]).all() and rdiff <= 1e-5 * scale):
        raise AssertionError("rollout_ksharded disagrees with rollout")


# the modules phase: train-network, plot-collisions, the sanitizer, the
# tracer, the matmul-form Cholesky and the native QP
# The bars of the port's train-network run, from the CPU runs of
# scripts/collision_net_jax_reference.py: the feasible fraction of the JAX
# CLI at its defaults, and the eval AUC and loss of JAX's training at the
# CLI's defaults on the port's own scenarios, the data this run trains on
# (the eval loss follows the base rate of the held-out split, which depends
# on the data: 21 positives in the JAX CLI's split, 33 in the port's)
JAX_TRAIN = dict(feasible_fraction=0.01416015625, eval_auc=0.8464268856792221,
                 eval_loss=0.07798689603805542)
TRAIN_FRACTION_TOL, TRAIN_AUC_TOL, TRAIN_LOSS_TOL = 0.03, 0.05, 0.05
TRAIN_AUC_MIN_CLASS = 50           # lanes of each class for the AUC bar
LABEL_LANES, LABEL_AGREE = 512, 0.99   # card labels against the CPU's
PROFILE_TOL = 1e-5                 # metres, collision_profile card vs CPU
# (B, n) of the NS chain's anchors on the main paths; the L-form shape
ANCHOR_SHAPES = ((512, 120), (128, 180), (128, 240))
LFORM_SHAPE = (64, 50, 120)        # B, K, n: N=20 on the reference path
SANITIZER_N, SANITIZER_B = 20, 64  # one production solve, then a batch
TRACE_PATH = (20, 1024, 512)       # N, scenarios, chunk of the traced solve


def _train_network_part(dev, tmp):
    """train-network at its defaults on the card, its labels against the
    CPU's, its rates against the JAX CLI's, its npz reloaded."""
    import numpy as np
    import torch
    from ba_path_planning_torch.cli import train_collision_network as tcli
    from ba_path_planning_torch.models.collision_net import (
        load_params, predict_logits, save_params)
    from ba_path_planning_torch.utils.config import ProblemConfig
    args = tcli.build_parser().parse_args(["--out", str(tmp / "net.npz")])
    problem = ProblemConfig(n_vehicles=args.n_vehicles,
                            time_horizon=args.time_horizon,
                            time_step=args.time_step,
                            min_distance=args.min_distance)
    t0 = time.perf_counter()
    p0, pf, y = tcli.label_chunks(problem, args.samples, args.label_chunk,
                                  args.seed, dev)
    t_label = time.perf_counter() - t0
    t0 = time.perf_counter()
    net, ev, losses, steps = tcli.train(p0, pf, y, args, dev,
                                        log=lambda s: None)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    m = tcli.evaluate(net, p0[ev], pf[ev], y[ev])
    t0 = time.perf_counter()
    _, _, y_cpu = tcli.label_chunks(problem, LABEL_LANES, args.label_chunk,
                                    args.seed, "cpu")
    t_cpu = time.perf_counter() - t0
    agree = float((y_cpu == y[:LABEL_LANES]).mean())
    frac = float(y.mean())
    print(f"modules: train-network N={args.n_vehicles} samples="
          f"{args.samples} epochs={args.epochs} batch={args.batch_size} "
          f"hidden={args.hidden} f32: feasible fraction {frac:.5f} (JAX CPU "
          f"{JAX_TRAIN['feasible_fraction']:.5f}); final epoch loss "
          f"{losses[-1]:.5f}; eval acc {m['acc']:.4f} auc {m['auc']:.4f} "
          f"loss {m['loss']:.5f} (JAX on the same scenarios, CPU: auc "
          f"{JAX_TRAIN['eval_auc']:.4f} loss {JAX_TRAIN['eval_loss']:.5f}; "
          f"n={m['n']} with "
          f"{m['n_pos']} / {m['n_neg']} of each class); label "
          f"{t_label:.2f} s, train {t_train:.2f} s, {steps} steps, "
          f"{steps / t_train:.1f} steps/s; first {LABEL_LANES} labels equal "
          f"to the CPU's on {agree:.4f} of the lanes ({t_cpu:.1f} s)",
          flush=True)
    if agree < LABEL_AGREE:
        raise AssertionError(f"card and CPU labels agree on {agree:.4f}")
    if abs(frac - JAX_TRAIN["feasible_fraction"]) > TRAIN_FRACTION_TOL:
        raise AssertionError(f"feasible fraction {frac} off JAX's")
    if min(m["n_pos"], m["n_neg"]) >= TRAIN_AUC_MIN_CLASS:
        if m["auc"] < JAX_TRAIN["eval_auc"] - TRAIN_AUC_TOL:
            raise AssertionError(f"eval AUC {m['auc']} below JAX's bar")
    elif m["loss"] > JAX_TRAIN["eval_loss"] + TRAIN_LOSS_TOL:
        raise AssertionError(f"eval loss {m['loss']} above JAX's bar")
    save_params(args.out, net)
    again = load_params(args.out, device=dev)
    inp = [torch.as_tensor(a[ev], device=dev) for a in (p0, pf)]
    if not torch.equal(predict_logits(net, *inp),
                       predict_logits(again, *inp)):
        raise AssertionError("reloaded network predicts other logits")


def _plot_collisions_part(dev, counters):
    """plot-collisions' solve and profile at its defaults, and the profile
    of the N=20 main path on the card against the CPU; the closest
    approach of every lane the solver calls feasible."""
    import torch
    from ba_path_planning_torch.viz import plot_collisions
    args = plot_collisions.build_parser().parse_args([])
    _zero(counters)
    t0 = time.perf_counter()
    _, out, prof = plot_collisions.analyse(args, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read(counters)
    pos, ff = PATH_POSITIONS["N=20"]
    main_prof = plot_collisions.collision_profile(pos)
    diff = float((main_prof.cpu() - plot_collisions.collision_profile(
        pos.cpu())).abs().max())
    feas = out.feasible_final
    closest = [float(p[f].min()) if bool(f.any()) else float("inf")
               for p, f in ((prof, feas), (main_prof, ff))]
    print(f"modules: plot-collisions N={args.n_vehicles} trials="
          f"{args.trials}: {int(feas.sum())}/{len(feas)} collision-free, "
          f"closest approach of those {closest[0]:.4f} m, wall {wall:.2f} s, "
          f"launches={launches}; N=20 main path profile card vs CPU max "
          f"|diff| {diff:.3e} m, closest approach of its {int(ff.sum())} "
          f"feasible lanes {closest[1]:.4f} m", flush=True)
    if diff > PROFILE_TOL:
        raise AssertionError(f"collision_profile card vs CPU {diff}")
    if min(closest) < R - 0.01:
        raise AssertionError(f"a feasible lane comes within {min(closest)}")
    return launches


def _sanitizer_part(dev, counters):
    """checked() on one clean N=20 production solve, on one with a NaN
    input, and find_nan_lanes on a B=64 batch with one poisoned lane."""
    import torch
    from ba_path_planning_torch.scenarios import generate_scenario_batch
    from ba_path_planning_torch.solvers.scp import SCPEngine
    from ba_path_planning_torch.utils.config import SolverConfig
    from ba_path_planning_torch.utils.debug import checked, find_nan_lanes
    problem = _problem(SANITIZER_N)
    eng = SCPEngine(problem, SolverConfig.production(problem=problem),
                    dtype=torch.float32, device=dev)
    sc = generate_scenario_batch(7, SANITIZER_B, n_vehicles=SANITIZER_N,
                                 min_distance=R, device=dev)
    p0, pf = sc.initial, sc.final
    v0 = torch.zeros_like(p0)
    eng.solve(p0[0], v0[0], pf[0], v0[0])        # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.solve(p0[0], v0[0], pf[0], v0[0])
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    _zero(counters)
    t0 = time.perf_counter()
    err, res = checked(eng.solve_fn())(p0[0], v0[0], pf[0], v0[0])
    clean = err.get()
    t_checked = time.perf_counter() - t0
    launches = _read(counters)
    # a NaN lane never stops: its SCP loop is cut to one iteration here
    eng1 = SCPEngine(problem.replace(max_iterations=1),
                     SolverConfig.production(problem=problem),
                     dtype=torch.float32, device=dev)
    bad_p0 = p0[0].clone()
    bad_p0[3, 0] = float("nan")
    t0 = time.perf_counter()
    poisoned = checked(eng1.solve_fn())(bad_p0, v0[0], pf[0], v0[0])[0].get()
    t_poisoned = time.perf_counter() - t0
    lane = SANITIZER_B // 4 + 1
    p0b = p0.clone()
    p0b[lane, 2, 1] = float("nan")
    flagged = torch.nonzero(find_nan_lanes(
        eng.solve_batch(p0b, v0, pf, v0))).flatten().tolist()
    print(f"modules: sanitizer N={SANITIZER_N} production: clean solve "
          f"{clean!r} "
          f"(status {int(res.status)}, {t_checked:.2f} s checked, "
          f"{t_plain:.2f} s unchecked, launches={launches}); NaN input "
          f"(one SCP iteration, {t_poisoned:.2f} s): {poisoned!r}; "
          f"find_nan_lanes on B={SANITIZER_B} with lane {lane} "
          f"poisoned: "
          f"{flagged}", flush=True)
    if clean is not None:
        raise AssertionError(f"a check fired on a clean solve: {clean}")
    if poisoned is None:
        raise AssertionError("no check fired on a NaN input")
    if flagged != [lane]:
        raise AssertionError(f"find_nan_lanes flagged {flagged}")
    return launches


def _trace_part(dev, counters, tmp, kstats, lstats, gstats):
    """profiling.trace over one N=20, B=1024 production solve, and the cost
    models' bounds beside the kernel phases' times of the same shapes."""
    import torch
    from ba_path_planning_torch.parallel.mesh import ShardedSCPSolver
    from ba_path_planning_torch.scenarios import generate_scenario_batch
    from ba_path_planning_torch.utils import profiling
    from ba_path_planning_torch.utils.config import SolverConfig
    n_veh, B, chunk = TRACE_PATH
    problem = _problem(n_veh)
    sh = ShardedSCPSolver(problem, SolverConfig.production(problem=problem),
                          dtype=torch.float32, device=dev)
    sc = generate_scenario_batch(100, B, n_vehicles=n_veh, min_distance=R,
                                 device=dev)
    v0 = torch.zeros_like(sc.initial)
    _zero(counters)
    t0 = time.perf_counter()
    with profiling.trace(str(tmp)) as prof:
        sh.solve_compacted(sc.initial, v0, sc.final, v0, chunk=chunk)
    wall = time.perf_counter() - t0
    launches = _read(counters)
    path = tmp / "trace.json"
    text = path.read_text()
    found = {k: k in text for k in ("ns_chain_kernel", "sweep_kernel",
                                    "admm_rhs_table_kernel",
                                    "admm_update_kernel",
                                    "admm_channel_kernel")}
    del text

    rows = [(e.key, _device_us(e) / 1e3, e.count)
            for e in prof.key_averages() if _device_us(e) > 0]
    busy = sum(r[1] for r in rows)
    by_kernel = {k: round(sum(ms for key, ms, _ in rows if k in key), 3)
                 for k in found}
    print(f"modules: trace N={n_veh} B={B} production: "
          f"{path.stat().st_size} bytes, kernels named {found}, their device "
          f"ms {by_kernel}; traced wall {wall:.2f} s, device busy "
          f"{busy / 1e3:.3f} s, idle share under tracing "
          f"{1 - busy / 1e3 / wall:.3f}, {sum(r[2] for r in rows)} device "
          f"operations, launches={launches}", flush=True)
    if not all(found.values()):
        raise AssertionError(f"the trace lacks a kernel: {found}")
    for what, cost, count, ms in (
            ("direct_xupdate_cost N=20 B=512",
             profiling.direct_xupdate_cost(20, K_STEPS), 512,
             kstats["group_solve_x"]["ms"]),
            ("factorize_X_cost N=20 B=512 (FP32 count; route time)",
             profiling.factorize_X_cost(20, K_STEPS), 512,
             kstats["ns_chain"]["ms"]),
            ("factorize_X_cost N=40 B=128 (FP32 count; route time)",
             profiling.factorize_X_cost(40, K_STEPS), 128,
             lstats[40]["ns_chain"]["ms"]),
            ("25 x admm_iteration_cost N=40 B=128",
             profiling.admm_iteration_cost(40, K_STEPS), 25 * 128,
             lstats[40]["admm_fused_x"]["ms"]),
            *((f"admm_stage_cost {key} N=20 B={B}",
               profiling.admm_stage_cost(key, 20, K_STEPS), B,
               gstats[key]["ms"])
              for key, B in (("admm_rhs", 512), ("admm_update", 512))),
            ("admm_stage_cost admm_channel_interval N=20 B=1024 "
             "(collision-free count)",
             profiling.admm_stage_cost("admm_channel_interval", 20, K_STEPS,
                                       eta_terms=False), 1024,
             gstats["admm_channel_interval"]["ms"])):
        bound, by = profiling.bound_ms(cost, count=count)
        print(f"modules: cost model {what}: bound {bound:.3f} ms "
              f"({by}); kernel phase {ms:.3f} ms", flush=True)
    return launches


def _blocked_chol_part(dev):
    """chol_inv and factorize_matmul against cuSOLVER at the anchor shapes
    and the L-form shape, with the JAX tests' tolerances; both timed."""
    import torch
    from ba_path_planning_torch.ops.blocked_chol import chol_inv
    from ba_path_planning_torch.solvers.banded import (
        _spd_inv, factorize_matmul, factorize_xla)
    gen = torch.Generator(device=dev).manual_seed(5)

    def spd(shape, n, scale):
        A = torch.randn(shape + (n, n), generator=gen, device=dev)
        return A @ A.mT / n + scale * torch.eye(n, device=dev)
    for B, n in ANCHOR_SHAPES:
        S = spd((B,), n, 1.0)
        L, Linv = chol_inv(S)
        L_ref = torch.linalg.cholesky(S)
        err = float(((L - L_ref).abs() - 2e-4 * L_ref.abs()).max())
        eye_err = float((L @ Linv - torch.eye(n, device=dev)).abs().max())
        inv_err = float((Linv.mT @ Linv - _spd_inv(S)).abs().max()
                        / _spd_inv(S).abs().max())
        ms = _time_ms(lambda: chol_inv(S), reps=2)
        spd_ms = _time_ms(lambda: Linv.mT @ chol_inv(S)[1], reps=2)
        ref_ms = _time_ms(lambda: _spd_inv(S))
        print(f"modules: chol_inv B={B} n={n} f32: |L - cholesky| - 2e-4|L| "
              f"max {err:.3e} (tol 2e-5), |L Linv - I| {eye_err:.3e} (tol "
              f"5e-4), spd inverse rel {inv_err:.3e}; chol_inv {ms:.3f} ms, "
              f"as the anchors' inverse {spd_ms:.3f} ms, cuSOLVER _spd_inv "
              f"{ref_ms:.3f} ms", flush=True)
        if err > 2e-5 or eye_err > 5e-4:
            raise AssertionError(f"chol_inv B={B} n={n} out of tolerance")
    B, K, n = LFORM_SHAPE
    D = spd((B, K), n, 5.0)
    Bm = 0.1 * torch.randn((K - 1, n, n), generator=gen, device=dev)
    La, Ea = factorize_matmul(D, Bm)
    Lb, Eb = factorize_xla(D, Bm)
    errs = [float(((a - b).abs() - 5e-3 * b.abs()).max())
            for a, b in ((La, Lb), (Ea, Eb))]
    mm_ms = _time_ms(lambda: factorize_matmul(D, Bm), reps=1)
    xla_ms = _time_ms(lambda: factorize_xla(D, Bm), reps=2)
    print(f"modules: factorize_matmul B={B} K={K} n={n} f32 against "
          f"factorize (cuSOLVER): Linv, E |diff| - 5e-3|ref| max {errs} (tol "
          f"5e-4); factorize_matmul {mm_ms:.3f} ms, factorize {xla_ms:.3f} "
          "ms", flush=True)
    if max(errs) > 5e-4:
        raise AssertionError("factorize_matmul out of tolerance")


def _native_part(dev):
    """NativeQP built with g++ on this host, one QP at N=3, K=10, against
    the port's solve_qp on the card in float64."""
    import numpy as np
    import torch
    from ba_path_planning_torch import native
    from ba_path_planning_torch.ops.collisions import (
        collision_lower_bounds, linearize, make_pair_index)
    from ba_path_planning_torch.ops.constraints import (ConstraintBlocks,
                                                        static_bounds)
    from ba_path_planning_torch.solvers.admm import (
        QPData, build_row_scaling, build_static_normal_inverse, solve_qp)
    from ba_path_planning_torch.utils.config import Limits, SolverConfig
    f64 = torch.float64
    N, K, h, R_ = 3, 10, 0.2, 1.0
    P = N * (N - 1) // 2
    rng = np.random.default_rng(0)
    p0 = rng.uniform(4, 16, (N, 2))
    pf = p0 + rng.uniform(-1, 1, (N, 2))
    tp0, tpf = (torch.tensor(a, device=dev) for a in (p0, pf))
    tv0 = torch.zeros_like(tp0)
    pairs = make_pair_index(N, dtype=f64, device=dev)
    lo, up = static_bounds(tp0, tv0, tpf, tv0, n_vehicles=N, n_steps=K, h=h,
                           limits=Limits())
    t = torch.arange(K, dtype=f64, device=dev) / (K - 1)
    prev = tp0[:, None] * (1 - t)[None, :, None] + tpf[:, None] * t[
        None, :, None]
    eta, dist = linearize(prev, pairs, torch.zeros((K, P), dtype=f64,
                                                   device=dev))
    lower = ConstraintBlocks(col=collision_lower_bounds(
        eta, dist, prev, tp0, tv0, pairs, h=h, min_distance=R_), **lo)
    upper = ConstraintBlocks(col=torch.full((K, P), float("inf"), dtype=f64,
                                            device=dev), **up)
    cfg = SolverConfig(eps_abs=1e-6, eps_rel=1e-6, max_iter=8000,
                       cg_iters=20, adaptive_rho=False, polish=False)
    pc = build_static_normal_inverse(K, h, cfg, dtype=f64, device=dev)
    out = solve_qp(QPData(eta=eta, col_mask=torch.tensor(1.0, dtype=f64,
                                                           device=dev),
                          lower=lower, upper=upper),
                   pairs.E, pc, torch.zeros((N, K, 2), dtype=f64,
                                            device=dev), h=h, cfg=cfg)
    t0 = time.perf_counter()
    nqp = native.NativeQP(N, K, h)
    t_build = time.perf_counter() - t0
    nqp.set_settings(rho=cfg.rho, sigma=cfg.sigma, alpha=cfg.alpha,
                     eps_abs=cfg.eps_abs, eps_rel=cfg.eps_rel,
                     max_iter=cfg.max_iter, check_interval=cfg.check_interval,
                     cg_iters=cfg.cg_iters)
    nqp.set_precond(pc.Q.cpu(), pc.lam.cpu())
    flat = [torch.cat([b.reshape(-1) for b in bl]).cpu()
            for bl in (lower, upper)]
    nqp.set_bounds(*flat)
    scaling = build_row_scaling(K, h, dtype=f64)
    shapes = ((N, K - 1, 2), (N, K, 2), (N, K, 2), (N, K, 2), (K, P))
    d_full = [d.expand(s) for d, s in zip(scaling, shapes)]
    rho_full = [cfg.rho * d ** 2 for d in d_full]
    for i in (2, 3):     # terminal vel/pos equality rows
        rho_full[i] = rho_full[i].clone()
        rho_full[i][:, K - 1, :] *= cfg.rho_eq_scale
    nqp.set_scaling(torch.cat([d.reshape(-1) for d in d_full]),
                    torch.cat([r.reshape(-1) for r in rho_full]))
    nqp.set_collision(eta.cpu(), 1.0)
    x_native, info = nqp.solve(np.zeros((N, K, 2)))
    x_card = out.x.cpu().numpy()
    diff = np.abs(x_native - x_card) - 5e-3 * np.abs(x_card)
    print(f"modules: NativeQP N={N} K={K} float64 (g++ build and load "
          f"{t_build:.2f} s): {info}; against solve_qp on the card "
          f"({int(out.iters)} iterations, converged {bool(out.converged)}): "
          f"max |diff| - 5e-3|x| {float(diff.max()):.3e} (tol 5e-4)",
          flush=True)
    if not info["converged"] or float(diff.max()) > 5e-4:
        raise AssertionError("NativeQP disagrees with solve_qp")


def modules_phase(dev, counters, kstats, lstats, gstats):
    """The modules the port took over last: train-network, plot-collisions,
    the sanitizer, the tracer, the matmul-form Cholesky and NativeQP.
    Returns the kernel launches of its solves."""
    import tempfile
    launches = dict.fromkeys(counters, 0)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _train_network_part(dev, tmp)
        for part in (_plot_collisions_part(dev, counters),
                     _sanitizer_part(dev, counters),
                     _trace_part(dev, counters, tmp, kstats, lstats,
                                 gstats)):
            for key, n in part.items():
                launches[key] += n
    _blocked_chol_part(dev)
    _native_part(dev)
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
    global HBM_BYTES_S, FP32_FLOP_S, TF32_FLOP_S
    from ba_path_planning_torch.utils.profiling import (
        H100_PEAK_FP32_FLOPS, H100_PEAK_HBM_BYTES, H100_PEAK_TF32_FLOPS)
    HBM_BYTES_S, FP32_FLOP_S, TF32_FLOP_S = (
        H100_PEAK_HBM_BYTES, H100_PEAK_FP32_FLOPS, H100_PEAK_TF32_FLOPS)
    name = torch.cuda.get_device_name(0)
    card = _card_line()
    print(f"device: {name}; nvidia-smi: {card}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    from ba_path_planning_torch.ops import (admm_fused, admm_steps,
                                            assemble_d, banded_solve,
                                            cuda_build, group_solve,
                                            ns_chain)
    from ba_path_planning_torch.utils.config import SolverConfig

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
    lstats = {n_veh: large_phase(dev, n_veh) for n_veh in LARGE_NS}
    for n_veh in (30, 50, 60):
        for key in ("ms", "bound_ms", "stream_bound_ms",
                    "nonzero_stream_bound_ms"):
            lstats[40]["admm_fused_x"][f"{key}_at_N{n_veh}"] = (
                lstats[n_veh]["admm_fused_x"][key])
        for key in ("ms", "plain_ms", "bound_ms", "stream_bound_ms",
                    "max_abs_err", "plan"):
            lstats[40]["admm_fused_x_wide"][f"{key}_at_N{n_veh}"] = (
                lstats[n_veh]["admm_fused_x_wide"][key])
        for key in ("ms", "kernel_ms", "bound_ms"):
            lstats[40]["ns_chain"][f"{key}_at_N{n_veh}"] = (
                lstats[n_veh]["ns_chain"][key])
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
    lane = lane_rho_phase(dev)
    # the grouped routes' kernels past N = 341: n = 2052 and 6144 (the L
    # sweep's on bf16 factors join the bf16 row below)
    wide = wide_kernel_phase(dev)
    for key, at in wide.items():
        if key == "group_solve_l_bf16":
            continue
        stats = lstats[40][key] if key == "ns_chain" else (
            kstats if key == "group_solve_x" else fstats)[key]
        stats["wide_shapes"] = at
    torch.cuda.empty_cache()
    lap("kernel phases")
    gstats = steps_phase(dev)
    torch.cuda.empty_cache()
    lap("steps phase")
    astats = assemble_phase(dev)
    torch.cuda.empty_cache()
    lap("assemble phase")
    bstats = bf16_kernel_phase(dev)
    bstats["group_solve_l"]["wide_shapes"] = wide["group_solve_l_bf16"]
    lap("bf16 kernel phase")
    for n_veh in (20, 30):
        reference_phase(dev, n_veh)
    reference_phase(dev, 20, facade=True)
    lap("reference phases")

    # the launch count of each wrapper, summed over the paths below; each
    # path sets the counts to 0 before it runs and reads them after
    counters = {"ns_chain": ns_chain.factorize_X_chain_batched,
                "group_solve_x": group_solve.solve_factorized_grouped_X,
                "admm_fused_x": admm_fused.admm_interval_fused_X,
                "admm_fused_x_wide": admm_fused.admm_interval_fused_X.wide,
                "group_solve_l": group_solve.solve_factorized_grouped_L,
                "banded_solve": banded_solve.solve_factorized_dense,
                "admm_fused_l": admm_fused.admm_interval_fused,
                "admm_rhs": admm_steps.admm_rhs,
                "admm_update": admm_steps.admm_update,
                "admm_channel_interval": admm_steps.admm_channel_interval,
                "assemble_d": assemble_d.assemble_D_fused}
    launches = dict.fromkeys(counters, 0)

    def add(path_launches):
        for key, n in path_launches.items():
            launches[key] += n
    for n_veh, B, chunk in MAIN_PATHS:
        add(main_path(dev, card, n_veh, B, chunk, counters))
    add(main_path(dev, card, *MAIN_PATHS[0], counters, latency=True))
    lap("production main paths")
    # ns_precision="default", served by the three-pass NS kernel
    default_launches = main_path(
        dev, card, *MAIN_PATHS[0], counters,
        solver=SolverConfig.production(problem=_problem(MAIN_PATHS[0][0]))
        .replace(ns_precision="default"), label="ns_precision=default")
    add(default_launches)
    lstats[40]["ns_chain"]["launches_ns_precision_default"] = (
        default_launches["ns_chain"])
    lap("ns_precision=default path")
    wide_launches = wide_phase(dev, card, counters)
    add(wide_launches)
    for key in ("admm_rhs", "admm_update"):
        gstats[key]["launches_wide_phase"] = wide_launches[key]
    torch.cuda.empty_cache()
    lap("wide phase")
    short, short_launches = short_phase(dev, card, counters)
    add(short_launches)
    lstats[40]["admm_fused_x_wide"]["short_shapes"] = short
    lstats[40]["admm_fused_x_wide"]["launches_short_phase"] = (
        short_launches["admm_fused_x_wide"])
    torch.cuda.empty_cache()
    lap("short-horizon phase")
    add(sweep_phase(dev, card, counters))
    lap("soak / N-sweep twin at N=50, 60")
    results = {}
    for route in FACADE_ROUTES:
        results[route], path_launches = facade_path(dev, card, route,
                                                    counters)
        add(path_launches)
    facade_agreement(results)
    add(facade_call(counters))
    add(facade_call(counters, defaults=True))
    lap("reference-compatible paths")
    # the adaptive-rho paths; their launches of the fused kernels are those
    # of the per-lane rho planes
    lane_launches = dict.fromkeys(counters, 0)
    for n_veh, B, chunk in ADAPTIVE_PATHS:
        path = adaptive_path(dev, card, n_veh, B, chunk, counters)
        add(path)
        for key in ("admm_fused_x", "admm_fused_x_wide"):
            lane_launches[key] += path[key]
    _, path = facade_path(dev, card, "fused_L", counters, adaptive=True)
    add(path)
    lane_launches["admm_fused_l"] += path["admm_fused_l"]
    lap("adaptive-rho paths")
    # the bf16 paths; their launches are those of the bf16 entries
    bf16_launches = bf16_paths(dev, card, counters, results)
    add(bf16_launches)
    lap("bf16 paths")
    parallel_phase(dev, card)
    lap("parallel phase")
    add(parity_phase(counters))
    lap("parity phase")
    add(cg_phase(dev, counters))
    lap("CG phase")
    add(bench_phase(dev, counters))
    lap("bench twin")
    add(batch_cli_phase(counters))
    lap("batch CLI")
    add(modules_phase(dev, counters, kstats, lstats, gstats))
    lap("modules phase")

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
        "admm_fused_x_wide": ("admm_interval_fused_X", "admm_fused_x.cu",
                              ["admm_fused.py:637", "admm_fused.py:432"],
                              lstats[40]["admm_fused_x_wide"]),
        "group_solve_l": ("solve_factorized_grouped_L", "group_solve_l.cu",
                          ["group_solve.py:241"], fstats["group_solve_l"]),
        "banded_solve": ("solve_factorized_dense", "banded_solve.cu",
                         ["banded_solve.py:116", "banded_solve.py:30",
                          "group_solve.py:57"], fstats["banded_solve"]),
        "admm_fused_l": ("admm_interval_fused", "admm_fused_l.cu",
                         ["admm_fused.py:162"], fstats["admm_fused_l"]),
    }
    # the fused kernels again, with one rho a lane (their per-lane strides)
    lane_rows = {
        "admm_fused_x": ("admm_interval_fused_X", "admm_fused_x.cu",
                         ["admm_fused.py:637", "admm_fused.py:432"],
                         lane["admm_fused_x"]),
        "admm_fused_x_wide": ("admm_interval_fused_X", "admm_fused_x.cu",
                              ["admm_fused.py:637", "admm_fused.py:432"],
                              lane["admm_fused_x_wide"]),
        "admm_fused_l": ("admm_interval_fused", "admm_fused_l.cu",
                         ["admm_fused.py:162"], lane["admm_fused_l"]),
    }
    # the four factor-streaming kernels again, on bf16 factors
    bf16_rows = {key: rows[key][:3] + (bstats[key],)
                 for key in ("group_solve_x", "group_solve_l", "banded_solve",
                             "admm_fused_l")}
    kernels = []
    for key, (wrapper, src, replaces, stats) in (
            list(rows.items()) + [(k + "_lane_rho", v)
                                  for k, v in lane_rows.items()]
            + [(k + "_bf16", v) for k, v in bf16_rows.items()]):
        lane_rho = key.endswith("_lane_rho")
        if key.endswith("_bf16"):
            n_launch = bf16_launches.get(key[:-len("_bf16")], 0)
        else:
            n_launch = (lane_launches[key[:-len("_lane_rho")]] if lane_rho
                        else launches[key])
        entry = {"name": wrapper, "route": "cuda", "source": csrc + src,
                 "replaces": pallas + replaces[0], "launches": n_launch,
                 **stats}
        if lane_rho:
            entry["rho"] = ("one rho a lane (adaptive rho); launches: the "
                            "adaptive-rho paths'")
        if key.endswith("_bf16"):
            entry["factors"] = ("bf16, widened in registers; launches: the "
                                "bf16 paths'")
        if len(replaces) > 1:
            entry["also_replaces"] = [pallas + r for r in replaces[1:]]
        if key.startswith("admm_fused_x"):
            entry["tier"] = (
                "wide (admm_fused_x_wide_kernel: a scenario over many SMs)"
                if key.startswith("admm_fused_x_wide")
                else "one block a scenario (admm_fused_x_kernel)")
        if n_launch < 1:
            raise AssertionError(f"no path launched {wrapper} ({key})")
        kernels.append(entry)
    # the hand-written kernels with no Pallas body: the ADMM loop body that
    # XLA fuses in the JAX package
    glue = []
    for key, stats in gstats.items():
        if launches[key] < 1:
            raise AssertionError(f"no path launched {key}")
        glue.append({"name": key, "route": "cuda",
                     "source": csrc + "admm_steps.cu",
                     "replaces": "ba_path_planning_tpu/solvers/banded.py:1319 "
                                 "(admm_iter, XLA-fused)",
                     "launches": launches[key], **stats})
    if launches["assemble_d"] < 1:
        raise AssertionError("no path launched assemble_d")
    glue.append({"name": "assemble_D_fused", "route": "cuda",
                 "source": csrc + "assemble_d.cu",
                 "replaces": "ba_path_planning_tpu/solvers/banded.py:463 "
                             "(assemble_D, jnp)",
                 "launches": launches["assemble_d"], "shapes": astats})
    print(f"chip_smoke wall: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(card)
    print(json.dumps({"glue_kernels": glue}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}))


if __name__ == "__main__":
    main()
