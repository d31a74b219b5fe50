#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. checks for a CUDA device and prints it, with the name and power limit
   that nvidia-smi reports, and the TF32 switches (both off);
2. builds the CUDA kernels from ``ba_path_planning_torch/csrc``;
3. kernel phase: each kernel against its plain PyTorch version on the card
   at the main path's shapes (N=20, K=50, f32; B=64 and the chunk B=512),
   with the stated tolerance on the relative error of every (b, k) block,
   and CUDA-event times of both;
4. reference phase: one SCP step of 8 scenarios through the kernels on the
   card against the plain versions on the CPU, both float32;
5. main path: 1024 scenarios from a seed, solved by ``solve_compacted``
   with chunk 512 at the ``bench.py`` configuration (N=20, T=10, h=0.2,
   R=0.8, production solver); the launch counters must rise, and at least
   99% of the scenarios must be collision-free with goal error < 5 cm.

Any failed phase raises, so the exit code is not 0.  The last two lines are
one JSON object on the kernels and ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N, T_HORIZON, H, R = 20, 10.0, 0.2, 0.8
B_MAIN, CHUNK = 1024, 512
NS_TOL, SWEEP_TOL, REF_TOL = 1e-4, 1e-5, 5e-3
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


def _case(B, dev, seed):
    """Main-path-shaped inputs of the two kernels: diagonal blocks D with the
    production rho pattern and collision blocks from random unit
    directions, the slot scalars C, a random right-hand side b, and one at
    the scale the ADMM loop feeds, b_admm = A^T (rho * A x) for a random
    state x."""
    import numpy as np
    import torch
    from ba_path_planning_torch.ops.collisions import make_pair_index
    from ba_path_planning_torch.solvers import banded
    from ba_path_planning_torch.utils.config import SolverConfig
    K, P = int(T_HORIZON / H), N * (N - 1) // 2
    f32 = torch.float32
    rng = np.random.default_rng(seed)
    scaling = banded.row_scaling_state(K, H, dtype=f32, device=dev)
    rho = banded.rho_pattern_masks(
        scaling, SolverConfig.production().static_part(),
        torch.tensor(2.6, device=dev), torch.tensor(2.5, device=dev),
        n_steps=K, n_pairs=P, col_enabled=True, dtype=f32)
    eta = torch.as_tensor(rng.normal(size=(B, K, P, 2)), dtype=f32,
                          device=dev)
    eta = eta / torch.linalg.vector_norm(eta, dim=-1, keepdim=True)
    E = make_pair_index(N, f32, dev).E
    D, C = banded.assemble_D(rho, eta, E, h=H,
                             sigma=torch.tensor(1e-6, device=dev),
                             n_vehicles=N)
    x = banded.StateVars(*(torch.as_tensor(
        rng.normal(size=(B, N, K, 2)) * scale, dtype=f32, device=dev)
        for scale in (1.0, 5.0, 2.0)))
    rz = banded.tree_map(torch.mul, rho, banded.apply_A(x, eta, E, H))
    b_admm = banded.to_stacked(banded.apply_AT(rz, eta, E, H))
    b = torch.as_tensor(rng.normal(size=(B, K, 6 * N)), dtype=f32, device=dev)
    return D, C, b, b_admm


def _block_rel(got, want, block_dims):
    """Largest relative error of any (b, k) block: max |got - want| over the
    block over max |want| over the same block."""
    dims = tuple(range(-block_dims, 0))
    diff = (got - want).abs().amax(dim=dims)
    return float((diff / want.abs().amax(dim=dims)).max())


def kernel_phase(dev, B):
    import torch
    from ba_path_planning_torch.ops import group_solve, ns_chain
    D, C, b, b_admm = _case(B, dev, seed=B)
    K = D.shape[1]
    # NS chain: kernel route (exact anchors + interior kernel) vs the plain
    # factorize_X, both on the card
    X = ns_chain.factorize_X_chain_batched(D, C, ns_iters=2)
    Xp = ns_chain.factorize_X_chain_plain(D, C, ns_iters=2)
    torch.cuda.synchronize()
    ns_abs = float((X - Xp).abs().max())
    ns_rel = _block_rel(X, Xp, 2)
    ns_ms = _time_ms(
        lambda: ns_chain.factorize_X_chain_batched(D, C, ns_iters=2))
    ns_plain_ms = _time_ms(
        lambda: ns_chain.factorize_X_chain_plain(D, C, ns_iters=2))
    # sweep solve on the kernel's factors
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
    print(f"kernel phase B={B} N={N} K={K} f32: "
          f"factorize_X_chain_batched max_block_rel={ns_rel:.3e} "
          f"(tol {NS_TOL:g}) "
          f"max_abs={ns_abs:.3e} kernel={ns_ms:.3f} ms plain={ns_plain_ms:.3f} "
          f"ms | solve_factorized_grouped_X max_block_rel={sw_rel:.3e} "
          f"(tol {SWEEP_TOL:g}) "
          f"max_abs={sw_abs:.3e} kernel={sw_ms:.3f} ms "
          f"plain={sw_plain_ms:.3f} ms; ADMM-scale b against float64: "
          f"kernel max_block_rel={adm_err:.3e}, plain f32 "
          f"{adm_plain_err:.3e} (limit {ADMM_ERR_RATIO:g}x plain)", flush=True)
    if not ns_rel <= NS_TOL:
        raise AssertionError(f"NS chain kernel disagrees: {ns_rel:.3e}")
    if not sw_rel <= SWEEP_TOL:
        raise AssertionError(f"sweep kernel disagrees: {sw_rel:.3e}")
    if not adm_err <= ADMM_ERR_RATIO * adm_plain_err:
        raise AssertionError(f"sweep kernel is off at the ADMM scale: "
                             f"{adm_err:.3e} vs plain {adm_plain_err:.3e}")
    return {"ns_chain": (ns_abs, ns_ms, ns_plain_ms),
            "group_solve_x": (sw_abs, sw_ms, sw_plain_ms)}


def reference_phase(dev, problem, solver):
    """One SCP step of 8 lanes from the same phase-1 carry: the kernels on
    the card (f32) against the plain versions on the CPU (f32, and f64 for
    information).  Tolerance: one step's f32 accelerations move by 5e-4
    (relative) under 1e-7 input noise on the CPU, so 5e-3 leaves 10x."""
    import torch
    from ba_path_planning_torch.scenarios.generator import (
        generate_scenario_batch)
    from ba_path_planning_torch.solvers.banded import tree_map
    from ba_path_planning_torch.solvers.scp import SCPEngine
    sc = generate_scenario_batch(5, 8, n_vehicles=N, min_distance=R,
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
    print(f"reference phase: one SCP step, 8 lanes, N={N}: card f32 vs CPU "
          f"f32 plain max_rel(a)={err:.3e} (tol {REF_TOL:g}), equal stop "
          f"flags={same_stop}; CPU f64 vs CPU f32 max_rel(a)="
          f"{rel(out['cpu64'].a):.3e}", flush=True)
    if not (err <= REF_TOL and same_stop
            and bool(torch.isfinite(out["gpu32"].a).all())):
        raise AssertionError(f"card and CPU reference disagree: {err:.3e}")


def main():
    if not (ROOT / "ba_path_planning_torch").is_dir():
        raise SystemExit("chip_smoke.py: run it from a checkout of the repo")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; this script runs "
                         "only on a GPU")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = _card_line()
    print(f"device: {name}; nvidia-smi: {card}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    from ba_path_planning_torch.models.double_integrator import (
        DoubleIntegrator2D)
    from ba_path_planning_torch.ops import cuda_build, group_solve, ns_chain
    from ba_path_planning_torch.parallel.mesh import ShardedSCPSolver
    from ba_path_planning_torch.scenarios.generator import (
        generate_scenario_batch)
    from ba_path_planning_torch.utils.config import (ProblemConfig,
                                                     SolverConfig)

    t0 = time.perf_counter()
    cuda_build.load_kernels()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({cuda_build.build_info['path']})", flush=True)
    print("nvcc/ptxas:", " | ".join(
        ln.strip() for ln in cuda_build.build_info["log"].splitlines()
        if "registers" in ln or "spill" in ln or "error" in ln), flush=True)

    kernel_phase(dev, 64)
    kstats = kernel_phase(dev, CHUNK)

    problem = ProblemConfig(n_vehicles=N, time_horizon=T_HORIZON,
                            time_step=H, min_distance=R, max_iterations=15,
                            stop_mode="feasible", goal_project=True)
    solver = SolverConfig.production(problem=problem)
    reference_phase(dev, problem, solver)

    sh = ShardedSCPSolver(problem, solver, dtype=torch.float32, device=dev)

    def scenarios(seed, B):
        sc = generate_scenario_batch(seed, B, n_vehicles=N, min_distance=R,
                                     dtype=torch.float32, device=dev)
        if not bool(sc.ok.all()):
            raise AssertionError("scenario generation gave up on a lane")
        return sc.initial, sc.final

    # warm-up (library handles, allocator) on other scenarios
    p0, pf = scenarios(1, CHUNK)
    z = torch.zeros_like(p0)
    sh.solve_compacted(p0, z, pf, z, chunk=CHUNK)
    torch.cuda.synchronize()

    p0, pf = scenarios(100, B_MAIN)
    v0 = torch.zeros_like(p0)
    torch.cuda.reset_peak_memory_stats(dev)
    ns_chain.factorize_X_chain_batched.launches = 0
    group_solve.solve_factorized_grouped_X.launches = 0
    t0 = time.perf_counter()
    out = sh.solve_compacted(p0, v0, pf, v0, chunk=CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ns_chain": ns_chain.factorize_X_chain_batched.launches,
                "group_solve_x": group_solve.solve_factorized_grouped_X.launches}

    K = problem.n_steps
    if tuple(out.positions.shape) != (B_MAIN, N, K, 2):
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
    print(f"main path: B={B_MAIN} chunk={CHUNK} N={N} K={K} R={R} f32 on "
          f"{card}: wall={wall:.3f} s solves/s={ok / wall:.1f} "
          f"ok={ok}/{B_MAIN} collision_free={int(ff.sum())} "
          f"goal<5cm={int((goal_err < 0.05).sum())} statuses={status} "
          f"mean_scp_iters={float(out.iterations.float().mean()):.3f} "
          f"mean_qp_iters={float(out.qp_iterations.float().mean()):.2f} "
          f"peak_mem={torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
          f"timing={json.dumps(sh.last_timing)} launches={launches}",
          flush=True)
    for kname, n_launch in launches.items():
        if n_launch <= 0:
            raise AssertionError(f"main path never launched {kname}")
    if ok < int(np.ceil(0.99 * B_MAIN)):
        raise AssertionError(f"only {ok}/{B_MAIN} collision-free and goal-exact")

    sources = {
        "ns_chain": ("factorize_X_chain_batched",
                     "ba_path_planning_torch/csrc/ns_chain.cu",
                     "ba_path_planning_tpu/ops/pallas/ns_chain.py:105"),
        "group_solve_x": ("solve_factorized_grouped_X",
                          "ba_path_planning_torch/csrc/group_solve_x.cu",
                          "ba_path_planning_tpu/ops/pallas/group_solve.py:424"),
    }
    kernels = []
    for key, (wrapper, src, replaces) in sources.items():
        err, ms, plain_ms = kstats[key]
        kernels.append({"name": wrapper, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[key],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}))


if __name__ == "__main__":
    main()
