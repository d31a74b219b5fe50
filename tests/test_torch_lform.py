"""PyTorch port, the L-form / dense-factor family: the dense blocks and
their factorizations against the JAX package in float64 (1e-10), the plain
versions of the three new kernels against the Pallas bodies in interpret mode
in float32, the router against the JAX router's conditions, and the device
default of the entry points.
"""

import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ba_path_planning_tpu.ops import collisions as jcol
from ba_path_planning_tpu.ops.pallas import banded_solve as jbs
from ba_path_planning_tpu.ops.pallas import group_solve as jgs
from ba_path_planning_tpu.solvers import banded as jb
from ba_path_planning_tpu.utils import config as jcfg

from ba_path_planning_torch.ops import banded_solve, group_solve
from ba_path_planning_torch.solvers import banded as tb
from ba_path_planning_torch.utils.config import SolverConfig, resolve_device
from ba_path_planning_torch.utils.convert import factors_from_numpy

from test_torch_banded import T, _close, _eta, _rho

F64 = torch.float64
STATIC = jcfg.SolverConfig(method="direct", adaptive_rho=False,
                           polish=False).static_part()


def _blocks(N, K, B, seed, dtype=jnp.float64):
    """JAX-side dense blocks of a random batch: rho pattern of the default
    solver (rho 2.6, boost 2.5 as ``test_torch_banded._rho`` sets them),
    unit eta; returns (jrho, eta, E, D (B, K, n, n), Bm (K-1, n, n),
    C (K-1, 3, 3))."""
    rng = np.random.default_rng(seed)
    P = N * (N - 1) // 2
    jrho = _rho(STATIC, N, K, True, dtype)
    eta = _eta(rng, B, K, P).astype(dtype)
    E = jcol.make_pair_index(N, dtype=dtype).E
    D, Bm = jax.vmap(lambda e: jb.assemble_blocks(
        jrho, e, E, h=0.2, sigma=dtype(1e-6), n_vehicles=N))(
            jnp.asarray(eta))
    C = jb.assemble_D(jrho, jnp.asarray(eta[0]), E, h=0.2,
                      sigma=dtype(1e-6), n_vehicles=N)[1]
    return jrho, eta, E, D, Bm, C


@pytest.mark.parametrize("N,K", [(3, 8), (4, 10)])
def test_dense_blocks_and_factors_match_jax(N, K):
    B = 2
    jrho, eta, E, jD, jBm, jC = _blocks(N, K, B, seed=N)
    rho = tb.RowVals(*map(T, jrho))
    D, Bm = tb.assemble_blocks(rho, T(eta), T(np.asarray(E)), h=0.2,
                               sigma=T(1e-6), n_vehicles=N)
    _close(D, jD)
    assert Bm.shape == (K - 1, 6 * N, 6 * N)
    for b in range(B):                     # JAX builds B_k per scenario
        _close(Bm, jBm[b])
    Linv, Eb = tb.factorize(D, Bm)
    jLinv, jEb = jax.vmap(jb.factorize)(jD, jBm)
    _close(Linv, jLinv)
    _close(Eb, jEb)
    rhs = np.random.default_rng(K).normal(size=(B, K, 6 * N))
    _close(tb.solve_factorized(Linv, Eb, T(rhs)),
           jax.vmap(jb.solve_factorized)(jLinv, jEb, jnp.asarray(rhs)))
    # the solve inverts the block-tridiagonal matrix
    x = tb.solve_factorized(Linv, Eb, T(rhs))
    Mx = tb._mv(D, x)
    Mx[:, 1:] += tb._mv(Bm, x[:, :-1])
    Mx[:, :-1] += tb._mv_t(Bm, x[:, 1:])
    assert float((Mx - T(rhs)).abs().max()) < 1e-9 * float(
        np.abs(rhs).max())


@pytest.mark.parametrize("N,K", [(3, 8), (4, 10)])
def test_L_only_factors_match_jax(N, K):
    B = 2
    _, _, _, jD, _, jC = _blocks(N, K, B, seed=10 + N)
    D, C = T(jD), T(jC)
    Linv = tb.factorize_L(D, C)
    jLinv = jax.vmap(lambda d: jb.factorize_L(d, jC))(jD)
    _close(Linv, jLinv)
    rhs = np.random.default_rng(K).normal(size=(B, K, 6 * N))
    want = jax.vmap(lambda l, r: jb.solve_factorized_L(l, jC, r))(
        jLinv, jnp.asarray(rhs))
    _close(tb.solve_factorized_L(Linv, C, T(rhs)), want)
    before = group_solve.solve_factorized_grouped_L.launches
    _close(group_solve.solve_factorized_grouped_L(Linv, C, T(rhs)), want)
    assert group_solve.solve_factorized_grouped_L.launches == before  # plain


def _f32_case(N, K, B, seed):
    """float32 factors from the JAX package on a random batch, and the same
    arrays as tensors: (jLinv, jEb, jC, jb_) and (Linv, Eb, C, b)."""
    _, _, _, jD, jBm, jC = _blocks(N, K, B, seed, dtype=jnp.float32)
    jLinv, jEb = jax.vmap(jb.factorize)(jD, jBm)
    rhs = np.random.default_rng(seed + 1).normal(
        size=(B, K, 6 * N)).astype(np.float32)
    tensors = factors_from_numpy(jLinv, jEb, jC, rhs, dtype=torch.float32)
    return (jLinv, jEb, jC, jnp.asarray(rhs)), tensors


def test_grouped_L_plain_matches_pallas_interpret():
    """Pallas body ``_make_group_kernel_L`` in interpret mode, float32, B
    not a multiple of the group; atol 1e-4, rtol 1e-3 as
    tests/test_pallas_kernels.py holds that kernel to the scan."""
    (jLinv, _, jC, jrhs), (Linv, _, C, rhs) = _f32_case(4, 9, 5, seed=1)
    want = jgs.solve_factorized_grouped_L(jgs.pad_factors(jLinv), jC, jrhs,
                                          group=2, interpret=True)
    got = group_solve.solve_factorized_grouped_L(Linv, C, rhs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-3)


@pytest.mark.parametrize("body", ["grouped", "resident_batched",
                                  "resident_vmapped"])
def test_dense_plain_matches_pallas_interpret(body):
    """The three Pallas bodies of the dense sweeps in interpret mode,
    float32: ``_group_kernel`` (grouped, B not a multiple of the group),
    ``_solve_kernel`` (batched resident) and ``_solve_kernel_nb`` (resident
    under vmap); atol 1e-5, rtol 1e-4 as tests/test_pallas_kernels.py."""
    (jLinv, jEb, _, jrhs), (Linv, Eb, _, rhs) = _f32_case(3, 8, 3, seed=7)
    if body == "grouped":
        Lp, Ep = jgs.pad_factors(jLinv, jEb)
        want = jgs.solve_factorized_grouped(Lp, Ep, jrhs, group=2,
                                            interpret=True)
        wrapper = group_solve.solve_factorized_grouped
    elif body == "resident_batched":
        want = jbs.solve_factorized_pallas(jLinv, jEb, jrhs, interpret=True)
        wrapper = banded_solve.solve_factorized_dense
    else:
        with pltpu.force_tpu_interpret_mode():
            want = jax.vmap(jbs.solve_factorized_single)(jLinv, jEb, jrhs)
        wrapper = banded_solve.solve_factorized_dense
    before = banded_solve.solve_factorized_dense.launches
    got = wrapper(Linv, Eb, rhs)
    assert banded_solve.solve_factorized_dense.launches == before   # plain
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-4)


def _jax_route(N, K, isz, form, pallas, fused, group):
    """The route of the JAX router, its conditions as they stand in
    ``ba_path_planning_tpu/solvers/banded.py:1211-1259, 1292-1339``."""
    factor_bytes = 2 * K * (6 * N) ** 2 * isz
    np_ = -(-6 * N // 128) * 128
    per_g = 4 * np_ * np_ * isz + 5 * K * np_ * isz
    auto_g = max(1, min(32, (12 * 1024 * 1024) // per_g))
    if group > 0:
        group_n = group
    elif group == 0 and pallas:
        group_n = auto_g
    else:
        group_n = 0
    pallas_resident = (pallas and group_n == 0
                       and 2 * factor_bytes <= 12 * 1024 * 1024)
    if form == "X":
        nr8 = -(-6 * N // 8) * 8
        fused_ok = K * nr8 * np_ * isz <= int(96 * 1024 * 1024)
        use_fused = fused and fused_ok and (group_n == 0 or group_n < 16)
    else:
        fused_ok = factor_bytes <= 12 * 1024 * 1024
        use_fused = fused and group_n == 0 and fused_ok
    if use_fused:
        return "fused_" + form
    if group_n:
        return "grouped_" + form
    return "resident" if pallas_resident else "dense"


@pytest.mark.parametrize("N", [2, 4, 20, 21, 29, 30, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_qp_route_follows_the_jax_router(N, dtype):
    isz = 4 if dtype == torch.float32 else 8
    seen = set()
    for form, kernels, fused, group in itertools.product(
            ("L", "X"), (False, True), (False, True), (-1, 0, 8)):
        static = SolverConfig.production().replace(
            factor_form=form, kernels=kernels, fused=fused,
            group=group).static_part()
        got = tb.qp_route(static, n_vehicles=N, n_steps=50, dtype=dtype,
                          col_enabled=True)
        assert got == _jax_route(N, 50, isz, form, kernels, fused, group), (
            form, kernels, fused, group)
        assert tb.qp_route(static, n_vehicles=N, n_steps=50, dtype=dtype,
                           col_enabled=False) == "channel"
        seen.add(got)
    assert {"grouped_L", "grouped_X", "dense", "fused_X"} <= seen


def test_facade_routes_at_the_benchmark_shape():
    """The three kernel routes of the reference-compatible solver at N=20,
    K=50, float32, and the gates' edges: resident up to N=20, the L-form
    fused route up to N=29."""
    base = SolverConfig(method="direct", polish=False, adaptive_rho=False,
                        max_iter=2000)

    def route(N, **kw):
        return tb.qp_route(base.replace(**kw).static_part(), n_vehicles=N,
                           n_steps=50, dtype=torch.float32, col_enabled=True)
    assert route(20) == "dense"
    assert route(20, kernels=True) == "grouped_L"
    assert route(40, kernels=True) == "grouped_L"
    assert route(20, kernels=True, group=-1) == "resident"
    assert route(21, kernels=True, group=-1) == "dense"
    assert route(20, kernels=True, group=-1, fused=True) == "fused_L"
    assert route(29, kernels=True, group=-1, fused=True) == "fused_L"
    assert route(30, kernels=True, group=-1, fused=True) == "dense"


def test_latency_config_matches_jax():
    want = jcfg.SolverConfig.latency(pallas=True)
    got = SolverConfig.latency()
    assert (got.max_iter, got.check_interval) == (27, 9) == (
        want.max_iter, want.check_interval)
    assert got.replace(max_iter=25, check_interval=25) == \
        SolverConfig.production()
    assert got.kernels == want.pallas and got.fused == want.fused


def test_entry_points_default_to_the_card():
    """No device given means "cuda": where there is no card the entry points
    raise and nothing runs on the CPU."""
    from ba_path_planning_torch.parallel.mesh import ShardedSCPSolver
    from ba_path_planning_torch.scenarios.generator import (
        generate_scenario_batch)
    from ba_path_planning_torch.solvers.scp import SCP, SCPEngine
    from ba_path_planning_torch.utils.config import ProblemConfig
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    problem = ProblemConfig(n_vehicles=2, time_horizon=2.0, time_step=0.2)
    solver = SolverConfig.production(problem=problem)
    assert SCP(2, 2.0, 0.2, verbose=False)._device.type == "cuda"
    if torch.cuda.is_available():
        assert SCPEngine(problem, solver).device.type == "cuda"
        assert ShardedSCPSolver(problem, solver).engine.device.type == "cuda"
        assert generate_scenario_batch(
            0, 2, n_vehicles=2).initial.device.type == "cuda"
        return
    for make in (lambda: SCPEngine(problem, solver),
                 lambda: ShardedSCPSolver(problem, solver),
                 lambda: generate_scenario_batch(0, 2, n_vehicles=2)):
        with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
            make()
    facade = SCP(2, 2.0, 0.2, verbose=False)
    facade.set_initial_states([[5.0, 5.0], [8.0, 8.0]])
    facade.set_final_states([[6.0, 5.0], [9.0, 8.0]])
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        facade.generate_trajectories()
