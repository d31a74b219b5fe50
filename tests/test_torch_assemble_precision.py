"""``SolverConfig.assemble_precision`` in the PyTorch port: every value the
JAX package knows is accepted, and each assembles in FP32 (the decision is
recorded in ROADMAP Queue 3 and in ``banded.qp_route``); any other value
raises.  The port's float32 assembly is held against the JAX package's at
each named precision on the CPU, where XLA computes a float32 product in
float32 whatever precision it is given.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ba_path_planning_tpu.ops import collisions as jcol
from ba_path_planning_tpu.solvers import banded as jb
from ba_path_planning_tpu.utils import config as jcfg

from ba_path_planning_torch.solvers import banded as tb
from ba_path_planning_torch.utils.config import SolverConfig

# as the JAX router maps the option (ba_path_planning_tpu/solvers/banded.py)
JAX_PRECISION = {"highest": None, "high": jax.lax.Precision.HIGH,
                 "default": jax.lax.Precision.DEFAULT}
# Two float32 sums of the same products in other orders: each entry of a
# collision block sums N - 1 pairs, so blocks agree to a few ulps of their
# largest entry.
RTOL = 1e-6


def _block_rel(got, want):
    """Largest relative error of any (b, k) block."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want).max(axis=(-2, -1))
    return float((diff / np.abs(want).max(axis=(-2, -1))).max())


def test_the_port_knows_the_jax_values():
    assert set(tb.ASSEMBLE_PRECISIONS) == set(JAX_PRECISION)
    assert SolverConfig.production().assemble_precision in JAX_PRECISION
    assert jcfg.SolverConfig.production().assemble_precision == \
        SolverConfig.production().assemble_precision


@pytest.mark.parametrize("precision", tb.ASSEMBLE_PRECISIONS)
@pytest.mark.parametrize("N,K", [(3, 8), (22, 6)])
def test_fp32_assembly_matches_jax_at_each_precision(precision, N, K):
    """The diagonal blocks D and slot scalars C of the production rho
    pattern, float32, against the JAX package's ``assemble_D`` at the
    precision the option names, within RTOL of each block's largest
    entry; the router accepts the value."""
    rng = np.random.default_rng(N + K)
    B, P, h, f32 = 2, N * (N - 1) // 2, 0.2, jnp.float32
    static = jcfg.SolverConfig.production(pallas=False).static_part()
    jrho = jb.rho_pattern_masks(jb.row_scaling_state(K, h, dtype=f32),
                                static, f32(2.6), f32(2.5), n_steps=K,
                                n_pairs=P, col_enabled=True, dtype=f32)
    eta = rng.normal(size=(B, K, P, 2))
    eta = (eta / np.linalg.norm(eta, axis=-1, keepdims=True)).astype(
        np.float32)
    E = jcol.make_pair_index(N, dtype=f32).E
    jD, jC = jax.vmap(lambda e: jb.assemble_D(
        jrho, e, E, h=h, sigma=1e-6, n_vehicles=N,
        precision=JAX_PRECISION[precision]), out_axes=(0, None))(
        jnp.asarray(eta))
    rho = tb.RowVals(*(torch.as_tensor(np.array(t)) for t in jrho))
    D, C = tb.assemble_D(rho, torch.as_tensor(eta),
                         torch.as_tensor(np.asarray(E)), h=h,
                         sigma=torch.tensor(1e-6), n_vehicles=N)
    assert D.dtype == torch.float32
    assert _block_rel(D.numpy(), jD) <= RTOL
    np.testing.assert_allclose(C.numpy(), np.asarray(jC), rtol=RTOL)
    port = SolverConfig.production().replace(assemble_precision=precision)
    assert tb.qp_route(port.static_part(), n_vehicles=N, n_steps=K,
                       dtype=torch.float32, col_enabled=True) in (
        "grouped_X", "fused_X")


def test_the_option_moves_no_result_and_an_unknown_value_raises():
    """One production QP on the CPU gives the same iterate bit for bit
    under each accepted value (one FP32 assembly); a value the JAX package
    does not know raises before any work."""
    from ba_path_planning_torch.ops.collisions import make_pair_index
    from ba_path_planning_torch.solvers.scp import _warm_state
    from ba_path_planning_torch.utils.config import (ProblemConfig,
                                                     make_solver_params)
    rng = np.random.default_rng(7)
    B, N, K, h = 2, 3, 8, 0.2
    P = N * (N - 1) // 2
    problem = ProblemConfig(n_vehicles=N, time_horizon=K * h, time_step=h)
    p0, pf = (torch.as_tensor(rng.uniform(4, 16, (B, N, 2)),
                              dtype=torch.float32) for _ in range(2))
    v0 = torch.zeros_like(p0)
    lower, upper = tb.build_bounds(p0, v0, pf, v0, n_vehicles=N, n_steps=K,
                                   h=h, limits=problem.limits, n_pairs=P)
    eta = torch.as_tensor(rng.normal(size=(B, K, P, 2)), dtype=torch.float32)
    eta = eta / torch.linalg.vector_norm(eta, dim=-1, keepdim=True)
    x0 = _warm_state(torch.zeros((B, N, K, 2)), p0, v0, h)
    E = make_pair_index(N, torch.float32).E
    results = []
    for precision in tb.ASSEMBLE_PRECISIONS + ("tf32",):
        solver = SolverConfig.production(problem=problem).replace(
            assemble_precision=precision)
        run = lambda: tb.solve_qp_state(  # noqa: E731
            lower, upper, eta, x0, make_solver_params(solver), E, h=h,
            static=solver.static_part(), n_vehicles=N)
        if precision == "tf32":
            with pytest.raises(ValueError, match="assemble_precision"):
                run()
        else:
            results.append(tb.to_stacked(run().x))
    for got in results[1:]:
        assert torch.equal(got, results[0])
