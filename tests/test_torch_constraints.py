"""PyTorch port, the acceleration-space constraint operators of the CG
method (``ops/constraints.py``, ``ops/matmul_ops.py``), the dense operator
matrices of ``models/double_integrator.py`` and the acceleration-space
``collision_lower_bounds``, held against the JAX package on the same numpy
inputs at N=3, K=10 in float64 (tolerance 1e-12 of each output's scale).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ba_path_planning_tpu.models.double_integrator import (
    DoubleIntegrator2D as JModel)
from ba_path_planning_tpu.ops import collisions as jcol
from ba_path_planning_tpu.ops import constraints as jc
from ba_path_planning_tpu.ops import matmul_ops as jm
from ba_path_planning_tpu.utils import config as jcfg

from ba_path_planning_torch.models.double_integrator import DoubleIntegrator2D
from ba_path_planning_torch.ops import collisions as tcol
from ba_path_planning_torch.ops import constraints as tc
from ba_path_planning_torch.ops import matmul_ops as tm

F64 = torch.float64
N, K, B, H = 3, 10, 2, 0.2
P = N * (N - 1) // 2


def T(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def _close(got, want, tol=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want), initial=0.0)), 1.0)
    assert float(np.max(np.abs(got - want), initial=0.0)) <= tol * scale


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(B, N, K, 2))
    eta = rng.normal(size=(B, K, P, 2))
    eta /= np.linalg.norm(eta, axis=-1, keepdims=True)
    rows = [rng.normal(size=s) for s in
            ((B, N, K - 1, 2), (B, N, K, 2), (B, N, K, 2), (B, N, K, 2),
             (B, K, P))]
    return a, eta, rows


def test_operator_matrices_match_jax():
    m, jm_ = DoubleIntegrator2D(K, H), JModel(K, H)
    for name in ("velocity_matrix", "position_matrix",
                 "rollout_position_matrix", "jerk_matrix"):
        np.testing.assert_allclose(getattr(m, name)(), getattr(jm_, name)(),
                                   rtol=0, atol=1e-15)


OPS = {
    "scan": (tc.apply_static, tc.apply_static_adjoint, tc.apply_collision,
             tc.apply_collision_adjoint,
             jc.apply_static, jc.apply_static_adjoint, jc.apply_collision,
             jc.apply_collision_adjoint),
    "matmul": (tm.apply_static_matmul, tm.apply_static_adjoint_matmul,
               tm.apply_collision_matmul, tm.apply_collision_adjoint_matmul,
               jm.apply_static_matmul, jm.apply_static_adjoint_matmul,
               jm.apply_collision_matmul, jm.apply_collision_adjoint_matmul),
}


@pytest.mark.parametrize("impl", list(OPS))
def test_operators_and_adjoints_match_jax(impl):
    st, st_adj, co, co_adj, jst, jst_adj, jco, jco_adj = OPS[impl]
    a, eta, rows = _inputs()
    E = np.asarray(jc.pair_incidence(N, dtype=jnp.float64))
    _close(tc.pair_incidence(N, dtype=F64), E)
    for got, want in zip(st(T(a), H), jst(jnp.asarray(a), H)):
        _close(got, want)
    _close(st_adj(*map(T, rows[:4]), H), jst_adj(*map(jnp.asarray, rows[:4]),
                                                 H))
    _close(co(T(a), T(eta), T(E), H),
           jco(jnp.asarray(a), jnp.asarray(eta), jnp.asarray(E), H))
    _close(co_adj(T(rows[4]), T(eta), T(E), H),
           jco_adj(jnp.asarray(rows[4]), jnp.asarray(eta), jnp.asarray(E), H))
    # <A a, y> = <a, A^T y>, lane by lane
    Aa = list(st(T(a), H)) + [co(T(a), T(eta), T(E), H)]
    ATy = st_adj(*map(T, rows[:4]), H) + co_adj(T(rows[4]), T(eta), T(E), H)
    lhs = sum((u * T(v)).flatten(1).sum(-1) for u, v in zip(Aa, rows))
    rhs = (T(a) * ATy).flatten(1).sum(-1)
    assert torch.allclose(lhs, rhs, rtol=1e-12, atol=1e-12)


def test_apply_A_AT_and_static_bounds_match_jax():
    a, eta, rows = _inputs(1)
    E = T(tc.pair_incidence(N, dtype=F64))
    got = tc.apply_A(T(a), T(eta), E, H)
    want = jc.apply_A(jnp.asarray(a), jnp.asarray(eta), jnp.asarray(E), H)
    for g, w in zip(got, want):
        _close(g, w)
    y = tc.ConstraintBlocks(*map(T, rows))
    _close(tc.apply_AT(y, T(eta), E, H),
           jc.apply_AT(jc.ConstraintBlocks(*map(jnp.asarray, rows)),
                       jnp.asarray(eta), jnp.asarray(E), H))
    rng = np.random.default_rng(2)
    p0, v0, pf, vf = (rng.uniform(2, 18, size=(B, N, 2)) if i % 2 == 0
                      else rng.normal(size=(B, N, 2)) for i in range(4))
    lim = jcfg.ProblemConfig(n_vehicles=N).limits
    lo, up = tc.static_bounds(*map(T, (p0, v0, pf, vf)), n_vehicles=N,
                              n_steps=K, h=H, limits=lim)
    jlo, jup = jc.static_bounds(*map(jnp.asarray, (p0, v0, pf, vf)),
                                n_vehicles=N, n_steps=K, h=H, limits=lim)
    for got, want in ((lo, jlo), (up, jup)):
        assert set(got) == set(want)
        for key in want:
            _close(got[key], want[key])


def test_collision_lower_bounds_match_jax():
    rng = np.random.default_rng(3)
    prev = rng.uniform(0, 4, size=(B, N, K, 2))
    p0 = rng.uniform(0, 4, size=(B, N, 2))
    v0 = rng.normal(size=(B, N, 2))
    eta = rng.normal(size=(B, K, P, 2))
    eta /= np.linalg.norm(eta, axis=-1, keepdims=True)
    dist = rng.uniform(0.5, 2.0, size=(B, K, P))
    jp = jcol.make_pair_index(N, dtype=jnp.float64)
    tp = tcol.make_pair_index(N, dtype=F64)
    got = tcol.collision_lower_bounds(T(eta), T(dist), T(prev), T(p0), T(v0),
                                      tp, h=H, min_distance=0.93)
    want = jax.vmap(lambda e, d, pp, a, b: jcol.collision_lower_bounds(
        e, d, pp, a, b, jp, h=H, min_distance=0.93))(
        *map(jnp.asarray, (eta, dist, prev, p0, v0)))
    _close(got, want)
