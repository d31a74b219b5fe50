"""PyTorch port, the CG method's QP solver (``solvers/admm.py``) held
against the JAX package's ``solvers/admm.py`` in float64: the preconditioner
(1e-10), the PCG x-update with per-lane early stops (1e-10), and a whole
QP with adaptive rho and the CG polish against JAX's vmapped solve (equal
iteration counts, x within 1e-8).
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from ba_path_planning_tpu.ops import collisions as jcol
from ba_path_planning_tpu.ops.constraints import (ConstraintBlocks as JCB,
                                                  static_bounds as jbounds)
from ba_path_planning_tpu.ops.rollout import rollout as jrollout
from ba_path_planning_tpu.solvers import admm as ja
from ba_path_planning_tpu.utils import config as jcfg

from ba_path_planning_torch.ops.constraints import ConstraintBlocks
from ba_path_planning_torch.solvers import admm as ta
from ba_path_planning_torch.utils.config import make_solver_params
from ba_path_planning_torch.utils.convert import config_from_jax

from test_torch_scp import _problem, _scenarios

F64 = torch.float64
N, K, B, H = 3, 10, 3, 0.2
P = N * (N - 1) // 2


def T(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1.0)


def test_static_normal_inverse_matches_jax():
    cfg = jcfg.SolverConfig()
    _, tcfg = config_from_jax(_problem(N), cfg)
    for K_ in (10, 50):
        pc = ta.build_static_normal_inverse(K_, H, tcfg, dtype=F64)
        jpc = ja.build_static_normal_inverse(K_, H, cfg, dtype=jnp.float64)
        assert _rel(pc.Q, jpc.Q) <= 1e-10 and _rel(pc.lam, jpc.lam) <= 1e-10
    scal = ta.build_row_scaling(K, H, dtype=F64)
    for got, want in zip(scal, ja.build_row_scaling(K, H, dtype=jnp.float64)):
        assert _rel(got, want) <= 1e-14


def _qp_data(col_masks, seed=0, R=0.3):
    """The QPs of the first SCP iteration, one a lane, as the CG method
    builds them with the JAX package: the phase-1 solution (the default
    solver), the collisions linearized about it, the acceleration-space
    collision rows (enabled where ``col_masks``).  Returns the data, the
    warm start and the pair index."""
    problem = _problem(N).replace(min_distance=R)
    p0, pf = _scenarios(B, N, seed=seed)
    v0 = np.zeros_like(p0)
    lo, up = jbounds(*map(jnp.asarray, (p0, v0, pf, v0)), n_vehicles=N,
                     n_steps=K, h=H, limits=problem.limits)
    jp = jcol.make_pair_index(N, dtype=jnp.float64)
    cfg = jcfg.SolverConfig()
    prm = ja.make_solver_params(cfg, jnp.float64)
    pc = ja.build_static_normal_inverse(K, H, cfg, dtype=jnp.float64)
    inf = jnp.full((B, K, P), jnp.inf)
    data0 = ja.QPData(eta=jnp.zeros((B, K, P, 2)), col_mask=None,
                      lower=JCB(col=-inf, **lo), upper=JCB(col=inf, **up))
    a0 = jax.vmap(lambda d: ja.solve_qp_impl(
        d._replace(col_mask=jnp.asarray(0.0)), jp.E, pc,
        jnp.zeros((N, K, 2)), prm, h=H, static=cfg.static_part()).x)(data0)
    prev, _ = jrollout(a0, jnp.asarray(p0), jnp.asarray(v0), H)
    eta, dist = jax.vmap(lambda p: jcol.linearize(p, jp,
                                                  jax.random.key(0)))(prev)
    col_lo = jax.vmap(lambda e, d, pp, a, b: jcol.collision_lower_bounds(
        e, d, pp, a, b, jp, h=H, min_distance=R))(
        eta, dist, prev, jnp.asarray(p0), jnp.asarray(v0))
    mask = jnp.asarray(col_masks, jnp.float64)
    col_lo = jnp.where(mask[:, None, None] > 0, col_lo, -jnp.inf)
    jdata = ja.QPData(eta=eta, col_mask=mask,
                      lower=JCB(col=col_lo, **lo), upper=JCB(col=inf, **up))
    return jdata, a0, jp


def _port_data(jdata, col_mask):
    return ta.QPData(eta=T(jdata.eta), col_mask=T(col_mask),
                     lower=ConstraintBlocks(*map(T, jdata.lower)),
                     upper=ConstraintBlocks(*map(T, jdata.upper)))


def test_pcg_xupdate_matches_jax_with_an_early_lane():
    """Lane 0 has no collision rows, so the preconditioner is exact for it
    and it meets cg_tol after one iteration; the others run on: x within
    1e-10 and equal iteration counts a lane."""
    jdata, a0, jp = _qp_data([0.0, 1.0, 1.0])
    cfg = jcfg.SolverConfig()
    prm = ja.make_solver_params(cfg, jnp.float64)
    static = cfg.static_part()
    pc = ja.build_static_normal_inverse(K, H, cfg, dtype=jnp.float64)
    scaling = ja.build_row_scaling(K, H, dtype=jnp.float64)
    rho = jax.vmap(lambda d: ja._rho_blocks(d, static, prm.rho, scaling,
                                            prm.col_rho_boost))(jdata)
    rng = np.random.default_rng(4)
    b = jnp.asarray(rng.normal(size=(B, N, K, 2)))
    jx, jit = jax.vmap(lambda bb, x0, e, r: ja._solve_xupdate(
        bb, x0, e, jp.E, H, r, prm.rho, prm.sigma, pc, static, prm))(
        b, a0, jdata.eta, rho)
    _, tcfg = config_from_jax(_problem(N), cfg)
    tprm = make_solver_params(tcfg, F64)
    tpc = ta.build_static_normal_inverse(K, H, tcfg, dtype=F64)
    x, its = ta._solve_xupdate(
        T(b), T(a0), T(jdata.eta), T(jp.E), H,
        ConstraintBlocks(*map(T, rho)), tprm.rho.expand(B), tprm.sigma, tpc,
        tcfg.static_part(), tprm)
    np.testing.assert_array_equal(its.numpy(), np.asarray(jit))
    assert int(its[0]) < int(its[1:].min())
    assert _rel(x, jx) <= 1e-10


def test_solve_qp_impl_adaptive_rho_and_polish_match_jax_vmap(monkeypatch):
    """The default solver (adaptive rho, CG polish) on B=3 QPs against
    JAX's vmapped ``solve_qp_impl``: equal iteration counts and convergence
    flags, x within 1e-8; the lanes' rho adapt at different intervals and
    one lane's never does."""
    # seed 2 at rho 1: lane 0 adapts after its fourth interval, lane 2
    # after its second, lane 1 never; 675, 100 and 25 iterations
    jdata, a0, jp = _qp_data([1.0, 1.0, 1.0], seed=2)
    cfg = jcfg.SolverConfig(rho=1.0, max_iter=1000)
    prm = ja.make_solver_params(cfg, jnp.float64)
    pc = ja.build_static_normal_inverse(K, H, cfg, dtype=jnp.float64)
    want = jax.vmap(lambda d, x0: ja.solve_qp_impl(
        d._replace(col_mask=jnp.asarray(1.0)), jp.E, pc, x0, prm, h=H,
        static=cfg.static_part()))(jdata._replace(col_mask=None), a0)

    rhos, orig = [], ta._rho_blocks

    def rec(data, static, rho, *a):
        rhos.append(rho.clone())
        return orig(data, static, rho, *a)
    monkeypatch.setattr(ta, "_rho_blocks", rec)
    _, tcfg = config_from_jax(_problem(N), cfg)
    got = ta.solve_qp_impl(
        _port_data(jdata, 1.0), T(jp.E),
        ta.build_static_normal_inverse(K, H, tcfg, dtype=F64), T(a0),
        make_solver_params(tcfg, F64), h=H, static=tcfg.static_part())
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    assert _rel(got.x, want.x) <= 1e-8
    rho = torch.stack(rhos)                    # (intervals, B)
    first = [int(torch.nonzero(rho[:, i] != rho[0, i])[0]) if bool(
        (rho[:, i] != rho[0, i]).any()) else None for i in range(B)]
    moved = [f for f in first if f is not None]
    assert None in first and len(set(moved)) >= 2, first
