"""PyTorch port, the native C++ QP (``native/``, built by g++ into
``build/native/`` at first use): the JAX package's
``tests/test_native_qp.py`` cases through the port's ``NativeQP`` and
``solve_qp`` (and, for the first, JAX's ``solve_qp`` on the same QP), with
that test's tolerances."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ba_path_planning_tpu.ops import (collision_lower_bounds as jcol_lb,
                                      linearize as jlinearize,
                                      make_pair_index as jpairs,
                                      static_bounds as jstatic_bounds)
from ba_path_planning_tpu.ops.constraints import ConstraintBlocks as JCB
from ba_path_planning_tpu.solvers import admm as ja
from ba_path_planning_tpu.utils import SolverConfig as JSolverConfig

from ba_path_planning_torch import native
from ba_path_planning_torch.ops.collisions import (collision_lower_bounds,
                                                   linearize, make_pair_index)
from ba_path_planning_torch.ops.constraints import (ConstraintBlocks,
                                                    static_bounds)
from ba_path_planning_torch.solvers.admm import (QPData, solve_qp,
                                                 build_static_normal_inverse,
                                                 build_row_scaling)
from ba_path_planning_torch.utils.config import Limits, SolverConfig

F64 = torch.float64


@pytest.fixture(scope="module")
def native_qp():
    try:
        native.load_library()
    except (OSError, FileNotFoundError) as exc:  # pragma: no cover
        pytest.skip(f"native toolchain unavailable: {exc}")
    return native.NativeQP


def _flatten_blocks(blocks) -> np.ndarray:
    return np.concatenate([np.asarray(b).reshape(-1) for b in blocks])


def _expand_scaling(scaling, N, K, P):
    """Per-k (K,1) scale arrays -> full per-row buffers in block shapes."""
    return ConstraintBlocks(
        jerk=np.broadcast_to(scaling.jerk.numpy(), (N, K - 1, 2)),
        acc=np.broadcast_to(scaling.acc.numpy(), (N, K, 2)),
        vel=np.broadcast_to(scaling.vel.numpy(), (N, K, 2)),
        pos=np.broadcast_to(scaling.pos.numpy(), (N, K, 2)),
        col=np.broadcast_to(scaling.col.numpy(), (K, P)))


def _scaling_and_rho(cfg, K, h, N, P, col_rho=None):
    d_full = _expand_scaling(build_row_scaling(K, h, dtype=F64), N, K, P)
    rho_full = ConstraintBlocks(*[cfg.rho * np.asarray(d) ** 2
                                  for d in d_full])
    # equality rows: terminal vel/pos rows get the rho_eq boost
    rho_vel = np.array(rho_full.vel)
    rho_pos = np.array(rho_full.pos)
    rho_vel[:, K - 1, :] *= cfg.rho_eq_scale
    rho_pos[:, K - 1, :] *= cfg.rho_eq_scale
    rho_full = rho_full._replace(vel=rho_vel, pos=rho_pos)
    if col_rho is not None:
        rho_full = rho_full._replace(col=col_rho)
    return _flatten_blocks(d_full), _flatten_blocks(rho_full)


def _set_settings(nqp, cfg, **extra):
    nqp.set_settings(rho=cfg.rho, sigma=cfg.sigma, alpha=cfg.alpha,
                     eps_abs=cfg.eps_abs, eps_rel=cfg.eps_rel,
                     max_iter=cfg.max_iter, cg_iters=cfg.cg_iters, **extra)


def test_native_matches_the_port_solver(native_qp):
    N, K, h, R = 3, 10, 0.2, 1.0
    P = N * (N - 1) // 2
    rng = np.random.default_rng(0)
    p0 = rng.uniform(4, 16, (N, 2))
    pf = p0 + rng.uniform(-1, 1, (N, 2))
    v0 = np.zeros((N, 2))
    lim = Limits()
    pairs = make_pair_index(N, dtype=F64)
    tp0, tv0, tpf = (torch.tensor(a) for a in (p0, v0, pf))
    lo, up = static_bounds(tp0, tv0, tpf, tv0, n_vehicles=N, n_steps=K, h=h,
                           limits=lim)
    # crossing previous iterate -> active-ish collision rows
    t = np.arange(K) / (K - 1)
    prev = p0[:, None, :] * (1 - t)[None, :, None] + pf[:, None, :] * t[
        None, :, None]
    eta, dist = linearize(torch.tensor(prev), pairs,
                          torch.zeros((K, P), dtype=F64))
    col_lo = collision_lower_bounds(eta, dist, torch.tensor(prev), tp0, tv0,
                                    pairs, h=h, min_distance=R)
    lower = ConstraintBlocks(col=col_lo, **lo)
    upper = ConstraintBlocks(col=torch.full((K, P), float("inf"), dtype=F64),
                             **up)
    cfg = SolverConfig(eps_abs=1e-6, eps_rel=1e-6, max_iter=8000,
                       cg_iters=20, adaptive_rho=False, polish=False)
    pc = build_static_normal_inverse(K, h, cfg, dtype=F64)
    data = QPData(eta=eta, col_mask=torch.tensor(1.0, dtype=F64),
                  lower=lower, upper=upper)
    out = solve_qp(data, pairs.E, pc, torch.zeros((N, K, 2), dtype=F64), h=h,
                   cfg=cfg)
    assert out.x.shape == (N, K, 2) and bool(out.converged)

    nqp = native_qp(N, K, h)
    _set_settings(nqp, cfg, check_interval=cfg.check_interval)
    nqp.set_precond(pc.Q, pc.lam)
    nqp.set_bounds(_flatten_blocks(lower), _flatten_blocks(upper))
    nqp.set_scaling(*_scaling_and_rho(cfg, K, h, N, P))
    nqp.set_collision(eta, 1.0)
    x_native, info = nqp.solve(torch.zeros((N, K, 2), dtype=F64))
    assert info["converged"], info
    np.testing.assert_allclose(x_native, out.x.numpy(), atol=5e-4, rtol=5e-3)

    # the same QP through the JAX package's solve_qp
    jpr = jpairs(N, dtype=jnp.float64)
    jlo, jup = jstatic_bounds(*(jnp.asarray(a) for a in (p0, v0, pf, v0)),
                              n_vehicles=N, n_steps=K, h=h, limits=lim)
    jeta, jdist = jlinearize(jnp.asarray(prev), jpr, jax.random.key(0))
    jcl = jcol_lb(jeta, jdist, jnp.asarray(prev), jnp.asarray(p0),
                  jnp.asarray(v0), jpr, h=h, min_distance=R)
    jcfg = JSolverConfig(eps_abs=1e-6, eps_rel=1e-6, max_iter=8000,
                         cg_iters=20, adaptive_rho=False, polish=False)
    jout = ja.solve_qp(
        ja.QPData(eta=jeta, col_mask=jnp.asarray(1.0, jnp.float64),
                  lower=JCB(col=jcl, **jlo),
                  upper=JCB(col=jnp.full((K, P), jnp.inf), **jup)),
        jpr.E, ja.build_static_normal_inverse(K, h, jcfg,
                                              dtype=jnp.float64),
        jnp.zeros((N, K, 2)), h=h, cfg=jcfg)
    assert int(out.iters) == int(jout.iters)
    np.testing.assert_allclose(out.x.numpy(), np.asarray(jout.x), rtol=0,
                               atol=1e-8)


def test_native_static_only_matches_oracle(native_qp):
    from oracles import reference_math as oracle
    N, K, h = 2, 8, 0.25
    P = 1
    rng = np.random.default_rng(1)
    p0 = rng.uniform(4, 16, (N, 2))
    pf = p0 + rng.uniform(-1, 1, (N, 2))
    v0 = np.zeros((N, 2))
    vf = np.zeros((N, 2))
    lim = Limits()
    lo, up = static_bounds(*(torch.tensor(a) for a in (p0, v0, pf, vf)),
                           n_vehicles=N, n_steps=K, h=h, limits=lim)
    inf = torch.full((K, P), float("inf"), dtype=F64)
    lower = ConstraintBlocks(col=-inf, **lo)
    upper = ConstraintBlocks(col=inf, **up)

    cfg = SolverConfig(eps_abs=1e-7, eps_rel=1e-7, max_iter=8000, cg_iters=20,
                       adaptive_rho=False)
    pc = build_static_normal_inverse(K, h, cfg, dtype=F64)
    nqp = native_qp(N, K, h)
    _set_settings(nqp, cfg)
    nqp.set_precond(pc.Q.numpy(), pc.lam.numpy())
    nqp.set_bounds(_flatten_blocks(lower), _flatten_blocks(upper))
    # disabled collision rows
    nqp.set_scaling(*_scaling_and_rho(cfg, K, h, N, P,
                                      col_rho=np.full((K, P), 1e-6)))
    nqp.set_collision(np.zeros((K, P, 2)), 0.0)
    x_native, info = nqp.solve(np.zeros((N, K, 2)))
    assert info["converged"], info

    lo_o, up_o = oracle.static_bounds(
        p0, v0, pf, vf, K=K, h=h, vel_min=lim.vel_min, vel_max=lim.vel_max,
        acc_min=lim.acc_min, acc_max=lim.acc_max, jerk_min=lim.jerk_min,
        jerk_max=lim.jerk_max, pos_min=lim.pos_min, pos_max=lim.pos_max)
    mats = oracle.static_dense_matrices(N, K, h)
    A = np.vstack([mats["jerk"], mats["acc"], mats["vel"], mats["pos"]])
    keys = ("jerk", "acc", "vel", "pos")
    l = np.concatenate([lo_o[k].reshape(-1) for k in keys])
    u = np.concatenate([up_o[k].reshape(-1) for k in keys])
    x_star = oracle.solve_qp(A, l, u)
    np.testing.assert_allclose(x_native.reshape(-1), x_star, atol=5e-4,
                               rtol=5e-3)


def test_native_rejects_wrong_sizes(native_qp):
    nqp = native_qp(2, 8, 0.25)
    with pytest.raises(ValueError, match="lam"):
        nqp.set_precond(np.eye(8), np.ones(7))
