"""PyTorch port, the exact active-set polish of the direct path
(``banded.polish_qp_state``) and its row-wise block assembly, held against
the JAX package in float64 on ``tests/test_polish.py``'s problem (an
approach-to-contact pair, N=2, K=20): the assembly within 1e-12, the
polished point within 1e-10 of JAX's and within 1e-8 of the certified
optimum of ``tests/oracles/reference_math.py``, and a batch in which one
lane's polish is rejected.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from ba_path_planning_tpu.solvers import banded as jb
from ba_path_planning_tpu.solvers.admm import make_solver_params
from ba_path_planning_tpu.utils import SolverConfig

from ba_path_planning_torch.solvers import banded as tb
from ba_path_planning_torch.utils.convert import rowvals_from_numpy

from test_polish import LIM, K, N, R, _oracle_optimum, _problem_inputs, h

F64 = torch.float64


def T(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1.0)


def _qp():
    """test_polish.py's QP and its unpolished ADMM solution (JAX, eps
    1e-6): bounds, eta, x, y and the oracle's inputs."""
    p0, v0, pf, pairs, prev, eta, dist = _problem_inputs()
    P = pairs.E.shape[1]
    cfg = SolverConfig(method="direct", adaptive_rho=False, polish=False,
                       eps_abs=1e-6, eps_rel=1e-6, max_iter=4000,
                       check_interval=50, rho=1.6)
    lower, upper = jb.build_bounds(p0, v0, pf, v0, n_vehicles=N, n_steps=K,
                                   h=h, limits=LIM, n_pairs=P)
    lower = lower._replace(col=jb.collision_lower_bounds_state(
        eta, dist, prev, pairs, min_distance=R))
    x0 = jb.StateVars(*(jnp.zeros((N, K, 2), jnp.float64),) * 3)
    qp = jb.solve_qp_state(lower, upper, eta, x0,
                           make_solver_params(cfg, jnp.float64), pairs.E,
                           h=h, static=cfg.static_part(), n_vehicles=N)
    assert bool(qp.converged)
    return lower, upper, eta, qp.x, qp.y, pairs, (p0, v0, pf, prev)


def _batch(tree, lanes=1):
    return jax.tree.map(lambda t: jnp.stack([t] * lanes), tree)


def _port_polish(lower, upper, eta, x, y, pairs):
    return tb.polish_qp_state(
        rowvals_from_numpy(lower), rowvals_from_numpy(upper), T(eta),
        tb.StateVars(*map(T, x)), rowvals_from_numpy(y), T(pairs.E), h=h,
        n_vehicles=N)


def test_rowwise_assembly_matches_jax():
    """Per-channel rho leaves, one set a lane (B=2): D and B within 1e-12
    of the JAX assembly run lane by lane."""
    rng = np.random.default_rng(0)
    _, _, _, pairs, _, eta, _ = _problem_inputs()
    P = pairs.E.shape[1]
    scaling = jb.row_scaling_state(K, h, dtype=jnp.float64)
    leaves = dict(
        dyn_p=np.asarray(scaling.dyn_p) * 7.0,
        dyn_v=np.asarray(scaling.dyn_v) * 3.0,
        **{name: rng.uniform(0.0, 5.0, size=(2, N, Kp, 2)) for name, Kp in
           (("jerk", K - 1), ("acc", K), ("vbox", K), ("pbox", K))},
        col=rng.uniform(0.0, 5.0, size=(2, K, P)))
    etas = np.stack([np.asarray(eta), np.asarray(eta)[::-1]])
    D, Bm = tb.assemble_blocks_rowwise(
        tb.RowVals(**{k: T(v) for k, v in leaves.items()}), T(etas),
        T(pairs.E), h=h, sigma=1e-6, n_vehicles=N)
    for i in range(2):
        jrho = jb.RowVals(**{k: jnp.asarray(v if k.startswith("dyn")
                                            else v[i])
                             for k, v in leaves.items()})
        jD, jB = jb.assemble_blocks_rowwise(jrho, jnp.asarray(etas[i]),
                                            pairs.E, h=h, sigma=1e-6,
                                            n_vehicles=N)
        assert _rel(D[i], jD) <= 1e-12 and _rel(Bm[i], jB) <= 1e-12


def test_polish_matches_jax_and_the_certified_optimum():
    lower, upper, eta, x, y, pairs, prob = _qp()
    want = jb.polish_qp_state(lower, upper, eta, x, y, pairs.E, h=h,
                              n_vehicles=N)
    got = _port_polish(*(_batch(t) for t in (lower, upper, eta, x, y)),
                       pairs)
    for g, w in zip(got, want):
        assert _rel(g[0], w) <= 1e-10
    a_ref = _oracle_optimum(*prob)
    raw_err = float(np.max(np.abs(np.asarray(x.a) - a_ref)))
    pol_err = float(np.max(np.abs(got.a[0].numpy() - a_ref)))
    assert pol_err < 1e-8 and pol_err < raw_err / 10, (pol_err, raw_err)


def test_polish_rejects_a_wrong_active_set_lane_by_lane():
    """Three lanes of the same QP; lane 1's duals claim every acceleration
    at its upper bound, an active set that contradicts the terminal
    equalities, so its polished point violates them and the lane keeps its
    ADMM iterate, while lanes 0 and 2 take theirs, as JAX's lanes do."""
    lower, upper, eta, x, y, pairs, _ = _qp()
    ys = _batch(y, 3)
    ys = ys._replace(acc=ys.acc.at[1].set(1.0))
    args = [_batch(t, 3) for t in (lower, upper, eta, x)]
    want = jax.vmap(lambda lo, up, e, xx, yy: jb.polish_qp_state(
        lo, up, e, xx, yy, pairs.E, h=h, n_vehicles=N))(*args[:4], ys)
    got = _port_polish(*args, ys, pairs)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-10
    # lane 1 unchanged, the others polished
    for g, raw in zip(got, x):
        assert torch.equal(g[1], T(raw))
        assert not torch.equal(g[0], T(raw))
        assert torch.equal(g[0], g[2])
