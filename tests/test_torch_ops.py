"""PyTorch port, modules 1-5: configuration, rollout, the double-integrator
model, collisions and the scenario generator, each held against the JAX
package on the same numpy inputs (float64, 1e-10 relative unless stated).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ba_path_planning_tpu.models.double_integrator import (
    DoubleIntegrator2D as JDI)
from ba_path_planning_tpu.ops import collisions as jcol
from ba_path_planning_tpu.ops.rollout import rollout as jrollout
from ba_path_planning_tpu.scenarios import generator as jgen
from ba_path_planning_tpu.utils import config as jcfg

from ba_path_planning_torch.models.double_integrator import DoubleIntegrator2D
from ba_path_planning_torch.ops import collisions as tcol
from ba_path_planning_torch.ops.rollout import rollout
from ba_path_planning_torch.scenarios.generator import (
    CIRCLE_CENTERS, CIRCLE_RADIUS, DIAMOND_CENTER, DIAMOND_SIZE,
    generate_scenario_batch)
from ba_path_planning_torch.utils import config as tcfg
from ba_path_planning_torch.utils.config import make_solver_params
from ba_path_planning_torch.utils.convert import (config_from_jax,
                                                  pairs_from_numpy)

RTOL = 1e-10


def _close(got, want, rtol=RTOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert got.shape == want.shape
    assert float(np.max(np.abs(got - want))) <= rtol * scale


@pytest.mark.parametrize("problem_kw", [
    dict(n_vehicles=20, time_horizon=10.0, time_step=0.2, min_distance=0.8),
    dict(n_vehicles=30, time_horizon=10.0, time_step=0.2, min_distance=0.8),
    dict(n_vehicles=4, time_horizon=2.0, time_step=0.2, min_distance=0.5),
])
def test_config_production_matches_jax(problem_kw):
    jp = jcfg.ProblemConfig(**problem_kw)
    tp = tcfg.ProblemConfig(**problem_kw)
    assert (jp.n_steps, jp.n_pairs, jp.limits) == (
        tp.n_steps, tp.n_pairs, jcfg.Limits(**dataclasses.asdict(tp.limits)))
    for flag in (False, True):
        js = dataclasses.asdict(jcfg.SolverConfig.production(pallas=flag,
                                                             problem=jp))
        ts = dataclasses.asdict(tcfg.SolverConfig.production(kernels=flag,
                                                             problem=tp))
        assert ts.pop("kernels") == js.pop("pallas")
        assert ts == js
    jstat = dataclasses.asdict(jcfg.SolverConfig.production(
        pallas=True, problem=jp).static_part())
    tstat = dataclasses.asdict(tcfg.SolverConfig.production(
        kernels=True, problem=tp).static_part())
    assert tstat.pop("kernels") == jstat.pop("pallas")
    assert tstat == jstat
    cp, cs = config_from_jax(jp, jcfg.SolverConfig.production(pallas=False,
                                                              problem=jp))
    assert cp == tp
    assert cs == tcfg.SolverConfig.production(kernels=False, problem=tp)
    prm = make_solver_params(cs, torch.float64)
    assert float(prm.rho) == cs.rho and int(prm.max_iter) == cs.max_iter


def test_rollout_and_model_match_jax():
    rng = np.random.default_rng(0)
    B, N, K, h = 3, 4, 7, 0.2
    a = rng.normal(size=(B, N, K, 2))
    p0, v0 = rng.normal(size=(B, N, 2)), rng.normal(size=(B, N, 2))
    pf, vf = rng.normal(size=(B, N, 2)), rng.normal(size=(B, N, 2))
    T = lambda x: torch.as_tensor(x, dtype=torch.float64)
    pos, vel = rollout(T(a), T(p0), T(v0), h)
    jpos, jvel = jrollout(jnp.asarray(a), jnp.asarray(p0), jnp.asarray(v0), h)
    _close(pos, jpos)
    _close(vel, jvel)
    m, jm = DoubleIntegrator2D(K, h), JDI(K, h)
    for got, want in zip(m.terminal_state(pos, vel, T(a)),
                         jm.terminal_state(jpos, jvel, jnp.asarray(a))):
        _close(got, want)
    ga = m.goal_projection(T(a), T(p0), T(v0), T(pf), T(vf))
    _close(ga, jm.goal_projection(jnp.asarray(a), jnp.asarray(p0),
                                  jnp.asarray(v0), jnp.asarray(pf),
                                  jnp.asarray(vf)))
    # the projection hits the goal exactly
    gp, gv = rollout(ga, T(p0), T(v0), h)
    pK, vK = m.terminal_state(gp, gv, ga)
    _close(pK, pf)
    _close(vK, vf)


def _jax_angles(keys, pairs, K, it):
    """The JAX package's degenerate-pair draws (collisions.py:78-85)."""
    pair_id = (np.asarray(pairs.i_idx).astype(np.uint32) * np.uint32(65536)
               + np.asarray(pairs.j_idx).astype(np.uint32))

    def one(key):
        sub = jax.random.fold_in(key, it)
        pk = jax.vmap(lambda i: jax.random.fold_in(sub, i))(
            jnp.asarray(pair_id))
        return jax.vmap(lambda k_: jax.random.uniform(
            k_, (K,), dtype=jnp.float64, maxval=2.0 * jnp.pi),
            out_axes=-1)(pk)
    return np.asarray(jax.vmap(one)(keys))


def test_collisions_match_jax_with_injected_angles():
    rng = np.random.default_rng(1)
    B, N, K, R = 2, 5, 6, 0.8
    pos = rng.uniform(0, 3, size=(B, N, K, 2))
    pos[:, 1, 2] = pos[:, 3, 2]            # a degenerate pair at k = 2
    pos[1, 0, 4] = pos[1, 2, 4]
    jp = jcol.make_pair_index(N, dtype=jnp.float64)
    tp = tcol.make_pair_index(N, dtype=torch.float64)
    keys = jax.random.split(jax.random.key(3), B)
    it = 2
    ang = np.array(_jax_angles(keys, jp, K, it))
    jeta, jdist = jax.vmap(lambda p, k: jcol.linearize(
        p, jp, jax.random.fold_in(k, it)))(jnp.asarray(pos), keys)
    tpos = torch.as_tensor(pos)
    conv = pairs_from_numpy(jp)
    for got, want in zip(conv, tp):
        assert torch.equal(got, want)
    eta, dist = tcol.linearize(tpos, tp, torch.as_tensor(ang))
    _close(eta, jeta)
    _close(dist, jdist)
    _close(tcol.pairwise_diffs(tpos, tp),
           jcol.pairwise_diffs(jnp.asarray(pos), jp))
    _close(tcol.min_pairwise_distance(tpos, tp),
           jcol.min_pairwise_distance(jnp.asarray(pos), jp))
    for r in (R, 0.05):
        np.testing.assert_array_equal(
            tcol.check_feasible(tpos, tp, r).numpy(),
            np.asarray(jcol.check_feasible(jnp.asarray(pos), jp, r)))


def test_degenerate_angles_are_keyed_per_lane():
    pairs = tcol.make_pair_index(4)
    ids = torch.tensor([7, 3, 9])
    it = torch.tensor([0, 2, 1])
    a = tcol.degenerate_angles(5, ids, it, pairs, 6)
    assert a.shape == (3, 6, 6)
    assert float(a.min()) >= 0.0 and float(a.max()) < 2 * np.pi
    # a lane's draws do not depend on its batch neighbours
    b = tcol.degenerate_angles(5, ids[1:2], it[1:2], pairs, 6)
    assert torch.equal(a[1:2], b)
    c = tcol.degenerate_angles(5, ids[1:2], it[1:2] + 1, pairs, 6)
    assert not torch.equal(b, c)
    big = tcol.degenerate_angles(0, torch.arange(64), torch.zeros(64), pairs,
                                 50)
    assert abs(float(big.mean()) - np.pi) < 0.05


@pytest.mark.parametrize("n_vehicles,min_distance", [(6, 0.8), (20, 0.8)])
def test_generator_properties(n_vehicles, min_distance):
    B = 64
    sc = generate_scenario_batch(11, B, n_vehicles=n_vehicles,
                                 min_distance=min_distance,
                                 dtype=torch.float64, device="cpu")
    assert sc.initial.shape == sc.final.shape == (B, n_vehicles, 2)
    assert bool(sc.ok.all())
    again = generate_scenario_batch(11, B, n_vehicles=n_vehicles,
                                    min_distance=min_distance,
                                    dtype=torch.float64, device="cpu")
    assert torch.equal(sc.initial, again.initial)
    for pts in (sc.initial.numpy(), sc.final.numpy()):
        d = np.linalg.norm(pts[:, :, None] - pts[:, None], axis=-1)
        d[:, np.arange(n_vehicles), np.arange(n_vehicles)] = np.inf
        assert d.min() >= min_distance - 1e-12
    cc = np.asarray(CIRCLE_CENTERS)

    def on_circle(p):
        r = np.linalg.norm(p[..., None, :] - cc, axis=-1)
        return np.isclose(r, CIRCLE_RADIUS, atol=1e-9).any(-1)

    def on_diamond(p):
        l1 = np.abs(p - np.asarray(DIAMOND_CENTER)).sum(-1)
        return np.isclose(l1, DIAMOND_SIZE, atol=1e-5)

    assert on_circle(sc.initial.numpy()).all()
    fin = sc.final.numpy()
    assert (on_circle(fin) | on_diamond(fin)).all()
    # the final-point mix matches the JAX sampler's (crowding on the
    # diamond pushes late draws to the circles, so it is below 0.9 at N=20)
    jsc = jgen.generate_scenario_batch(jax.random.key(11), B,
                                       n_vehicles=n_vehicles,
                                       min_distance=min_distance)
    assert abs(on_diamond(fin).mean()
               - on_diamond(np.asarray(jsc.final, np.float64)).mean()) < 0.05
