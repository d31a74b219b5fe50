"""PyTorch port, the collision-prediction network and ``train-network``
(``models/collision_net.py``, ``cli/train_collision_network.py``) held
against the JAX package's flax/optax versions on seeded numpy inputs: the
pair features (1e-12 in float64, 1e-6 in float32), the logits of converted
flax parameters (1e-10 / 1e-5), five AdamW steps against optax's adamw
(parameters within 1e-9 / 1e-5, equal accuracy), npz files in both
directions, the phase-1 labels against JAX's vmapped ``start`` in float64,
and the CLI at the JAX test's size.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ba_path_planning_tpu.models import collision_net as jnet
from ba_path_planning_tpu.solvers.scp import SCPEngine as JEngine
from ba_path_planning_tpu.utils import config as jcfg

from ba_path_planning_torch.cli import train_collision_network as tcli
from ba_path_planning_torch.models import collision_net as tnet
from ba_path_planning_torch.scenarios import generate_scenario_batch
from ba_path_planning_torch.solvers.scp import SCPEngine
from ba_path_planning_torch.utils.convert import (collision_net_from_jax,
                                                  config_from_jax)

DTYPES = {"f64": (torch.float64, jnp.float64, 1e-12),
          "f32": (torch.float32, jnp.float32, 1e-6)}


def _boundary(B, N, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(2, 18, (B, N, 2)), rng.uniform(2, 18, (B, N, 2))


def _flax_params(seed, N, jdtype):
    params, _, apply_fn, tx = jnet.make_train_state(jax.random.key(seed), N)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdtype), params)
    return params, apply_fn, tx


def _port_net(params, tdtype):
    net, opt = tnet.make_train_state(0, 4, dtype=tdtype, device="cpu")
    state = collision_net_from_jax(jax.tree_util.tree_map(np.asarray, params))
    net.load_state_dict({k: v.to(tdtype) for k, v in state.items()})
    return net, opt


@pytest.mark.parametrize("dt", DTYPES)
def test_pair_features_match_jax(dt):
    tdtype, jdtype, tol = DTYPES[dt]
    p0, pf = _boundary(6, 5, 0)
    # one pair that does not move relative to each other (t = 0 branch)
    pf[0, 1] = pf[0, 0] + (p0[0, 1] - p0[0, 0])
    want = np.asarray(jax.vmap(jnet.pair_features)(jnp.asarray(p0, jdtype),
                                                   jnp.asarray(pf, jdtype)))
    got = tnet.pair_features(torch.tensor(p0, dtype=tdtype),
                             torch.tensor(pf, dtype=tdtype)).numpy()
    assert got.shape == (6, 10, tnet.N_PAIR_FEATURES)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * 20)


@pytest.mark.parametrize("dt,tol", [("f64", 1e-10), ("f32", 1e-5)])
def test_logits_of_converted_flax_params_match_jax(dt, tol):
    tdtype, jdtype, _ = DTYPES[dt]
    params, apply_fn, _ = _flax_params(3, 5, jdtype)
    net, _ = _port_net(params, tdtype)
    p0, pf = _boundary(8, 5, 1)
    want = np.asarray(jnet.predict_logits(params, jnp.asarray(p0, jdtype),
                                          jnp.asarray(pf, jdtype),
                                          apply_fn=apply_fn))
    got = tnet.predict_logits(net, torch.tensor(p0, dtype=tdtype),
                              torch.tensor(pf, dtype=tdtype)).numpy()
    assert got.shape == (8,)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("dt,tol", [("f64", 1e-9), ("f32", 1e-5)])
def test_adamw_steps_track_optax(dt, tol):
    """Five steps from the same parameters on the same batches: the port's
    torch.optim.AdamW at optax.adamw's defaults (weight decay 1e-4 on every
    parameter) against optax."""
    tdtype, jdtype, _ = DTYPES[dt]
    params, apply_fn, tx = _flax_params(5, 4, jdtype)
    opt_state = tx.init(params)
    jstep = jnet.make_train_step(apply_fn, tx)
    net, opt = _port_net(params, tdtype)
    tstep = tnet.make_train_step(net, opt)
    rng = np.random.default_rng(2)
    for _ in range(5):
        p0, pf = (rng.uniform(2, 18, (32, 4, 2)) for _ in range(2))
        y = (rng.uniform(size=32) < 0.4).astype(np.float64)
        params, opt_state, jloss, jacc = jstep(
            params, opt_state, *(jnp.asarray(a, jdtype) for a in (p0, pf, y)))
        loss, acc = tstep(*(torch.tensor(a, dtype=tdtype)
                            for a in (p0, pf, y)))
        assert float(acc) == float(jacc)
        assert abs(float(loss) - float(jloss)) <= tol * max(1.0,
                                                            abs(float(jloss)))
    want = collision_net_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for key, got in net.state_dict().items():
        np.testing.assert_allclose(got.double().numpy(), want[key].numpy(),
                                   rtol=0, atol=tol)


def test_init_is_flax_lecun_normal():
    """Kernels drawn as flax's lecun_normal (std 1/sqrt(fan_in), truncated
    at two standard deviations), biases zero."""
    net = tnet.CollisionNet(hidden=(512, 512),
                            generator=torch.Generator().manual_seed(1))
    w = net.hidden[1].weight.detach().double()
    std = 1.0 / np.sqrt(512)
    assert abs(float(w.std()) / std - 1.0) < 0.01
    assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-12
    assert all(float(layer.bias.detach().abs().max()) == 0.0
               for layer in net.dense_layers())
    jw = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.key(0), (512, 512), jnp.float64))
    assert abs(float(w.std()) / jw.std() - 1.0) < 0.02


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_npz_files_move_both_ways(tmp_path, direction):
    path = str(tmp_path / "net.npz")
    p0, pf = _boundary(5, 4, 4)
    if direction == "jax_to_torch":
        params, apply_fn, _ = _flax_params(7, 4, jnp.float32)
        jnet.save_params(path, params)
        net = tnet.load_params(path, device="cpu")
    else:
        net, _ = tnet.make_train_state(7, 4, device="cpu")
        tnet.save_params(path, net)
        template, _, apply_fn, _ = jnet.make_train_state(jax.random.key(0), 4)
        params = jnet.load_params(path, template)
    want = np.asarray(jnet.predict_logits(params, jnp.asarray(p0, jnp.float32),
                                          jnp.asarray(pf, jnp.float32),
                                          apply_fn=apply_fn))
    got = tnet.predict_logits(net, torch.tensor(p0, dtype=torch.float32),
                              torch.tensor(pf, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the file reloads bit for bit into the package that wrote it
    again = tnet.load_params(path, tnet.CollisionNet())
    np.testing.assert_array_equal(
        tnet.predict_logits(again, torch.tensor(p0, dtype=torch.float32),
                            torch.tensor(pf, dtype=torch.float32)).numpy(),
        got)


def test_phase1_labels_match_jax_start():
    """The labels of ``label_chunks``: the port's phase 1 against JAX's
    vmapped ``start`` on the same N=4 scenarios, in float64."""
    problem = jcfg.ProblemConfig(n_vehicles=4, time_horizon=10.0,
                                 time_step=0.2, min_distance=1.6)
    solver = jcfg.SolverConfig.production(pallas=False, problem=problem)
    tproblem, tsolver = config_from_jax(problem, solver)
    sc = generate_scenario_batch(3, 12, n_vehicles=4, min_distance=1.6,
                                 dtype=torch.float64, device="cpu")
    v0 = torch.zeros_like(sc.initial)
    carry = SCPEngine(tproblem, tsolver, dtype=torch.float64,
                      device="cpu").start(sc.initial, v0, sc.final, v0)
    start, _, _ = JEngine(problem, solver, dtype=jnp.float64
                          ).start_step_finalize_fns()
    args = [jnp.asarray(t.numpy()) for t in (sc.initial, v0, sc.final, v0)]
    jcarry = jax.vmap(start)(*args, jax.random.split(jax.random.key(0), 12))
    want = np.asarray(jcarry.feasible_initial)
    assert 0 < want.sum() < len(want)
    np.testing.assert_array_equal(carry.feasible_initial.numpy(), want)
    np.testing.assert_allclose(carry.a.numpy(), np.asarray(jcarry.a),
                               rtol=0, atol=1e-8)


def test_train_network_cli_and_roundtrip(tmp_path):
    """The CLI at the JAX test's size: labels, trains, evaluates, saves an
    npz that both packages load to the same logits."""
    out = tmp_path / "cnet.npz"
    rc = tcli.main(["--n-vehicles", "3", "--samples", "96", "--label-chunk",
                    "48", "--batch-size", "32", "--epochs", "3",
                    "--time-horizon", "2.0", "--min-distance", "0.6",
                    "--out", str(out)], device="cpu")
    assert rc == 0 and out.exists()
    net = tnet.load_params(str(out), device="cpu")
    template, _, apply_fn, _ = jnet.make_train_state(jax.random.key(1), 3)
    params = jnet.load_params(str(out), template)
    p0, pf = _boundary(4, 3, 0)
    want = np.asarray(jnet.predict_logits(params, jnp.asarray(p0, jnp.float32),
                                          jnp.asarray(pf, jnp.float32),
                                          apply_fn=apply_fn))
    got = tnet.predict_logits(net, torch.tensor(p0, dtype=torch.float32),
                              torch.tensor(pf, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_train_split_and_metrics_follow_the_jax_cli():
    """Given the same labelled arrays, ``train`` draws the JAX CLI's split
    and ``evaluate`` computes its metric formulas."""
    import argparse
    p0, pf = _boundary(40, 3, 5)
    y = (np.random.default_rng(6).uniform(size=40) < 0.5).astype(np.float32)
    args = argparse.Namespace(seed=3, eval_frac=0.25, n_vehicles=3,
                              hidden=[8], lr=1e-2, batch_size=8, epochs=2)
    net, ev, losses, steps = tcli.train(p0, pf, y, args, "cpu",
                                        log=lambda s: None)
    np.testing.assert_array_equal(
        ev, np.random.default_rng(3).permutation(40)[:10])
    assert steps == 2 * (30 // 8) and len(losses) == 2
    m = tcli.evaluate(net, p0[ev], pf[ev], y[ev])
    logits = tnet.predict_logits(
        net, *(torch.tensor(a[ev], dtype=torch.float32)
               for a in (p0, pf))).numpy()
    truth = y[ev] > 0.5
    pos, neg = logits[truth], logits[~truth]
    # the rank AUC is the share of (positive, negative) pairs in order
    auc = np.mean(pos[:, None] > neg[None, :])
    assert m["auc"] == pytest.approx(auc, abs=1e-12)
    assert m["acc"] == pytest.approx(np.mean((logits > 0) == truth))
