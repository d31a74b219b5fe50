"""PyTorch port: the helpers behind the entry points, against the JAX
package's on the same numpy inputs: the reachability screen, scenario
analysis, config files, the batch CLI's summary and the checkpoints; and the
ROADMAP items that the port's refusals name."""

import builtins
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ba_path_planning_tpu.cli import compute_trajectories_batch as jcli
from ba_path_planning_tpu.models.double_integrator import (
    DoubleIntegrator2D as JModel)
from ba_path_planning_tpu.scenarios import generator as jgen
from ba_path_planning_tpu.solvers.scp import SCPResult as JResult
from ba_path_planning_tpu.utils import checkpoint as jck
from ba_path_planning_tpu.utils import config as jcfg

from ba_path_planning_torch.cli import compute_trajectories_batch as cli
from ba_path_planning_torch.models.double_integrator import DoubleIntegrator2D
from ba_path_planning_torch.scenarios import generator as gen
from ba_path_planning_torch.solvers import banded
from ba_path_planning_torch.solvers.scp import SCPEngine, SCPResult
from ba_path_planning_torch.utils import checkpoint as ck
from ba_path_planning_torch.utils import config as cfg

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("K,h", [(50, 0.2), (10, 0.5), (2, 0.05)])
def test_reachability_screen_matches_jax(K, h):
    rng = np.random.default_rng(K)
    p0 = rng.uniform(0, 20, (5, 4, 2))
    pf = rng.uniform(0, 20, (5, 4, 2))
    want_model = JModel(n_steps=K, time_step=h)
    model = DoubleIntegrator2D(n_steps=K, time_step=h)
    assert model.max_displacement(2.0, 15.0) == \
        want_model.max_displacement(2.0, 15.0)
    want = np.asarray(want_model.reachable(p0, pf, 2.0, 15.0))
    got_np = model.reachable(p0, pf, 2.0, 15.0)
    got_t = model.reachable(torch.as_tensor(p0), pf, 2.0, 15.0)
    assert isinstance(got_np, np.ndarray) and got_np.dtype == bool
    assert isinstance(got_t, torch.Tensor) and got_t.dtype == torch.bool
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_t.numpy(), want)
    assert 0 < want.sum() < want.size or K != 10   # both outcomes at K=10


def test_scenario_analysis_matches_jax(capsys):
    rng = np.random.default_rng(1)
    init, final = rng.uniform(0, 20, (7, 2)), rng.uniform(0, 20, (7, 2))
    for pos in (init, final, init[:1]):
        assert gen.minimum_distance(pos) == jgen.minimum_distance(pos)
    want = jgen.print_distance_analysis(init, final)
    want_out = capsys.readouterr().out
    assert gen.print_distance_analysis(init, final) == want
    assert capsys.readouterr().out == want_out


def test_generate_positions_draws_on_the_host_and_raises_when_it_gives_up():
    init, final = gen.generate_positions(6, 0.8, seed=3)
    assert init.shape == final.shape == (6, 2) and init.dtype == np.float32
    for pos in (init, final):
        assert gen.minimum_distance(pos)[0] >= 0.8 - 1e-6
    again = gen.generate_positions(6, 0.8, seed=3)
    np.testing.assert_array_equal(again[0], init)
    one = gen.generate_scenario(3, n_vehicles=6, min_distance=0.8,
                                device="cpu")
    np.testing.assert_array_equal(one.initial.numpy(), init)
    assert one.ok.dim() == 0 and bool(one.ok)
    with pytest.raises(ValueError, match="Could not generate"):
        gen.generate_positions(60, 5.0, max_attempts=50, seed=0)
    with pytest.raises(ValueError, match="Could not generate"):
        jgen.generate_positions(60, 5.0, max_attempts=50, seed=0)


YAML_TEXT = """\
# a problem and a solver in one file
n_vehicles: 12
time_horizon: 8.0
space_dims: [0, 0, 30, 30]
stop_mode: feasible
goal_project: false
unknown_key: 3
solver:
  rho: 2.6
  pallas: true
  factor_form: X
"""


@pytest.mark.parametrize("with_pyyaml", [True, False])
def test_load_yaml_matches_jax(tmp_path, monkeypatch, with_pyyaml):
    """The port reads a file as the JAX package does with PyYAML, also
    where PyYAML is missing (the machine with the card has none).  JAX's
    own fallback keeps YAML's ``true`` as the string "true"; the port's
    reads it as PyYAML does."""
    path = tmp_path / "c.yaml"
    path.write_text(YAML_TEXT)
    want = jcfg.load_yaml(str(path))
    assert want["solver"] == {"rho": 2.6, "pallas": True, "factor_form": "X"}
    if not with_pyyaml:
        real_import = builtins.__import__

        def no_yaml(name, *args, **kw):
            if name == "yaml":
                raise ImportError("no PyYAML here")
            return real_import(name, *args, **kw)
        monkeypatch.setattr(builtins, "__import__", no_yaml)
        assert jcfg.load_yaml(str(path))["solver"]["pallas"] == "true"
    assert cfg.load_yaml(str(path)) == want


def test_problem_and_solver_from_dict_match_jax():
    d = {"n_vehicles": 12, "time_horizon": 8.0, "space_dims": [0, 0, 30, 30],
         "stop_mode": "feasible", "unknown_key": 3}
    got, want = cfg.problem_from_dict(d), jcfg.problem_from_dict(d)
    for f in ("n_vehicles", "time_horizon", "space_dims", "stop_mode",
              "n_steps", "n_pairs"):
        assert getattr(got, f) == getattr(want, f), f
    s = {"rho": 2.6, "pallas": True, "factor_form": "X", "max_iter": 25,
         "unknown_key": 1}
    got, want = cfg.solver_from_dict(s), jcfg.solver_from_dict(s)
    assert got.kernels is True and want.pallas is True
    for f in ("rho", "factor_form", "max_iter", "method", "alpha"):
        assert getattr(got, f) == getattr(want, f), f
    assert cfg.solver_from_dict({"kernels": True, "pallas": True}).kernels
    assert not cfg.solver_from_dict({"pallas": False}).kernels
    with pytest.raises(ValueError, match="disagree"):
        cfg.solver_from_dict({"kernels": True, "pallas": False})


def test_summarize_matches_jax():
    rng = np.random.default_rng(2)
    runs = [{"N": n, "status": "success" if rng.uniform() < 0.8 else "error",
             "time_sec": float(rng.uniform(0.01, 2.0))}
            for n in (3, 5, 5, 5, 7, 7) for _ in range(4)]
    runs += [{"N": 9, "status": "error", "time_sec": 1.0}]
    assert cli.summarize(runs, [3, 5, 7, 9]) == jcli.summarize(
        runs, [3, 5, 7, 9])


def _result(B, seed):
    rng = np.random.default_rng(seed)
    f = {name: rng.normal(size=(B, 2, 3, 2)) for name in
         ("positions", "velocities", "accelerations")}
    f.update(iterations=rng.integers(0, 5, B).astype(np.int32),
             status=rng.integers(0, 3, B).astype(np.int32),
             converged=rng.uniform(size=B) < 0.5,
             feasible_initial=rng.uniform(size=B) < 0.5,
             feasible_final=rng.uniform(size=B) < 0.5,
             qp_iterations=rng.integers(0, 99, B).astype(np.int32),
             qp_converged_all=rng.uniform(size=B) < 0.5,
             rel_step=rng.uniform(size=B))
    return SCPResult(**{k: torch.tensor(v) for k, v in f.items()})


def test_checkpoints_round_trip_tensors_and_read_the_jax_files(tmp_path):
    res = _result(5, 0)
    ck.save_result(tmp_path / "r.npz", res, meta={"seed": 1})
    back = ck.load_result(tmp_path / "r.npz", SCPResult)
    for got, want in zip(back, res):
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want.numpy())
    assert ck.load_meta(tmp_path / "r.npz") == {"seed": 1}
    # the JAX package's checkpoint files read back the same
    jck.save_result(tmp_path / "j.npz", JResult(*(t.numpy() for t in res)))
    for got, want in zip(ck.load_result(tmp_path / "j.npz", SCPResult), res):
        np.testing.assert_array_equal(got, want.numpy())


def test_chunked_run_resumes_and_refuses(tmp_path):
    ident = {"N": 2, "chunk": 2, "engine": "ba_path_planning_torch"}
    parts = [_result(2, 10 + i) for i in range(3)]
    run = ck.ChunkedRun(tmp_path / "run", ident)
    assert list(run.pending(5, 2)) == [(0, (0, 2)), (1, (2, 4)), (2, (4, 5))]
    run.save_chunk(0, parts[0])
    # a new run object on the same directory sees the finished chunk
    run = ck.ChunkedRun(tmp_path / "run", ident)
    assert [i for i, _ in run.pending(5, 2)] == [1, 2]
    with pytest.raises(ValueError, match="incomplete"):
        run.merge(SCPResult, total=5, chunk=2)
    run.save_chunk(1, parts[1])
    run.save_chunk(2, SCPResult(*(t[:1] for t in parts[2])))
    merged = run.merge(SCPResult, total=5, chunk=2)
    want = jck.ChunkedRun(tmp_path / "run", ident).merge(JResult, total=5,
                                                          chunk=2)
    for got, exp in zip(merged, want):
        assert isinstance(got, np.ndarray) and got.shape[0] == 5
        np.testing.assert_array_equal(got, exp)
    with pytest.raises(ValueError, match="different config"):
        ck.ChunkedRun(tmp_path / "run", dict(ident, chunk=3))
    without_engine = {k: v for k, v in ident.items() if k != "engine"}
    jck.ChunkedRun(tmp_path / "jax_run", without_engine)
    with pytest.raises(ValueError, match="different config"):
        ck.ChunkedRun(tmp_path / "jax_run", ident)


def _queue1_items():
    text = (ROOT / "ROADMAP.md").read_text()
    queue = text.split("### Queue 1", 1)[1].split("### Queue 2", 1)[0]
    parts = re.split(r"^(\d+)\. ", queue, flags=re.M)
    return {int(n): body for n, body in zip(parts[1::2], parts[2::2])}


def _problem():
    return cfg.ProblemConfig(n_vehicles=2, time_horizon=1.0, time_step=0.2)


def _route(solver):
    return banded.qp_route(solver.static_part(), n_vehicles=2, n_steps=5,
                           dtype=torch.float32, col_enabled=True)


def _cg_engine(engine):
    # the CG method builds its preconditioner and is not resumable, as the
    # JAX engine's
    with pytest.raises(NotImplementedError, match="resumable SCP"):
        engine.start(*engine.as_inputs(*[np.zeros((1, 2, 2))] * 4))
    return engine.solver.method == "cg" and engine.Minv.Q.shape == (5, 5)


@pytest.mark.parametrize("make,topic,check", [
    (lambda: SCPEngine(_problem(), cfg.SolverConfig(method="cg"),
                       device="cpu"), r"\bCG\b", _cg_engine),
    (lambda: SCPEngine(_problem(), cfg.SolverConfig(
        method="direct", adaptive_rho=False), device="cpu"), "polish",
     lambda engine: engine.solver_static.polish),
    # the JAX solve_qp_state routes these options to its dense route
    (lambda: _route(cfg.SolverConfig(method="direct")), "adaptive rho",
     lambda route: route == "dense"),
    # bf16 factors are stored on the routes JAX stores them on
    (lambda: _route(cfg.SolverConfig(method="direct", adaptive_rho=False,
                                     factor_dtype="bf16")), "bf16",
     lambda route: route in banded.BF16_ROUTES),
], ids=["cg", "polish", "adaptive_rho", "bf16"])
def test_refusals_name_the_roadmap_item_of_their_option(make, topic, check):
    """An option not ported raises, naming the ROADMAP Queue 1 item that
    covers it; an option that was refused before its item was done now
    constructs and routes, and its item says it is done."""
    items = _queue1_items()
    if check is not None:
        assert check(make())
        done = [n for n, body in items.items()
                if re.search(topic, body, re.I) and body.startswith("**Done")]
        assert done, topic
        return
    with pytest.raises(NotImplementedError) as err:
        make()
    item = int(re.search(r"ROADMAP Queue 1 item (\d+)",
                         str(err.value)).group(1))
    assert re.search(topic, items[item], re.I), item
