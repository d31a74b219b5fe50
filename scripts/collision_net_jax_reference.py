#!/usr/bin/env python3
"""Reference runs of ``train-network`` on the CPU: the numbers the PyTorch
port's run on the card is held to, and the spread of both packages over
seeds.

    JAX_PLATFORMS=cpu python scripts/collision_net_jax_reference.py \\
        [--out DIR] [--seeds 8]

1. The JAX package's CLI (``ba_path_planning_tpu.cli.train_collision_network``)
   at its defaults (N=10, 8192 scenarios labelled by the JAX phase-1 solve,
   30 epochs at batch 256, hidden 64 64, seed 0); the same scenarios are
   labelled once more (the labelling is deterministic in the seed) to
   rebuild the CLI's held-out split and compute the eval loss of the saved
   parameters, which the CLI does not print.
2. JAX's training and evaluation, as the CLI runs them (seed 0), on the
   port's scenarios: ``ba_path_planning_torch``'s ``label_chunks`` at the
   same defaults on the CPU, the data the port's run on the card trains on
   (its labels agree with the card's).  The eval split depends on the data,
   and the eval loss on the split's base rate, so the port's loss is held
   to this run on the same data.
3. The port's ``train`` on the JAX CLI's scenarios from the JAX CLI's own
   initial parameters (carried across with ``collision_net_from_jax``):
   the same start, data and batch order as item 1, so the metrics show
   whether the two trainings agree where only FP32 rounding differs.
4. With ``--seeds K``: both packages' training at seeds 0..K-1 on both
   label sets (the init draw and the batch order change with the seed).

The last line is one JSON object with all of it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SEED, SAMPLES, CHUNK, EVAL_FRAC = 0, 8192, 128, 0.2
EPOCHS, BATCH, LR, HIDDEN, N_VEH = 30, 256, 3e-3, (64, 64), 10


def _auc(logits, truth):
    """The JAX CLI's rank AUC."""
    import numpy as np
    ranked = truth[np.argsort(-logits)]
    n_pos, n_neg = int(ranked.sum()), int((~ranked).sum())
    if not (n_pos and n_neg):
        return 0.0
    return 1.0 - float((np.cumsum(~ranked) * ranked).sum()
                       / max(n_pos * n_neg, 1))


def _split(n, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_eval = int(n * EVAL_FRAC)
    return rng, perm[n_eval:], perm[:n_eval]


def _metrics(logits, y):
    import numpy as np
    import optax
    truth = y > 0.5
    loss = float(np.mean(np.asarray(optax.sigmoid_binary_cross_entropy(
        logits, y))))
    return {"eval_acc": float(((logits > 0) == truth).mean()),
            "eval_auc": _auc(logits, truth), "eval_loss": loss,
            "eval_n_pos": int(truth.sum()), "eval_n_neg": int((~truth).sum())}


def jax_train_eval(p0, pf, y, seed):
    """The JAX CLI's split, training loop and evaluation on given arrays."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ba_path_planning_tpu.models.collision_net import (
        make_train_state, make_train_step, predict_logits)
    rng, tr, ev = _split(len(y), seed)
    params, opt_state, apply_fn, tx = make_train_state(
        jax.random.key(seed), N_VEH, hidden=HIDDEN, learning_rate=LR)
    step = make_train_step(apply_fn, tx)
    for _ in range(EPOCHS):
        rng.shuffle(tr)
        for lo in range(0, len(tr) - BATCH + 1, BATCH):
            idx = tr[lo:lo + BATCH]
            params, opt_state, _, _ = step(
                params, opt_state, jnp.asarray(p0[idx]), jnp.asarray(pf[idx]),
                jnp.asarray(y[idx]))
    logits = np.asarray(predict_logits(params, jnp.asarray(p0[ev]),
                                       jnp.asarray(pf[ev]),
                                       apply_fn=apply_fn))
    return _metrics(logits, y[ev])


def port_train_eval(p0, pf, y, seed, init=None):
    """The port's ``train`` and ``evaluate`` on the CPU on given arrays;
    ``init``: start from these flax parameters instead of the port's own
    draw (the port's ``make_train_state`` is wrapped for the call)."""
    import torch
    from ba_path_planning_torch.cli import train_collision_network as tcli
    from ba_path_planning_torch.models import collision_net as tnet
    from ba_path_planning_torch.utils.convert import collision_net_from_jax
    args = argparse.Namespace(seed=seed, eval_frac=EVAL_FRAC, n_vehicles=N_VEH,
                              hidden=list(HIDDEN), lr=LR, batch_size=BATCH,
                              epochs=EPOCHS)
    own = tnet.make_train_state

    def from_init(*a, **k):
        net, opt = own(*a, **k)
        net.load_state_dict({key: v.to(torch.float32) for key, v in
                             collision_net_from_jax(init).items()})
        return net, opt
    if init is not None:
        tnet.make_train_state = from_init
    try:
        net, ev, _, _ = tcli.train(p0, pf, y, args, "cpu",
                                   log=lambda s: None)
    finally:
        tnet.make_train_state = own
    m = tcli.evaluate(net, p0[ev], pf[ev], y[ev])
    return {"eval_acc": m["acc"], "eval_auc": m["auc"],
            "eval_loss": m["loss"], "eval_n_pos": m["n_pos"],
            "eval_n_neg": m["n_neg"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory of the saved npz (default: a temp dir)")
    ap.add_argument("--seeds", type=int, default=0,
                    help="also train both packages at seeds 0..K-1")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ba_path_planning_tpu.cli import train_collision_network as cli
    from ba_path_planning_tpu.models.collision_net import (
        make_train_state, load_params, predict_logits)
    from ba_path_planning_tpu.utils import ProblemConfig
    from ba_path_planning_torch.cli import train_collision_network as tcli
    from ba_path_planning_torch.utils.config import (
        ProblemConfig as TProblemConfig)

    out_dir = args.out or tempfile.mkdtemp()
    path = os.path.join(out_dir, "collision_net_jax.npz")
    t0 = time.perf_counter()
    cli.main(["--out", path])
    wall = time.perf_counter() - t0

    problem = ProblemConfig(n_vehicles=N_VEH, time_horizon=10.0,
                            time_step=0.2, min_distance=0.8)
    jp0, jpf, jy = cli._label_chunks(problem, SAMPLES, CHUNK, SEED)
    _, _, ev = _split(SAMPLES, SEED)
    template, _, apply_fn, _ = make_train_state(jax.random.key(SEED), N_VEH)
    params = load_params(path, template)
    logits = np.asarray(predict_logits(params, jnp.asarray(jp0[ev]),
                                       jnp.asarray(jpf[ev]),
                                       apply_fn=apply_fn))
    report = {"backend": jax.default_backend(), "jax_cli": dict(
        feasible_fraction=float(jy.mean()), wall_s=wall,
        **_metrics(logits, jy[ev]))}
    init, _, _, _ = make_train_state(jax.random.key(SEED), N_VEH,
                                     hidden=HIDDEN, learning_rate=LR)
    report["port_from_jax_init"] = port_train_eval(
        jp0, jpf, jy, SEED, init=jax.tree_util.tree_map(np.asarray, init))

    tproblem = TProblemConfig(n_vehicles=N_VEH, time_horizon=10.0,
                              time_step=0.2, min_distance=0.8)
    t0 = time.perf_counter()
    pp0, ppf, py = tcli.label_chunks(tproblem, SAMPLES, CHUNK, SEED, "cpu")
    report["port_scenarios"] = dict(
        feasible_fraction=float(py.mean()),
        label_wall_s=time.perf_counter() - t0,
        jax_training=jax_train_eval(pp0, ppf, py, SEED))
    print(json.dumps(report), flush=True)

    if args.seeds:
        sweep = {}
        for data, (p0, pf, y) in (("jax_scenarios", (jp0, jpf, jy)),
                                  ("port_scenarios", (pp0, ppf, py))):
            for who, fn in (("jax", jax_train_eval),
                            ("port", port_train_eval)):
                runs = [fn(p0, pf, y, s) for s in range(args.seeds)]
                sweep[f"{who}_on_{data}"] = {
                    k: [r[k] for r in runs] for k in ("eval_loss",
                                                      "eval_auc")}
                print(json.dumps({f"{who}_on_{data}":
                                  sweep[f"{who}_on_{data}"]}), flush=True)
        report["seed_sweep"] = sweep
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
