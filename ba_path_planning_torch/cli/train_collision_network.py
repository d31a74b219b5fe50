"""``train-network``: train the collision-prediction network (counterpart of
``ba_path_planning_tpu.cli.train_collision_network``: the same flags,
defaults and printed lines).

    python -m ba_path_planning_torch.cli.train_collision_network \\
        --samples 8192 --out collision_net.npz

Scenarios come from :func:`~ba_path_planning_torch.scenarios.
generate_scenario_batch`, are labelled by running the solver's phase 1 (the
collision-free initial QP and the exact feasibility check,
``SCPEngine.start`` and its ``feasible_initial``) on the card in float32,
and fit :class:`~ba_path_planning_torch.models.collision_net.CollisionNet`
with AdamW.  The scenario draws are a ``torch.Generator``'s, so a seed gives
other scenarios than the JAX CLI's; the split and the batch order come from
``np.random.default_rng(seed)`` as in the JAX CLI, so the same labelled
arrays give the same batches.  The npz is the JAX package's layout.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-vehicles", type=int, default=10)
    ap.add_argument("--min-distance", type=float, default=0.8)
    ap.add_argument("--time-horizon", type=float, default=10.0)
    ap.add_argument("--time-step", type=float, default=0.2)
    ap.add_argument("--samples", type=int, default=8192)
    ap.add_argument("--label-chunk", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--hidden", type=int, nargs="+", default=[64, 64])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-frac", type=float, default=0.2)
    ap.add_argument("--out", type=str, default="collision_net.npz")
    return ap


def label_chunks(problem, n_samples: int, chunk: int, seed: int,
                 device=None):
    """``n_samples`` scenarios in chunks of ``chunk``, each chunk drawn from
    the seed ``seed + done`` (the JAX CLI's keying), labelled by phase 1 in
    float32 on ``device`` (None: the card).  Returns numpy (p0 (S, N, 2),
    pf (S, N, 2), y (S,) float32: 1 where the initial QP trajectory is
    already collision-free)."""
    import torch

    from ..scenarios import generate_scenario_batch
    from ..solvers.scp import SCPEngine
    from ..utils.config import SolverConfig

    engine = SCPEngine(problem, SolverConfig.production(problem=problem),
                       dtype=torch.float32, device=device)
    p0s, pfs, ys = [], [], []
    done = 0
    while done < n_samples:
        b = min(chunk, n_samples - done)
        sc = generate_scenario_batch(seed + done, b,
                                     n_vehicles=problem.n_vehicles,
                                     min_distance=problem.min_distance,
                                     device=engine.device)
        v0 = torch.zeros_like(sc.initial)
        carry = engine.start(sc.initial, v0, sc.final, v0)
        p0s.append(sc.initial.cpu().numpy())
        pfs.append(sc.final.cpu().numpy())
        ys.append(carry.feasible_initial.cpu().numpy().astype(np.float32))
        done += b
    return np.concatenate(p0s), np.concatenate(pfs), np.concatenate(ys)


def train(p0, pf, y, args, device=None, log=print):
    """Split and fit as the JAX CLI does: ``np.random.default_rng(seed)``
    draws the eval split and shuffles the training lanes every epoch.
    Returns (net, eval lane indices, per-epoch mean losses, steps run)."""
    import torch

    from ..models.collision_net import make_train_state, make_train_step

    n = len(y)
    n_eval = int(n * args.eval_frac)
    rng = np.random.default_rng(args.seed)
    perm = rng.permutation(n)
    tr, ev = perm[n_eval:], perm[:n_eval]

    net, opt = make_train_state(args.seed, args.n_vehicles,
                                hidden=args.hidden, learning_rate=args.lr,
                                device=device)
    dev = next(net.parameters()).device
    p0_t, pf_t, y_t = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                       for a in (p0, pf, y))
    train_step = make_train_step(net, opt)

    bs = args.batch_size
    epoch_losses, steps = [], 0
    for epoch in range(args.epochs):
        rng.shuffle(tr)
        order = torch.as_tensor(tr, device=dev)      # one copy an epoch
        losses, accs = [], []
        for lo in range(0, len(tr) - bs + 1, bs):
            idx = order[lo:lo + bs]
            loss, acc = train_step(p0_t[idx], pf_t[idx], y_t[idx])
            losses.append(loss)
            accs.append(acc)
            steps += 1
        # one host read an epoch
        mean_loss = float(torch.stack(losses).mean()) if losses else np.nan
        epoch_losses.append(mean_loss)
        if epoch % 5 == 0 or epoch == args.epochs - 1:
            mean_acc = float(torch.stack(accs).mean()) if accs else np.nan
            log(f"epoch {epoch:3d}: loss {mean_loss:.4f} "
                f"train acc {mean_acc:.3f}")
    return net, ev, epoch_losses, steps


def evaluate(net, p0, pf, y) -> dict:
    """The JAX CLI's held-out metrics on numpy arrays: accuracy, precision,
    recall and the rank AUC (ties broken by order), plus the mean binary
    cross-entropy ``loss``, the lane count and the base rate."""
    import torch

    from ..models.collision_net import predict_logits

    dev = next(net.parameters()).device
    logits_t = predict_logits(net, *(torch.as_tensor(a, dtype=torch.float32,
                                                     device=dev)
                                     for a in (p0, pf)))
    loss = float(torch.nn.functional.binary_cross_entropy_with_logits(
        logits_t, torch.as_tensor(y, dtype=logits_t.dtype, device=dev)))
    logits = logits_t.cpu().numpy()
    pred = logits > 0
    truth = y > 0.5
    acc = float((pred == truth).mean())
    tp = float((pred & truth).sum())
    prec = tp / max(pred.sum(), 1)
    rec = tp / max(truth.sum(), 1)
    order = np.argsort(-logits)
    ranked = truth[order]
    n_pos, n_neg = ranked.sum(), (~ranked).sum()
    auc = float(((np.cumsum(~ranked) * ranked).sum() / max(n_pos * n_neg, 1))
                if n_pos and n_neg else 1.0)
    return dict(acc=acc, precision=prec, recall=rec, auc=1.0 - auc,
                loss=loss, n=int(len(y)), base_rate=float(truth.mean()),
                n_pos=int(n_pos), n_neg=int(n_neg))


def main(argv=None, *, device=None) -> int:
    """The CLI; ``device`` (None: the card) is for callers in Python."""
    args = build_parser().parse_args(argv)

    import torch

    from ..models.collision_net import save_params
    from ..utils.config import ProblemConfig, resolve_device

    device = resolve_device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: main(..., device='cpu') runs on "
                           "the CPU")
    problem = ProblemConfig(n_vehicles=args.n_vehicles,
                            time_horizon=args.time_horizon,
                            time_step=args.time_step,
                            min_distance=args.min_distance)

    print(f"Labeling {args.samples} scenarios (N={args.n_vehicles}) via the "
          f"phase-1 solve on {device} ...", flush=True)
    t0 = time.perf_counter()
    p0, pf, y = label_chunks(problem, args.samples, args.label_chunk,
                             args.seed, device)
    print(f"  done in {time.perf_counter() - t0:.1f}s; "
          f"feasible fraction {y.mean():.3f}", flush=True)

    net, ev, _, _ = train(p0, pf, y, args, device,
                          log=lambda s: print(s, flush=True))
    m = evaluate(net, p0[ev], pf[ev], y[ev])
    print(f"eval: acc {m['acc']:.3f}  precision {m['precision']:.3f}  "
          f"recall {m['recall']:.3f}  auc {m['auc']:.3f}  (n={m['n']}, "
          f"base rate {m['base_rate']:.3f})")

    save_params(args.out, net)
    print(f"Saved parameters: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
