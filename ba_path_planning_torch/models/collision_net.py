"""Learned collision predictor (counterpart of
``ba_path_planning_tpu.models.collision_net``).

A permutation-invariant pair-set network that predicts, from a scenario's
boundary conditions alone, whether the collision-free initial QP trajectory
already satisfies the pairwise safety distance: the gate the solver computes
at the end of phase 1 (``SCPCarry.feasible_initial``) to skip the SCP
iterations.  Per-pair features of both vehicles' boundary positions
(symmetric in the pair's vehicle order), a shared MLP encoder, smooth-min
pooling over pairs (collision risk is set by the worst pair) and a logistic
head.

The layers are those of the JAX package's flax module, in the same order
(flax names ``Dense_0`` .. ``Dense_{L+1}``: the L hidden layers, the
per-pair score, the head), initialised as flax does (LeCun normal kernels,
zero biases) and trained with AdamW at optax's defaults.
:func:`save_params` writes the JAX package's npz layout, so a parameter
file moves between the two packages in both directions.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..ops.collisions import make_pair_index

N_PAIR_FEATURES = 12

# flax's ``lecun_normal``: a normal truncated to two standard deviations,
# rescaled by this constant (the standard deviation of the unit normal
# truncated to [-2, 2]) so that the kernel's variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978
# optax.adamw's defaults
ADAMW_BETAS, ADAMW_EPS, ADAMW_WEIGHT_DECAY = (0.9, 0.999), 1e-8, 1e-4


def pair_features(p0, pf, pairs=None):
    """Per-pair symmetric features from boundary conditions.

    p0, pf (..., N, 2) initial and final positions -> (..., P, 12) with
    P = N(N-1)/2 in the pair order of ``make_pair_index``: |d0|, |df|,
    ||d0||, ||df||, the straight-line closest approach dmin and its t, the
    pair midpoints at the start and at the end (d = p_i - p_j)."""
    if pairs is None:
        pairs = make_pair_index(p0.shape[-2], dtype=p0.dtype,
                                device=p0.device)
    a0, b0 = p0[..., pairs.i_idx, :], p0[..., pairs.j_idx, :]
    af, bf = pf[..., pairs.i_idx, :], pf[..., pairs.j_idx, :]
    d0 = a0 - b0
    df = af - bf
    # closest approach of the relative straight line d(t) = d0 + t (df - d0)
    dd = df - d0
    denom = torch.sum(dd * dd, dim=-1)
    t = torch.where(denom > 1e-12,
                    -torch.sum(d0 * dd, dim=-1) / torch.clamp_min(denom, 1e-12),
                    torch.zeros_like(denom))
    t = torch.clamp(t, 0.0, 1.0)
    dmin = torch.linalg.vector_norm(d0 + t[..., None] * dd, dim=-1)
    return torch.cat([
        torch.abs(d0), torch.abs(df),
        torch.linalg.vector_norm(d0, dim=-1, keepdim=True),
        torch.linalg.vector_norm(df, dim=-1, keepdim=True),
        dmin[..., None], t[..., None],
        (a0 + b0) / 2.0, (af + bf) / 2.0,
    ], dim=-1)


def _lecun_normal_(weight: torch.Tensor, gen: torch.Generator) -> None:
    """flax's ``lecun_normal`` on a torch (out, in) weight, drawn from
    ``gen`` on the host: a unit normal truncated to [-2, 2] by its inverse
    CDF, times sqrt(1 / fan_in) / _TRUNC_STD."""
    lo, hi = (0.5 * (1.0 + math.erf(z / math.sqrt(2.0))) for z in (-2.0, 2.0))
    u = lo + (hi - lo) * torch.rand(weight.shape, generator=gen,
                                    dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    with torch.no_grad():
        weight.copy_((std * z).clamp(-2.0 * std, 2.0 * std))


class CollisionNet(nn.Module):
    """Pair-set encoder + smooth-min pooling + logistic head.

    ``forward(feats)``: feats (..., P, 12) -> (...) the log-odds that the
    scenario's initial QP trajectory is collision-FREE (label 1: skip the
    SCP iterations).  ``generator`` draws the initial weights (flax's
    LeCun normal kernels, zero biases); None draws from a fresh
    ``torch.Generator`` seeded 0."""

    def __init__(self, hidden: Sequence[int] = (64, 64),
                 pool_temp: float = 4.0, n_features: int = N_PAIR_FEATURES,
                 generator: torch.Generator | None = None):
        super().__init__()
        widths = [n_features, *hidden]
        self.hidden = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(widths, widths[1:]))
        self.score = nn.Linear(widths[-1], 1)
        self.head = nn.Linear(1, 1)
        self.pool_temp = pool_temp
        gen = generator or torch.Generator().manual_seed(0)
        for layer in self.dense_layers():
            _lecun_normal_(layer.weight, gen)
            nn.init.zeros_(layer.bias)

    def dense_layers(self) -> list[nn.Linear]:
        """The layers in flax's order: Dense_0 .. Dense_{L+1}."""
        return [*self.hidden, self.score, self.head]

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = feats
        for layer in self.hidden:
            x = nn.functional.silu(layer(x))
        s = self.score(x)[..., 0]                 # per-pair safety score
        # smooth-min over pairs: one risky pair makes the scenario risky
        pooled = -(1.0 / self.pool_temp) * torch.logsumexp(
            -self.pool_temp * s, dim=-1)
        return self.head(pooled[..., None])[..., 0]


def make_train_state(key, n_vehicles: int, hidden=(64, 64),
                     learning_rate: float = 3e-3, *, dtype=torch.float32,
                     device=None):
    """(net, optimizer) for training: a :class:`CollisionNet` initialised
    from ``key`` (an int seed or a ``torch.Generator``) on ``device`` (None:
    the card) in ``dtype``, and ``torch.optim.AdamW`` at optax.adamw's
    defaults: betas (0.9, 0.999), eps 1e-8 outside the square root, weight
    decay 1e-4 on every parameter, biases included.  The JAX function's
    params and opt_state are the module and the optimizer here.
    ``n_vehicles`` is not needed to build the net (the pair axis is
    pooled); it is kept for the JAX signature."""
    from ..utils.config import resolve_device
    gen = (key if isinstance(key, torch.Generator)
           else torch.Generator().manual_seed(int(key)))
    net = CollisionNet(hidden=tuple(hidden), generator=gen).to(
        dtype=dtype, device=resolve_device(device))
    opt = torch.optim.AdamW(net.parameters(), lr=learning_rate,
                            betas=ADAMW_BETAS, eps=ADAMW_EPS,
                            weight_decay=ADAMW_WEIGHT_DECAY)
    return net, opt


def predict_logits(net: CollisionNet, p0_batch, pf_batch) -> torch.Tensor:
    """(B, N, 2) boundary positions -> (B,) feasibility log-odds."""
    with torch.no_grad():
        return net(pair_features(p0_batch, pf_batch))


def make_train_step(net: CollisionNet, opt: torch.optim.Optimizer):
    """One optimisation step on a labelled scenario batch:
    ``train_step(p0, pf, labels) -> (loss, acc)``, 0-d tensors, updating
    ``net`` and ``opt`` in place.  The loss is the mean of optax's
    ``sigmoid_binary_cross_entropy``; acc counts (logits > 0) ==
    (labels > 0.5)."""

    def train_step(p0, pf, labels):
        logits = net(pair_features(p0, pf))
        loss = nn.functional.binary_cross_entropy_with_logits(logits, labels)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        acc = ((logits.detach() > 0) == (labels > 0.5)).to(logits.dtype)
        return loss.detach(), acc.mean()

    return train_step


def flax_key(layer: int, leaf: str) -> str:
    """The npz key of a flax Dense leaf: ``jax.tree_util.keystr`` of its
    path in ``{'params': {'Dense_<layer>': {'kernel', 'bias'}}}``."""
    return f"['params']['Dense_{layer}']['{leaf}']"


def save_params(path: str, net: CollisionNet) -> None:
    """Write the net as the JAX package's flat npz: flax keys, kernels
    stored (in, out)."""
    arrays = {}
    for i, layer in enumerate(net.dense_layers()):
        arrays[flax_key(i, "kernel")] = layer.weight.detach().cpu().numpy().T
        arrays[flax_key(i, "bias")] = layer.bias.detach().cpu().numpy()
    np.savez(path, **arrays)


def load_params(path: str, template: CollisionNet | None = None,
                device=None) -> CollisionNet:
    """Load an npz written by either package's ``save_params`` into
    ``template`` (returned), or into a new float32 :class:`CollisionNet`
    on ``device`` (None: the card) whose hidden widths are read from the
    file."""
    from ..utils.config import resolve_device
    from ..utils.convert import collision_net_from_jax
    with np.load(path) as data:
        state = collision_net_from_jax(dict(data))
    if template is None:
        n_hidden = sum(1 for k in state if k.startswith("hidden.")) // 2
        hidden = [state[f"hidden.{i}.weight"].shape[0]
                  for i in range(n_hidden)]
        template = CollisionNet(hidden=hidden).to(
            device=resolve_device(device))
    ref = next(template.parameters())
    template.load_state_dict({k: v.to(dtype=ref.dtype, device=ref.device)
                              for k, v in state.items()})
    return template
