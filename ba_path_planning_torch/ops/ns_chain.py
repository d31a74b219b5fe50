"""X-form factorization with the Newton-Schulz chain kernel: the CUDA kernel
``csrc/ns_chain.cu``, its launcher, and its plain PyTorch version
(counterpart of ``ba_path_planning_tpu/ops/pallas/ns_chain.py``).

:func:`factorize_X_chain_batched` equals
``banded.factorize_X(D, C, ns_iters=j, ns_anchor=0)``.  On the card the
exact anchors at k = 0, 1, 2 and K-1 run in PyTorch (Cholesky inverses,
the span ``qp.anchors``) and the interior k = 3..K-2 runs in the kernel
(the span ``qp.ns_chain``, which on the CPU covers the whole plain chain).
``ns_precision`` is the solver option of that name: ``"high"`` (the
production solver's) takes the products on the tensor cores as three TF32
passes over a hi + lo split of each FP32 operand, ``"highest"`` takes them
as FP32 FMAs in the same tiling (the exact-FP32 witness of the checks; no
production path runs it).  The solver's third name, ``"default"``, runs
``"high"`` (``banded.NS_KERNEL_PRECISION``).
:func:`ns_chain_plan` picks the kernel's tier from (B, n): one block a
scenario for a batch that fills the card, which keeps its matrices in shared
memory while they fit and in a per-scenario global scratch beyond; or, for a
small batch, the wide tier, which spreads each step's products over the card
in output tiles of one block each.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..solvers.banded import _spd_inv, bxbt, factorize_X
from ..utils import debug
from ..utils.profiling import span
from .cuda_build import (SMS, check, device_sms, load_kernels,
                         require_f32_cuda)


def factorize_X_chain_plain(D, C, *, ns_iters: int):
    """Plain version of the kernel route: ``banded.factorize_X``."""
    return factorize_X(D, C, ns_iters=ns_iters)


# ns_precision -> the kernel's precision argument.
PRECISIONS = {"highest": 0, "high": 1}

# The tier switch (the kernel takes the tile it is given): the largest
# batch the wide tier takes, and the time of a wave of its output tiles of
# each size, in hundredths of a wave of tiles of 64 (measured at n = 2052
# on the H100)
NS_WIDE_MAX_B = 32
NS_WAVE_COST = {64: 100, 128: 286, 192: 602}
# the tiers: one block a scenario (0), the wide tier's output tiles
NS_TILES = (0,) + tuple(NS_WAVE_COST)


class NSChainPlan(NamedTuple):
    """The kernel's tier for a batch: ``tile`` 0 runs one block a scenario;
    64, 128 or 192 the wide tier, a block an output tile of ``tile`` x
    ``tile``, ``tiles`` blocks a scenario for T' = X S and ``upper_tiles``
    for the update on and above the diagonal."""
    tile: int
    tiles: int
    upper_tiles: int


def _tile_count(n: int, tile: int, upper: bool) -> int:
    """Output tiles of a product (the kernel's ``tile_count``): all, or
    those each row of which starts at its first row."""
    return sum(-(-(n - (r0 if upper else 0)) // tile)
               for r0 in range(0, n, tile))


def ns_wide_cost(B: int, n: int, tile: int, sms: int = SMS) -> int:
    """The time of a Newton-Schulz iteration on the wide tier: the waves of
    its two launches on ``sms`` SMs, B times a product's ``tile`` tiles,
    times the time of a wave (NS_WAVE_COST)."""
    r = -(-n // tile)
    waves = -(-B * r * r // sms) + -(-(B * r * (r + 1) // 2) // sms)
    return waves * NS_WAVE_COST[tile]


def ns_chain_plan(B: int, n: int, sms: int = SMS,
                  _tile: int | None = None) -> NSChainPlan:
    """The plan of the chain kernel for B scenarios of n x n blocks on a
    card of ``sms`` SMs (the launches give :func:`cuda_build.device_sms`):
    one block a scenario above NS_WIDE_MAX_B scenarios; up to it the wide
    tier, in the output tile of least :func:`ns_wide_cost` (the larger on
    a tie).  ``_tile`` names the tier instead (to time and check every
    tier at one shape)."""
    tile = _tile
    if tile is None:
        tile = 0
        if B <= NS_WIDE_MAX_B:
            tile = min(NS_WAVE_COST, key=lambda t: (
                ns_wide_cost(B, n, t, sms), -t))
    if tile not in NS_TILES:
        raise ValueError(f"ns_chain_plan: no tier of tile {tile}")
    if not tile:
        return NSChainPlan(0, 0, 0)
    return NSChainPlan(tile, _tile_count(n, tile, False),
                       _tile_count(n, tile, True))


def _exact(Xprev, Dk, Ck):
    return _spd_inv(Dk - bxbt(Ck, Xprev))


def anchor_head(D, C):
    """A new X (B, K, n, n) with the exact steps k = 0, 1, 2 filled in."""
    X = torch.empty_like(D)
    X[:, 0] = _spd_inv(D[:, 0])
    X[:, 1] = _exact(X[:, 0], D[:, 1], C[0])
    X[:, 2] = _exact(X[:, 1], D[:, 2], C[1])
    return X


def anchor_tail(X, D, C):
    """Fill the exact last step k = K-1 of X in place."""
    K = D.shape[1]
    X[:, K - 1] = _exact(X[:, K - 2], D[:, K - 1], C[K - 2])
    return X


def chain_interior(D, C, X, *, ns_iters: int, ns_precision: str,
                   _plan: NSChainPlan | None = None):
    """Launch the kernel on :func:`ns_chain_plan` for D's card (or on
    ``_plan``, to time and check another tier): the interior steps
    k = 3..K-2 of X, in place, from the warm start X[:, 2].  Arguments as
    checked by :func:`factorize_X_chain_batched`."""
    B, K, n, _ = D.shape
    plan = _plan
    if plan is None:
        plan = ns_chain_plan(B, n, device_sms(D.device))
    lib = load_kernels()
    scratch = torch.empty((B, lib.ns_chain_scratch_floats(n, plan.tile)),
                          dtype=D.dtype, device=D.device)
    with torch.cuda.device(D.device):
        err = lib.ns_chain_interior_f32(
            D.data_ptr(), C.data_ptr(), X.data_ptr(), scratch.data_ptr(), B,
            K, n, 3, K - 1, ns_iters, PRECISIONS[ns_precision], plan.tile,
            torch.cuda.current_stream(D.device).cuda_stream)
    check(err, "factorize_X_chain_batched")
    factorize_X_chain_batched.launches += 1
    debug.report("ns_chain", X)
    return X


def factorize_X_chain_batched(D, C, *, ns_iters: int,
                              ns_precision: str = "highest"):
    """Batched ``factorize_X(..., ns_anchor=0)``.  D (B, K, n, n),
    C (K-1, 3, 3) batch-shared; returns X (B, K, n, n).  CUDA tensors launch
    the kernel for the interior (float32, contiguous, K >= 6, n = 6N,
    ``ns_precision`` "high" or "highest"; anything else raises); CPU tensors
    run the plain version, in FP32 at either ``ns_precision``."""
    if ns_precision not in PRECISIONS:
        raise ValueError(
            f"factorize_X_chain_batched: unknown ns_precision {ns_precision!r}")
    if not D.is_cuda:
        if D.device.type != "cpu":
            raise ValueError(
                f"factorize_X_chain_batched: unsupported device {D.device}")
        with span("qp.ns_chain"):
            return factorize_X_chain_plain(D, C, ns_iters=ns_iters)
    require_f32_cuda("factorize_X_chain_batched", D=D, C=C)
    if D.dim() != 4 or D.shape[-1] != D.shape[-2]:
        raise ValueError(
            f"factorize_X_chain_batched: D {tuple(D.shape)} is not (B, K, n, n)")
    B, K, n, _ = D.shape
    if K < 6 or C.shape != (K - 1, 3, 3) or n % 6 or ns_iters < 1:
        raise ValueError(
            f"factorize_X_chain_batched: unsupported shapes D "
            f"{tuple(D.shape)}, C {tuple(C.shape)}, ns_iters {ns_iters} "
            "(the chain split needs K >= 6: anchors 0..2 and K-1)")
    with span("qp.anchors"):
        X = anchor_head(D, C)
    with span("qp.ns_chain"):
        X = chain_interior(D, C, X, ns_iters=ns_iters,
                           ns_precision=ns_precision)
    with span("qp.anchors"):
        return anchor_tail(X, D, C)


factorize_X_chain_batched.launches = 0
