"""X-form factorization with the Newton-Schulz chain kernel: the CUDA kernel
``csrc/ns_chain.cu``, its launcher, and its plain PyTorch version
(counterpart of ``ba_path_planning_tpu/ops/pallas/ns_chain.py``).

:func:`factorize_X_chain_batched` equals
``banded.factorize_X(D, C, ns_iters=j, ns_anchor=0)``.  On the card the
exact anchors at k = 0, 1, 2 and K-1 run in PyTorch (Cholesky inverses) and
the interior k = 3..K-2 runs in the kernel.  ``ns_precision`` is the solver
option of that name: ``"high"`` (the production solver's) takes the products
on the tensor cores as three TF32 passes over a hi + lo split of each FP32
operand, ``"highest"`` takes them as FP32 FMAs in the same tiling (the
exact-FP32 witness of the checks; no production path runs it).  Either keeps
its matrices in shared memory while they fit and in a per-scenario global
scratch beyond.
"""

from __future__ import annotations

import torch

from ..solvers.banded import _spd_inv, bxbt, factorize_X
from ..utils import debug
from .cuda_build import check, load_kernels, require_f32_cuda


def factorize_X_chain_plain(D, C, *, ns_iters: int):
    """Plain version of the kernel route: ``banded.factorize_X``."""
    return factorize_X(D, C, ns_iters=ns_iters)


# ns_precision -> the kernel's precision argument.  "default" (one TF32
# pass) is not offered: it leaves the chain outside its tolerance.
PRECISIONS = {"highest": 0, "high": 1}


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


def chain_interior(D, C, X, *, ns_iters: int, ns_precision: str):
    """Launch the kernel: the interior steps k = 3..K-2 of X, in place, from
    the warm start X[:, 2].  Arguments as checked by
    :func:`factorize_X_chain_batched`."""
    B, K, n, _ = D.shape
    lib = load_kernels()
    scratch = torch.empty((B, lib.ns_chain_scratch_floats(n)),
                          dtype=D.dtype, device=D.device)
    with torch.cuda.device(D.device):
        err = lib.ns_chain_interior_f32(
            D.data_ptr(), C.data_ptr(), X.data_ptr(), scratch.data_ptr(), B,
            K, n, 3, K - 1, ns_iters, PRECISIONS[ns_precision],
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
    run the plain version, whatever ``ns_precision`` says."""
    if ns_precision not in PRECISIONS and ns_precision != "default":
        raise ValueError(
            f"factorize_X_chain_batched: unknown ns_precision {ns_precision!r}")
    if not D.is_cuda:
        if D.device.type != "cpu":
            raise ValueError(
                f"factorize_X_chain_batched: unsupported device {D.device}")
        return factorize_X_chain_plain(D, C, ns_iters=ns_iters)
    if ns_precision == "default":
        raise NotImplementedError(
            "factorize_X_chain_batched: ns_precision='default' (a single "
            "TF32 pass) is not implemented; use 'high' or 'highest'")
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
    X = chain_interior(D, C, anchor_head(D, C), ns_iters=ns_iters,
                       ns_precision=ns_precision)
    return anchor_tail(X, D, C)


factorize_X_chain_batched.launches = 0
