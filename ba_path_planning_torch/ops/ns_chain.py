"""X-form factorization with the Newton-Schulz chain kernel: the CUDA kernel
``csrc/ns_chain.cu``, its launcher, and its plain PyTorch version
(counterpart of ``ba_path_planning_tpu/ops/pallas/ns_chain.py``).

:func:`factorize_X_chain_batched` equals
``banded.factorize_X(D, C, ns_iters=j, ns_anchor=0)``.  On the card the
exact anchors at k = 0, 1, 2 and K-1 run in PyTorch (Cholesky inverses) and
the interior k = 3..K-2 runs in the kernel, which keeps its matrices in
shared memory up to N = 28 and in a per-scenario global scratch beyond.
"""

from __future__ import annotations

import torch

from ..solvers.banded import _spd_inv, bxbt, factorize_X
from .cuda_build import check, load_kernels, require_f32_cuda


def factorize_X_chain_plain(D, C, *, ns_iters: int):
    """Plain version of the kernel route: ``banded.factorize_X``."""
    return factorize_X(D, C, ns_iters=ns_iters)


def factorize_X_chain_batched(D, C, *, ns_iters: int):
    """Batched ``factorize_X(..., ns_anchor=0)``.  D (B, K, n, n),
    C (K-1, 3, 3) batch-shared; returns X (B, K, n, n).  CUDA tensors launch
    the kernel for the interior (float32, contiguous, K >= 6; anything else
    raises); CPU tensors run the plain version."""
    if not D.is_cuda:
        if D.device.type != "cpu":
            raise ValueError(
                f"factorize_X_chain_batched: unsupported device {D.device}")
        return factorize_X_chain_plain(D, C, ns_iters=ns_iters)
    require_f32_cuda("factorize_X_chain_batched", D=D, C=C)
    if D.dim() != 4 or D.shape[-1] != D.shape[-2]:
        raise ValueError(
            f"factorize_X_chain_batched: D {tuple(D.shape)} is not (B, K, n, n)")
    B, K, n, _ = D.shape
    if K < 6 or C.shape != (K - 1, 3, 3) or n % 3 or ns_iters < 1:
        raise ValueError(
            f"factorize_X_chain_batched: unsupported shapes D "
            f"{tuple(D.shape)}, C {tuple(C.shape)}, ns_iters {ns_iters} "
            "(the chain split needs K >= 6: anchors 0..2 and K-1)")

    def exact(Xprev, Dk, Ck):
        return _spd_inv(Dk - bxbt(Ck, Xprev))

    X = torch.empty_like(D)
    X[:, 0] = _spd_inv(D[:, 0])
    X[:, 1] = exact(X[:, 0], D[:, 1], C[0])
    X[:, 2] = exact(X[:, 1], D[:, 2], C[1])
    lib = load_kernels()
    scratch = torch.empty((B, lib.ns_chain_scratch_floats(n)), dtype=D.dtype,
                          device=D.device)
    with torch.cuda.device(D.device):
        err = lib.ns_chain_interior_f32(
            D.data_ptr(), C.data_ptr(), X.data_ptr(), scratch.data_ptr(), B,
            K, n, 3, K - 1, ns_iters,
            torch.cuda.current_stream(D.device).cuda_stream)
    check(err, "factorize_X_chain_batched")
    factorize_X_chain_batched.launches += 1
    X[:, K - 1] = exact(X[:, K - 2], D[:, K - 1], C[K - 2])
    return X


factorize_X_chain_batched.launches = 0
