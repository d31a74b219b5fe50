"""X-form sweep solve of one ADMM x-update: the CUDA kernel
``csrc/group_solve_x.cu``, its launcher, and its plain PyTorch version
(counterpart of ``solve_factorized_grouped_X`` in
``ba_path_planning_tpu/ops/pallas/group_solve.py``).

The factors are not padded: the TPU kernel's 128-lane pad was a rule of its
DMA engine.
"""

from __future__ import annotations

import torch

from ..solvers.banded import solve_factorized_X
from .cuda_build import check, load_kernels, require_f32_cuda


def solve_factorized_grouped_X_plain(X, C, b):
    """Plain version of the kernel: ``banded.solve_factorized_X``."""
    return solve_factorized_X(X, C, b)


def solve_factorized_grouped_X(X, C, b):
    """Solve M x = b for a batch: X (B, K, n, n) symmetric block inverses,
    C (K-1, 3, 3) shared upper-triangular slot scalars, b (B, K, n) ->
    x (B, K, n).  CUDA tensors launch the kernel (float32, contiguous;
    anything else raises); CPU tensors run the plain version."""
    if not b.is_cuda:
        if b.device.type != "cpu":
            raise ValueError(
                f"solve_factorized_grouped_X: unsupported device {b.device}")
        return solve_factorized_grouped_X_plain(X, C, b)
    require_f32_cuda("solve_factorized_grouped_X", X=X, C=C, b=b)
    B, K, n = b.shape
    if X.shape != (B, K, n, n) or C.shape != (K - 1, 3, 3) or n % 3:
        raise ValueError(
            f"solve_factorized_grouped_X: unsupported shapes X "
            f"{tuple(X.shape)}, C {tuple(C.shape)}, b {tuple(b.shape)}")
    x = torch.empty_like(b)
    lib = load_kernels()
    with torch.cuda.device(b.device):
        err = lib.group_solve_x_f32(
            X.data_ptr(), C.data_ptr(), b.data_ptr(), x.data_ptr(), B, K, n,
            torch.cuda.current_stream(b.device).cuda_stream)
    check(err, "solve_factorized_grouped_X")
    solve_factorized_grouped_X.launches += 1
    return x


solve_factorized_grouped_X.launches = 0
