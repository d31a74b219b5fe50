"""Dense (Linv, Eb) sweep solve of one ADMM x-update: the CUDA kernel
``csrc/banded_solve.cu``, its launcher, and its plain PyTorch version
(counterpart of ``ba_path_planning_tpu/ops/pallas/banded_solve.py``).

The JAX package has three Pallas bodies for this one function, which differ
in their VMEM tiling only: ``_solve_kernel`` (a scenario per program, factors
resident), ``_solve_kernel_nb`` (the same, unbatched under ``vmap``; the
router's resident route) and ``group_solve._group_kernel`` (G scenarios per
program, factors streamed).  Here a grid of blocks runs the scenarios side
by side, so one kernel stands for all three: the dense form of the sweep
template ``csrc/group_sweep.cuh``, launched on ``group_solve.sweep_plan``.
"""

from __future__ import annotations

import torch

from ..solvers.banded import solve_factorized
from .cuda_build import check, load_kernels, require_f32_cuda
from .group_solve import sweep_plan


def solve_factorized_dense_plain(Linv, Eb, b):
    """Plain version of the kernel: ``banded.solve_factorized``."""
    return solve_factorized(Linv, Eb, b)


def solve_factorized_dense(Linv, Eb, b):
    """Solve M x = b for a batch: Linv (B, K, n, n) inverted diagonal
    factors, Eb (B, K-1, n, n) off-diagonal factors, b (B, K, n) ->
    x (B, K, n).  CUDA tensors launch the kernel on
    ``group_solve.sweep_plan`` (float32, contiguous, n even up to 1536;
    Linv is read as lower triangular; anything else raises); CPU tensors
    run the plain version."""
    if not b.is_cuda:
        if b.device.type != "cpu":
            raise ValueError(
                f"solve_factorized_dense: unsupported device {b.device}")
        return solve_factorized_dense_plain(Linv, Eb, b)
    require_f32_cuda("solve_factorized_dense", Linv=Linv, Eb=Eb, b=b)
    if b.dim() != 3:
        raise ValueError(
            f"solve_factorized_dense: b {tuple(b.shape)} is not (B, K, n)")
    B, K, n = b.shape
    if K < 2 or Linv.shape != (B, K, n, n) or Eb.shape != (B, K - 1, n, n):
        raise ValueError(
            f"solve_factorized_dense: unsupported shapes Linv "
            f"{tuple(Linv.shape)}, Eb {tuple(Eb.shape)}, b {tuple(b.shape)}")
    plan = sweep_plan(B, K, n, "dense")
    x = torch.empty_like(b)
    lib = load_kernels()
    with torch.cuda.device(b.device):
        err = lib.banded_solve_f32(
            Linv.data_ptr(), Eb.data_ptr(), b.data_ptr(), x.data_ptr(), B, K,
            n, plan.cluster, plan.band_rows, plan.stages,
            torch.cuda.current_stream(b.device).cuda_stream)
    check(err, "solve_factorized_dense")
    solve_factorized_dense.launches += 1
    return x


solve_factorized_dense.launches = 0
