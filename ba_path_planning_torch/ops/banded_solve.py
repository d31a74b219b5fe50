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

from ..solvers.banded import solve_factorized
from .group_solve import _launch_sweep


def solve_factorized_dense_plain(Linv, Eb, b):
    """Plain version of the kernel: ``banded.solve_factorized`` (bf16
    factors are widened to b's dtype block by block)."""
    return solve_factorized(Linv, Eb, b)


def solve_factorized_dense(Linv, Eb, b):
    """Solve M x = b for a batch: Linv (B, K, n, n) inverted diagonal
    factors, Eb (B, K-1, n, n) off-diagonal factors, b (B, K, n) ->
    x (B, K, n).  CUDA tensors launch the kernel on
    ``group_solve.sweep_plan`` (float32 and contiguous, or both factors
    bf16 as ``banded.compress_factors`` lays them out; n even up to 1536;
    Linv is read as lower triangular; anything else raises); CPU tensors
    run the plain version."""
    if not b.is_cuda:
        if b.device.type != "cpu":
            raise ValueError(
                f"solve_factorized_dense: unsupported device {b.device}")
        return solve_factorized_dense_plain(Linv, Eb, b)
    x = _launch_sweep("solve_factorized_dense", "banded_solve", Linv, Eb, b,
                      "dense", bf16_ok=("F", "G"))
    solve_factorized_dense.launches += 1
    return x


solve_factorized_dense.launches = 0
