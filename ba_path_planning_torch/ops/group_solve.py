"""Sweep solves of one ADMM x-update (counterpart of
``ba_path_planning_tpu/ops/pallas/group_solve.py``): on X-form factors the
CUDA kernel ``csrc/group_solve_x.cu``, on L-only factors
``csrc/group_solve_l.cu``, each with its launcher and its plain PyTorch
version; on dense (Linv, Eb) factors the kernel of ``ops/banded_solve.py``.

The two kernels are one template (``csrc/group_sweep.cuh``) that streams
the factors through a ring of shared-memory stages; :func:`sweep_plan`
chooses how a batch runs.  The factors are not padded: the TPU kernels'
128-lane pad was a rule of their DMA engine.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..solvers.banded import solve_factorized_L, solve_factorized_X
from .banded_solve import solve_factorized_dense
from .cuda_build import check, load_kernels, require_f32_cuda


# The H100's shared memory: what one block may take, and what an SM holds
# (each resident block also takes 1 KB of it).
SMEM_BLOCK_MAX = 232448
SMEM_SM = 233472
SWEEP_MAX_N = 1536             # n = 6N the kernels serve (N <= 256)
SWEEP_WARPS = 8                # consumer warps of a block
SWEEP_MAX_BAND = 4 * SWEEP_WARPS   # a warp takes at most 4 rows of a band
SWEEP_MAX_STAGES = 8
SWEEP_WANT_STAGES = 4          # bands shrink until this many stages fit
SWEEP_BARRIER_BYTES = 2 * SWEEP_MAX_STAGES * 8 + 2 * 8
SWEEP_CLUSTER_B = 64           # batches up to this size run in clusters
SMS = 132                      # streaming multiprocessors of the H100


class SweepPlan(NamedTuple):
    """How the grouped sweep kernels run a batch: ``cluster`` blocks a
    scenario, each streaming its rows of every factor block in bands of
    ``band_rows`` rows through a ring of ``stages`` shared-memory stages;
    ``smem_bytes`` of dynamic shared memory a block, sized so that
    ``per_sm`` blocks share an SM."""
    cluster: int
    band_rows: int
    stages: int
    smem_bytes: int
    per_sm: int


def sweep_rows(rank: int, cluster: int, n: int) -> int:
    """First row of cluster rank ``rank``'s share of the n rows (the
    kernel's ``row_lo``): whole row pairs, so every bound is even and every
    band a multiple of 16 bytes."""
    return 2 * (rank * (n // 2) // cluster)


def sweep_smem_bytes(n: int, cluster: int, band_rows: int,
                     stages: int) -> int:
    """Dynamic shared memory of a block (the kernel's ``smem_bytes``): the
    barriers, the ring, the right-hand side and w_k, the two halves of the
    cluster's exchange buffer and the warps' column partial sums."""
    return SWEEP_BARRIER_BYTES + 4 * n * (stages * band_rows + 2
                                          + 2 * cluster + SWEEP_WARPS)


def sweep_plan(B: int, K: int, n: int) -> SweepPlan:
    """The launch plan of both grouped sweep kernels for B scenarios of K
    blocks of n x n.

    * B > 64 (the production chunk of 512, the compaction's later chunks):
      one block per scenario, its shared memory sized so that as many
      blocks share an SM as B needs to run in one wave on 132 SMs, up to
      four (528 blocks hold the chunk of 512); a block alone on its SM
      takes a ring four times as deep.
    * B <= 64 (the reference-compatible path's 64, the ``SCP`` class's 1):
      a cluster of 2 blocks per scenario, 4 up to B = 32, each streaming its
      share of the rows, so that a scenario's stream is spread over as many
      SMs; two clusters may share an SM.
    Bands are an even number of rows, at most 4 a consumer warp, and shrink
    until SWEEP_WANT_STAGES stages fit; the ring is no deeper than the
    bands of the whole chain.  Where n is so large that not even a ring of
    two stages fits beside the vectors of as many blocks, fewer blocks
    share an SM.  Raises ValueError for what the
    kernels do not serve (n not a multiple of 6, n > 1536, K < 2)."""
    if B < 1 or K < 2 or n <= 0 or n % 6 or n > SWEEP_MAX_N:
        raise ValueError(f"sweep kernels: unsupported B={B}, K={K}, n={n} "
                         f"(n a multiple of 6 up to {SWEEP_MAX_N}, K >= 2)")
    cluster = (4 if B <= SWEEP_CLUSTER_B // 2 else
               2 if B <= SWEEP_CLUSTER_B else 1)
    share = max(sweep_rows(c + 1, cluster, n) - sweep_rows(c, cluster, n)
                for c in range(cluster))
    per_sm = 2 if cluster > 1 else min(4, -(-B // SMS))
    while True:
        room = (SMEM_SM // per_sm - 1024) - sweep_smem_bytes(n, cluster, 0, 0)
        for n_bands in range(-(-share // SWEEP_MAX_BAND), share // 2 + 1):
            band_rows = 2 * -(-share // (2 * n_bands))
            stages = min(SWEEP_MAX_STAGES, room // (4 * n * band_rows))
            if stages >= SWEEP_WANT_STAGES:
                break
        if stages >= 2 or per_sm == 1:
            break
        per_sm -= 1
    stages = min(stages, -(-share // band_rows) * (2 * K - 1))
    if stages < 2:
        raise ValueError(f"sweep kernels: no ring of two stages fits n={n}")
    return SweepPlan(cluster, band_rows, stages,
                     sweep_smem_bytes(n, cluster, band_rows, stages), per_sm)


def solve_factorized_grouped_X_plain(X, C, b):
    """Plain version of the kernel: ``banded.solve_factorized_X``."""
    return solve_factorized_X(X, C, b)


def solve_factorized_grouped_X(X, C, b):
    """Solve M x = b for a batch: X (B, K, n, n) symmetric block inverses,
    C (K-1, 3, 3) shared upper-triangular slot scalars, b (B, K, n) ->
    x (B, K, n).  CUDA tensors launch the kernel on :func:`sweep_plan`
    (float32, contiguous, n a multiple of 6 up to 1536; anything else
    raises); CPU tensors run the plain version."""
    if not b.is_cuda:
        if b.device.type != "cpu":
            raise ValueError(
                f"solve_factorized_grouped_X: unsupported device {b.device}")
        return solve_factorized_grouped_X_plain(X, C, b)
    require_f32_cuda("solve_factorized_grouped_X", X=X, C=C, b=b)
    if b.dim() != 3:
        raise ValueError(
            f"solve_factorized_grouped_X: b {tuple(b.shape)} is not (B, K, n)")
    B, K, n = b.shape
    if X.shape != (B, K, n, n) or C.shape != (K - 1, 3, 3):
        raise ValueError(
            f"solve_factorized_grouped_X: unsupported shapes X "
            f"{tuple(X.shape)}, C {tuple(C.shape)}, b {tuple(b.shape)}")
    plan = sweep_plan(B, K, n)
    x = torch.empty_like(b)
    lib = load_kernels()
    with torch.cuda.device(b.device):
        err = lib.group_solve_x_f32(
            X.data_ptr(), C.data_ptr(), b.data_ptr(), x.data_ptr(), B, K, n,
            plan.cluster, plan.band_rows, plan.stages,
            torch.cuda.current_stream(b.device).cuda_stream)
    check(err, "solve_factorized_grouped_X")
    solve_factorized_grouped_X.launches += 1
    return x


solve_factorized_grouped_X.launches = 0


def solve_factorized_grouped_L_plain(Linv, C, b):
    """Plain version of the kernel: ``banded.solve_factorized_L``."""
    return solve_factorized_L(Linv, C, b)


def solve_factorized_grouped_L(Linv, C, b):
    """Solve M x = b for a batch from the L-only factors: Linv (B, K, n, n)
    inverted diagonal factors, C (K-1, 3, 3) shared upper-triangular slot
    scalars, b (B, K, n) -> x (B, K, n).  CUDA tensors launch the kernel on
    :func:`sweep_plan` (float32, contiguous, n a multiple of 6 up to 1536;
    Linv is read as lower triangular; anything else raises); CPU tensors
    run the plain version."""
    if not b.is_cuda:
        if b.device.type != "cpu":
            raise ValueError(
                f"solve_factorized_grouped_L: unsupported device {b.device}")
        return solve_factorized_grouped_L_plain(Linv, C, b)
    require_f32_cuda("solve_factorized_grouped_L", Linv=Linv, C=C, b=b)
    if b.dim() != 3:
        raise ValueError(
            f"solve_factorized_grouped_L: b {tuple(b.shape)} is not (B, K, n)")
    B, K, n = b.shape
    if Linv.shape != (B, K, n, n) or C.shape != (K - 1, 3, 3):
        raise ValueError(
            f"solve_factorized_grouped_L: unsupported shapes Linv "
            f"{tuple(Linv.shape)}, C {tuple(C.shape)}, b {tuple(b.shape)}")
    plan = sweep_plan(B, K, n)
    x = torch.empty_like(b)
    lib = load_kernels()
    with torch.cuda.device(b.device):
        err = lib.group_solve_l_f32(
            Linv.data_ptr(), C.data_ptr(), b.data_ptr(), x.data_ptr(), B, K,
            n, plan.cluster, plan.band_rows, plan.stages,
            torch.cuda.current_stream(b.device).cuda_stream)
    check(err, "solve_factorized_grouped_L")
    solve_factorized_grouped_L.launches += 1
    return x


solve_factorized_grouped_L.launches = 0


def solve_factorized_grouped(Linv, Eb, b):
    """The dense (Linv, Eb) sweeps for a batch, what the JAX package's
    grouped streaming kernel ``_group_kernel`` computes:
    :func:`banded_solve.solve_factorized_dense`, whose kernel and launch
    count it shares."""
    return solve_factorized_dense(Linv, Eb, b)
