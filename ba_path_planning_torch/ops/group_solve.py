"""Sweep solves of one ADMM x-update (counterpart of
``ba_path_planning_tpu/ops/pallas/group_solve.py``): on X-form factors the
CUDA kernel ``csrc/group_solve_x.cu``, on L-only factors
``csrc/group_solve_l.cu``, each with its launcher and its plain PyTorch
version; on dense (Linv, Eb) factors the kernel of ``ops/banded_solve.py``.

The three kernels are one template (``csrc/group_sweep.cuh``) that streams
the factors through a ring of shared-memory stages; :func:`sweep_plan`
chooses how a batch runs.  Float32 factors are not padded: the TPU kernels'
128-lane pad was a rule of their DMA engine.  bf16 factors
(``SolverConfig.factor_dtype="bf16"``, ``banded.compress_factors``) lie on
rows of :func:`cuda_build.bf16_row_stride` elements, 16 bytes aligned for
the ring's bulk copies, and the kernels widen them to FP32 as they read
them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..solvers.banded import solve_factorized_L, solve_factorized_X
from ..utils import debug
from .cuda_build import (bf16_row_stride, check, load_kernels,
                         require_f32_cuda)


# The H100's shared memory: what one block may take, and what an SM holds
# (each resident block also takes 1 KB of it).
SMEM_BLOCK_MAX = 232448
SMEM_SM = 233472
SWEEP_FORMS = ("X", "L", "dense")
# n up to which the L and dense forms keep column sums in registers
# (N <= 256; the most the dense form serves), and the most the X form
# (no column sums) and the L form (beyond, column sums in shared memory)
# serve
SWEEP_MAX_N = 1536
SWEEP_MAX_N_WIDE = 6144
SWEEP_WARPS = 8                # consumer warps of a block
SWEEP_MAX_BAND = 4 * SWEEP_WARPS   # a warp takes at most 4 rows of a band
SWEEP_MAX_STAGES = 8
SWEEP_WANT_STAGES = 4          # bands shrink until this many stages fit
SWEEP_BARRIER_BYTES = 2 * SWEEP_MAX_STAGES * 8 + 2 * 8
SWEEP_CLUSTER_B = 64           # batches up to this size run in clusters
SMS = 132                      # streaming multiprocessors of the H100


class SweepPlan(NamedTuple):
    """How the sweep kernels run a batch: ``cluster`` blocks a scenario,
    each streaming its rows of every factor block in bands of
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


def sweep_part_rows(form: str, n: int) -> int:
    """Rows of n floats of partial sums a form keeps at n (the kernel's
    ``part_rows``): the warps' column sums of the L and dense forms, or the
    block's one row of them in the L form above SWEEP_MAX_N."""
    if form == "X":
        return 0
    return 1 if n > SWEEP_MAX_N else SWEEP_WARPS


def sweep_row_bytes(n: int, esize: int = 4) -> int:
    """Bytes a factor row takes in global memory and in the ring: n floats,
    or n bf16 elements on the stride :func:`cuda_build.bf16_row_stride`."""
    return 4 * n if esize == 4 else 2 * bf16_row_stride(n)


def sweep_smem_bytes(n: int, cluster: int, band_rows: int, stages: int,
                     part: int, row_bytes: int | None = None) -> int:
    """Dynamic shared memory of a block (the kernel's ``smem_bytes``): the
    barriers, the ring (rows of ``row_bytes``, default float32 rows of n),
    the right-hand side and w_k, the two halves of the cluster's exchange
    buffer and ``part`` rows of partial sums."""
    if row_bytes is None:
        row_bytes = 4 * n
    return (SWEEP_BARRIER_BYTES + stages * band_rows * row_bytes
            + 4 * n * (2 + 2 * cluster + part))


def _sweep_ring(B: int, n: int, cluster: int, part: int, row_bytes: int):
    """(share, band_rows, stages, per_sm) of a cluster size: the largest
    bands that leave SWEEP_WANT_STAGES stages beside as many blocks an SM as
    B needs, or, where not even two stages fit, fewer blocks an SM."""
    share = max(sweep_rows(c + 1, cluster, n) - sweep_rows(c, cluster, n)
                for c in range(cluster))
    per_sm = 2 if cluster > 1 else min(4, -(-B // SMS))
    while True:
        room = (SMEM_SM // per_sm - 1024) - sweep_smem_bytes(n, cluster, 0, 0,
                                                             part)
        for n_bands in range(-(-share // SWEEP_MAX_BAND), share // 2 + 1):
            band_rows = 2 * -(-share // (2 * n_bands))
            stages = min(SWEEP_MAX_STAGES, room // (row_bytes * band_rows))
            if stages >= SWEEP_WANT_STAGES:
                break
        if stages >= 2 or per_sm == 1:
            return share, band_rows, stages, per_sm
        per_sm -= 1


def sweep_plan(B: int, K: int, n: int, form: str,
               esize: int = 4) -> SweepPlan:
    """The launch plan of the sweep kernel of ``form`` ("X", "L" or
    "dense") for B scenarios of K blocks of n x n, stored as float32
    (``esize`` 4) or as bf16 on padded rows (``esize`` 2: a stage holds
    about twice the rows).

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
    bands of the whole chain (2K - 1 blocks; dense: 4K - 3, its two blocks
    a step of k).  Where n is so large that not even a ring of two stages
    fits beside the vectors of as many blocks, fewer blocks share an SM,
    and then a cluster has fewer blocks (the widest blocks run one block a
    scenario).  Raises ValueError for what the kernels do not serve
    (K < 2; X and L: n not a multiple of 6 or above 6144; dense: n odd or
    above 1536)."""
    if form not in SWEEP_FORMS:
        raise ValueError(f"sweep kernels: unknown form {form!r}")
    unit = 2 if form == "dense" else 6
    max_n = SWEEP_MAX_N if form == "dense" else SWEEP_MAX_N_WIDE
    if B < 1 or K < 2 or n <= 0 or n % unit or n > max_n:
        raise ValueError(f"sweep kernels, {form} form: unsupported B={B}, "
                         f"K={K}, n={n} (n a multiple of {unit} up to "
                         f"{max_n}, K >= 2)")
    part = sweep_part_rows(form, n)
    row_bytes = sweep_row_bytes(n, esize)
    chain = 4 * K - 3 if form == "dense" else 2 * K - 1
    cluster = (4 if B <= SWEEP_CLUSTER_B // 2 else
               2 if B <= SWEEP_CLUSTER_B else 1)
    while True:
        share, band_rows, stages, per_sm = _sweep_ring(B, n, cluster, part,
                                                       row_bytes)
        if stages >= 2 or cluster == 1:
            break
        cluster //= 2
    stages = min(stages, -(-share // band_rows) * chain)
    if stages < 2:
        raise ValueError(f"sweep kernels: no ring of two stages fits n={n}")
    return SweepPlan(cluster, band_rows, stages,
                     sweep_smem_bytes(n, cluster, band_rows, stages, part,
                                      row_bytes), per_sm)


def solve_factorized_grouped_X_plain(X, C, b):
    """Plain version of the kernel: ``banded.solve_factorized_X`` (bf16
    factors are widened to b's dtype block by block)."""
    return solve_factorized_X(X, C, b)


def _launch_sweep(what: str, entry: str, F, G, b, form: str,
                  bf16_ok=("F",)):
    """Check the operands of a sweep kernel, launch ``entry`` (its ``_f32``
    or, for bf16 factors, ``_bf16`` variant) on :func:`sweep_plan` and
    return x.  F (B, K, n, n) the factor blocks, G the slot scalars
    (K-1, 3, 3) (X, L) or the second factor (B, K-1, n, n) (dense)."""
    require_f32_cuda(what, bf16_ok=bf16_ok, F=F, G=G, b=b)
    if b.dim() != 3:
        raise ValueError(f"{what}: b {tuple(b.shape)} is not (B, K, n)")
    B, K, n = b.shape
    second = (B, K - 1, n, n) if form == "dense" else (K - 1, 3, 3)
    if K < 2 or F.shape != (B, K, n, n) or G.shape != second:
        raise ValueError(
            f"{what}: unsupported shapes {tuple(F.shape)}, "
            f"{tuple(G.shape)}, b {tuple(b.shape)}")
    bf16 = F.dtype == torch.bfloat16
    plan = sweep_plan(B, K, n, form, esize=F.element_size())
    x = torch.empty_like(b)
    lib = load_kernels()
    with torch.cuda.device(b.device):
        err = getattr(lib, entry + ("_bf16" if bf16 else "_f32"))(
            F.data_ptr(), G.data_ptr(), b.data_ptr(), x.data_ptr(), B, K, n,
            *((F.stride(-2),) if bf16 else ()), plan.cluster,
            plan.band_rows, plan.stages,
            torch.cuda.current_stream(b.device).cuda_stream)
    check(err, what)
    debug.report(entry, x)
    return x


def solve_factorized_grouped_X(X, C, b):
    """Solve M x = b for a batch: X (B, K, n, n) symmetric block inverses,
    C (K-1, 3, 3) shared upper-triangular slot scalars, b (B, K, n) ->
    x (B, K, n).  CUDA tensors launch the kernel on :func:`sweep_plan`
    (float32 and contiguous, X also bf16 as ``banded.compress_factors``
    lays it out; n a multiple of 6 up to 6144; anything else raises); CPU
    tensors run the plain version."""
    if not b.is_cuda:
        if b.device.type != "cpu":
            raise ValueError(
                f"solve_factorized_grouped_X: unsupported device {b.device}")
        return solve_factorized_grouped_X_plain(X, C, b)
    x = _launch_sweep("solve_factorized_grouped_X", "group_solve_x", X, C, b,
                      "X")
    solve_factorized_grouped_X.launches += 1
    return x


solve_factorized_grouped_X.launches = 0


def solve_factorized_grouped_L_plain(Linv, C, b):
    """Plain version of the kernel: ``banded.solve_factorized_L`` (bf16
    factors are widened to b's dtype block by block)."""
    return solve_factorized_L(Linv, C, b)


def solve_factorized_grouped_L(Linv, C, b):
    """Solve M x = b for a batch from the L-only factors: Linv (B, K, n, n)
    inverted diagonal factors, C (K-1, 3, 3) shared upper-triangular slot
    scalars, b (B, K, n) -> x (B, K, n).  CUDA tensors launch the kernel on
    :func:`sweep_plan` (float32 and contiguous, Linv also bf16 as
    ``banded.compress_factors`` lays it out; n a multiple of 6 up to 6144;
    Linv is read as lower triangular; anything else raises); CPU tensors
    run the plain version."""
    if not b.is_cuda:
        if b.device.type != "cpu":
            raise ValueError(
                f"solve_factorized_grouped_L: unsupported device {b.device}")
        return solve_factorized_grouped_L_plain(Linv, C, b)
    x = _launch_sweep("solve_factorized_grouped_L", "group_solve_l", Linv, C,
                      b, "L")
    solve_factorized_grouped_L.launches += 1
    return x


solve_factorized_grouped_L.launches = 0


def solve_factorized_grouped(Linv, Eb, b):
    """The dense (Linv, Eb) sweeps for a batch, what the JAX package's
    grouped streaming kernel ``_group_kernel`` computes:
    :func:`banded_solve.solve_factorized_dense`, whose kernel and launch
    count it shares."""
    from .banded_solve import solve_factorized_dense
    return solve_factorized_dense(Linv, Eb, b)
