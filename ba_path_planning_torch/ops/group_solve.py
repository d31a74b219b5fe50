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
from .cuda_build import (SMS, bf16_row_stride, check, device_sms,
                         load_kernels, require_f32_cuda)


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
SWEEP_NARROW_N = 512           # n of the narrow instantiation
SWEEP_WARPS = 8                # consumer warps of a block
SWEEP_MAX_BAND = 4 * SWEEP_WARPS   # a warp takes at most 4 rows of a band
# the L form above SWEEP_MAX_N: y of a band and each warp's sums of it
SWEEP_BAND_SUMS = SWEEP_MAX_BAND * (SWEEP_WARPS + 1)
SWEEP_MAX_STAGES = 8
SWEEP_WANT_STAGES = 4          # bands shrink until this many stages fit
SWEEP_BARRIER_BYTES = 2 * SWEEP_MAX_STAGES * 8 + 2 * 8
SWEEP_CLUSTER_B = 64           # batches up to this size run in clusters
# The wide tier of the X and L forms (``group_sweep.cuh``): the launch
# bounds' blocks an SM, the barriers before its ring, and the smallest n
# and largest batch each form takes it at (:func:`sweep_wide`)
SWEEP_WIDE_PER_SM = 2
SWEEP_WIDE_BARRIER_BYTES = 2 * SWEEP_MAX_STAGES * 8
SWEEP_WIDE_MIN_N = 360
SWEEP_WIDE_MAX_B = 32
# the L form's, by element size: (least n, largest B) pairs, the wide tier
# where one of them admits (n, B) (the crossover measured on the H100,
# ``scripts/torch_sweep_bench.py --tiers``, ``PERF.md``)
SWEEP_WIDE_L = {4: ((240, 2), (360, 32)), 2: ((600, 8), (1200, 32))}
# the L form takes two blocks an SM where their bands hold this many rows,
# or a block more than twice as many (:func:`sweep_wide_plan`)
SWEEP_WIDE_L_BAND = 8


class SweepPlan(NamedTuple):
    """How the sweep kernels run a batch: ``cluster`` blocks a scenario,
    each streaming its rows of every factor block in bands of
    ``band_rows`` rows through a ring of ``stages`` shared-memory stages;
    ``smem_bytes`` of dynamic shared memory a block, sized so that
    ``per_sm`` blocks share an SM.  On the wide tier ``spread`` blocks of
    one cooperative grid take a scenario (``cluster`` is then 1); 0 on the
    cluster tiers."""
    cluster: int
    band_rows: int
    stages: int
    smem_bytes: int
    per_sm: int
    spread: int = 0


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


def sweep_blocks_per_sm(form: str, n: int, esize: int = 4,
                        per_sm: int = 4) -> int:
    """Blocks an SM that the launch bounds of the instantiation serving n
    and a plan of ``per_sm`` blocks an SM leave registers for (the kernel's
    ``blocks_per_sm``): four in the narrow tier, two there for the L form
    on bf16 factors and for the dense form on bf16 factors at ``per_sm``
    <= 2, one in the wide tiers.  At the default ``per_sm`` it is the most
    that any plan may put on an SM."""
    if n > SWEEP_NARROW_N:
        return 1
    if esize == 2 and (form == "L" or (form == "dense" and per_sm <= 2)):
        return 2
    return 4


def sweep_row_bytes(n: int, esize: int = 4) -> int:
    """Bytes a factor row takes in global memory and in the ring: n floats,
    or n bf16 elements on the stride :func:`cuda_build.bf16_row_stride`."""
    return 4 * n if esize == 4 else 2 * bf16_row_stride(n)


def sweep_smem_bytes(n: int, cluster: int, band_rows: int, stages: int,
                     part: int, row_bytes: int | None = None) -> int:
    """Dynamic shared memory of a block (the kernel's ``smem_bytes``): the
    barriers, the ring (rows of ``row_bytes``, default float32 rows of n),
    the right-hand side and w_k, the two halves of the cluster's exchange
    buffer and ``part`` rows of partial sums; with one row (the L form above
    SWEEP_MAX_N) also y of a band and each warp's sums of it."""
    if row_bytes is None:
        row_bytes = 4 * n
    return (SWEEP_BARRIER_BYTES + stages * band_rows * row_bytes
            + 4 * (n * (2 + 2 * cluster + part)
                   + (SWEEP_BAND_SUMS if part == 1 else 0)))


def _sweep_ring(B: int, n: int, cluster: int, part: int, row_bytes: int,
                most: int, sms: int):
    """(share, band_rows, stages, per_sm) of a cluster size: the largest
    bands that leave SWEEP_WANT_STAGES stages beside as many blocks an SM as
    B needs on ``sms`` SMs, at most ``most``, or, where not even two stages
    fit, fewer blocks an SM."""
    share = max(sweep_rows(c + 1, cluster, n) - sweep_rows(c, cluster, n)
                for c in range(cluster))
    per_sm = min(most, 2 if cluster > 1 else -(-B // sms))
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


def sweep_wide_most(n: int, form: str, esize: int = 4) -> int:
    """The largest batch of n x n blocks of ``esize`` bytes an element that
    takes the wide tier of ``form`` (0: none): the X form's SWEEP_WIDE_MAX_B
    from n = SWEEP_WIDE_MIN_N, the L form's by SWEEP_WIDE_L."""
    if form == "X":
        return SWEEP_WIDE_MAX_B if n >= SWEEP_WIDE_MIN_N else 0
    if form == "L":
        return max([most for least, most in SWEEP_WIDE_L[esize]
                    if n >= least], default=0)
    return 0


def sweep_wide(B: int, n: int, form: str, sms: int = SMS,
               esize: int = 4) -> bool:
    """Whether B scenarios of n x n blocks (``esize`` bytes an element)
    take the wide tier on a card of ``sms`` SMs: up to
    :func:`sweep_wide_most` scenarios, and no more than the card has SMs
    (its grid is cooperative: a block a scenario at least, all
    resident)."""
    return B <= min(sweep_wide_most(n, form, esize), sms)


def sweep_wide_rows(n: int, spread: int) -> int:
    """The most rows any of ``spread`` blocks owns (the kernel's
    ``wide_rows``)."""
    return 2 * -(-(n // 2) // spread)


def sweep_wide_smem_bytes(n: int, rows: int, band_rows: int, stages: int,
                          row_bytes: int, form: str = "X") -> int:
    """Dynamic shared memory of a wide-tier block (the kernel's
    ``wide_smem_bytes``): the ring's barriers, the ring, r and w_k of the
    block's ``rows``; in the L form also y of a band and each consumer
    warp's sums of a band's or the block's rows."""
    extra = 0 if form == "X" else SWEEP_MAX_BAND + SWEEP_WARPS * rows
    return (SWEEP_WIDE_BARRIER_BYTES + stages * band_rows * row_bytes
            + 4 * (n + rows + extra))


def sweep_wide_vbuf_floats(B: int, n: int, spread: int, form: str) -> int:
    """float32 words of a wide launch's scratch (the kernel's
    ``wide_vbuf_floats``): the step vectors (2, B, n); in the L form the
    blocks' column partials (B, spread, n); then the barriers' words, one a
    scenario."""
    return 2 * B * n + (B * spread * n if form == "L" else 0) + B


def sweep_wide_fit(K: int, n: int, spread: int, per_sm: int, row_bytes: int,
                   form: str = "X", extra_bytes: int = 0,
                   one_sweep: bool = True) -> SweepPlan | None:
    """The wide plan of ``spread`` blocks a scenario, ``per_sm`` of them an
    SM, on rows of ``row_bytes``: the largest bands (an even number of
    rows, at most SWEEP_MAX_BAND and the block's rows) of which two stages
    fit beside the block's vectors and ``extra_bytes`` more (the fused X
    interval's slot scalars), and as many stages as fit, at most
    SWEEP_MAX_STAGES and, where ``one_sweep`` (the launch streams one sweep
    of 2K - 1 blocks, not a ring that runs on across sweeps), no more than
    that sweep's bands; None where not even bands of two rows fit."""
    rows = sweep_wide_rows(n, spread)
    room = (SMEM_SM // per_sm - 1024) - extra_bytes - sweep_wide_smem_bytes(
        n, rows, 0, 0, row_bytes, form)
    band = min(SWEEP_MAX_BAND, rows, room // (2 * row_bytes)) // 2 * 2
    if band < 2:
        return None
    stages = min(SWEEP_MAX_STAGES, room // (band * row_bytes))
    if one_sweep:
        stages = min(stages, -(-rows // band) * (2 * K - 1))
    return SweepPlan(1, band, stages, extra_bytes + sweep_wide_smem_bytes(
        n, rows, band, stages, row_bytes, form), per_sm, spread)


def sweep_wide_plan(B: int, K: int, n: int, esize: int, sms: int,
                    form: str = "X", extra_bytes: int = 0,
                    one_sweep: bool = True) -> SweepPlan:
    """The wide tier's plan of ``form`` on a card of ``sms`` SMs.  For each
    count of blocks an SM up to SWEEP_WIDE_PER_SM that gives each scenario a
    block, the card's blocks (all of them resident at once, as a cooperative
    grid must be) are shared out between the B scenarios (each at least 2
    rows), on :func:`sweep_wide_fit` (``extra_bytes`` and ``one_sweep`` as
    there).  X: a band
    costs a step about one row product's latency whatever its rows (its
    rows run on the consumer warps side by side), so the plan with the
    fewest bands a step is taken, the fewer blocks an SM on a tie.  L: two
    blocks an SM where their bands hold SWEEP_WIDE_L_BAND rows or more or a
    block owns more than twice as many rows, else one (measured over the
    plans at N = 60 … 1024, B = 1 … 32: two blocks an SM, each with half the
    rows, overlap each other's products and reduction, which pays where a
    block has many rows; where it has few, in small bands, one block an SM
    with bands twice as large is faster)."""
    row_bytes = sweep_row_bytes(n, esize)
    plans = [plan for per_sm in range(-(-B // sms), SWEEP_WIDE_PER_SM + 1)
             if (plan := sweep_wide_fit(
                 K, n, min(sms * per_sm // B, n // 2), per_sm, row_bytes,
                 form, extra_bytes, one_sweep)) is not None]
    if not plans:
        raise ValueError(f"sweep kernels: no wide plan of B={B} at n={n} "
                         f"fits {sms} SMs")
    if form == "L":
        paired = [p for p in plans if p.per_sm == 2 and (
            p.band_rows >= SWEEP_WIDE_L_BAND
            or sweep_wide_rows(n, p.spread) > 2 * SWEEP_WIDE_L_BAND)]
        return paired[0] if paired else plans[0]
    return min(plans, key=lambda p: (
        -(-sweep_wide_rows(n, p.spread) // p.band_rows), p.per_sm))


def sweep_plan(B: int, K: int, n: int, form: str, esize: int = 4,
               sms: int = SMS, _wide: bool | None = None) -> SweepPlan:
    """The launch plan of the sweep kernel of ``form`` ("X", "L" or
    "dense") for B scenarios of K blocks of n x n, stored as float32
    (``esize`` 4) or as bf16 on padded rows (``esize`` 2: a stage holds
    about twice the rows).

    * B > 64 (the production chunk of 512, the compaction's later chunks):
      one block per scenario, its shared memory sized so that as many
      blocks share an SM as B needs to run in one wave on 132 SMs, up to
      :func:`sweep_blocks_per_sm` (four: 528 blocks hold the chunk of
      512; two for the L form on bf16 factors, one for n > 512); a block
      alone on its SM takes a ring four times as deep.  The kernel runs the
      instantiation whose launch bounds hold ``per_sm`` blocks an SM.
    * B <= 64 (the reference-compatible path's 64, the ``SCP`` class's 1):
      a cluster of 2 blocks per scenario, 4 up to B = 32, each streaming its
      share of the rows, so that a scenario's stream is spread over as many
      SMs; two clusters may share an SM where the launch bounds allow.
    Bands are an even number of rows, at most 4 a consumer warp, and shrink
    until SWEEP_WANT_STAGES stages fit; the ring is no deeper than the
    bands of the whole chain (2K - 1 blocks; dense: 4K - 3, its two blocks
    a step of k).  Where n is so large that not even a ring of two stages
    fits beside the vectors of as many blocks, fewer blocks share an SM,
    and then a cluster has fewer blocks (the widest blocks run one block a
    scenario).
    * The X form from n = 360 up to B = 32, the L form from n = 240 up to
      B = 2 and from n = 360 up to B = 32 (bf16: from 600 up to 8 and from
      1200 up to 32) (:func:`sweep_wide`; the grouped routes past N = 59
      at small batches): the wide tier, each scenario on its share of one
      cooperative grid over the card (:func:`sweep_wide_plan`).  ``_wide``
      names the tier instead (to time and check both tiers at one
      shape).
    ``sms`` is the card's count of SMs (the launches give
    :func:`cuda_build.device_sms`).
    Raises ValueError for what the kernels do not serve (K < 2; X and L:
    n not a multiple of 6 or above 6144; dense: n odd or above 1536; the
    wide tier of the dense form)."""
    if form not in SWEEP_FORMS:
        raise ValueError(f"sweep kernels: unknown form {form!r}")
    unit = 2 if form == "dense" else 6
    max_n = SWEEP_MAX_N if form == "dense" else SWEEP_MAX_N_WIDE
    if B < 1 or K < 2 or n <= 0 or n % unit or n > max_n:
        raise ValueError(f"sweep kernels, {form} form: unsupported B={B}, "
                         f"K={K}, n={n} (n a multiple of {unit} up to "
                         f"{max_n}, K >= 2)")
    if _wide is None:
        _wide = sweep_wide(B, n, form, sms, esize)
    if _wide:
        if form == "dense":
            raise ValueError(f"sweep kernels: no wide tier of form {form!r}")
        return sweep_wide_plan(B, K, n, esize, sms, form)
    part = sweep_part_rows(form, n)
    row_bytes = sweep_row_bytes(n, esize)
    most = sweep_blocks_per_sm(form, n, esize)
    chain = 4 * K - 3 if form == "dense" else 2 * K - 1
    cluster = (4 if B <= SWEEP_CLUSTER_B // 2 else
               2 if B <= SWEEP_CLUSTER_B else 1)
    while True:
        share, band_rows, stages, per_sm = _sweep_ring(B, n, cluster, part,
                                                       row_bytes, most, sms)
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
                  bf16_ok=("F",), plan: SweepPlan | None = None):
    """Check the operands of a sweep kernel, launch ``entry`` (its ``_f32``
    or, for bf16 factors, ``_bf16`` variant; ``_wide`` before it on the
    wide tier) on :func:`sweep_plan` for b's card (or ``plan``) and return
    x.
    F (B, K, n, n) the factor blocks, G the slot scalars (K-1, 3, 3) (X, L)
    or the second factor (B, K-1, n, n) (dense)."""
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
    if plan is None:
        plan = sweep_plan(B, K, n, form, esize=F.element_size(),
                          sms=device_sms(b.device))
    x = torch.empty_like(b)
    lib = load_kernels()
    ld = (F.stride(-2),) if bf16 else ()
    dtype = "_bf16" if bf16 else "_f32"
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        if plan.spread:
            # the vector of a step, double-buffered, in global memory, the
            # L form's column partials, then the launch's barrier words
            vbuf = torch.empty(sweep_wide_vbuf_floats(B, n, plan.spread, form),
                               dtype=torch.float32, device=b.device)
            err = getattr(lib, entry + "_wide" + dtype)(
                F.data_ptr(), G.data_ptr(), b.data_ptr(), x.data_ptr(),
                vbuf.data_ptr(), B, K, n, *ld, plan.spread, plan.band_rows,
                plan.stages, plan.per_sm, stream)
        else:
            err = getattr(lib, entry + dtype)(
                F.data_ptr(), G.data_ptr(), b.data_ptr(), x.data_ptr(), B,
                K, n, *ld, plan.cluster, plan.band_rows, plan.stages,
                plan.per_sm, stream)
    check(err, what)
    debug.report(entry, x)
    return x


def solve_factorized_grouped_X(X, C, b, *, _plan: SweepPlan | None = None):
    """Solve M x = b for a batch: X (B, K, n, n) symmetric block inverses,
    C (K-1, 3, 3) shared upper-triangular slot scalars, b (B, K, n) ->
    x (B, K, n).  CUDA tensors launch the kernel on :func:`sweep_plan`, or
    on ``_plan`` (to time and check another tier; float32 and contiguous,
    X also bf16 as
    ``banded.compress_factors`` lays it out; n a multiple of 6 up to 6144;
    anything else raises); CPU tensors run the plain version."""
    if not b.is_cuda:
        if b.device.type != "cpu":
            raise ValueError(
                f"solve_factorized_grouped_X: unsupported device {b.device}")
        return solve_factorized_grouped_X_plain(X, C, b)
    x = _launch_sweep("solve_factorized_grouped_X", "group_solve_x", X, C, b,
                      "X", plan=_plan)
    solve_factorized_grouped_X.launches += 1
    return x


solve_factorized_grouped_X.launches = 0


def solve_factorized_grouped_L_plain(Linv, C, b):
    """Plain version of the kernel: ``banded.solve_factorized_L`` (bf16
    factors are widened to b's dtype block by block)."""
    return solve_factorized_L(Linv, C, b)


def solve_factorized_grouped_L(Linv, C, b, *, _plan: SweepPlan | None = None):
    """Solve M x = b for a batch from the L-only factors: Linv (B, K, n, n)
    inverted diagonal factors, C (K-1, 3, 3) shared upper-triangular slot
    scalars, b (B, K, n) -> x (B, K, n).  CUDA tensors launch the kernel on
    :func:`sweep_plan`, or on ``_plan`` (to time and check another tier;
    float32 and contiguous, Linv also bf16 as ``banded.compress_factors``
    lays it out; n a multiple of 6 up to 6144; Linv is read as lower
    triangular; anything else raises); CPU tensors run the plain
    version."""
    if not b.is_cuda:
        if b.device.type != "cpu":
            raise ValueError(
                f"solve_factorized_grouped_L: unsupported device {b.device}")
        return solve_factorized_grouped_L_plain(Linv, C, b)
    x = _launch_sweep("solve_factorized_grouped_L", "group_solve_l", Linv, C,
                      b, "L", plan=_plan)
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
