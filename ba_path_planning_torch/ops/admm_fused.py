"""One whole ADMM check interval in one launch (counterpart of
``ba_path_planning_tpu/ops/pallas/admm_fused.py``): with X-form factors the
CUDA kernel ``csrc/admm_fused_x.cu`` (:func:`admm_interval_fused_X`, for the
Pallas bodies ``_admm_kernel_XG`` and ``_admm_kernel_X``), with dense
(Linv, Eb) factors ``csrc/admm_fused_l.cu`` (:func:`admm_interval_fused`, for
``_admm_kernel``), each with its launcher and its plain PyTorch version.

The kernels take the rows as planes: the six static row blocks as
(B, K, 6, 2N) in the slot order :data:`SLOTS` (:func:`static_plane`; the
jerk block's row K-1 is padding), the collision rows as (B, K, P), the state
stacked as (B, K, 6N).  The TPU kernels' lane padding, jerk dummy bounds and
dense pair maps were rules of its VMEM tiling and are not carried over.
Both kernels stream their factors through a ring of shared-memory stages
on the plan of :func:`fused_plan`; the X form at small batches on its wide
tier, each scenario over many SMs (:func:`fused_x_plan`).
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..solvers.banded import (RowVals, StateVars, admm_iterations,
                              from_stacked, solve_factorized,
                              solve_factorized_X, to_stacked)
from ..utils import debug
from .cuda_build import (SMS, bf16_row_stride, check, device_sms,
                         load_kernels, require_f32_cuda)
from .group_solve import (SweepPlan, sweep_wide_fit, sweep_wide_plan,
                          sweep_wide_smem_bytes)

SLOTS = ("dyn_p", "dyn_v", "jerk", "acc", "vbox", "pbox")

# The fused kernels' launch layout (csrc/admm_fused.cuh, factor_ring.cuh)
FUSED_SMEM_MAX = 232448          # dynamic shared memory of one block
FUSED_RING_BARRIER_BYTES = 128   # the ring's full and empty barriers
FUSED_MAX_STAGES = 8
FUSED_WANT_STAGES = 4            # bands shrink until this many stages fit
FUSED_WARPS = 16                 # consumer warps of a block
# n = 6N the L-form kernel serves: 16 consumer warps of 7 column octets
FUSED_L_MAX_N = 896
# n from which and up to which the X-form kernel reads packed upper
# triangles (below, whole bands time as fast or faster on the H100:
# PERF.md), and the most bands a block splits into there
FUSED_X_PACKED_MIN_N = 234
FUSED_X_PACKED_MAX_N = 512
FUSED_MAX_BANDS = 256
# The X form's wide tier (csrc/admm_fused_x.cu, on the layout of the X
# sweep's, group_sweep.cuh): (least n, largest B) pairs, the wide tier
# where one of them admits (n, B) (the crossover measured on the H100,
# ``scripts/torch_sweep_bench.py --tiers``, PERF.md: at N = 22 the
# one-block tier wins from B = 32, from N = 30 the wide tier at every
# B <= 32), and the most n it serves
FUSED_X_WIDE = ((132, 16), (180, 32))
FUSED_X_WIDE_MAX_N = 6144


class FusedPlan(NamedTuple):
    """How a fused-interval kernel runs: its factor blocks stream through a
    ring of ``stages`` shared-memory stages of ``band_rows`` rows; the
    (K, 6N) sweep plane lies in shared memory where ``plane_in_smem``,
    else in a global scratch; ``packed``: the X-form factors come as the
    packed upper triangles of :func:`pack_upper`; ``smem_bytes`` of
    dynamic shared memory a block.  On the X form's wide tier ``spread``
    blocks of one cooperative grid take a scenario, ``per_sm`` of them
    sharing an SM; ``spread`` is 0 on the one-block tier."""
    band_rows: int
    stages: int
    plane_in_smem: bool
    packed: bool
    smem_bytes: int
    spread: int = 0
    per_sm: int = 1


def _ring_width(n: int, packed: int) -> int:
    """Floats a factor row takes in the ring (the kernels' ``ring_width``):
    n, or in the packed mode n rounded up to a multiple of 4."""
    return -(-n // 4) * 4 if packed else n


def fused_row_bytes(n: int, packed: int, esize: int = 4) -> int:
    """Bytes a factor row takes in the ring: 6N floats, rounded up to a
    multiple of 4 where ``packed``, or (``esize`` 2) 6N bf16 elements on
    the stride :func:`cuda_build.bf16_row_stride`."""
    return 4 * _ring_width(n, packed) if esize == 4 else 2 * bf16_row_stride(n)


def fused_smem_bytes(K: int, N: int, band_rows: int, stages: int,
                     plane: int, packed: int, xform: int,
                     row_bytes: int | None = None) -> int:
    """Dynamic shared memory of a fused-interval block (the kernels'
    ``admm_fused::smem_bytes``): the ring's barriers and stages (rows of
    ``row_bytes``, by default float32 rows of :func:`fused_row_bytes`), the
    sweep plane where ``plane`` is 1, one vector of 6N floats, where
    ``packed`` the warps' column partial sums, the row dots and the band
    table and, in the X form (``xform`` 1), the slot scalars.  No pair
    table: the kernels find a collision row's pair in closed form."""
    n = 6 * N
    if row_bytes is None:
        row_bytes = fused_row_bytes(n, packed)
    return (FUSED_RING_BARRIER_BYTES + stages * band_rows * row_bytes
            + 4 * (n * (1 + plane * K + packed * (FUSED_WARPS + 1))
                   + packed * FUSED_MAX_BANDS)
            + 36 * (K - 1) * xform)


def fused_plan(K: int, N: int, form: str, esize: int = 4) -> FusedPlan:
    """The launch plan of the fused-interval kernel of factor ``form``
    ("X" or "L") for K steps of N vehicles, one block a scenario, its
    factors float32 or (``esize`` 2, the L form) bf16 on padded rows: the X
    form reads packed upper triangles for 234 <= 6N <= 512 (from N = 39;
    PERF.md has the times of both layouts); the sweep plane in
    shared memory where it takes at most half of it, then the largest bands
    (an even number of rows) that leave FUSED_WANT_STAGES stages, at most
    FUSED_MAX_STAGES.  Raises ValueError for what the kernel does not serve
    (the L form: 6N > 896; either: a scenario's 2 K P floats of eta past
    ``int`` indexing, or no ring of two stages fits).  Every (K, N) that
    ``banded.qp_route`` sends to a fused route has a plan
    (tests/test_torch_fused_plan.py): the X form at K = 2 up to N = 584,
    n = 3504, in whole bands of 2 rows."""
    n = 6 * N
    if form not in ("X", "L") or K < 2 or N < 1 or N > 65535 or (
            2 * K * (N * (N - 1) // 2) >= 2 ** 31) or (
            form == "L" and n > FUSED_L_MAX_N) or esize not in (
                (4,) if form == "X" else (4, 2)):
        raise ValueError(f"fused {form} kernel: unsupported K={K}, N={N}, "
                         f"{esize}-byte factors")
    packed = int(form == "X"
                 and FUSED_X_PACKED_MIN_N <= n <= FUSED_X_PACKED_MAX_N)
    row_bytes = fused_row_bytes(n, packed, esize)
    xform = int(form == "X")
    plane = int(4 * K * n <= FUSED_SMEM_MAX // 2)
    room = FUSED_SMEM_MAX - fused_smem_bytes(K, N, 0, 0, plane, packed, xform)
    for n_bands in range(1, n // 2 + 1):
        band_rows = (-(-n // n_bands) + 1) // 2 * 2
        stages = room // (row_bytes * band_rows)
        if stages >= FUSED_WANT_STAGES:
            break
    stages = min(stages, FUSED_MAX_STAGES)
    if stages < 2:
        raise ValueError(f"fused {form} kernel: no ring of two stages fits "
                         f"K={K}, N={N}")
    return FusedPlan(band_rows, stages, bool(plane), bool(packed),
                     fused_smem_bytes(K, N, band_rows, stages, plane, packed,
                                      xform, row_bytes))


def _slot_bytes(K: int) -> int:
    """Shared memory of a wide block's slot scalars: 9 floats a slot."""
    return 36 * (K - 1)


def fused_wide_smem_bytes(K: int, N: int, rows: int, band_rows: int,
                          stages: int) -> int:
    """Dynamic shared memory of a block of the X form's wide tier (the
    kernel's ``wide_smem_bytes``): the X sweep's wide block (the ring's
    barriers, ``stages`` stages of ``band_rows`` whole rows of 6N floats, r
    (6N) and w_k of the block's ``rows``) and the slot scalars."""
    n = 6 * N
    return sweep_wide_smem_bytes(n, rows, band_rows, stages,
                                 4 * n) + _slot_bytes(K)


def fused_wide_scratch_floats(B: int, K: int, N: int) -> int:
    """float32 words of a wide launch's scratch (the kernel's
    ``wide_scratch_floats``): the right-hand-side plane and the sweep plane
    (2, B, K, 6N), then the barriers' words, one a scenario."""
    return 2 * B * K * 6 * N + B


def fused_wide_share(g: int, spread: int, items: int) -> int:
    """First of ``items`` elementwise rows (K 2N static ones, K P
    collision ones) that block ``g`` of a scenario's ``spread`` takes (the
    kernel's ``wide_share``)."""
    return g * items // spread


def _as_fused(plan: SweepPlan) -> FusedPlan:
    return FusedPlan(plan.band_rows, plan.stages, False, False,
                     plan.smem_bytes, plan.spread, plan.per_sm)


def fused_wide_fit(K: int, N: int, spread: int,
                   per_sm: int) -> FusedPlan | None:
    """The wide plan of ``spread`` blocks a scenario, ``per_sm`` of them
    an SM, as the X sweep's wide tier fits one
    (:func:`group_solve.sweep_wide_fit`), beside the slot scalars and with
    a ring that runs on across the interval's sweeps; None where not even
    bands of two rows fit."""
    plan = sweep_wide_fit(K, 6 * N, spread, per_sm, 4 * 6 * N,
                          extra_bytes=_slot_bytes(K), one_sweep=False)
    return None if plan is None else _as_fused(plan)


def fused_x_wide_plan(B: int, K: int, N: int, sms: int = SMS) -> FusedPlan:
    """The X form's wide plan for B scenarios on a card of ``sms`` SMs: the
    X sweep's wide plan (:func:`group_solve.sweep_wide_plan`: the card's
    blocks shared out between the scenarios, fewest bands a step) on
    :func:`fused_wide_fit`'s blocks.  Raises ValueError where none fits or
    n passes FUSED_X_WIDE_MAX_N."""
    n = 6 * N
    if B >= 1 and 2 <= K and n <= FUSED_X_WIDE_MAX_N:
        try:
            return _as_fused(sweep_wide_plan(
                B, K, n, 4, sms, extra_bytes=_slot_bytes(K),
                one_sweep=False))
        except ValueError:
            pass
    raise ValueError(f"fused X kernel: no wide plan of B={B}, K={K}, "
                     f"N={N} fits {sms} SMs")


def fused_x_wide(B: int, N: int, sms: int = SMS) -> bool:
    """Whether B scenarios of N vehicles take the X form's wide tier on a
    card of ``sms`` SMs: where a (least n, largest B) pair of FUSED_X_WIDE
    admits them, up to FUSED_X_WIDE_MAX_N, and no more scenarios than the
    card has SMs (a block a scenario at least, all resident)."""
    n = 6 * N
    return (n <= FUSED_X_WIDE_MAX_N and B <= sms
            and any(n >= least and B <= most for least, most in FUSED_X_WIDE))


def fused_x_plan(B: int, K: int, N: int, sms: int = SMS, esize: int = 4,
                 _wide: bool | None = None) -> FusedPlan:
    """The launch plan of the X-form fused interval for B scenarios of K
    steps of N vehicles on a card of ``sms`` SMs: the wide tier where
    :func:`fused_x_wide` takes it (:func:`fused_x_wide_plan`), else one
    block a scenario (:func:`fused_plan`).  ``_wide`` names the tier
    instead (to time and check both at one shape).  Raises ValueError for
    what :func:`fused_plan` refuses, factors of another ``esize`` than 4
    bytes among them: the X form keeps its factors in float32."""
    if esize != 4:
        return fused_plan(K, N, "X", esize=esize)
    if _wide is None:
        _wide = fused_x_wide(B, N, sms)
    if _wide:
        return fused_x_wide_plan(B, K, N, sms)
    return fused_plan(K, N, "X")


def packed_offsets(n: int) -> list:
    """Offsets of the rows of a packed upper triangle (the kernel's
    ``packed_off``), n + 1 of them: row i holds columns 4 floor(i/4) up to
    n rounded up to a multiple of 4 (the columns from n on are padding), so
    every row starts 16-byte aligned; the last offset is the block's
    size."""
    width = _ring_width(n, 1)
    out = [0]
    for i in range(n):
        out.append(out[-1] + width - 4 * (i // 4))
    return out


@functools.lru_cache(maxsize=16)
def _packed_index(n: int, device: torch.device) -> torch.Tensor:
    """Flat indices into an n x n block of the entries of its packed upper
    triangle (a padding column repeats column n - 1)."""
    width = _ring_width(n, 1)
    idx = []
    for i in range(n):
        c0 = 4 * (i // 4)
        idx.extend(i * n + min(j, n - 1) for j in range(c0, width))
    return torch.tensor(idx, dtype=torch.long, device=device)


def pack_upper(X: torch.Tensor) -> torch.Tensor:
    """(B, K, n, n) symmetric blocks -> (B, K, T) their packed upper
    triangles, the layout the X-form kernel reads in its packed mode
    (:func:`packed_offsets`; T = ``packed_offsets(n)[-1]``)."""
    B, K, n = X.shape[:3]
    flat = X.reshape(B * K, n * n)
    return flat.index_select(1, _packed_index(n, X.device)).reshape(B, K, -1)


def static_plane(rv: RowVals, n_steps: int) -> torch.Tensor:
    """The static rows of ``rv`` ((B, N, K', 2) leaves) as a new contiguous
    plane (B, K, 6, 2N); the jerk block is padded with a zero row at K-1.
    One copy a leaf and one fill: seven launches on the card."""
    batch, (N, _, two) = rv.acc.shape[:-3], rv.acc.shape[-3:]
    out = rv.acc.new_empty(batch + (n_steps, len(SLOTS), N, two))
    for i, name in enumerate(SLOTS):
        t = getattr(rv, name).transpose(-3, -2)
        out[..., :t.shape[-3], i, :, :].copy_(t)
    out[..., rv.jerk.shape[-2]:, SLOTS.index("jerk"), :, :].zero_()
    return out.view(batch + (n_steps, len(SLOTS), N * two))


def planes_to_rows(static, col, n_vehicles: int) -> RowVals:
    """RowVals from a static plane and collision rows (views of both)."""
    parts = {}
    for i, name in enumerate(SLOTS):
        t = static[..., i, :]
        if name == "jerk":
            t = t[..., :-1, :]
        parts[name] = t.reshape(t.shape[:-1] + (n_vehicles, 2)).transpose(-3,
                                                                          -2)
    return RowVals(col=col, **parts)


def rho_planes(rho: RowVals, n_steps: int, n_pairs: int):
    """Rho from :func:`banded.rho_pattern_masks` -> per-(k, slot) scalars
    (K, 6) (the jerk row K-1 is padding) and (K, P), batch-shared, or
    (B, K, 6) and (B, K, P), one plane a lane, from per-lane leaves
    (B, 1, K', 1) (adaptive rho); a per-lane ``col`` (B, K, P) beside
    batch-shared static leaves (the loose rho of disabled rows) stays
    per-lane."""
    cols = []
    for name in SLOTS:
        leaf = getattr(rho, name)
        if leaf.dim() == 4 and leaf.shape[1] == 1:
            leaf = leaf[:, 0]
        if leaf.dim() not in (2, 3) or leaf.shape[-1] != 1:
            raise ValueError(
                "the fused ADMM kernels need (K', 1) or (B, 1, K', 1) rho "
                "leaves (banded.rho_pattern_masks)")
        cols.append(F.pad(leaf, (0, 0, 0, n_steps - leaf.shape[-2]),
                          value=1.0))
    rho_c = rho.col.expand(torch.broadcast_shapes(
        cols[0].shape[:-2] + (n_steps, n_pairs), rho.col.shape))
    return torch.cat(cols, dim=-1).contiguous(), rho_c.contiguous()


def _launch(wrapper, entry: str, factors: dict, eta, E, lower: RowVals,
            upper: RowVals, x: StateVars, z: RowVals, y: RowVals,
            rho: RowVals, *, h: float, sigma, alpha, lam, n_iters: int,
            plan: FusedPlan | None = None):
    """Lay the rows out as planes, launch ``entry`` of the kernel library
    (its ``_bf16`` variant for the L form's bf16 factors, its ``_wide``
    one on the X form's wide tier) on the two factor tensors (their shapes
    checked by the caller) on ``plan``, by default the X form's
    :func:`fused_x_plan` for the card or the L form's :func:`fused_plan`,
    and count the launch on ``wrapper`` (a wide one on ``wrapper.wide``).
    The inputs are not modified."""
    what = wrapper.__name__
    B, K = eta.shape[:2]
    N, P = E.shape
    n = 6 * N
    x_form = entry == "admm_fused_x"
    first = factors["X" if x_form else "Linv"]
    bf16 = first.dtype == torch.bfloat16
    if plan is None:
        esize = 2 if bf16 else 4
        plan = (fused_x_plan(B, K, N, sms=device_sms(eta.device),
                             esize=esize) if x_form
                else fused_plan(K, N, "L", esize=esize))
    if plan.packed:
        require_f32_cuda(what, X=factors["X"])
        factors = dict(factors, X=pack_upper(factors["X"]))
    # fresh contiguous copies of the state: the kernel updates them in place
    zs, ys = static_plane(z, K), static_plane(y, K)
    zc, yc = (t.clone(memory_format=torch.contiguous_format)
              for t in (z.col, y.col))
    xs = to_stacked(x)
    rho_s, rho_c = rho_planes(rho, K, P)
    C = factors.get("C")
    # floats between two lanes' rho planes and slot scalars: 0 where they
    # are batch-shared
    strides = [t.shape[-2] * t.shape[-1] if t.dim() == 3 else 0
               for t in (rho_s, rho_c)]
    if x_form:
        strides.append(9 * (K - 1) if C.dim() == 4 else 0)
    fpar = torch.stack([torch.as_tensor(v, dtype=eta.dtype, device=eta.device)
                        .reshape(()) for v in (h, sigma, alpha, lam)])
    tensors = dict(fpar=fpar, **factors, eta=eta,
                   l_s=static_plane(lower, K), u_s=static_plane(upper, K),
                   l_c=lower.col.contiguous(), rho_s=rho_s, rho_c=rho_c, x=xs,
                   zs=zs, ys=ys, zc=zc, yc=yc)
    require_f32_cuda(what, bf16_ok=() if x_form else ("Linv", "Eb"),
                     **tensors)
    sp, cp = (B, K, 6, 2 * N), (B, K, P)
    shapes = dict(l_s=sp, u_s=sp, l_c=cp, x=(B, K, n), zs=sp, ys=sp, zc=cp,
                  yc=cp, rho_s=(B, K, 6) if strides[0] else (K, 6),
                  rho_c=cp if strides[1] else (K, P))
    for name, want in shapes.items():
        if tensors[name].shape != want:
            raise ValueError(f"{what}: {name} is "
                             f"{tuple(tensors[name].shape)}, not {want}")
    lib = load_kernels()
    ptrs = [t.data_ptr() for t in tensors.values()]
    with torch.cuda.device(eta.device):
        stream = torch.cuda.current_stream(eta.device).cuda_stream
        if plan.spread:
            # the wide tier: the right-hand-side and sweep planes, then the
            # launch's barrier words
            scratch = torch.empty(fused_wide_scratch_floats(B, K, N),
                                  dtype=torch.float32, device=eta.device)
            err = lib.admm_fused_x_wide_f32(
                *ptrs, scratch.data_ptr(), B, K, N, int(n_iters),
                plan.spread, plan.band_rows, plan.stages, plan.per_sm,
                *strides, stream)
        else:
            # the sweep plane, where the plan leaves it out of shared memory
            plane = None if plan.plane_in_smem else torch.empty(
                (B, K, n), dtype=eta.dtype, device=eta.device)
            err = getattr(lib, entry + ("_bf16" if bf16 else "_f32"))(
                *ptrs, None if plane is None else plane.data_ptr(), B, K, N,
                *([first.stride(-2)] if bf16 else []),
                int(n_iters), plan.band_rows, plan.stages,
                *([int(plan.packed)] if x_form else []), *strides, stream)
    check(err, what)
    # the wide tier's kernel counts its launches apart
    (wrapper.wide if plan.spread else wrapper).launches += 1
    debug.report(entry, xs, zs, ys, zc, yc)
    return (from_stacked(xs, N), planes_to_rows(zs, zc, N),
            planes_to_rows(ys, yc, N))


def _on_cpu(what: str, t) -> bool:
    """True for a CPU tensor, False for a CUDA one; raises for any other."""
    if t.is_cuda:
        return False
    if t.device.type != "cpu":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return True


def admm_interval_fused_X_plain(X, C, eta, E, lower: RowVals, upper: RowVals,
                                x: StateVars, z: RowVals, y: RowVals,
                                rho: RowVals, *, h: float, sigma, alpha, lam,
                                n_iters: int):
    """Plain version of the kernel: ``n_iters`` iterations of
    :func:`banded.admm_iterations` with the X-form sweeps of
    ``banded.solve_factorized_X``."""
    return admm_iterations(x, z, y, lambda sb: solve_factorized_X(X, C, sb),
                           eta, E, lower, upper, rho, h=h, sigma=sigma,
                           alpha=alpha, lam=lam, n_iters=n_iters)


def admm_interval_fused_X(X, C, eta, E, lower: RowVals, upper: RowVals,
                          x: StateVars, z: RowVals, y: RowVals, rho: RowVals,
                          *, _plan: FusedPlan | None = None, **step):
    """``n_iters`` ADMM iterations for a batch, returning the new (x, z, y).

    X (B, K, 6N, 6N) symmetric block inverses and C (K-1, 3, 3) shared slot
    scalars from ``banded.factorize_X``, or (B, K-1, 3, 3) one set a lane
    (adaptive rho); eta (B, K, P, 2) and E (N, P) the
    collision directions and the pair incidence (``triu_indices`` order);
    lower/upper the row bounds (``upper.col`` is not read: the collision
    rows have the exact-penalty prox with weight ``lam``, which may be
    +inf for hard rows); x, z, y the ADMM state; rho from
    ``banded.rho_pattern_masks``, batch-shared or one rho a lane
    (:func:`rho_planes`); ``step`` the keywords h, sigma, alpha, lam
    and n_iters.  CUDA tensors launch the kernel on :func:`fused_x_plan`
    for the card (small batches on the wide tier), or on ``_plan`` (to
    time and check another tier; float32, X, C and eta contiguous;
    anything else raises, a wide plan whose blocks the card cannot hold
    all at once too); CPU tensors run the plain version.  The inputs are
    not modified."""
    if _on_cpu("admm_interval_fused_X", X):
        return admm_interval_fused_X_plain(X, C, eta, E, lower, upper, x, z,
                                           y, rho, **step)
    B, K, n = X.shape[:3]
    N, P = E.shape
    if (X.shape != (B, K, n, n) or n != 6 * N
            or C.shape not in ((K - 1, 3, 3), (B, K - 1, 3, 3))
            or eta.shape != (B, K, P, 2) or P != N * (N - 1) // 2):
        raise ValueError(
            f"admm_interval_fused_X: unsupported shapes X {tuple(X.shape)}, "
            f"C {tuple(C.shape)}, eta {tuple(eta.shape)}, E {tuple(E.shape)}")
    return _launch(admm_interval_fused_X, "admm_fused_x", dict(C=C, X=X),
                   eta, E, lower, upper, x, z, y, rho, plan=_plan, **step)


admm_interval_fused_X.launches = 0
# launches of the wide tier's kernel (admm_fused_x_wide_kernel); those of
# the one-block kernel are ``admm_interval_fused_X.launches``
admm_interval_fused_X.wide = SimpleNamespace(launches=0)


def admm_interval_fused_plain(Linv, Eb, eta, E, lower: RowVals,
                              upper: RowVals, x: StateVars, z: RowVals,
                              y: RowVals, rho: RowVals, *, h: float, sigma,
                              alpha, lam, n_iters: int):
    """Plain version of the kernel: ``n_iters`` iterations of
    :func:`banded.admm_iterations` with the dense sweeps of
    ``banded.solve_factorized`` (bf16 factors are widened to the state's
    dtype block by block)."""
    return admm_iterations(x, z, y,
                           lambda sb: solve_factorized(Linv, Eb, sb), eta, E,
                           lower, upper, rho, h=h, sigma=sigma, alpha=alpha,
                           lam=lam, n_iters=n_iters)


def admm_interval_fused(Linv, Eb, eta, E, lower: RowVals, upper: RowVals,
                        x: StateVars, z: RowVals, y: RowVals, rho: RowVals,
                        **step):
    """As :func:`admm_interval_fused_X`, on the dense factors
    Linv (B, K, 6N, 6N) and Eb (B, K-1, 6N, 6N) of ``banded.factorize``.
    Linv_k is lower triangular: the kernel does not read what lies above
    the diagonal.  The factors may be bf16 as ``banded.compress_factors``
    lays them out (``SolverConfig.factor_dtype="bf16"``).  It serves
    6N <= 896 (:data:`FUSED_L_MAX_N`): every (K, N) that
    ``banded.qp_route`` sends to the L-form fused route."""
    if _on_cpu("admm_interval_fused", Linv):
        return admm_interval_fused_plain(Linv, Eb, eta, E, lower, upper, x,
                                         z, y, rho, **step)
    B, K, n = Linv.shape[:3]
    N, P = E.shape
    if (K < 2 or Linv.shape != (B, K, n, n) or n != 6 * N
            or Eb.shape != (B, K - 1, n, n) or eta.shape != (B, K, P, 2)
            or P != N * (N - 1) // 2):
        raise ValueError(
            f"admm_interval_fused: unsupported shapes Linv "
            f"{tuple(Linv.shape)}, Eb {tuple(Eb.shape)}, eta "
            f"{tuple(eta.shape)}, E {tuple(E.shape)}")
    return _launch(admm_interval_fused, "admm_fused_l",
                   dict(Linv=Linv, Eb=Eb), eta, E,
                   lower, upper, x, z, y, rho, **step)


admm_interval_fused.launches = 0
