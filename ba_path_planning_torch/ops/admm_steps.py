"""The ADMM iteration of the sweep routes and of phase 1 in hand-written
kernels (``csrc/admm_steps.cu``), each with its plain PyTorch version.

The JAX package runs its ADMM loop body (``admm_iter``,
``ba_path_planning_tpu/solvers/banded.py:1319``) as XLA-fused code around
the Pallas sweep, inside one compiled program; run operator by operator
(:func:`banded.admm_iterations`) it is ~177 launches an iteration.  Here the
routes that launch a sweep kernel per iteration (``grouped_X``,
``grouped_L``, ``resident``) run each iteration as three launches:

* :func:`admm_rhs`: b = A^T (rho z - y) + sigma x, times the lane's 1 / rho
  where the grouped routes solve (M / rho) x = b / rho (adaptive rho);
* the sweep kernel of the route, on b;
* :func:`admm_update`: from the sweep's xt, x, z and y in place (the
  relaxation, A xt, the clip, the exact-penalty prox, the dual step);

and the collision-free phase-1 QP (``"channel"``, eta = 0) runs each check
interval in one launch, :func:`admm_channel_interval`: 2N independent
channel problems a lane and an elementwise recurrence a collision row.
The state lies on the planes of the fused kernels (``ops/admm_fused.py``):
x stacked (B, K, 6N), the static rows of z and y as (B, K, 6, 2N), their
collision rows (B, K, P); it is packed once an interval
(:func:`pack_state`) and the interval returns views of it.  CUDA tensors
launch the kernels (float32; anything else raises), CPU tensors run the
plain versions, which compute on the same planes what
:func:`banded.admm_iterations` computes (the channel interval: its
collision-free function, equal to it on eta = 0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..solvers.banded import (RowVals, StateVars, apply_A, apply_A_static,
                              apply_AT, apply_AT_static, from_stacked,
                              solve_factorized_channel, to_stacked)
from ..utils import debug
from ..utils.profiling import host_write
from .admm_fused import _on_cpu, planes_to_rows, rho_planes, static_plane
from .cuda_build import SMS, check, load_kernels, require_f32_cuda
from .group_solve import SWEEP_MAX_N_WIDE

# The row stages' launch layout (csrc/admm_steps.cu): a block of
# ROW_THREADS threads takes k_tile steps of one lane, at most as many
# static rows as it has threads (admm_rhs) or about UPDATE_ITEMS items
# (admm_update: two neighbouring slots of a static row, or a collision
# row), and the grid has at least ROW_MIN_BLOCKS blocks where B * K allows
# (two a streaming multiprocessor of the H100)
ROW_THREADS = 256
UPDATE_ITEMS = 5 * ROW_THREADS
ROW_MIN_BLOCKS = 2 * SMS
SMEM_MAX = 232448
# The row stages serve every N the grouped sweeps serve: n = 6N up to
# group_solve.SWEEP_MAX_N_WIDE (N <= 1024)
ROW_STAGES_MAX_N = SWEEP_MAX_N_WIDE // 6
# The channel interval (csrc/admm_steps.cu admm_channel_interval_f32): a
# thread keeps up to CHANNEL_REG_STEPS steps in registers (K <= 64), the
# memory form ceil(K / 32) in its block's region (K <= 1184 in shared
# memory); a region that does not fit shared memory lies in a global
# scratch of CHANNEL_SCRATCH_BLOCKS regions.  The register form's tables:
# 3x3 matrices, L, M, N a step and the scans' ten, a thread of the warp;
# the memory form's steps: 42 floats a step.
CHANNEL_REG_STEPS = 2
CHANNEL_SCRATCH_BLOCKS = 2 * SMS
_WARP, _TAB_STEP, _TAB_SCAN, _STEP_FLOATS = 32, 3 * 9, 10 * 9, 42


class Rows(NamedTuple):
    """The ADMM state on planes, which the stages update in place: x
    stacked (B, K, 6N), the static rows of z and y as planes zs, ys
    (B, K, 6, 2N) (the jerk block's row K-1 is padding, kept at zero) and
    their collision rows zc, yc (B, K, P)."""
    x: torch.Tensor
    zs: torch.Tensor
    ys: torch.Tensor
    zc: torch.Tensor
    yc: torch.Tensor


class RowConsts(NamedTuple):
    """What the stages read and do not change, laid out once a
    factorization (:func:`row_consts`): eta (B, K, P, 2); E (N, P), the
    pair incidence the plain versions take; the static bounds l_s, u_s
    (B, K, 6, 2N); the collision lower bounds l_c (B, K, P); rho as
    (K, 6) or (B, K, 6) and (K, P) or (B, K, P) (``admm_fused.rho_planes``);
    fpar (4,) = (h, sigma, alpha, lam) in the state's dtype on its device,
    which the kernels read; and h (a float), sigma, alpha and lam as the
    solver gives them, which the plain versions take."""
    eta: torch.Tensor
    E: torch.Tensor
    l_s: torch.Tensor
    u_s: torch.Tensor
    l_c: torch.Tensor
    rho_s: torch.Tensor
    rho_c: torch.Tensor
    fpar: torch.Tensor
    h: float
    sigma: object
    alpha: object
    lam: object


def row_consts(eta, E, lower: RowVals, upper: RowVals, rho: RowVals, *,
               h: float, sigma, alpha, lam) -> RowConsts:
    """The constant operands of the stages, for B lanes of eta
    (B, K, P, 2); ``rho`` from ``banded.rho_pattern_masks`` (its collision
    rows may carry each lane's loose rho)."""
    B, K, P = eta.shape[:3]
    rho_s, rho_c = rho_planes(rho, K, P)
    fpar = torch.stack([
        (torch.as_tensor(v, dtype=eta.dtype)
         if torch.is_tensor(v) and v.device == eta.device else
         host_write("qp", v, dtype=eta.dtype, device=eta.device)).reshape(())
        for v in (h, sigma, alpha, lam)])
    return RowConsts(eta.contiguous(), E, static_plane(lower, K),
                     static_plane(upper, K),
                     lower.col.expand(B, K, P).contiguous(), rho_s, rho_c,
                     fpar, h, sigma, alpha, lam)


def pack_state(x: StateVars, z: RowVals, y: RowVals) -> Rows:
    """Fresh contiguous planes of the state (B lanes): on the card a copy a
    leaf and two fills."""
    B, N, K = x.a.shape[:3]
    xs = x.a.new_empty((B, K, 3, N, 2))
    for i, t in enumerate(x):
        xs[:, :, i].copy_(t.transpose(1, 2))
    return Rows(xs.view(B, K, 6 * N), static_plane(z, K), static_plane(y, K),
                z.col.clone(memory_format=torch.contiguous_format),
                y.col.clone(memory_format=torch.contiguous_format))


def unpack(rows: Rows, n_vehicles: int):
    """(x, z, y) as views of the planes."""
    return (from_stacked(rows.x, n_vehicles),
            planes_to_rows(rows.zs, rows.zc, n_vehicles),
            planes_to_rows(rows.ys, rows.yc, n_vehicles))


class RhsPlan(NamedTuple):
    """The launch of :func:`admm_rhs`: blocks of ``k_tile`` steps of one
    lane; ``table``: the table form, the tile's pair terms in a transposed
    table of ``smem_bytes`` of shared memory (else the direct form, which
    reads them from global memory)."""
    k_tile: int
    table: bool
    smem_bytes: int


def rhs_table_stride(N: int) -> int:
    """float2 entries between two rows of admm_rhs's pair table (the
    kernel's ``rhs_table_stride``): a vehicle's N - 1 partner terms,
    rounded up to an odd number so that a warp's rows fall on distinct
    banks."""
    return N - (N - 1) % 2


def rhs_table_bytes(k_tile: int, N: int) -> int:
    """Shared memory of the pair table of ``k_tile`` steps (the kernel's
    ``rhs_table_bytes``): a row of float2 a vehicle and step."""
    return 8 * k_tile * N * rhs_table_stride(N)


def rhs_plan(B: int, K: int, N: int) -> RhsPlan:
    """The launch of :func:`admm_rhs` for B lanes of N vehicles and K
    steps: as many steps a block as its ROW_THREADS threads have static
    rows (2N a step), fewer where the grid would have less than
    ROW_MIN_BLOCKS blocks, and fewer until the table leaves room for four
    blocks an SM; at least one.  The table form wherever one step's table
    fits a block's shared memory (N <= 170), else the direct form."""
    k_tile = min(K, max(1, ROW_THREADS // (2 * N)),
                 max(1, B * K // ROW_MIN_BLOCKS))
    if rhs_table_bytes(1, N) > SMEM_MAX:
        return RhsPlan(k_tile, False, 0)
    while k_tile > 1 and rhs_table_bytes(k_tile, N) > SMEM_MAX // 4:
        k_tile -= 1
    return RhsPlan(k_tile, True, rhs_table_bytes(k_tile, N))


def update_plan(B: int, K: int, N: int) -> int:
    """Steps of k a block of :func:`admm_update` takes: about UPDATE_ITEMS
    items (6N pairs of static slots and P collision rows a step), fewer
    where the grid would have less than ROW_MIN_BLOCKS blocks, at least
    one."""
    per_step = 6 * N + N * (N - 1) // 2
    by_work = max(1, UPDATE_ITEMS // per_step)
    by_fill = max(1, B * K // ROW_MIN_BLOCKS)
    return min(K, by_work, by_fill)


def row_stages_serve(K: int, N: int) -> bool:
    """Whether :func:`admm_rhs` and :func:`admm_update` serve K steps of N
    vehicles (the kernels' ``row_args_ok``): every N the grouped sweeps
    serve, N <= ROW_STAGES_MAX_N, with a lane's K (6N + P) static slots and
    collision rows within ``int`` indexing, which holds to K = 4052 at
    N = 1024, a lane of 600 GB of factors.  Neither stage keeps a pair
    table: ``admm_update`` finds a pair's vehicles in closed form,
    ``admm_rhs`` keeps its transposed table only up to N = 170."""
    return (1 <= N <= ROW_STAGES_MAX_N and K >= 2
            and K * (6 * N + N * (N - 1) // 2) < 2 ** 31)


class ChannelPlan(NamedTuple):
    """The launch of :func:`admm_channel_interval`: ``steps`` a thread in
    registers (1 or 2), or 0 for the memory form; ``warps`` the channels
    (warps) a block; ``in_smem``: each block's region lies in shared
    memory (else in a global scratch)."""
    steps: int
    warps: int
    in_smem: bool


def channel_region_floats(K: int, warps: int, steps: int) -> int:
    """Floats of one channel block's region (the kernel's
    ``admm_channel_region_floats``): the staging buffer of K (6 warps + 1)
    floats, and the register form's tables or the memory form's steps."""
    stage = K * (6 * warps + 1)
    if steps > 0:
        return stage + _WARP * (_TAB_STEP * steps + _TAB_SCAN)
    return stage + warps * _WARP * _STEP_FLOATS * -(-K // _WARP)


def channel_plan(B: int, K: int, N: int) -> ChannelPlan:
    """The channel interval's plan for B lanes of N vehicles and K steps:
    the steps in registers up to K = 64; the widest block of 4 or 2
    channels of one lane that leaves at most an eighth of its warps idle
    on the lane's 2N channels and still gives every streaming
    multiprocessor a block, else one channel a block (the memory form
    always)."""
    steps = next((s for s in range(1, CHANNEL_REG_STEPS + 1)
                  if K <= _WARP * s), 0)
    warps = 1
    if steps:
        n2 = 2 * N
        for w in (4, 2):
            slots = -(-n2 // w) * w
            if 8 * (slots - n2) <= slots and B * (slots // w) >= SMS:
                warps = w
                break
    return ChannelPlan(steps, warps, 4 * channel_region_floats(
        K, warps, steps) <= SMEM_MAX)


# ---------------------------------------------------------------------------
# Plain versions, on the planes
# ---------------------------------------------------------------------------

def admm_rhs_plain(rows: Rows, c: RowConsts, inv_rho=None) -> torch.Tensor:
    """Plain version of :func:`admm_rhs`: the right-hand side of
    :func:`banded.admm_iterations` on the planes, times ``inv_rho`` (B,) a
    lane where it is given."""
    N = rows.x.shape[-1] // 6
    rzy = planes_to_rows(c.rho_s[..., None] * rows.zs - rows.ys,
                         c.rho_c * rows.zc - rows.yc, N)
    b = to_stacked(apply_AT(rzy, c.eta, c.E, c.h)) + c.sigma * rows.x
    return b if inv_rho is None else b * inv_rho[:, None, None]


def _update_static(xt, Ax: RowVals, rows: Rows, c: RowConsts) -> None:
    """The relaxation of x and the clip and dual step of the static rows,
    from the sweep's solution xt and A xt's static rows, in place."""
    K = rows.x.shape[-2]
    alpha = c.alpha
    rows.x.copy_(alpha * xt + (1 - alpha) * rows.x)
    rho_s = c.rho_s[..., None]
    zr = alpha * static_plane(Ax, K) + (1 - alpha) * rows.zs
    zn = torch.clamp(zr + rows.ys / rho_s, c.l_s, c.u_s)
    rows.ys.copy_(rows.ys + rho_s * (zr - zn))
    rows.zs.copy_(zn)


def _update_collision(zr, rows: Rows, c: RowConsts) -> None:
    """The exact-penalty soft prox and dual step of the collision rows
    from their relaxed rows zr, in place."""
    w = zr + rows.yc / c.rho_c
    zn = torch.where(w >= c.l_c, w,
                     torch.minimum(w + c.lam / c.rho_c, c.l_c))
    rows.yc.copy_(rows.yc + c.rho_c * (zr - zn))
    rows.zc.copy_(zn)


def admm_update_plain(xt, rows: Rows, c: RowConsts) -> None:
    """Plain version of :func:`admm_update`: the update of
    :func:`banded.admm_iterations` from the sweep's solution xt
    (B, K, 6N), on the planes, in place."""
    N = rows.x.shape[-1] // 6
    Ax = apply_A(from_stacked(xt, N), c.eta, c.E, c.h)
    _update_static(xt, Ax, rows, c)
    _update_collision(c.alpha * Ax.col + (1 - c.alpha) * rows.zc, rows, c)


def admm_channel_interval_plain(Linv, Eb, rows: Rows, c: RowConsts,
                                n_iters: int) -> None:
    """Plain version of :func:`admm_channel_interval`: ``n_iters``
    iterations of the collision-free QP, in place.  The static rows by
    channel: b = A^T (rho z - y) + sigma x over the static rows alone
    (``banded.apply_AT_static``), ``banded.solve_factorized_channel``, and
    the update of :func:`admm_update_plain` from A xt's static rows; each
    collision row its recurrence with A xt = 0 (zr = (1 - alpha) z).
    ``c.eta`` is not read: on eta = 0, where A^T's collision term and A's
    collision rows are exactly 0 for a finite state, this equals
    ``n_iters`` times :func:`admm_rhs_plain`,
    ``banded.solve_factorized_channel`` and :func:`admm_update_plain`
    exactly."""
    B, K, n = rows.x.shape
    N = n // 6
    for _ in range(n_iters):
        rz = planes_to_rows(c.rho_s[..., None] * rows.zs - rows.ys, None, N)
        b = to_stacked(apply_AT_static(rz, c.h)) + c.sigma * rows.x
        xt = solve_factorized_channel(
            Linv, Eb, b.reshape(B, K, 3, n // 3)).reshape(B, K, n)
        _update_static(xt, apply_A_static(from_stacked(xt, N), c.h), rows,
                       c)
        _update_collision((1 - c.alpha) * rows.zc, rows, c)


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

def _operands(what: str, rows: Rows, c: RowConsts, channel: bool = False,
              **extra) -> tuple:
    """Check the planes of a stage (float32, contiguous, on one card, of
    the shapes of :class:`Rows` and :class:`RowConsts`; admm_rhs and
    admm_update at the N and K of :func:`row_stages_serve`; the channel
    interval reads no eta and no pairs, and its kernel checks its own
    limits); returns (B, K, N) and the per-lane strides of rho_s and rho_c
    (0: batch-shared)."""
    if not channel:
        extra = dict(extra, eta=c.eta)
    require_f32_cuda(what, **rows._asdict(), l_s=c.l_s, u_s=c.u_s,
                     l_c=c.l_c, rho_s=c.rho_s, rho_c=c.rho_c, fpar=c.fpar,
                     **extra)
    B, K, n = rows.x.shape
    N = n // 6
    P = N * (N - 1) // 2
    sp, cp = (B, K, 6, 2 * N), (B, K, P)
    want = dict(zs=sp, ys=sp, zc=cp, yc=cp, l_s=sp, u_s=sp, l_c=cp,
                fpar=(4,))
    got = dict(rows._asdict(), l_s=c.l_s, u_s=c.u_s, l_c=c.l_c, fpar=c.fpar)
    if not channel:
        want.update(eta=(B, K, P, 2))
        got.update(eta=c.eta)
    bad = [name for name, shape in want.items()
           if tuple(got[name].shape) != shape]
    if (n % 6 or K < 2 or bad or not (channel or row_stages_serve(K, N))
            or tuple(c.rho_s.shape) not in ((K, 6), (B, K, 6))
            or tuple(c.rho_c.shape) not in ((K, P), (B, K, P))):
        raise ValueError(f"{what}: unsupported shapes: x {tuple(rows.x.shape)}"
                         f", {bad}, rho {tuple(c.rho_s.shape)} "
                         f"{tuple(c.rho_c.shape)}")
    return (B, K, N), [t[0].numel() if t.dim() == 3 else 0
                       for t in (c.rho_s, c.rho_c)]


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def admm_rhs(rows: Rows, c: RowConsts, inv_rho=None) -> torch.Tensor:
    """b (B, K, 6N) = A^T (rho z - y) + sigma x from the planes, times the
    lane's ``inv_rho`` (B,) where it is given, in the layout the sweep
    kernels read.  CUDA tensors launch the kernel (float32, contiguous;
    anything else raises), CPU tensors run the plain version."""
    if _on_cpu("admm_rhs", rows.x):
        return admm_rhs_plain(rows, c, inv_rho)
    extra = {} if inv_rho is None else dict(inv_rho=inv_rho)
    (B, K, N), strides = _operands("admm_rhs", rows, c, **extra)
    if inv_rho is not None and tuple(inv_rho.shape) != (B,):
        raise ValueError(f"admm_rhs: inv_rho {tuple(inv_rho.shape)}, not "
                         f"({B},)")
    # the kernel reads eta's two axes as float2
    if c.eta.data_ptr() % 8:
        raise ValueError("admm_rhs: eta must start 8-byte aligned")
    plan = rhs_plan(B, K, N)
    b = torch.empty_like(rows.x)
    lib = load_kernels()
    with torch.cuda.device(b.device):
        err = lib.admm_rhs_f32(
            c.fpar.data_ptr(), c.eta.data_ptr(), c.rho_s.data_ptr(),
            c.rho_c.data_ptr(),
            None if inv_rho is None else inv_rho.data_ptr(),
            *(t.data_ptr() for t in rows), b.data_ptr(), B, K, N,
            plan.k_tile, int(plan.table), *strides, _stream(b))
    check(err, "admm_rhs")
    admm_rhs.launches += 1
    debug.report("admm_rhs", b)
    return b


admm_rhs.launches = 0


def admm_update(xt, rows: Rows, c: RowConsts) -> None:
    """From the sweep's solution xt (B, K, 6N): x = alpha xt + (1 - alpha) x,
    zr = alpha A xt + (1 - alpha) z, z = clip(zr + y / rho, l, u) on the
    static rows and the exact-penalty prox (weight ``lam``, +inf for hard
    rows; rows disabled by a -inf lower bound keep zr + y / rho) on the
    collision rows, y += rho (zr - z); the planes are updated in place.
    CUDA tensors launch the kernel (float32, contiguous; anything else
    raises), CPU tensors run the plain version."""
    if _on_cpu("admm_update", rows.x):
        return admm_update_plain(xt, rows, c)
    (B, K, N), strides = _operands("admm_update", rows, c, xt=xt)
    if xt.shape != rows.x.shape:
        raise ValueError(f"admm_update: xt {tuple(xt.shape)}, not "
                         f"{tuple(rows.x.shape)}")
    # the kernel moves neighbouring static slots as float2
    if any(t.data_ptr() % 8 for t in (xt, rows.x, rows.zs, rows.ys, c.l_s,
                                      c.u_s)):
        raise ValueError("admm_update: the x and static planes must start "
                         "8-byte aligned")
    lib = load_kernels()
    with torch.cuda.device(xt.device):
        err = lib.admm_update_f32(
            c.fpar.data_ptr(), c.eta.data_ptr(), c.l_s.data_ptr(),
            c.u_s.data_ptr(), c.l_c.data_ptr(), c.rho_s.data_ptr(),
            c.rho_c.data_ptr(), xt.data_ptr(),
            *(t.data_ptr() for t in rows), B, K, N, update_plan(B, K, N),
            *strides, _stream(xt))
    check(err, "admm_update")
    admm_update.launches += 1
    debug.report("admm_update", *rows)


admm_update.launches = 0


def admm_channel_interval(Linv, Eb, rows: Rows, c: RowConsts,
                          n_iters: int) -> None:
    """``n_iters`` ADMM iterations of the collision-free QP on the
    per-channel factors of ``banded.factorize(*assemble_channel(...))``:
    Linv (K, 3, 3) and Eb (K-1, 3, 3) shared by every lane, or
    (B, K, 3, 3) and (B, K-1, 3, 3) one set a lane (adaptive rho); the
    planes are updated in place.

    The function is the one ``banded.admm_iterations`` computes on the
    channel route, which phase 1 defines by eta = 0 (JAX
    ``ba_path_planning_tpu/solvers/banded.py:1192-1202``): with eta = 0
    A^T's collision term and A's collision rows are exactly 0 for a finite
    state, so ``c.eta`` and the pairs are not read, the static rows are 2N
    independent channel problems a lane, and each collision row runs its
    exact-penalty prox and dual step with A xt = 0 (any finite collision
    state, any lower bounds).  The kernel indexes the batch's collision
    rows as ``int``: B K P < 2^31, at N = 342 and K = 50 B <= 736 lanes a
    launch; the grouped routes' chunks at that N are far smaller, since a
    lane's float32 X-form factors alone take 842 MB.  CUDA tensors launch
    the kernel (float32, contiguous; anything else raises), CPU tensors
    run the plain version."""
    if _on_cpu("admm_channel_interval", rows.x):
        return admm_channel_interval_plain(Linv, Eb, rows, c, n_iters)
    (B, K, N), strides = _operands("admm_channel_interval", rows, c,
                                   channel=True, Linv=Linv, Eb=Eb)
    lane = Linv.dim() == 4
    if (Linv.shape != ((B,) if lane else ()) + (K, 3, 3)
            or Eb.shape != Linv.shape[:-3] + (K - 1, 3, 3)):
        raise ValueError(f"admm_channel_interval: unsupported factors "
                         f"{tuple(Linv.shape)}, {tuple(Eb.shape)} for "
                         f"B={B}, K={K}")
    plan = channel_plan(B, K, N)
    scratch, blocks = None, 2 ** 31 - 1
    if not plan.in_smem:
        blocks = CHANNEL_SCRATCH_BLOCKS
        scratch = rows.x.new_empty(
            blocks * channel_region_floats(K, plan.warps, plan.steps))
    lib = load_kernels()
    with torch.cuda.device(Linv.device):
        err = lib.admm_channel_interval_f32(
            c.fpar.data_ptr(), Linv.data_ptr(), Eb.data_ptr(),
            c.l_s.data_ptr(), c.u_s.data_ptr(), c.l_c.data_ptr(),
            c.rho_s.data_ptr(), c.rho_c.data_ptr(),
            *(t.data_ptr() for t in rows),
            None if scratch is None else scratch.data_ptr(), B, K, N,
            int(n_iters), *strides, int(lane), plan.steps, plan.warps,
            blocks, _stream(Linv))
    check(err, "admm_channel_interval")
    admm_channel_interval.launches += 1
    debug.report("admm_channel_interval", *rows)


admm_channel_interval.launches = 0


# ---------------------------------------------------------------------------
# Check intervals
# ---------------------------------------------------------------------------

def sweep_interval(solve, c: RowConsts, n_iters: int, inv_rho=None):
    """The function (x, z, y) -> (x, z, y) of one check interval on a sweep
    route: the state packed once, ``n_iters`` times :func:`admm_rhs`,
    ``solve`` (b (B, K, 6N) -> xt, the route's sweep) and
    :func:`admm_update`, and views of the planes returned."""
    def run(x, z, y):
        rows = pack_state(x, z, y)
        for _ in range(n_iters):
            admm_update(solve(admm_rhs(rows, c, inv_rho)), rows, c)
        return unpack(rows, x.a.shape[-3])
    return run


def channel_interval(Linv, Eb, c: RowConsts, n_iters: int):
    """The function (x, z, y) -> (x, z, y) of one check interval of the
    collision-free QP: the state packed once, one
    :func:`admm_channel_interval`, views of the planes returned."""
    def run(x, z, y):
        rows = pack_state(x, z, y)
        admm_channel_interval(Linv, Eb, rows, c, n_iters)
        return unpack(rows, x.a.shape[-3])
    return run
