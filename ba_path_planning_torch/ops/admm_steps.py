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

and the collision-free phase-1 QP (``"channel"``) runs each check interval
in one launch, :func:`admm_channel_interval`.  The state lies on the planes
of the fused kernels (``ops/admm_fused.py``): x stacked (B, K, 6N), the
static rows of z and y as (B, K, 6, 2N), their collision rows (B, K, P);
it is packed once an interval (:func:`pack_state`) and the interval returns
views of it.  CUDA tensors launch the kernels (float32; anything else
raises), CPU tensors run the plain versions, which compute on the same
planes what :func:`banded.admm_iterations` computes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..solvers.banded import (RowVals, StateVars, apply_A, apply_AT,
                              from_stacked, solve_factorized_channel,
                              to_stacked)
from ..utils import debug
from .admm_fused import _on_cpu, planes_to_rows, rho_planes, static_plane
from .cuda_build import check, load_kernels, require_f32_cuda

# The row stages' launch layout (csrc/admm_steps.cu): a block of
# ROW_THREADS threads takes k_tile steps of one lane, at most about
# ROW_ITEMS rows, and the grid has at least ROW_MIN_BLOCKS blocks where
# B * K allows (two a streaming multiprocessor of the H100)
ROW_THREADS = 256
ROW_ITEMS = 2 * ROW_THREADS
ROW_MIN_BLOCKS = 2 * 132
SMEM_MAX = 232448


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
    fpar = torch.stack([torch.as_tensor(v, dtype=eta.dtype,
                                        device=eta.device).reshape(())
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


def row_plan(B: int, K: int, N: int) -> int:
    """Steps of k a block of :func:`admm_rhs` and :func:`admm_update` takes:
    about ROW_ITEMS rows (2N static and P collision rows a step), fewer
    where the grid would have less than ROW_MIN_BLOCKS blocks, at least
    one."""
    per_step = 2 * N + N * (N - 1) // 2
    by_work = max(1, ROW_ITEMS // per_step)
    by_fill = max(1, B * K // ROW_MIN_BLOCKS)
    return min(K, by_work, by_fill)


def pair_table_fits(N: int) -> bool:
    """Whether the pair table of N vehicles (two 16-bit indices a pair),
    which admm_update and the channel interval keep in shared memory,
    fits there: N <= 341."""
    return 2 * N * (N - 1) <= SMEM_MAX


def channel_smem_bytes(K: int, N: int, plane: bool) -> int:
    """Dynamic shared memory of an :func:`admm_channel_interval` block (the
    kernel's ``admm_channel_smem_bytes``): the (K, 6N) float32 plane where
    ``plane``, and the pair table."""
    return 4 * K * 6 * N * int(plane) + 2 * N * (N - 1)


def channel_plane_in_smem(K: int, N: int) -> bool:
    """Whether the channel interval keeps its sweep plane in shared memory
    (else in a global scratch)."""
    return channel_smem_bytes(K, N, True) <= SMEM_MAX


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


def admm_update_plain(xt, rows: Rows, c: RowConsts) -> None:
    """Plain version of :func:`admm_update`: the update of
    :func:`banded.admm_iterations` from the sweep's solution xt
    (B, K, 6N), on the planes, in place."""
    N, K = rows.x.shape[-1] // 6, rows.x.shape[-2]
    alpha, lam = c.alpha, c.lam
    Ax = apply_A(from_stacked(xt, N), c.eta, c.E, c.h)
    rows.x.copy_(alpha * xt + (1 - alpha) * rows.x)
    rho_s = c.rho_s[..., None]
    zr = alpha * static_plane(Ax, K) + (1 - alpha) * rows.zs
    zn = torch.clamp(zr + rows.ys / rho_s, c.l_s, c.u_s)
    rows.ys.copy_(rows.ys + rho_s * (zr - zn))
    rows.zs.copy_(zn)
    # exact-penalty soft prox on the collision rows
    zr = alpha * Ax.col + (1 - alpha) * rows.zc
    w = zr + rows.yc / c.rho_c
    zn = torch.where(w >= c.l_c, w,
                     torch.minimum(w + lam / c.rho_c, c.l_c))
    rows.yc.copy_(rows.yc + c.rho_c * (zr - zn))
    rows.zc.copy_(zn)


def admm_channel_interval_plain(Linv, Eb, rows: Rows, c: RowConsts,
                                n_iters: int) -> None:
    """Plain version of :func:`admm_channel_interval`: ``n_iters`` times
    :func:`admm_rhs_plain`, ``banded.solve_factorized_channel`` and
    :func:`admm_update_plain`, in place."""
    B, K, n = rows.x.shape
    for _ in range(n_iters):
        b = admm_rhs_plain(rows, c)
        xt = solve_factorized_channel(Linv, Eb, b.reshape(B, K, 3, n // 3))
        admm_update_plain(xt.reshape(B, K, n), rows, c)


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

def _operands(what: str, rows: Rows, c: RowConsts, **extra) -> tuple:
    """Check the planes of a stage (float32, contiguous, on one card, of
    the shapes of :class:`Rows` and :class:`RowConsts`); returns (B, K, N)
    and the per-lane strides of rho_s and rho_c (0: batch-shared)."""
    require_f32_cuda(what, **rows._asdict(), eta=c.eta, l_s=c.l_s,
                     u_s=c.u_s, l_c=c.l_c, rho_s=c.rho_s, rho_c=c.rho_c,
                     fpar=c.fpar, **extra)
    B, K, n = rows.x.shape
    N = n // 6
    P = N * (N - 1) // 2
    sp, cp = (B, K, 6, 2 * N), (B, K, P)
    want = dict(zs=sp, ys=sp, zc=cp, yc=cp, eta=(B, K, P, 2), l_s=sp,
                u_s=sp, l_c=cp, fpar=(4,))
    got = dict(rows._asdict(), eta=c.eta, l_s=c.l_s, u_s=c.u_s, l_c=c.l_c,
               fpar=c.fpar)
    bad = [name for name, shape in want.items()
           if tuple(got[name].shape) != shape]
    if (n % 6 or K < 2 or bad or not pair_table_fits(N)
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
    b = torch.empty_like(rows.x)
    lib = load_kernels()
    with torch.cuda.device(b.device):
        err = lib.admm_rhs_f32(
            c.fpar.data_ptr(), c.eta.data_ptr(), c.rho_s.data_ptr(),
            c.rho_c.data_ptr(),
            None if inv_rho is None else inv_rho.data_ptr(),
            *(t.data_ptr() for t in rows), b.data_ptr(), B, K, N,
            row_plan(B, K, N), *strides, _stream(b))
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
    lib = load_kernels()
    with torch.cuda.device(xt.device):
        err = lib.admm_update_f32(
            c.fpar.data_ptr(), c.eta.data_ptr(), c.l_s.data_ptr(),
            c.u_s.data_ptr(), c.l_c.data_ptr(), c.rho_s.data_ptr(),
            c.rho_c.data_ptr(), xt.data_ptr(),
            *(t.data_ptr() for t in rows), B, K, N, row_plan(B, K, N),
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
    planes are updated in place.  CUDA tensors launch the kernel (float32,
    contiguous; anything else raises), CPU tensors run the plain
    version."""
    if _on_cpu("admm_channel_interval", rows.x):
        return admm_channel_interval_plain(Linv, Eb, rows, c, n_iters)
    (B, K, N), strides = _operands("admm_channel_interval", rows, c,
                                   Linv=Linv, Eb=Eb)
    lane = Linv.dim() == 4
    if (Linv.shape != ((B,) if lane else ()) + (K, 3, 3)
            or Eb.shape != Linv.shape[:-3] + (K - 1, 3, 3)):
        raise ValueError(f"admm_channel_interval: unsupported factors "
                         f"{tuple(Linv.shape)}, {tuple(Eb.shape)} for "
                         f"B={B}, K={K}")
    plane = None if channel_plane_in_smem(K, N) else torch.empty_like(rows.x)
    lib = load_kernels()
    with torch.cuda.device(Linv.device):
        err = lib.admm_channel_interval_f32(
            c.fpar.data_ptr(), Linv.data_ptr(), Eb.data_ptr(),
            c.eta.data_ptr(), c.l_s.data_ptr(), c.u_s.data_ptr(),
            c.l_c.data_ptr(), c.rho_s.data_ptr(), c.rho_c.data_ptr(),
            *(t.data_ptr() for t in rows),
            None if plane is None else plane.data_ptr(), B, K, N,
            int(n_iters), *strides, int(lane), _stream(Linv))
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
