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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..solvers.banded import (RowVals, StateVars, admm_iterations,
                              from_stacked, solve_factorized,
                              solve_factorized_X, to_stacked)
from .cuda_build import check, load_kernels, require_f32_cuda

SLOTS = ("dyn_p", "dyn_v", "jerk", "acc", "vbox", "pbox")


def static_plane(rv: RowVals, n_steps: int) -> torch.Tensor:
    """The static rows of ``rv`` ((B, N, K', 2) leaves) as a new contiguous
    plane (B, K, 6, 2N); the jerk block is padded with a zero row at K-1."""
    planes = []
    for name in SLOTS:
        t = getattr(rv, name).transpose(-3, -2)
        t = t.reshape(t.shape[:-2] + (-1,))
        planes.append(F.pad(t, (0, 0, 0, n_steps - t.shape[-2])))
    return torch.stack(planes, dim=-2)


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
    """Batch-shared rho from :func:`banded.rho_pattern_masks` -> (K, 6)
    per-(k, slot) scalars (the jerk row K-1 is padding) and (K, P)."""
    cols = []
    for name in SLOTS:
        leaf = getattr(rho, name)
        if leaf.dim() != 2 or leaf.shape[-1] != 1:
            raise ValueError(
                "the fused ADMM kernels need batch-shared (K', 1) rho leaves "
                "(banded.rho_pattern_masks)")
        cols.append(F.pad(leaf, (0, 0, 0, n_steps - leaf.shape[0]),
                          value=1.0))
    rho_c = rho.col.expand(n_steps, n_pairs).contiguous()
    return torch.cat(cols, dim=-1).contiguous(), rho_c


def _launch(wrapper, entry: str, factors: dict, eta, E, lower: RowVals,
            upper: RowVals, x: StateVars, z: RowVals, y: RowVals,
            rho: RowVals, *, h: float, sigma, alpha, lam, n_iters: int):
    """Lay the rows out as planes, launch ``entry`` of the kernel library
    on the two factor tensors (their shapes checked by the caller) and
    count the launch on ``wrapper``.  The inputs are not modified."""
    what = wrapper.__name__
    B, K = eta.shape[:2]
    N, P = E.shape
    n = 6 * N
    # fresh contiguous copies of the state: the kernel updates them in place
    zs, ys = static_plane(z, K), static_plane(y, K)
    zc, yc = (t.clone(memory_format=torch.contiguous_format)
              for t in (z.col, y.col))
    xs = to_stacked(x)
    rho_s, rho_c = rho_planes(rho, K, P)
    fpar = torch.stack([torch.as_tensor(v, dtype=eta.dtype, device=eta.device)
                        .reshape(()) for v in (h, sigma, alpha, lam)])
    tensors = dict(fpar=fpar, **factors, eta=eta,
                   l_s=static_plane(lower, K), u_s=static_plane(upper, K),
                   l_c=lower.col.contiguous(), rho_s=rho_s, rho_c=rho_c, x=xs,
                   zs=zs, ys=ys, zc=zc, yc=yc)
    require_f32_cuda(what, **tensors)
    sp, cp = (B, K, 6, 2 * N), (B, K, P)
    for name, want in dict(l_s=sp, u_s=sp, l_c=cp, x=(B, K, n), zs=sp, ys=sp,
                           zc=cp, yc=cp).items():
        if tensors[name].shape != want:
            raise ValueError(f"{what}: {name} is "
                             f"{tuple(tensors[name].shape)}, not {want}")
    # the kernel's sweep plane, used where it does not fit in shared memory
    plane = torch.empty((B, K, n), dtype=eta.dtype, device=eta.device)
    lib = load_kernels()
    with torch.cuda.device(eta.device):
        err = getattr(lib, entry)(
            *(t.data_ptr() for t in tensors.values()), plane.data_ptr(), B, K,
            N, int(n_iters), torch.cuda.current_stream(eta.device).cuda_stream)
    check(err, what)
    wrapper.launches += 1
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
                          **step):
    """``n_iters`` ADMM iterations for a batch, returning the new (x, z, y).

    X (B, K, 6N, 6N) symmetric block inverses and C (K-1, 3, 3) shared slot
    scalars from ``banded.factorize_X``; eta (B, K, P, 2) and E (N, P) the
    collision directions and the pair incidence (``triu_indices`` order);
    lower/upper the row bounds (``upper.col`` is not read: the collision
    rows have the exact-penalty prox with weight ``lam``, which may be
    +inf for hard rows); x, z, y the ADMM state; rho the batch-shared rho of
    ``banded.rho_pattern_masks``; ``step`` the keywords h, sigma, alpha, lam
    and n_iters.  CUDA tensors launch the kernel (float32, X, C and eta
    contiguous; anything else raises); CPU tensors run the plain version.
    The inputs are not modified."""
    if _on_cpu("admm_interval_fused_X", X):
        return admm_interval_fused_X_plain(X, C, eta, E, lower, upper, x, z,
                                           y, rho, **step)
    B, K, n = X.shape[:3]
    N, P = E.shape
    if (X.shape != (B, K, n, n) or n != 6 * N or C.shape != (K - 1, 3, 3)
            or eta.shape != (B, K, P, 2) or P != N * (N - 1) // 2):
        raise ValueError(
            f"admm_interval_fused_X: unsupported shapes X {tuple(X.shape)}, "
            f"C {tuple(C.shape)}, eta {tuple(eta.shape)}, E {tuple(E.shape)}")
    return _launch(admm_interval_fused_X, "admm_fused_x_f32", dict(C=C, X=X),
                   eta, E,
                   lower, upper, x, z, y, rho, **step)


admm_interval_fused_X.launches = 0


def admm_interval_fused_plain(Linv, Eb, eta, E, lower: RowVals,
                              upper: RowVals, x: StateVars, z: RowVals,
                              y: RowVals, rho: RowVals, *, h: float, sigma,
                              alpha, lam, n_iters: int):
    """Plain version of the kernel: ``n_iters`` iterations of
    :func:`banded.admm_iterations` with the dense sweeps of
    ``banded.solve_factorized``."""
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
    the diagonal.  It serves 6N <= 512."""
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
    return _launch(admm_interval_fused, "admm_fused_l_f32",
                   dict(Linv=Linv, Eb=Eb), eta, E,
                   lower, upper, x, z, y, rho, **step)


admm_interval_fused.launches = 0
