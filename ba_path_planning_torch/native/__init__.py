"""Native (C++) host-side QP solver binding (counterpart of
``ba_path_planning_tpu.native``, with its own copy of ``scp_qp.cpp``).

At first use :func:`load_library` builds the source with ``g++`` into
``build/native/`` at the root of the checkout (git-ignored), named by a hash
of the source and flags, and loads it through ctypes; importing the module
builds nothing.  :class:`NativeQP` is the equilibrated matrix-free ADMM of
``solvers/admm.py`` on the host CPU, an independent implementation for
differential tests.  Its arrays may be numpy arrays or CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "scp_qp.cpp"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib = None


def _build() -> Path:
    """The library for the current source, compiled if it is not there
    yet (into a temporary file renamed into place, so concurrent processes
    never load a half-written library)."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
    lib = _BUILD / f"libscp_qp-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    _BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(_SRC)], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load_library():
    """Load (building if needed) the native solver library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build()))
    d = ctypes.c_double
    dp = ctypes.POINTER(ctypes.c_double)
    lib.scp_qp_create.restype = ctypes.c_void_p
    lib.scp_qp_create.argtypes = [ctypes.c_int, ctypes.c_int, d]
    lib.scp_qp_destroy.restype = None
    lib.scp_qp_destroy.argtypes = [ctypes.c_void_p]
    lib.scp_qp_set_settings.restype = None
    lib.scp_qp_set_settings.argtypes = [ctypes.c_void_p, d, d, d, d, d,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int]
    for name in ("scp_qp_set_precond", "scp_qp_set_bounds",
                 "scp_qp_set_scaling"):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [ctypes.c_void_p, dp, dp]
    lib.scp_qp_set_collision.restype = None
    lib.scp_qp_set_collision.argtypes = [ctypes.c_void_p, dp, d]
    lib.scp_qp_solve.restype = ctypes.c_int
    lib.scp_qp_solve.argtypes = [ctypes.c_void_p, dp, dp, dp]
    _lib = lib
    return lib


def _f64(a, size: int, what: str) -> np.ndarray:
    """A contiguous float64 host copy of a numpy array or CPU tensor,
    checked to hold ``size`` values."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    a = np.ascontiguousarray(a, dtype=np.float64)
    if a.size != size:
        raise ValueError(f"NativeQP: {what} has {a.size} values, not {size}")
    return a


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeQP:
    """One QP instance:  min ||x||^2  s.t.  l <= A x <= u  on the host.

    Row buffers are concatenated in block order jerk|acc|vel|pos|col,
    matching ``ConstraintBlocks`` flattened per block.
    """

    def __init__(self, n_vehicles: int, n_steps: int, h: float):
        self.lib = load_library()
        self.N, self.K, self.h = n_vehicles, n_steps, h
        self.P = n_vehicles * (n_vehicles - 1) // 2
        self.handle = self.lib.scp_qp_create(n_vehicles, n_steps,
                                             ctypes.c_double(h))
        self.n = 2 * n_vehicles * n_steps
        self.m = (2 * self.N * (self.K - 1) + 3 * 2 * self.N * self.K
                  + self.K * self.P)

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.scp_qp_destroy(self.handle)
            self.handle = None

    def set_settings(self, *, rho=0.1, sigma=1e-6, alpha=1.6, eps_abs=1e-3,
                     eps_rel=1e-3, max_iter=4000, check_interval=25,
                     cg_iters=10):
        self.lib.scp_qp_set_settings(self.handle, rho, sigma, alpha, eps_abs,
                                     eps_rel, max_iter, check_interval,
                                     cg_iters)

    def set_precond(self, Q, lam):
        Q = _f64(Q, self.K * self.K, "Q")
        lam = _f64(lam, self.K, "lam")
        self.lib.scp_qp_set_precond(self.handle, _ptr(Q), _ptr(lam))

    def set_bounds(self, lower, upper):
        lower = _f64(lower, self.m, "lower")
        upper = _f64(upper, self.m, "upper")
        self.lib.scp_qp_set_bounds(self.handle, _ptr(lower), _ptr(upper))

    def set_scaling(self, d_rows, rho_rows):
        d_rows = _f64(d_rows, self.m, "d_rows")
        rho_rows = _f64(rho_rows, self.m, "rho_rows")
        self.lib.scp_qp_set_scaling(self.handle, _ptr(d_rows), _ptr(rho_rows))

    def set_collision(self, eta, col_mask: float):
        eta = _f64(eta, self.K * self.P * 2, "eta")
        self.lib.scp_qp_set_collision(self.handle, _ptr(eta),
                                      ctypes.c_double(col_mask))

    def solve(self, x_init):
        x_init = _f64(x_init, self.n, "x_init")
        x_out = np.zeros(self.n)
        info = np.zeros(4)
        self.lib.scp_qp_solve(self.handle, _ptr(x_init), _ptr(x_out),
                              _ptr(info))
        return (x_out.reshape(self.N, self.K, 2),
                dict(iters=int(info[0]), prim_res=float(info[1]),
                     dual_res=float(info[2]), converged=bool(info[3])))
