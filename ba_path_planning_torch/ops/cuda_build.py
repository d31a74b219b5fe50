"""Build and load the port's CUDA kernels.

The sources in ``ba_path_planning_torch/csrc/`` have a plain C interface.
At first use each is compiled by its own ``nvcc`` for ``sm_90a``, all
started together, and the objects are linked into one shared library under
``build/kernels/`` at the root of the checkout, named by a hash of the
sources and flags, and loaded with ``ctypes``.  A later call with the same
sources loads the library that is already there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("ns_chain.cu", "group_solve_x.cu", "admm_fused_x.cu",
           "group_solve_l.cu", "banded_solve.cu", "admm_fused_l.cu")
# included by the sources above
HEADERS = ("sweeps.cuh", "admm_rows.cuh", "factor_ring.cuh",
           "group_sweep.cuh", "admm_fused.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((_CSRC / name).read_bytes())
    out = _BUILD / f"libbapp_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, log="(cached)")
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [_BUILD / f"{tag}.{Path(name).stem}.o" for name in SOURCES]
    tmp = _BUILD / f"{tag}.so.tmp"
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(_CSRC / name)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for name, obj in zip(SOURCES, objs)]
    logs = [f"{name}:\n{proc.communicate()[0]}"
            for name, proc in zip(SOURCES, procs)]
    try:
        failed = [log for log, proc in zip(logs, procs) if proc.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        link = subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      log="\n".join(logs))
    return out


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ns_chain_scratch_floats.argtypes = [i]
    lib.ns_chain_scratch_floats.restype = i
    lib.ns_chain_interior_f32.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.ns_chain_interior_f32.restype = i
    for sweep in (lib.group_solve_x_f32, lib.group_solve_l_f32,
                  lib.banded_solve_f32):
        sweep.argtypes = [p, p, p, p] + [i] * 6 + [p]
        sweep.restype = i
    # the X form also takes the plan's packed flag
    lib.admm_fused_x_f32.argtypes = [p] * 15 + [i] * 7 + [p]
    lib.admm_fused_l_f32.argtypes = [p] * 15 + [i] * 6 + [p]
    for fused in (lib.admm_fused_x_f32, lib.admm_fused_l_f32):
        fused.restype = i
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def require_f32_cuda(what: str, **tensors) -> None:
    """Raise unless every tensor is float32, contiguous and on one CUDA
    device."""
    dev = None
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is not a CUDA tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}, the kernel takes "
                            "float32 only")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        if dev is not None and t.device != dev:
            raise ValueError(f"{what}: tensors on different devices")
        dev = t.device
