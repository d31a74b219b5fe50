"""Build and load the port's CUDA kernels.

The sources in ``ba_path_planning_torch/csrc/`` have a plain C interface.
At first use they are compiled with ``nvcc`` for ``sm_90a`` into one shared
library under ``build/kernels/`` at the root of the checkout, named by a hash
of the sources and flags, and loaded with ``ctypes``.  A later call with the
same sources loads the library that is already there.
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
SOURCES = ("ns_chain.cu", "group_solve_x.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    for name in SOURCES:
        h.update((_CSRC / name).read_bytes())
    out = _BUILD / f"libbapp_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, log="(cached)")
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(_CSRC / name) for name in SOURCES]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      log=proc.stdout + proc.stderr)
    return out


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ns_chain_ld.argtypes = [i]
    lib.ns_chain_ld.restype = i
    lib.ns_chain_t_in_smem.argtypes = [i]
    lib.ns_chain_t_in_smem.restype = i
    lib.ns_chain_interior_f32.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.ns_chain_interior_f32.restype = i
    lib.group_solve_x_f32.argtypes = [p, p, p, p, i, i, i, p]
    lib.group_solve_x_f32.restype = i
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
