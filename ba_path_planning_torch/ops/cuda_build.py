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
           "group_solve_l.cu", "banded_solve.cu", "admm_fused_l.cu",
           "admm_steps.cu", "assemble_d.cu")
# included by the sources above
HEADERS = ("sweeps.cuh", "admm_rows.cuh", "factor_ring.cuh",
           "group_sweep.cuh", "admm_fused.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# bf16 factors lie with the rows of each block on a stride of a multiple of
# this many elements (16 bytes), the alignment of the kernels' bulk copies
BF16_ROW_ALIGN = 8
# streaming multiprocessors of the H100 SXM: the plans' default where no
# card is given (the launches plan on :func:`device_sms`)
SMS = 132

_lib = None
build_info: dict = {}


def bf16_row_stride(n: int) -> int:
    """Elements between two rows of a bf16 factor block of n columns: n
    rounded up to a multiple of :data:`BF16_ROW_ALIGN`."""
    return -(-n // BF16_ROW_ALIGN) * BF16_ROW_ALIGN


def device_sms(device) -> int:
    """Streaming multiprocessors of the card ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def padded_strides(shape, ld: int) -> tuple:
    """The strides of a (..., rows, n) view of a contiguous (..., rows, ld)
    tensor."""
    out, step = [1], ld
    for size in reversed(tuple(shape)[:-1]):
        out.append(step)
        step *= size
    return tuple(reversed(out))


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
    lib.ns_chain_scratch_floats.argtypes = [i, i]
    lib.ns_chain_scratch_floats.restype = i
    lib.ns_chain_interior_f32.argtypes = [p, p, p, p] + [i] * 8 + [p]
    lib.ns_chain_interior_f32.restype = i
    for sweep in (lib.group_solve_x_f32, lib.group_solve_l_f32,
                  lib.banded_solve_f32):
        sweep.argtypes = [p, p, p, p] + [i] * 7 + [p]
        sweep.restype = i
    # the bf16 entries also take the factors' row stride
    for sweep in (lib.group_solve_x_bf16, lib.group_solve_l_bf16,
                  lib.banded_solve_bf16):
        sweep.argtypes = [p, p, p, p] + [i] * 8 + [p]
        sweep.restype = i
    # the wide tiers: vbuf, then the plan's spread for the cluster
    for form in ("x", "l"):
        getattr(lib, f"group_solve_{form}_wide_f32").argtypes = (
            [p] * 5 + [i] * 7 + [p])
        getattr(lib, f"group_solve_{form}_wide_bf16").argtypes = (
            [p] * 5 + [i] * 8 + [p])
        for dtype in ("f32", "bf16"):
            getattr(lib, f"group_solve_{form}_wide_{dtype}").restype = i
    # the X form also takes the plan's packed flag and a slot-scalar stride
    lib.admm_fused_x_f32.argtypes = [p] * 15 + [i] * 10 + [p]
    # its wide tier: the scratch, then the plan's spread and per_sm
    lib.admm_fused_x_wide_f32.argtypes = [p] * 15 + [i] * 11 + [p]
    lib.admm_fused_l_f32.argtypes = [p] * 15 + [i] * 8 + [p]
    lib.admm_fused_l_bf16.argtypes = [p] * 15 + [i] * 9 + [p]
    for fused in (lib.admm_fused_x_f32, lib.admm_fused_x_wide_f32,
                  lib.admm_fused_l_f32, lib.admm_fused_l_bf16):
        fused.restype = i
    # the ADMM row stages and the channel interval (admm_steps.cu)
    lib.admm_rhs_f32.argtypes = [p] * 11 + [i] * 7 + [p]
    lib.admm_update_f32.argtypes = [p] * 13 + [i] * 6 + [p]
    lib.admm_channel_interval_f32.argtypes = [p] * 14 + [i] * 10 + [p]
    for stage in (lib.admm_rhs_f32, lib.admm_update_f32,
                  lib.admm_channel_interval_f32):
        stage.restype = i
    # the QP's diagonal blocks (assemble_d.cu)
    for dtype in ("f32", "f64"):
        entry = getattr(lib, f"assemble_d_{dtype}")
        entry.argtypes = [p] * 5 + [i] * 6 + [p]
        entry.restype = i
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def require_f32_cuda(what: str, bf16_ok=(), **tensors) -> None:
    """Raise unless every tensor is float32, contiguous and on one CUDA
    device.  The factor operands named in ``bf16_ok`` may instead be
    bfloat16, all of them alike, laid out with the rows of each block on
    the stride :func:`bf16_row_stride` (``banded.compress_factors``)."""
    dev = None
    factor_dtypes = {tensors[name].dtype for name in bf16_ok}
    if len(factor_dtypes) > 1:
        raise TypeError(f"{what}: factors of mixed types {factor_dtypes}")
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is not a CUDA tensor")
        if name in bf16_ok and t.dtype == torch.bfloat16:
            ld = bf16_row_stride(t.shape[-1])
            if t.stride() != padded_strides(t.shape, ld):
                raise ValueError(
                    f"{what}: bf16 {name} does not lie on rows of {ld} "
                    "elements (banded.compress_factors)")
        elif t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}, the kernel takes "
                            "float32" + (" or bfloat16 factors" if bf16_ok
                                         else " only"))
        elif not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        if dev is not None and t.device != dev:
            raise ValueError(f"{what}: tensors on different devices")
        dev = t.device
