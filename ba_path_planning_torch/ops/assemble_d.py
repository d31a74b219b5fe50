"""The QP's diagonal blocks D in one hand-written kernel
(``csrc/assemble_d.cu``), with the plain version it replaces on the card.

:func:`banded.assemble_D` (the plain version, and the CPU's) forms the
collision blocks as a dense product of G = E (x) eta and G rho on cuBLAS,
shifts it by one step and adds it into a clone of the broadcast skeleton:
~95 launches a QP moving ~4.3 times the bytes of D.  The kernel writes each
D_k once, skeleton and collision terms together, from eta, the collision
rho and the slot scalars, which the wrapper forms in PyTorch as the plain
version does (``banded._tridiag_scalars``), with C (``assemble_d.cu`` says
how each entry is rounded).  It runs wherever the solver assembles D on the
card: the routes of ``banded.SHARED_C_ROUTES`` (with one rho a lane under
adaptive rho) and ``banded.assemble_blocks``; a pair-sharded ``group``
keeps the plain version, whose collision blocks are summed over the ranks
before they reach D.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..solvers.banded import (RowVals, _tridiag_scalars, assemble_D,
                              b_slot_mats)
from ..utils import debug
from .admm_fused import _on_cpu
from .cuda_build import check, load_kernels

# A block writes tiles of about this many bytes of one D_k: the whole block
# at N = 20 (120 x 120 float32, 57.6 KB), rows of it at wider N
TILE_BYTES = 64 * 1024
# the shared memory a block of the H100 can take
SMEM_MAX = 232448


class AssemblePlan(NamedTuple):
    rows: int       # rows of D_k a block writes (even)
    tiles: int      # blocks a D_k
    smem: int       # bytes of shared memory a block


def assemble_plan(B: int, K: int, n_vehicles: int,
                  itemsize: int) -> AssemblePlan:
    """The kernel's launch for B lanes of K blocks of 6N rows: tiles of an
    even count of rows (so that every tile starts 16-byte aligned and holds
    whole vehicles of the p-p slot) of about :data:`TILE_BYTES`, all 6N
    rows where they fit; each block stages the p-p rows of its vehicles,
    at most min(rows, 2N) rows of 2N, and their partner terms.  Raises where the kernel refuses
    (its shared memory past :data:`SMEM_MAX`, 2^31 blocks or more)."""
    N, n = n_vehicles, 6 * n_vehicles
    rows = min(n, max(2, TILE_BYTES // (itemsize * n) // 2 * 2))
    tiles = -(-n // rows)
    # the tile's p-p rows (2V, 2N) and its vehicles' partner terms (V, N, 3)
    smem = min(rows, 2 * N) * N * 7 // 2 * itemsize
    if smem > SMEM_MAX or B * K * tiles >= 2 ** 31:
        raise ValueError(f"assemble_D_fused: B={B}, K={K}, N={N} in "
                         f"{itemsize}-byte elements is past the kernel "
                         f"({smem} bytes of shared memory a block, "
                         f"{B * K * tiles} blocks)")
    return AssemblePlan(rows, tiles, smem)


def assemble_D_fused(rho: RowVals, eta, E, *, h: float, sigma,
                     n_vehicles: int, group=None):
    """The diagonal blocks D (..., K, 6N, 6N) and the slot scalars
    C (K-1, 3, 3), or (B, K-1, 3, 3) for a per-lane rho, as
    :func:`banded.assemble_D` gives them.  E's pairs are in
    ``triu_indices`` order, pad pairs after them (``PaddedPairIndex``), as
    ``ops.collisions`` makes them; the kernel finds each pair in closed
    form and reads no E.  CUDA tensors launch the kernel (float32 or
    float64, eta contiguous; anything else raises), CPU tensors and a
    ``group`` run the plain version."""
    if group is not None or _on_cpu("assemble_D_fused", eta):
        return assemble_D(rho, eta, E, h=h, sigma=sigma,
                          n_vehicles=n_vehicles, group=group)
    N = n_vehicles
    *batch, K, P, two = eta.shape
    B = math.prod(batch)
    s = _tridiag_scalars(rho, h=h, sigma=sigma)
    # the skeleton's slot scalars (aa, ap, av, pp, pv, vv), (K, 6) or one
    # row a lane (B, K, 6)
    S = torch.stack(torch.broadcast_tensors(
        *(s[x] for x in ("aa", "ap", "av", "pp", "pv", "vv"))), dim=-1)
    lanes = S.shape[0] if S.dim() == 3 else 1
    dtype = eta.dtype
    if (two != 2 or E.shape != (N, P) or P < N * (N - 1) // 2
            or S.shape[-2:] != (K, 6) or S.dim() > 3
            or (lanes > 1 and (len(batch) != 1 or lanes != B))):
        raise ValueError(
            f"assemble_D_fused: unsupported shapes eta {tuple(eta.shape)}, "
            f"E {tuple(E.shape)}, slot scalars {tuple(S.shape)}, N={N}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"assemble_D_fused: eta is {dtype}, the kernel takes "
                        "float32 or float64")
    if any(t.dtype != dtype or t.device != eta.device for t in (rho.col, S)):
        raise ValueError("assemble_D_fused: operands of mixed types or "
                         "devices")
    if not eta.is_contiguous():
        raise ValueError("assemble_D_fused: eta is not contiguous")
    plan = assemble_plan(B, K, N, eta.element_size())
    rc = rho.col.expand(*batch, K, P).reshape(B, K, P)
    n = 6 * N
    D = torch.empty(tuple(batch) + (K, n, n), dtype=dtype,
                    device=eta.device)
    strides = (ctypes.c_longlong * 4)(K * P * 2, *rc.stride())
    lib = load_kernels()
    entry = (lib.assemble_d_f32 if dtype == torch.float32
             else lib.assemble_d_f64)
    with torch.cuda.device(eta.device):
        err = entry(eta.data_ptr(), rc.data_ptr(), S.data_ptr(),
                    D.data_ptr(), strides, B, K, N, P, lanes, plan.rows,
                    torch.cuda.current_stream(eta.device).cuda_stream)
    check(err, "assemble_D_fused")
    assemble_D_fused.launches += 1
    C = b_slot_mats(s)
    debug.report("assemble_D_fused", D, C)
    return D, C


assemble_D_fused.launches = 0
