"""Carry state across from the JAX package: its configurations, and its
solver state as numpy arrays, into the port's types.  The system has no
weights; these are what starts both engines from the same point.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.collisions import PaddedPairIndex, PairIndex
from ..solvers.banded import RowVals, compress_factors
from ..solvers.scp import SCPCarry
from .config import ProblemConfig, SolverConfig


def config_from_jax(problem, solver) -> tuple[ProblemConfig, SolverConfig]:
    """Copy a JAX ``ProblemConfig`` and ``SolverConfig`` field by field,
    ``pallas`` renamed ``kernels``."""
    p = ProblemConfig(**{f.name: getattr(problem, f.name)
                         for f in dataclasses.fields(ProblemConfig)})
    kw = {f.name: getattr(solver, "pallas" if f.name == "kernels"
                          else f.name)
          for f in dataclasses.fields(SolverConfig)}
    return p, SolverConfig(**kw)


def _t(a, dtype, device):
    a = np.array(a)
    if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a, device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def rowvals_from_numpy(y, dtype=torch.float64, device=None) -> RowVals:
    """A JAX ``RowVals`` (leaves as arrays) -> the port's RowVals."""
    return RowVals(*[_t(leaf, dtype, device) for leaf in y])


def carry_from_numpy(carry, dtype=torch.float64, device=None) -> SCPCarry:
    """A batched JAX ``SCPCarry`` (leaves as arrays) -> the port's SCPCarry.
    Integer and boolean leaves keep their kind; ``it`` and ``qp_iters``
    become int32."""
    out = {}
    for name in SCPCarry._fields:
        v = getattr(carry, name)
        if name == "y":
            out[name] = rowvals_from_numpy(v, dtype, device)
        elif name in ("it", "qp_iters"):
            out[name] = torch.as_tensor(np.array(v), dtype=torch.int32,
                                        device=device)
        else:
            out[name] = _t(v, dtype, device)
    return SCPCarry(**out)


def pairs_from_numpy(pairs, dtype=torch.float64, device=None) -> PairIndex:
    """A JAX ``PairIndex`` -> the port's PairIndex, its ``valid`` mask (the
    pad pairs of a pair-sharded index) carried across."""
    out = PairIndex(i_idx=torch.as_tensor(np.array(pairs.i_idx),
                                          dtype=torch.int64, device=device),
                    j_idx=torch.as_tensor(np.array(pairs.j_idx),
                                          dtype=torch.int64, device=device),
                    E=torch.as_tensor(np.array(pairs.E), dtype=dtype,
                                      device=device))
    valid = getattr(pairs, "valid", None)
    if valid is None:
        return out
    return PaddedPairIndex(*out, valid=torch.as_tensor(
        np.array(valid), dtype=torch.bool, device=device))


def factors_from_numpy(*arrays, dtype=torch.float64, device=None, n=None):
    """Factor arrays of the JAX package, as numpy arrays, -> tensors, one
    per array: the dense pair ``(Linv, Eb)``, ``Linv`` alone with the slot
    scalars ``C``, or X-form ``X`` with ``C``.  ``pad_factors`` of the JAX
    package pads the last two axes to 128 lanes for the TPU's DMA engine;
    pass ``n``, the unpadded block size, to strip that padding from the
    arrays of blocks.  A bf16 array (``np.asarray`` of a JAX bf16 array is
    an ``ml_dtypes`` array, which torch cannot read) crosses as its bits,
    a uint16 view, and comes out as ``torch.bfloat16`` laid out as
    ``banded.compress_factors`` stores it (rows on a stride of 8
    elements); other arrays come out in ``dtype``."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        if n is not None and a.ndim >= 2 and a.shape[-1] > n:
            a = a[..., :n, :n]
        if a.dtype.name == "bfloat16":
            bits = np.array(a).view(np.uint16).view(np.int16)
            t = torch.from_numpy(bits).view(torch.bfloat16).to(device)
            out.append(compress_factors(t)[0])
        else:
            out.append(torch.as_tensor(np.array(a), dtype=dtype,
                                       device=device))
    return tuple(out)
