"""Carry state across from the JAX package: its configurations, and its
solver state as numpy arrays, into the port's types.  The system has no
weights; these are what starts both engines from the same point.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.collisions import PairIndex
from ..solvers.banded import RowVals
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
    """A JAX ``PairIndex`` -> the port's PairIndex (``valid`` must be
    None: pair sharding is not ported)."""
    if getattr(pairs, "valid", None) is not None:
        raise NotImplementedError("padded pair indices are not ported")
    return PairIndex(i_idx=torch.as_tensor(np.asarray(pairs.i_idx),
                                           dtype=torch.int64, device=device),
                     j_idx=torch.as_tensor(np.asarray(pairs.j_idx),
                                           dtype=torch.int64, device=device),
                     E=torch.as_tensor(np.asarray(pairs.E), dtype=dtype,
                                       device=device))
