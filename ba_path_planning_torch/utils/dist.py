"""The collectives of the parallel axes (counterparts of the JAX package's
``psum``, ``pmax``, ``pmin`` and ``all_gather`` at its ``axis_name`` sites),
over ``torch.distributed``: one process a device, the caller's process
group and backend.

Only ``all_reduce`` (SUM, MIN, MAX) is used, so the same code runs with NCCL
on one card a rank, and with gloo on CPU tensors (the tests) or on CUDA
tensors of ranks that share one card (NCCL refuses two ranks on one
device).  Every function takes ``group=None`` as "no
collective": a path without a group runs as it did on one device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """``t`` reduced over ``group`` ("sum", "min" or "max"), as a new
    tensor; ``t`` itself when ``group`` is None.  Bool tensors travel as
    int32."""
    if group is None:
        return t
    kind = t.dtype
    out = t.to(torch.int32) if kind == torch.bool else t.clone(
        memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_OPS[op], group=group)
    return out.to(kind) if kind == torch.bool else out


def gather_rows(local: torch.Tensor, rank: int, size: int,
                group) -> torch.Tensor:
    """The (size * R, ...) concatenation of every rank's (R, ...) rows, on
    every rank: a zero-filled buffer with this rank's rows in its slot,
    summed over ``group`` (the counterpart of ``all_gather``; adding zeros
    leaves every value as it was).  Bool and integer rows travel as int32
    or int64."""
    R = local.shape[0]
    kind = local.dtype
    wire = torch.int32 if kind == torch.bool else kind
    buf = torch.zeros((size * R,) + tuple(local.shape[1:]), dtype=wire,
                      device=local.device)
    buf[rank * R:(rank + 1) * R] = local.to(wire)
    if group is not None:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(kind)
