"""Profiling and tracing helpers (counterpart of
``ba_path_planning_tpu.utils.profiling``).

:func:`span` names a range of the solve path in a ``torch.profiler`` trace
(the card's kernels and copies land in the same event stream, on the same
clock); :func:`host_read` is the one way the solve path copies a value
from the card to the host and :func:`host_write` the one way it copies a
host value to the card, each counted and timed on the host's clock (on the
card both wait for its queue to drain); a span costs a check of a flag and
nothing else while no profiler records.  :func:`trace`
captures a ``torch.profiler`` trace around a block and writes it as
Chrome-trace JSON (Perfetto or ``chrome://tracing`` read it; no TensorBoard
needed); the cost models count the bytes and operations of the solver's hot
spots in the port's layouts (block width n = 6N, no lane padding; bf16
factor rows on a stride of ``cuda_build.BF16_ROW_ALIGN`` elements), so a
kernel's time can be held against the least time the card could take.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
H100_PEAK_HBM_BYTES = 3.35e12        # bytes/s
H100_PEAK_FP32_FLOPS = 67e12         # FLOP/s outside the tensor cores
H100_PEAK_TF32_FLOPS = 495e12        # FLOP/s on the tensor cores


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the CPU and, where there is
    one, the card around a block; on exit it is written to
    ``<log_dir>/trace.json`` (Chrome-trace JSON).  The profiler object is
    yielded (its ``key_averages()`` sums the time by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A range named ``name`` (``<layer>.<what>``) in the trace of the
    ``torch.profiler`` that records, if one does; nested ranges give each
    its parent.  With no profiler recording it is one shared null context:
    no range is opened, nothing is synchronised, launched or allocated."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def host_read(layer: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` copied to the host (``t.cpu()``, which waits for the card's
    queue to drain), inside the span ``<layer>.host_read``.  Counts the
    read in ``host_read.count`` and its host time, the wait included, in
    ``host_read.seconds``; both only grow."""
    host_read.count += 1
    t0 = time.perf_counter()
    with span(f"{layer}.host_read"):
        out = t.cpu()
    host_read.seconds += time.perf_counter() - t0
    return out


host_read.count = 0
host_read.seconds = 0.0


def host_write(layer: str, data, *, dtype, device) -> torch.Tensor:
    """``data`` (a number or a host array) as a tensor on ``device``
    (``torch.as_tensor``), inside the span ``<layer>.host_write``.  On the
    card the copy is from pageable host memory, which waits for the card's
    queue to drain, as a read does.  Counts the write in
    ``host_write.count`` and its host time, the wait included, in
    ``host_write.seconds``; both only grow."""
    host_write.count += 1
    t0 = time.perf_counter()
    with span(f"{layer}.host_write"):
        out = torch.as_tensor(data, dtype=dtype, device=device)
    host_write.seconds += time.perf_counter() - t0
    return out


host_write.count = 0
host_write.seconds = 0.0


def _row_stride(n: int, itemsize: int) -> int:
    """Elements between two rows of a stored factor block: n for 4- and
    8-byte factors, the bf16 stride for 2-byte ones."""
    from ..ops.cuda_build import bf16_row_stride
    return bf16_row_stride(n) if itemsize == 2 else n


def direct_xupdate_cost(n_vehicles: int, n_steps: int,
                        itemsize: int = 4) -> dict:
    """Cost model of ONE production x-update (X-form banded solve) for one
    scenario: the forward and backward sweeps each read all K (n, n)
    symmetric-inverse blocks once (rows on their stored stride) and do one
    dense matvec per step (``banded.solve_factorized_X``).  The factor
    stream dominates every vector touched."""
    K = n_steps
    n = 6 * n_vehicles
    ld = _row_stride(n, itemsize)
    flops = 2 * K * 2 * n * n                 # 2 sweeps x K matvecs
    hbm_bytes = 2 * K * n * ld * itemsize     # the factor stream
    return {"flops": flops, "hbm_bytes": hbm_bytes, "n": n, "ld": ld}


def admm_iteration_cost(n_vehicles: int, n_steps: int,
                        itemsize: int = 4) -> dict:
    """Cost model of one production ADMM iteration (direct path): the
    x-update plus the constraint-operator applications (apply_A and
    apply_AT: collision einsums 2NPK MACs each, plus O(NK) elementwise row
    work) and the z/y updates, with the rows in float32."""
    N, K = n_vehicles, n_steps
    P = N * (N - 1) // 2
    xup = direct_xupdate_cost(N, K, itemsize)
    einsum = 2 * (2 * N * P * K * 2) * 2      # A and A^T, 2 flops/MAC
    rowwork = 12 * (6 * N * K)                # z/y/rhs elementwise passes
    row_bytes = 10 * (6 * N * K + K * P) * 4
    return {"flops": xup["flops"] + einsum + rowwork,
            "hbm_bytes": xup["hbm_bytes"] + row_bytes}


ADMM_STAGES = ("admm_rhs", "admm_update", "admm_channel_interval")


def admm_stage_cost(stage: str, n_vehicles: int, n_steps: int,
                    n_iters: int = 25, eta_terms: bool = True) -> dict:
    """Cost model of one call of a kernel of ``ops/admm_steps.py`` for one
    scenario: the bytes it must move, each input read once and each output
    written once in float32 (the collision rows' rho one plane a lane, as
    the sweep routes lay it out), and its FP32 operations as
    ``csrc/admm_rows.cuh`` counts them (about 40 a static row and 4 a pair
    term of A^T, 75 a static row and 15 a collision row of the update, 78 a
    step and channel column of the per-channel sweeps):

    * "admm_rhs": x, z, y (static and collision rows), eta and rho read, b
      written;
    * "admm_update": xt, x, z, y, the bounds, eta and rho read; x, z and y
      written;
    * "admm_channel_interval": ``n_iters`` iterations of both stages and
      the sweeps; the state read and written once, the bounds, eta and
      the batch-shared rho read once.  With ``eta_terms=False`` the
      collision-free function the channel kernel computes (eta = 0): 40 +
      75 + 78 operations a static row and iteration, no pair terms (the
      collision rows' prox is not counted); the static rows' state and
      bounds (84 floats a vehicle and step) and the collision rows' z, y,
      lower bound and rho (6 floats a row) moved once."""
    N, K = n_vehicles, n_steps
    P = N * (N - 1) // 2
    nk, kp = N * K, K * P
    rhs = 2 * nk * (40 + 4 * (N - 1))
    update = 2 * nk * 75 + kp * 15
    if stage == "admm_rhs":
        return {"flops": rhs, "hbm_bytes": 4 * (36 * nk + 5 * kp)}
    if stage == "admm_update":
        return {"flops": update, "hbm_bytes": 4 * (90 * nk + 8 * kp)}
    if stage == "admm_channel_interval" and not eta_terms:
        return {"flops": n_iters * 2 * nk * (40 + 75 + 78),
                "hbm_bytes": 4 * (84 * nk + 6 * kp)}
    if stage == "admm_channel_interval":
        return {"flops": n_iters * (rhs + update + 2 * nk * 78),
                "hbm_bytes": 4 * (84 * nk + 7 * kp)}
    raise ValueError(f"admm_stage_cost: unknown stage {stage!r}")


def ns_chain_interior_flops(B: int, n_steps: int, n: int,
                            ns_iters: int = 2) -> int:
    """FP32 operations of the NS chain's interior (``ops/ns_chain.py``
    ``chain_interior``: the steps k = 3 .. K-2) for B scenarios of n x n
    blocks: per step S_k = D_k - (C (x) I) X (C (x) I)^T (117 operations a
    slot pair, 13 n^2), then ``ns_iters`` Newton-Schulz iterations, each
    T' = X S whole (2 n^3) and the update 2 X - X T'^T, which is symmetric
    and so formed on and above the diagonal only (n (n + 1) / 2 elements
    of 2 n + 2 operations: n (n + 1)^2)."""
    step = ns_iters * (2 * n ** 3 + n * (n + 1) ** 2) + 13 * n * n
    return B * (n_steps - 4) * step


def factorize_X_cost(n_vehicles: int, n_steps: int, ns_iters: int = 2,
                     n_anchors: int = 4, itemsize: int = 4) -> dict:
    """Cost model of the X-form factorization for one scenario QP
    (``banded.factorize_X``): per interior step, ``ns_iters`` Newton-Schulz
    iterations of two (n, n) matmuls each plus the bxbt slot recombination;
    the exact anchors pay a Cholesky and an inversion (~(7/3) n^3 MACs).
    Bytes: D read, X written, the warm start X re-read."""
    K = n_steps
    n = 6 * n_vehicles
    interior = (K - n_anchors) * (ns_iters * 2 * 2 * n ** 3 + 4 * n * n)
    anchors = n_anchors * int((7 / 3) * 2 * n ** 3)
    hbm_bytes = 3 * K * n * n * itemsize
    return {"flops": interior + anchors, "hbm_bytes": hbm_bytes, "n": n}


def admm_iteration_flops(n_vehicles: int, n_steps: int, cg_iters: int) -> int:
    """FLOPs of one ADMM iteration of the accel-space CG method
    (``solvers/admm.py``); the production path is modelled by
    :func:`admm_iteration_cost`.

    Counts the dominant terms: collision einsums (2 * N * P * K * 2 MACs per
    operator application), prefix sums (~6 passes over N*K*2), and the
    preconditioner's two K x K matmuls per CG step."""
    N, K = n_vehicles, n_steps
    P = N * (N - 1) // 2
    einsum = 2 * (2 * N * P * K * 2)          # apply + adjoint, 2 flops/MAC
    scans = 6 * (N * K * 2) * 2
    op_pair = einsum + scans                   # one A + A^T application
    precond = 2 * (2 * K * K * N * 2)
    # per ADMM iter: rhs A^T, CG (cg_iters x (matvec + precond)), final A
    return op_pair + cg_iters * (op_pair + precond) + op_pair // 2


def solve_flops(n_vehicles: int, n_steps: int, cg_iters: int,
                admm_iters: int, scp_iters: int) -> int:
    """FLOPs of the ADMM iterations of one CG-method solve
    (``scp_iters`` is kept for the JAX signature and not counted)."""
    return admm_iteration_flops(n_vehicles, n_steps, cg_iters) * admm_iters


def bound_ms(cost: dict, flop_s: float = H100_PEAK_FP32_FLOPS,
             count: int = 1) -> tuple[float, str]:
    """The least time in ms the card could take for ``count`` times the
    work of ``cost`` (a cost model's dict): the larger of its bytes over
    the HBM rate and its operations over ``flop_s``, and which it is."""
    t_b = count * cost["hbm_bytes"] / H100_PEAK_HBM_BYTES * 1e3
    t_f = count * cost["flops"] / flop_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")
