"""Profiling and tracing helpers (counterpart of
``ba_path_planning_tpu.utils.profiling``).

:func:`trace` captures a ``torch.profiler`` trace around a block and writes
it as Chrome-trace JSON (Perfetto or ``chrome://tracing`` read it; no
TensorBoard needed); :class:`PhaseTimer` accumulates wall time per named
phase, synchronising the card at each phase edge; the cost models count the
bytes and operations of the solver's hot spots in the port's layouts (block
width n = 6N, no lane padding; bf16 factor rows on a stride of
``cuda_build.BF16_ROW_ALIGN`` elements), so a kernel's time can be held
against the least time the card could take.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field

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
    import torch
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


def _sync() -> None:
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclass
class PhaseTimer:
    """Accumulates wall time per named phase; reports a JSON-able summary.
    Each phase edge synchronises the card (where CUDA is in use), so a
    phase's time is its work, not the launches it queued."""
    phases: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - t0)

    def summary(self) -> dict:
        total = sum(self.phases.values())
        return {"total_sec": total,
                "phases": {k: {"sec": v, "frac": v / total if total else 0.0}
                           for k, v in self.phases.items()}}

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)


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
