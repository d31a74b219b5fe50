"""The least time of the QP work a scenario needs on one H100, counted from
shapes (a restatement of the program's ``utils/profiling.py`` cost models,
with each input byte read once and each output byte written once a QP).

Work of one scenario with N vehicles, K steps, n = 6N, and ``iters`` ADMM
iterations a QP:

* phase 1, the collision-free QP: ``iters`` iterations of the right-hand
  side, the update and the per-channel sweeps over 2N channels, about
  40 + 75 + 78 FP32 operations a static row, channel and iteration;
* each SCP iteration's QP:
  - the X-form factorization: the Newton-Schulz interior, steps 3 .. K-2,
    each S_k (13 n^2) and ``ns_iters`` iterations of X S (2 n^3) and the
    symmetric update on and above the diagonal (n (n + 1)^2), all matrix
    products; and the four exact steps, a Cholesky inverse each (about
    (7/3) 2 n^3);
  - ``iters`` x-updates, each two sweeps of K matrix-vector products
    (2 K 2 n^2);
  - ``iters`` right-hand sides and updates over the rows: (40 + 4 (N - 1))
    a static row and 75 a static row and 15 a collision row;
* bytes of a QP: its inputs (the warm start, the duals, the bounds, the
  collision directions) read once and its outputs (x, z, y) written once,
  in float32: 72 N K + 6 K P floats; phase 1 has no collision directions.

The matrix products of the factorization are counted at the tensor cores'
TF32 peak, the other operations at the FP32 peak.  The least time of a body
of work is the largest of its bytes over the memory rate and each unit's
operations over its peak, summed over the whole body first, so no
implementation can beat it.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full power limit of 700 W
PEAK_HBM_BYTES = 3.35e12       # bytes/s
PEAK_FP32_FLOPS = 67e12        # FLOP/s outside the tensor cores
PEAK_TF32_FLOPS = 495e12       # FLOP/s on the tensor cores


def phase1_cost(N: int, K: int, iters: int) -> dict:
    """Operations and bytes of one scenario's collision-free QP."""
    P = N * (N - 1) // 2
    return {"fp32_flops": iters * 2 * N * K * (40 + 75 + 78),
            "mm_flops": 0,
            "bytes": 4 * (72 * N * K + 4 * K * P)}


def scp_qp_cost(N: int, K: int, iters: int, ns_iters: int) -> dict:
    """Operations and bytes of one scenario's QP of an SCP iteration."""
    n, P = 6 * N, N * (N - 1) // 2
    interior = (K - 4) * (ns_iters * (2 * n ** 3 + n * (n + 1) ** 2)
                          + 13 * n * n)
    anchors = 4 * int((7 / 3) * 2 * n ** 3)
    xupdate = 2 * K * 2 * n * n
    rows = 2 * N * K * (40 + 4 * (N - 1)) + 2 * N * K * 75 + K * P * 15
    return {"fp32_flops": anchors + iters * (xupdate + rows),
            "mm_flops": interior,
            "bytes": 4 * (72 * N * K + 6 * K * P)}


def least_seconds(cost: dict) -> float:
    """The least time of ``cost`` on one H100: the larger of its bytes over
    the memory rate and each unit's operations over its peak."""
    return max(cost["bytes"] / PEAK_HBM_BYTES,
               cost["fp32_flops"] / PEAK_FP32_FLOPS,
               cost["mm_flops"] / PEAK_TF32_FLOPS)


def work(N: int, K: int, iters: int, ns_iters: int,
         scp_iterations) -> dict:
    """The operations and bytes of the QP work of scenarios whose SCP counts
    are ``scp_iterations`` (a sequence): each its phase-1 QP and that many
    QPs of the SCP loop."""
    one = phase1_cost(N, K, iters)
    qp = scp_qp_cost(N, K, iters, ns_iters)
    qps = sum(int(i) for i in scp_iterations)
    return {key: len(scp_iterations) * one[key] + qps * qp[key]
            for key in one}
