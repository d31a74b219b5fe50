"""Share of the traced window's device busy time that the QP work of the
traced calls' scenarios needs at the least: the NS-chain factorization,
the x-updates, the row stages and the phase-1 channel problems, counted
from shapes and each scenario's SCP count (``reference/cost.py``; padded
duplicate lanes count nothing) over the device busy seconds."""

from ..reference import cost

LAYER = "kernels (ops, csrc)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "solves_per_s"


def read(ctx):
    if not ctx.trace or not ctx.trace.get("busy_s"):
        return None
    s = ctx.spec
    counts = [int(i) for c in ctx.traced_calls for i in c.iterations]
    if not counts:
        return None
    w = cost.work(s.N, s.K, s.admm_iters, s.ns_iters, counts)
    return 100.0 * cost.least_seconds(w) / ctx.trace["busy_s"]
