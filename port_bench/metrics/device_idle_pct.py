"""Share of the traced window in which no kernel, copy or set ran on the
card: 100 (1 - busy / window), both from the profiler's trace."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "solves_per_s"


def read(ctx):
    if not ctx.trace or not ctx.trace.get("window_s"):
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
