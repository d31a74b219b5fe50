"""Device operations (kernels, copies and sets) in the traced window a
traced call."""

LAYER = "device"
UNIT = "launches"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "solves_per_s"


def read(ctx):
    if not ctx.trace or not ctx.trace.get("calls"):
        return None
    return ctx.trace["device_ops"] / ctx.trace["calls"]
