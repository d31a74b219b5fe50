"""Share of the lane-steps the compaction driver dispatched that the
scenarios needed: the SCP iterations the scenarios ran (each one lane-step
of a dispatch) over the lanes dispatched (``last_timing``'s
``loop_lanes_dispatched``, padding included), summed over the window's
calls.  Padding of partial dispatches and the tail policy show here."""

LAYER = "host driver (parallel.mesh)"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "solves_per_s"


def read(ctx):
    needed = sum(int(c.iterations.sum()) for c in ctx.calls)
    dispatched = sum(c.timing.get("loop_lanes_dispatched", 0)
                     for c in ctx.calls)
    if not dispatched:
        return None
    return 100.0 * needed / dispatched
