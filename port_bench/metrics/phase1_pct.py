"""Share of the calls' wall time spent in phase 1 (the collision-free QP
over the whole batch and the host's read of the flags): the sum of
``last_timing``'s ``phase1_s`` over the sum of the call walls, over the
window's calls."""

LAYER = "host driver (parallel.mesh)"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "solves_per_s"


def read(ctx):
    wall = sum(c.wall_s for c in ctx.calls)
    p1 = sum(c.timing.get("phase1_s", 0.0) for c in ctx.calls)
    if not wall or not p1:
        return None
    return 100.0 * p1 / wall
