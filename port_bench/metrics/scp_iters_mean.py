"""Mean SCP iterations a scenario ran (``SCPResult.iterations``) over the
window's scenarios: the QPs a scenario costs past phase 1."""

LAYER = "SCP loop (solvers.scp)"
UNIT = "iters"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "solves_per_s"


def read(ctx):
    n = sum(c.iterations.numel() for c in ctx.calls)
    if not n:
        return None
    return sum(float(c.iterations.double().sum()) for c in ctx.calls) / n
