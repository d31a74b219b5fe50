"""Reads of a value from the card to the host a call, each of which waits
for the card's queue to drain: ``last_timing``'s ``host_reads`` (the
program's count of ``utils.profiling.host_read``: the driver's flags once
after phase 1 and once a round, the SCP step's flags three times a
dispatch), averaged over the window's calls."""

LAYER = "host driver (parallel.mesh)"
UNIT = "reads"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "solves_per_s"


def read(ctx):
    reads = [c.timing["host_reads"] for c in ctx.calls
             if "host_reads" in c.timing]
    if not reads:
        return None
    return sum(reads) / len(reads)
