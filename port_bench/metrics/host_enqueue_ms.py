"""Host time of a call less its waits on the card, on the program's own
clock: ``last_timing``'s ``call_s`` (the span ``mesh.call``) less its
``host_read_s`` (the ``*.host_read`` spans: copies to the host) and its
``host_write_s`` (the ``*.host_write`` spans: copies of host values to the
card, from pageable memory), each of which waits for the card's queue to
drain, averaged over the window's calls, which run with no profiler.  It
is the host's own work, Python and the launches, with one wait left in
it: a launch that waits for room in the card's launch queue.  On the card
those reads and writes are every synchronising operation of the call
(``tests/test_torch_kernels_gpu.py``)."""

LAYER = "host driver (parallel.mesh)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "solves_per_s"


def read(ctx):
    keys = ("call_s", "host_read_s", "host_write_s")
    own = [c.timing["call_s"] - c.timing["host_read_s"]
           - c.timing["host_write_s"] for c in ctx.calls
           if all(k in c.timing for k in keys)]
    if not own:
        return None
    return 1e3 * sum(own) / len(own)
