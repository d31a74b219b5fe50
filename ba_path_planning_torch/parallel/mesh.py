"""Scenario parallelism (counterpart of ``ba_path_planning_tpu.parallel.
mesh``): the batch solvers, the uncompacted :meth:`ShardedSCPSolver.solve`,
optionally in sequential microbatches, and
:meth:`ShardedSCPSolver.solve_compacted` with host-side straggler
compaction, over a :class:`Mesh` of ranks.

JAX runs one program over a device mesh; the port runs one process a
device over ``torch.distributed`` (``parallel/distributed.py``).  A mesh is
the caller's process group: each rank solves its slice of the global
batch (``distributed.host_local_slice``), compacts its own lanes, as JAX's
compaction is shard-local, and every rank returns the whole result,
gathered with one ``all_reduce`` a field.  Scenarios are independent, so
no collective runs inside a solve.  Without a process group the mesh is
one rank and the solvers run as on one device.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..solvers.banded import tree_map
from ..solvers.scp import SCPCarry, SCPEngine, SCPResult
from ..utils.config import ProblemConfig, SolverConfig
from ..utils.dist import gather_rows
from ..utils.profiling import host_read, host_write, span

SCENARIO_AXIS = "scenarios"


class Mesh(NamedTuple):
    """A 1-D mesh of ranks, one process a device: the process ``group``
    (None: the default group), this process's ``rank`` in it and its
    ``size``."""
    group: object
    rank: int
    size: int

    @property
    def collective_group(self):
        """The group the collectives run over, or None on a mesh of one
        rank (no collective at all)."""
        if self.size == 1:
            return None
        return self.group if self.group is not None else dist.group.WORLD


def make_mesh(group=None) -> Mesh:
    """The mesh of the ranks of ``group`` (default: every rank of the
    initialized process group; one rank where none is initialized)."""
    if not dist.is_available() or not dist.is_initialized():
        if group is not None:
            raise ValueError("a process group needs torch.distributed "
                             "initialized (distributed.init_distributed)")
        return Mesh(None, 0, 1)
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group))


def pad_to_multiple(n: int, m: int) -> int:
    """The least multiple of ``m`` that is at least ``n``."""
    return ((n + m - 1) // m) * m


def _cat(parts):
    return parts[0] if len(parts) == 1 else tree_map(
        lambda *xs: torch.cat(xs), *parts)


def _gather(result, mesh: Mesh):
    """Every rank's rows of ``result`` (a NamedTuple of (B_local, ...)
    tensors), on every rank."""
    group = mesh.collective_group
    if group is None:
        return result
    return type(result)(*(gather_rows(t, mesh.rank, mesh.size, group)
                          for t in result))


class ShardedSCPSolver:
    """Batch SCP solver over a :class:`Mesh` of ranks (default: one rank),
    each rank on its ``device`` (``device=None``: the card)."""

    def __init__(self, problem: ProblemConfig,
                 solver: SolverConfig | None = None, dtype=torch.float32,
                 device=None, seed: int = 0, microbatch: int | None = None,
                 mesh: Mesh | None = None):
        """``microbatch``: chunk size of :meth:`solve` on each rank.  The
        uncompacted solve runs every lane until the slowest lane of its
        batch stops, so solving the batch as sequential chunks of
        ``microbatch`` scenarios bounds that tail to the chunk's slowest
        lane (total work = sum of the per-chunk maxima).  None = one
        chunk."""
        self.engine = SCPEngine(problem, solver, dtype=dtype, device=device,
                                seed=seed)
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_devices = self.mesh.size
        self.microbatch = microbatch
        self.last_timing: dict = {}

    def _local(self, B: int, lane_ids):
        """This rank's slice [lo, hi) of a global batch of B and its global
        lane ids (default 0..B-1): the degenerate-pair draws are keyed by
        the scenario id, so a lane draws what it draws on one rank."""
        size = self.mesh.size
        if B % size != 0:
            raise ValueError(f"batch {B} not divisible by {size} ranks")
        per = B // size
        lo = self.mesh.rank * per
        if lane_ids is None:
            lane_ids = torch.arange(B, device=self.engine.device)
        return lo, lo + per, lane_ids[lo:lo + per]

    def _active_flags(self, carry: SCPCarry) -> torch.Tensor:
        return (~carry.stop & ~carry.feasible_initial
                & (carry.it < self.engine.problem.max_iterations))

    def solve(self, p0, v0, pf, vf, lane_ids=None,
              angle_fn=None) -> SCPResult:
        """Uncompacted batch solve: p0/v0/pf/vf (B, N, 2) the global batch,
        ``lane_ids`` (B,) scenario ids (default 0..B-1) that key the
        degenerate-pair draws.  Each rank solves its slice of B / size
        lanes; every lane of a chunk runs until the chunk's slowest lane
        stops; with ``microbatch`` the chunks run one after another
        (:meth:`SCPEngine.solve_batch` each) and their results are
        concatenated in order.  The slice must be a multiple of
        ``microbatch``.  Every rank returns the whole result."""
        eng = self.engine
        p0, v0, pf, vf = eng.as_inputs(p0, v0, pf, vf)
        lo, hi, lane_ids = self._local(p0.shape[0], lane_ids)
        p0, v0, pf, vf = (a[lo:hi] for a in (p0, v0, pf, vf))
        B = hi - lo
        mb = self.microbatch
        if mb is None or mb >= B:
            out = eng.solve_batch(p0, v0, pf, vf, lane_ids, angle_fn)
        elif B % mb != 0:
            raise ValueError(f"batch {B} must be a multiple of microbatch "
                             f"{mb}")
        else:
            out = _cat([eng.solve_batch(
                *(a[lo_:lo_ + mb] for a in (p0, v0, pf, vf, lane_ids)),
                angle_fn=angle_fn) for lo_ in range(0, B, mb)])
        return _gather(out, self.mesh)

    def solve_compacted(self, p0, v0, pf, vf, lane_ids=None,
                        chunk: int | None = None,
                        angle_fn=None, step_iters: int = 1) -> SCPResult:
        """Batch solve with straggler compaction.

        Phase 1 runs over the whole batch at once.  Then, round by round,
        the still-active lanes are packed densely into dispatches of
        ``chunk`` lanes (or ``chunk // 4`` for the tail of a round), each
        advanced by up to ``step_iters`` SCP iterations and scattered back; a
        partial dispatch is padded by repeating active lanes (identical
        duplicate work, scattered back idempotently).  Per-lane iteration
        counts, statuses and degenerate-pair draws (keyed by lane id and
        global iteration) are those of an uncompacted solve.

        p0/v0/pf/vf (B, N, 2) the global batch; ``lane_ids`` (B,) scenario
        ids, default 0..B-1.  On a mesh of several ranks each rank compacts
        its own slice of B / size lanes in dispatches of chunk / size lanes
        (B a multiple of chunk, chunk of the rank count), as JAX's
        compaction is shard-local, and every rank returns the whole
        result.  ``last_timing`` records this rank's phase and loop split
        (``loop_prep_s`` and ``loop_enqueue_s``: the dispatches' host time
        less its waits on the card), and the call's waits: its reads of
        values from the card (``host_reads``, taking ``host_read_s``) and
        copies of host values to it (``host_writes``, ``host_write_s``) in
        the call's ``call_s``; under a ``torch.profiler`` the call is the
        span ``mesh.call``.
        """
        with span("mesh.call"):
            tc = time.perf_counter()
            reads0, read_s0 = host_read.count, host_read.seconds
            writes0, write_s0 = host_write.count, host_write.seconds
            eng = self.engine
            n_ranks = self.mesh.size
            p0, v0, pf, vf = eng.as_inputs(p0, v0, pf, vf)
            B = p0.shape[0]
            if chunk is None:
                chunk = min(B, 128 * n_ranks)
            if B % chunk != 0 or chunk % n_ranks != 0:
                raise ValueError(
                    f"batch {B} must be a multiple of chunk {chunk}, and "
                    f"chunk a multiple of the rank count {n_ranks}")
            lo, hi, lane_ids = self._local(B, lane_ids)
            args = tuple(a[lo:hi] for a in (p0, v0, pf, vf)) + (lane_ids,)
            B, chunk = hi - lo, chunk // n_ranks
            tail_chunk = chunk // 4 if chunk // 4 >= 1 else chunk

            t0 = time.perf_counter()
            max_start = max(chunk, 8192)
            with span("mesh.phase1"):
                parts = [eng.start(*(a[lo:lo + max_start] for a in args[:4]))
                         for lo in range(0, B, max_start)]
                carry = _cat(parts)
            flags_h = host_read("mesh", self._active_flags(carry)).numpy()
            t1 = time.perf_counter()

            def waited():
                return host_read.seconds + host_write.seconds

            t_prep = t_enqueue = 0.0
            n_rounds = n_dispatches = lanes_dispatched = 0
            while True:
                act = np.flatnonzero(flags_h)
                if act.size == 0:
                    break
                n_rounds += 1
                lo = 0
                while lo < act.size:
                    tp, wp = time.perf_counter(), waited()
                    with span("mesh.pack"):
                        size = chunk if act.size - lo > chunk - tail_chunk \
                            else tail_chunk
                        jidx = host_write(
                            "mesh", np.resize(act[lo:lo + size], size),
                            dtype=None, device=eng.device)
                        cpart = tree_map(lambda x: x[jidx], carry)
                        apart = [a[jidx] for a in args]
                        cap = cpart.it + step_iters
                    te, we = time.perf_counter(), waited()
                    stepped = eng.step(cpart, *apart, cap, angle_fn)

                    def scatter(full, part):
                        full[jidx] = part
                        return full
                    with span("mesh.scatter"):
                        carry = tree_map(scatter, carry, stepped)
                    t_prep += (te - tp) - (we - wp)
                    t_enqueue += (time.perf_counter() - te) - (waited() - we)
                    n_dispatches += 1
                    lanes_dispatched += size
                    lo += size
                flags_h = host_read("mesh", self._active_flags(carry)).numpy()
            t2 = time.perf_counter()
            self.last_timing = {"phase1_s": t1 - t0, "loop_s": t2 - t1,
                                "loop_prep_s": t_prep,
                                "loop_enqueue_s": t_enqueue,
                                "loop_rounds": n_rounds,
                                "loop_dispatches": n_dispatches,
                                "loop_lanes_dispatched": lanes_dispatched}

            max_fin = max(chunk, 16384)
            with span("mesh.finalize"):
                results = [eng.finalize(
                    tree_map(lambda x: x[lo:lo + max_fin], carry),
                    *(a[lo:lo + max_fin] for a in args[:4]))
                    for lo in range(0, B, max_fin)]
                out = _gather(_cat(results), self.mesh)
            self.last_timing.update(
                call_s=time.perf_counter() - tc,
                host_reads=host_read.count - reads0,
                host_read_s=host_read.seconds - read_s0,
                host_writes=host_write.count - writes0,
                host_write_s=host_write.seconds - write_s0)
            return out
