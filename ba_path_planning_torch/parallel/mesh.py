"""Batch solvers on one device (counterpart of ``ShardedSCPSolver`` in
``ba_path_planning_tpu.parallel.mesh``; meshes and ``shard_map`` are left
out): the uncompacted :meth:`ShardedSCPSolver.solve`, optionally in
sequential microbatches, and :meth:`ShardedSCPSolver.solve_compacted` with
host-side straggler compaction.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..solvers.banded import tree_map
from ..solvers.scp import SCPCarry, SCPEngine, SCPResult
from ..utils.config import ProblemConfig, SolverConfig


def pad_to_multiple(n: int, m: int) -> int:
    """The least multiple of ``m`` that is at least ``n``."""
    return ((n + m - 1) // m) * m


def _cat(parts):
    return parts[0] if len(parts) == 1 else tree_map(
        lambda *xs: torch.cat(xs), *parts)


class ShardedSCPSolver:
    """Batch SCP solver on one device (``device=None``: the card)."""

    def __init__(self, problem: ProblemConfig,
                 solver: SolverConfig | None = None, dtype=torch.float32,
                 device=None, seed: int = 0, microbatch: int | None = None):
        """``microbatch``: chunk size of :meth:`solve`.  The uncompacted
        solve runs every lane until the slowest lane of its batch stops, so
        solving the batch as sequential chunks of ``microbatch`` scenarios
        bounds that tail to the chunk's slowest lane (total work = sum of
        the per-chunk maxima).  None = one chunk."""
        self.engine = SCPEngine(problem, solver, dtype=dtype, device=device,
                                seed=seed)
        self.microbatch = microbatch
        self.last_timing: dict = {}

    def _active_flags(self, carry: SCPCarry) -> torch.Tensor:
        return (~carry.stop & ~carry.feasible_initial
                & (carry.it < self.engine.problem.max_iterations))

    def solve(self, p0, v0, pf, vf, lane_ids=None,
              angle_fn=None) -> SCPResult:
        """Uncompacted batch solve: p0/v0/pf/vf (B, N, 2), ``lane_ids`` (B,)
        scenario ids (default 0..B-1) that key the degenerate-pair draws.
        Every lane of a chunk runs until the chunk's slowest lane stops;
        with ``microbatch`` the chunks run one after another
        (:meth:`SCPEngine.solve_batch` each) and their results are
        concatenated in order.  B must be a multiple of ``microbatch``."""
        eng = self.engine
        p0, v0, pf, vf = eng.as_inputs(p0, v0, pf, vf)
        B = p0.shape[0]
        if lane_ids is None:
            lane_ids = torch.arange(B, device=eng.device)
        mb = self.microbatch
        if mb is None or mb >= B:
            return eng.solve_batch(p0, v0, pf, vf, lane_ids, angle_fn)
        if B % mb != 0:
            raise ValueError(f"batch {B} must be a multiple of microbatch "
                             f"{mb}")
        return _cat([eng.solve_batch(
            *(a[lo:lo + mb] for a in (p0, v0, pf, vf, lane_ids)),
            angle_fn=angle_fn) for lo in range(0, B, mb)])

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

        p0/v0/pf/vf (B, N, 2); ``lane_ids`` (B,) scenario ids, default
        0..B-1.  ``last_timing`` records the phase and loop split.
        """
        eng = self.engine
        p0, v0, pf, vf = eng.as_inputs(p0, v0, pf, vf)
        B = p0.shape[0]
        if chunk is None:
            chunk = min(B, 128)
        if B % chunk != 0:
            raise ValueError(f"batch {B} must be a multiple of chunk {chunk}")
        if lane_ids is None:
            lane_ids = torch.arange(B, device=eng.device)
        args = (p0, v0, pf, vf, lane_ids)
        tail_chunk = chunk // 4 if chunk // 4 >= 1 else chunk

        t0 = time.perf_counter()
        max_start = max(chunk, 8192)
        parts = [eng.start(*(a[lo:lo + max_start] for a in args[:4]))
                 for lo in range(0, B, max_start)]
        carry = _cat(parts)
        flags_h = self._active_flags(carry).cpu().numpy()
        t1 = time.perf_counter()

        t_prep = t_enqueue = t_sync = 0.0
        n_rounds = n_dispatches = lanes_dispatched = 0
        while True:
            act = np.flatnonzero(flags_h)
            if act.size == 0:
                break
            n_rounds += 1
            lo = 0
            while lo < act.size:
                tp = time.perf_counter()
                size = chunk if act.size - lo > chunk - tail_chunk \
                    else tail_chunk
                jidx = torch.as_tensor(np.resize(act[lo:lo + size], size),
                                       device=eng.device)
                cpart = tree_map(lambda x: x[jidx], carry)
                apart = [a[jidx] for a in args]
                te = time.perf_counter()
                stepped = eng.step(cpart, *apart, cpart.it + step_iters,
                                   angle_fn)

                def scatter(full, part):
                    full[jidx] = part
                    return full
                carry = tree_map(scatter, carry, stepped)
                t_prep += te - tp
                t_enqueue += time.perf_counter() - te
                n_dispatches += 1
                lanes_dispatched += size
                lo += size
            ts = time.perf_counter()
            flags_h = self._active_flags(carry).cpu().numpy()
            t_sync += time.perf_counter() - ts
        t2 = time.perf_counter()
        self.last_timing = {"phase1_s": t1 - t0, "loop_s": t2 - t1,
                            "loop_prep_s": t_prep,
                            "loop_enqueue_s": t_enqueue,
                            "loop_sync_s": t_sync,
                            "loop_rounds": n_rounds,
                            "loop_dispatches": n_dispatches,
                            "loop_lanes_dispatched": lanes_dispatched}

        max_fin = max(chunk, 16384)
        results = [eng.finalize(tree_map(lambda x: x[lo:lo + max_fin], carry),
                                *(a[lo:lo + max_fin] for a in args[:4]))
                   for lo in range(0, B, max_fin)]
        return _cat(results)
