"""Batch driver with host-side straggler compaction, on one device
(counterpart of ``ShardedSCPSolver.solve_compacted`` in
``ba_path_planning_tpu.parallel.mesh``; meshes and ``shard_map`` are left
out).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..solvers.banded import tree_map
from ..solvers.scp import SCPCarry, SCPEngine, SCPResult
from ..utils.config import ProblemConfig, SolverConfig


class ShardedSCPSolver:
    """Batch SCP solver on one device (``device=None``: the card)."""

    def __init__(self, problem: ProblemConfig,
                 solver: SolverConfig | None = None, dtype=torch.float32,
                 device=None, seed: int = 0):
        self.engine = SCPEngine(problem, solver, dtype=dtype, device=device,
                                seed=seed)
        self.last_timing: dict = {}

    def _active_flags(self, carry: SCPCarry) -> torch.Tensor:
        return (~carry.stop & ~carry.feasible_initial
                & (carry.it < self.engine.problem.max_iterations))

    def solve_compacted(self, p0, v0, pf, vf, lane_ids=None,
                        chunk: int | None = None,
                        angle_fn=None) -> SCPResult:
        """Batch solve with straggler compaction.

        Phase 1 runs over the whole batch at once.  Then, round by round,
        the still-active lanes are packed densely into dispatches of
        ``chunk`` lanes (or ``chunk // 4`` for the tail of a round), each
        advanced by one SCP iteration and scattered back; a
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
        carry = parts[0] if len(parts) == 1 else tree_map(
            lambda *xs: torch.cat(xs), *parts)
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
                stepped = eng.step(cpart, *apart, cpart.it + 1, angle_fn)

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
        return results[0] if len(results) == 1 else tree_map(
            lambda *xs: torch.cat(xs), *results)
