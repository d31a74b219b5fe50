"""Agent-pair parallelism: ONE large-N scenario with its pairs sharded over
the ranks of a mesh (counterpart of
``ba_path_planning_tpu.parallel.pair_sharded``).

The pair count P = N(N-1)/2 grows quadratically in N, and with it the
collision linearization, the K x P collision rows of z and y, and the
collision blocks of the normal matrix.  Each rank holds P / size of the
pairs (their eta, bounds and rows of z and y); the partial collision
blocks and A^T contributions are summed over the ranks and the residual
norms and feasibility checks reduced, with ``all_reduce`` (the JAX
package's ``psum``, ``pmax`` and ``pmin``), so the block-tridiagonal
x-update, which is sequential in K, stays replicated on every rank.

The pairs are padded to a multiple of the rank count with INERT pairs
(zero incidence columns, -inf collision bounds, ``PaddedPairIndex.valid``
false).  The engine's own ``_scp_start/step/finalize_direct`` run with the
rank's share of the pairs and the mesh's group; the QP runs on the dense
route with no kernel, as JAX forces it (``pallas=False, group=-1,
fused=False``): the grouped and fused kernels are machinery of a batch of
scenarios.  Degenerate-pair directions are keyed on the global pair id, so
a rank draws what the unsharded engine draws for its pairs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.collisions import PaddedPairIndex, degenerate_angles
from ..solvers.scp import (SCPResult, _scp_finalize_direct,
                           _scp_start_direct, _scp_step_direct)
from ..utils.config import (ProblemConfig, SolverConfig, make_solver_params,
                            resolve_device)
from .mesh import Mesh, make_mesh

PAIR_AXIS = "pairs"


def make_pair_mesh(group=None) -> Mesh:
    """The 1-D mesh of the ranks of ``group`` for intra-scenario pair
    parallelism (one rank where no process group is initialized)."""
    return make_mesh(group)


def padded_pair_index(n_vehicles: int, n_shards: int, dtype=torch.float32,
                      device=None) -> PaddedPairIndex:
    """The all-pair index padded to a multiple of ``n_shards`` with inert
    pairs (vehicles 0, 0; zero E columns; ``valid`` false)."""
    N = n_vehicles
    ii, jj = np.triu_indices(N, k=1)
    Pn = len(ii)
    Pp = -(-Pn // n_shards) * n_shards
    i_idx = np.zeros(Pp, np.int64)
    j_idx = np.zeros(Pp, np.int64)
    i_idx[:Pn], j_idx[:Pn] = ii, jj
    E = np.zeros((N, Pp))
    E[ii, np.arange(Pn)] = 1.0
    E[jj, np.arange(Pn)] = -1.0
    valid = np.zeros(Pp, bool)
    valid[:Pn] = True
    return PaddedPairIndex(
        i_idx=torch.as_tensor(i_idx, device=device),
        j_idx=torch.as_tensor(j_idx, device=device),
        E=torch.as_tensor(E, dtype=dtype, device=device),
        valid=torch.as_tensor(valid, device=device))


def shard_pairs(pairs: PaddedPairIndex, rank: int,
                size: int) -> PaddedPairIndex:
    """Rank ``rank``'s contiguous share of a padded pair index."""
    per = pairs.i_idx.shape[0] // size
    sl = slice(rank * per, (rank + 1) * per)
    return PaddedPairIndex(i_idx=pairs.i_idx[sl], j_idx=pairs.j_idx[sl],
                           E=pairs.E[:, sl].contiguous(),
                           valid=pairs.valid[sl])


class PairShardedSCPSolver:
    """Single-scenario SCP solver with pair-sharded QP subproblems over a
    mesh of ranks (``device=None``: the card).

    Complements :class:`~ba_path_planning_torch.parallel.mesh.
    ShardedSCPSolver` (the scenario axis): use this one when a single
    problem instance is large (many vehicles) rather than when there are
    many instances.  Every rank of the mesh calls :meth:`solve` with the
    same scenario."""

    def __init__(self, problem: ProblemConfig,
                 solver: SolverConfig | None = None,
                 mesh: Mesh | None = None, dtype=torch.float32,
                 device=None, seed: int = 0):
        solver = solver if solver is not None else SolverConfig()
        if solver.method != "direct":
            solver = solver.replace(method="direct")
        # the dense route with no kernel, as the JAX solver forces it
        solver = solver.replace(kernels=False, group=-1, fused=False)
        self.problem = problem
        self.solver = solver
        self.dtype = dtype
        self.device = resolve_device(device)
        self.seed = seed
        self.mesh = mesh if mesh is not None else make_pair_mesh()
        self.pairs = padded_pair_index(problem.n_vehicles, self.mesh.size,
                                       dtype, self.device)
        self.local_pairs = shard_pairs(self.pairs, self.mesh.rank,
                                       self.mesh.size)
        self.params = make_solver_params(solver, dtype, self.device)
        self.static = solver.static_part()

    def _angles(self, lane_ids, it):
        """The degenerate-pair angles of this rank's pairs: the engine's
        hash of (seed, lane 0, iteration, global pair id, k)."""
        return degenerate_angles(self.seed, lane_ids, it, self.local_pairs,
                                 self.problem.n_steps, dtype=self.dtype)

    def solve(self, p0, v0, pf, vf) -> SCPResult:
        """p0/v0/pf/vf: (N, 2), one large-N scenario; the result has no
        batch axis and is the same on every rank (the duals stay
        sharded)."""
        args = [torch.as_tensor(a, dtype=self.dtype,
                                device=self.device)[None]
                for a in (p0, v0, pf, vf)]
        kw = dict(params=self.params, pairs=self.local_pairs,
                  problem=self.problem, solver=self.static,
                  group=self.mesh.collective_group)
        carry = _scp_start_direct(*args, **kw)
        carry = _scp_step_direct(
            carry, *args, torch.zeros(1, dtype=torch.int64,
                                      device=self.device),
            self.problem.max_iterations, angle_fn=self._angles, **kw)
        kw.pop("params")
        kw.pop("solver")
        res = _scp_finalize_direct(carry, *args, **kw)
        return SCPResult(*(t[0] for t in res))
