"""Horizon (K-axis) parallelism: the timestep axis sharded over the ranks
of a mesh (counterpart of ``ba_path_planning_tpu.parallel.horizon_sharded``).

Every K-indexed operator of the planner is either a prefix sum (the
dynamics rollout, ``ops/rollout.py``) or k-local (collision linearization,
feasibility, bounds), so a horizon shard needs only its own block plus a
few per-shard totals of the blocks before it:

* :func:`rollout_ksharded`: the double-cumsum rollout as a block prefix
  sum: local exclusive cumsums, then two ``all_reduce``s of zero-filled
  (size, ..., 2) buffers of per-shard totals (JAX's two ``all_gather``s);
* :func:`check_feasible_ksharded` and :func:`linearize_ksharded`: k-local
  work, with one AND (``all_reduce`` MIN) for the feasibility.

As in JAX, the QP's block-tridiagonal recurrence is not K-sharded: it is
sequential in k, and one card holds a whole horizon's factors at the
reference's horizons.  Each function takes the global (..., K, .) arrays
and works on this rank's block of K / size steps; K must be divisible by
the rank count.  :func:`gather_k` assembles the blocks of every rank.
"""

from __future__ import annotations

import torch

from ..ops.collisions import PairIndex, check_feasible, linearize
from ..utils.dist import all_reduce, gather_rows
from .mesh import Mesh, make_mesh

K_AXIS = "horizon"


def make_horizon_mesh(group=None) -> Mesh:
    """The 1-D mesh of the ranks of ``group`` over the horizon."""
    return make_mesh(group)


def _k_block(K: int, mesh: Mesh) -> slice:
    """This rank's steps of a horizon of K."""
    if K % mesh.size != 0:
        raise ValueError(f"K={K} not divisible by {mesh.size} horizon "
                         "shards")
    per = K // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def _totals(local_total: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(size, ...) the per-shard totals of every rank: a zero-filled buffer
    with this rank's total in its slot, summed over the mesh."""
    return gather_rows(local_total[None], mesh.rank, mesh.size,
                       mesh.collective_group)


def _block_prefix(a_local: torch.Tensor, mesh: Mesh):
    """Distributed exclusive prefix sums along a sharded K axis.

    a_local: this shard's (..., K_loc, 2) block.  Returns (s1, s2): the
    global exclusive cumsum of a over this shard's steps, and the global
    inclusive cumsum of s1, from two reductions of per-shard totals."""
    idx = mesh.rank
    K_loc = a_local.shape[-2]
    C = torch.cumsum(a_local, dim=-2) - a_local     # local exclusive cumsum
    S_all = _totals(torch.sum(a_local, dim=-2), mesh)   # (size, ..., 2)
    n_sh = S_all.shape[0]
    before = (torch.arange(n_sh, device=a_local.device) < idx).reshape(
        (n_sh,) + (1,) * (S_all.dim() - 1))
    zero = torch.zeros_like(S_all)
    A = torch.sum(torch.where(before, S_all, zero), dim=0)  # blocks < idx
    s1 = C + A[..., None, :]
    # per-shard totals of s1, for the second cumsum
    Csum_all = _totals(torch.sum(C, dim=-2), mesh)
    A_all = torch.cumsum(S_all, dim=0) - S_all
    T_all = Csum_all + K_loc * A_all                  # sum of s1 over block b
    U = torch.sum(torch.where(before, T_all, zero), dim=0)
    D = torch.cumsum(C, dim=-2)
    t1 = torch.arange(1, K_loc + 1, dtype=a_local.dtype,
                      device=a_local.device).reshape(K_loc, 1)
    s2 = U[..., None, :] + D + t1 * A[..., None, :]
    return s1, s2


def rollout_ksharded(accelerations, p0, v0, h, mesh: Mesh | None = None):
    """The dynamics rollout with the K axis sharded over ``mesh``:
    accelerations (..., K, 2), K divisible by the rank count; p0/v0 (..., 2)
    the same on every rank.  Returns this rank's block (..., K / size, 2) of
    (positions, velocities): the values of :func:`ops.rollout.rollout`, in
    another order of the sums."""
    mesh = mesh if mesh is not None else make_horizon_mesh()
    blk = _k_block(accelerations.shape[-2], mesh)
    a_loc = accelerations[..., blk, :]
    K_loc = a_loc.shape[-2]
    s1, s2 = _block_prefix(a_loc, mesh)
    t = torch.arange(K_loc, dtype=a_loc.dtype, device=a_loc.device)
    k_glob = (mesh.rank * K_loc + t).reshape(K_loc, 1)
    p0b, v0b = p0[..., None, :], v0[..., None, :]
    vel = v0b + h * s1
    pos = p0b + h * k_glob * v0b + (h * h) * (s2 - 0.5 * s1)
    return pos, vel


def check_feasible_ksharded(positions, pairs: PairIndex, min_distance,
                            mesh: Mesh | None = None) -> torch.Tensor:
    """Pairwise feasibility of a trajectory (..., N, K, 2) over the K-sharded
    mesh: the k-local check of this rank's steps and one AND over the ranks
    (the semantics of ``ops.collisions.check_feasible``)."""
    mesh = mesh if mesh is not None else make_horizon_mesh()
    blk = _k_block(positions.shape[-2], mesh)
    ok = check_feasible(positions[..., blk, :], pairs, min_distance)
    return all_reduce(ok, "min", mesh.collective_group)


def linearize_ksharded(positions, pairs: PairIndex, angle,
                       mesh: Mesh | None = None):
    """The collision linearization of this rank's steps: eta (..., K_loc, P,
    2) and dist (..., K_loc, P) of :func:`ops.collisions.linearize`;
    ``angle`` (..., K, P) the global degenerate-pair angles, of which the
    rank takes its steps (so a degenerate pair draws what the unsharded
    call draws at every global k)."""
    mesh = mesh if mesh is not None else make_horizon_mesh()
    blk = _k_block(positions.shape[-2], mesh)
    return linearize(positions[..., blk, :], pairs, angle[..., blk, :])


def gather_k(local: torch.Tensor, dim: int, mesh: Mesh | None = None):
    """Every rank's K-block of ``local`` along ``dim``, assembled on every
    rank (one ``all_reduce`` of a zero-filled buffer)."""
    mesh = mesh if mesh is not None else make_horizon_mesh()
    moved = torch.movedim(local, dim, 0)
    out = gather_rows(moved, mesh.rank, mesh.size, mesh.collective_group)
    return torch.movedim(out, 0, dim)
