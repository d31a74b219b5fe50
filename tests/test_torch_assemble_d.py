"""The one-pass assembly of the QP's diagonal blocks D
(``ops/assemble_d.py``, ``csrc/assemble_d.cu``) on the CPU: no JAX and no
card.  The wrapper takes the plain version on CPU tensors; the closed form
of the pairs the kernel reads in place of E reproduces E; and its launch
plan serves every shape.  The card tests in
``tests/test_torch_kernels_gpu.py`` hold the kernel itself to the plain
version.

    python -m pytest tests/test_torch_assemble_d.py -q
"""

import numpy as np
import pytest
import torch

from ba_path_planning_torch.ops import assemble_d
from ba_path_planning_torch.ops.collisions import make_pair_index
from ba_path_planning_torch.parallel.pair_sharded import padded_pair_index
from ba_path_planning_torch.solvers import banded as tb
from ba_path_planning_torch.utils.config import SolverConfig


def _case(B, K, N, dtype=torch.float32, *, lane_rho=False, shards=1,
          seed=0):
    """Production-shaped rho rows (one rho a lane where ``lane_rho``, a
    share of the collision rows on the loose rho as the solver's disabled
    rows), unit directions eta (B, K, P, 2) and the incidence E of the
    pair index, padded to a multiple of ``shards``."""
    rng = np.random.default_rng(seed)
    pairs = (padded_pair_index(N, shards, dtype) if shards > 1
             else make_pair_index(N, dtype))
    P = pairs.E.shape[1]
    scaling = tb.row_scaling_state(K, 0.2, dtype=dtype)
    rho = (torch.as_tensor(rng.uniform(0.5, 4.0, size=B), dtype=dtype)
           if lane_rho else torch.tensor(2.6, dtype=dtype))
    rows = tb.rho_pattern_masks(
        scaling, SolverConfig.production().static_part(), rho,
        torch.tensor(2.5, dtype=dtype), n_steps=K, n_pairs=P,
        col_enabled=True, dtype=dtype)
    loose = torch.as_tensor(rng.uniform(size=(B, K, P)) < 0.3)
    rows = rows._replace(col=torch.where(
        loose, torch.tensor(tb._LOOSE_RHO, dtype=dtype),
        rows.col.expand(B, K, P)))
    eta = rng.normal(size=(B, K, P, 2))
    eta /= np.linalg.norm(eta, axis=-1, keepdims=True)
    return rows, torch.as_tensor(eta, dtype=dtype), pairs.E


def _pair(i, j, N):
    """The kernel's closed form of pair (i < j): ``admm_rows.cuh``
    pair_base(i) + j - i - 1."""
    return i * (2 * N - i - 1) // 2 + j - i - 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lane_rho,shards,sigma", [
    (False, 1, "tensor"), (True, 1, "tensor"), (False, 4, "float"),
    (True, 3, "float")])
def test_cpu_tensors_take_the_plain_version(dtype, lane_rho, shards, sigma):
    """On CPU tensors the wrapper returns the plain version's D and C (both
    of a batch-shared and of a per-lane rho, padded pairs, sigma a tensor
    or a float) and launches nothing."""
    rho, eta, E = _case(3, 5, 4, dtype, lane_rho=lane_rho, shards=shards)
    sig = torch.tensor(1e-6, dtype=dtype) if sigma == "tensor" else 1e-6
    before = assemble_d.assemble_D_fused.launches
    D, C = assemble_d.assemble_D_fused(rho, eta, E, h=0.2, sigma=sig,
                                       n_vehicles=4)
    D0, C0 = tb.assemble_D(rho, eta, E, h=0.2, sigma=sig, n_vehicles=4)
    assert torch.equal(D, D0) and torch.equal(C, C0)
    assert C.shape == ((3, 4, 3, 3) if lane_rho else (4, 3, 3))
    assert assemble_d.assemble_D_fused.launches == before


@pytest.mark.parametrize("N", range(2, 41))
def test_closed_form_pairs_reproduce_the_incidence(N):
    """The kernel reads no E: it finds pair (i, j) by the closed form of
    ``triu_indices`` order, and skips the pad pairs after the N (N - 1) / 2
    real ones.  Rebuilt from that form, E is the pair index's, with and
    without pad pairs; and the partners of each vehicle, walked in
    ascending order as the kernel sums its diagonal block, visit its pairs
    in ascending pair order, each once."""
    Pn = N * (N - 1) // 2
    for shards in (1, 3, 4, 7):
        E = (padded_pair_index(N, shards) if shards > 1
             else make_pair_index(N)).E
        rebuilt = torch.zeros_like(E)
        for i in range(N):
            for j in range(i + 1, N):
                p = _pair(i, j, N)
                rebuilt[i, p], rebuilt[j, p] = 1.0, -1.0
        assert torch.equal(rebuilt, E), shards
        assert not E[:, Pn:].any()
    for v in range(N):
        walk = [_pair(min(v, u), max(v, u), N) for u in range(N) if u != v]
        assert walk == sorted(walk)
        assert set(walk) == set(
            torch.nonzero(make_pair_index(N).E[v]).flatten().tolist())


@pytest.mark.parametrize("itemsize", [4, 8])
def test_the_plan_serves_every_n_of_the_routes(itemsize):
    """Up to N = 1024 (the grouped routes' limit) and at the batches the
    solver dispatches, the plan's tiles start 16-byte aligned on an even
    row, hold whole vehicles of the p-p slot, and fit the kernel's shared
    memory; the production shape takes one D_k a block (120 x 120 float32,
    57.6 KB) and the wide ones rows of it."""
    for N in range(1, 1025):
        n = 6 * N
        for B, K in ((512, 50), (2, 50), (1, 6), (4096, 50)):
            plan = assemble_d.assemble_plan(B, K, N, itemsize)
            assert plan.rows % 2 == 0 and 2 <= plan.rows <= n
            assert (plan.rows * n * itemsize) % 16 == 0
            assert (n * n * itemsize) % 16 == 0
            assert plan.smem <= assemble_d.SMEM_MAX
            assert plan.tiles * plan.rows >= n
    assert assemble_d.assemble_plan(512, 50, 20, 4) == (120, 1, 11200)
    assert assemble_d.assemble_plan(2, 50, 342, 4).rows == 6
    assert assemble_d.assemble_plan(1, 6, 1024, 4).rows == 2


@pytest.mark.parametrize("B,K,N,itemsize", [
    (1, 6, 4200, 8), (1, 6, 8400, 4), (2 ** 26, 50, 20, 4),
    (2 ** 17, 50, 342, 4)])
def test_the_plan_refuses_what_the_kernel_cannot_serve(B, K, N, itemsize):
    """Past the kernel's shared memory (two rows of 2N staged and their
    partner terms) or at 2^31 blocks, the plan raises, so the wrapper never
    launches a shape the kernel would refuse."""
    with pytest.raises(ValueError, match="past the kernel"):
        assemble_d.assemble_plan(B, K, N, itemsize)
