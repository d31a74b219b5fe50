"""PyTorch port, the two kernel modules (``ops/ns_chain.py`` and
``ops/group_solve.py``).

On the CPU each wrapper runs its plain version; those are held against the
JAX package's Pallas kernels in interpret mode and against its XLA
references.  The CUDA kernels themselves are held against the plain
versions in ``test_torch_kernels_gpu.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ba_path_planning_tpu.ops.pallas.group_solve import (
    pad_factors, solve_factorized_grouped_X as j_grouped_X)
from ba_path_planning_tpu.ops.pallas.ns_chain import (
    factorize_X_chain_batched as j_chain)
from ba_path_planning_tpu.solvers import banded as jb

from ba_path_planning_torch.ops import group_solve, ns_chain
from ba_path_planning_torch.solvers import banded as tb
from ba_path_planning_torch.utils.config import SolverConfig

from test_torch_kernels_gpu import _sweep_case


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))


def _spd_chain(B, K, N, seed, scale=0.08):
    """SPD diagonal blocks and slot scalars, as ``tests/test_ns_chain.py``
    builds them (float32)."""
    n = 6 * N
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, K, n, n)) * scale
    D = np.eye(n)[None, None] * 4.0 + np.einsum('bkij,bklj->bkil', A, A)
    C = rng.normal(size=(K - 1, 3, 3)) * 0.3
    return D.astype(np.float32), C.astype(np.float32)


@pytest.mark.parametrize("B,K,N,G", [(4, 12, 4, 2), (2, 9, 3, 1),
                                     (3, 10, 5, 3)])
def test_ns_chain_plain_matches_pallas_interpret(B, K, N, G):
    """float32, max relative 1e-5, as tests/test_ns_chain.py holds the
    Pallas kernel against the XLA chain."""
    D, C = _spd_chain(B, K, N, seed=B * K)
    want = j_chain(jnp.asarray(D), jnp.asarray(C), ns_iters=2, group=G,
                   interpret=True)
    before = ns_chain.factorize_X_chain_batched.launches
    got = ns_chain.factorize_X_chain_batched(torch.as_tensor(D),
                                             torch.as_tensor(C), ns_iters=2)
    assert got.dtype == torch.float32
    assert ns_chain.factorize_X_chain_batched.launches == before  # plain
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_factorize_X_routed_cpu_runs_plain(dtype):
    """With kernels on, CPU tensors of either dtype take the plain
    ``factorize_X`` (as the JAX router's XLA chain and the Pallas kernel's
    reference do) and launch nothing."""
    D, C = _spd_chain(2, 9, 3, seed=4)
    D, C = torch.as_tensor(D).to(dtype), torch.as_tensor(C).to(dtype)
    static = SolverConfig.production().static_part()
    assert static.kernels and static.ns_iters > 0 and static.ns_anchor == 0
    before = ns_chain.factorize_X_chain_batched.launches
    got = tb._factorize_X_routed(D, C, static)
    assert ns_chain.factorize_X_chain_batched.launches == before
    assert torch.equal(got, tb.factorize_X(D, C, ns_iters=static.ns_iters))


def test_group_solve_plain_matches_jax_f64():
    X, C, b = _sweep_case(3, 8, 3, seed=0, dtype=torch.float64)
    before = group_solve.solve_factorized_grouped_X.launches
    got = group_solve.solve_factorized_grouped_X(X, C, b)
    assert group_solve.solve_factorized_grouped_X.launches == before
    want = jax.vmap(lambda x_, b_: jb.solve_factorized_X(
        x_, jnp.asarray(C.numpy()), b_))(jnp.asarray(X.numpy()),
                                         jnp.asarray(b.numpy()))
    assert _rel(got.numpy(), want) < 1e-10


def test_group_solve_plain_matches_pallas_interpret():
    """N=4, K=9, B=5 in float32 against the grouped Pallas kernel in
    interpret mode (atol 1e-4, rtol 1e-3, as
    tests/test_pallas_kernels.py:236)."""
    X, C, b = _sweep_case(5, 9, 4, seed=1, dtype=torch.float32)
    got = group_solve.solve_factorized_grouped_X(X, C, b)
    want = j_grouped_X(pad_factors(jnp.asarray(X.numpy())),
                       jnp.asarray(C.numpy()), jnp.asarray(b.numpy()),
                       group=2, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-3)
