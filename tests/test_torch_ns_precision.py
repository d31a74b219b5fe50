"""The precision of the Newton-Schulz chain's tensor-core products, on the
CPU: this file models the arithmetic of the ``ns_precision="high"`` kernel
of ``csrc/ns_chain.cu`` (TF32 rounding of a hi + lo split, three passes,
float32 sums, the upper triangle mirrored), and the interior chain run with
that model is held
against ``factorize_X`` in float64 on the diagonal blocks of real problems:
the production rho pattern and collision blocks from random unit directions,
assembled by the port as the main path assembles them.  The split stays
inside NS_TOL in every (b, k) block; a single TF32 pass does not, which is
why the kernel takes three.  torch only.
"""

import numpy as np
import pytest
import torch

from ba_path_planning_torch.ops import ns_chain
from ba_path_planning_torch.ops.collisions import make_pair_index
from ba_path_planning_torch.solvers import banded as tb
from ba_path_planning_torch.utils.config import (ProblemConfig, SolverConfig,
                                                 make_solver_params)

NS_TOL = 1e-4
H = 0.2
# (B, K, N): two small fleets, and the main path's N = 20 with K cut to 8
CASES = [(3, 8, 3), (3, 10, 4), (2, 8, 20)]


def tf32_round(a):
    """float32 ``a`` rounded to TF32 (10 mantissa bits, ties away from
    zero), as the kernel's split and ``cvt.rna.tf32.f32`` round."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncate(a):
    """float32 ``a`` cut to its leading TF32 bits, as the tensor core reads
    an operand that was not rounded first."""
    return (a.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def matmul_nt_split_tf32(A, Bt):
    """``A @ Bt^T`` as the "high" kernel takes it: each float32 operand
    split into hi (rounded to TF32) and lo = a - hi (of which the tensor
    core reads the leading TF32 bits), and the three passes lo*hi + hi*lo +
    hi*hi summed in float32."""
    ah, bh = tf32_round(A), tf32_round(Bt)
    al, bl = tf32_truncate(A - ah), tf32_truncate(Bt - bh)
    return (al @ bh.mT + ah @ bl.mT) + ah @ bh.mT


def matmul_nt_tf32(A, Bt):
    """``A @ Bt^T`` in a single TF32 pass (what "default" would be)."""
    return tf32_round(A) @ tf32_round(Bt).mT


def chain_model(D, C, *, ns_iters, product=matmul_nt_split_tf32):
    """The kernel route with the interior modelled step by step as the
    "high" kernel computes it: ``product(A, Bt)`` for every ``A @ Bt^T``,
    T' = X S first, then 2X - X T'^T on and above the diagonal, mirrored.
    float32 D (B, K, n, n) and C; K >= 6."""
    K = D.shape[1]
    X = ns_chain.anchor_head(D, C)
    for k in range(3, K - 1):
        Xk = X[:, k - 1]
        S = D[:, k] - tb.bxbt(C[k - 1], Xk)
        for _ in range(ns_iters):
            upper = torch.triu(2.0 * Xk - product(Xk, product(Xk, S)))
            Xk = upper + torch.triu(upper, 1).mT
        X[:, k] = Xk
    return ns_chain.anchor_tail(X, D, C)


def _assembled(B, K, N, seed):
    """float32 D (B, K, 6N, 6N) and C (K-1, 3, 3) of the production solver
    for N vehicles: its rho, boost and sigma, random unit directions."""
    f32 = torch.float32
    P = N * (N - 1) // 2
    problem = ProblemConfig(n_vehicles=N, time_horizon=K * H, time_step=H,
                            min_distance=0.8)
    solver = SolverConfig.production(problem=problem)
    prm = make_solver_params(solver, f32, "cpu")
    rho = tb.rho_pattern_masks(
        tb.row_scaling_state(K, H, dtype=f32), solver.static_part(), prm.rho,
        prm.col_rho_boost, n_steps=K, n_pairs=P, col_enabled=True, dtype=f32)
    eta = np.random.default_rng(seed).normal(size=(B, K, P, 2))
    eta /= np.linalg.norm(eta, axis=-1, keepdims=True)
    return tb.assemble_D(rho, torch.as_tensor(eta, dtype=f32),
                         make_pair_index(N, f32).E, h=H, sigma=prm.sigma,
                         n_vehicles=N)


def _block_rel(got, want):
    diff = (got - want).abs().amax(dim=(-2, -1))
    return float((diff / want.abs().amax(dim=(-2, -1))).max())


def test_tf32_round_keeps_ten_mantissa_bits():
    a = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, -3.1415927,
                      1.0 + 2.0 ** -11 - 2.0 ** -23, 0.0])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         -3.140625, 1.0, 0.0])
    assert torch.equal(tf32_round(a), want)
    r = torch.as_tensor(np.random.default_rng(0).normal(size=4096),
                        dtype=torch.float32)
    hi = tf32_round(r)
    assert float(((r - hi).abs() / r.abs()).max()) <= 2.0 ** -11
    lo = tf32_truncate(r - hi)        # what the tensor core reads
    assert float(((r - hi - lo).abs() / r.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("B,K,N", CASES)
def test_split_product_is_float32_grade(B, K, N):
    """One product of the chain's operands: the three-pass split is within
    a few float32 roundings of float64, a single pass is ~1e-4 off."""
    D, C = _assembled(B, K, N, seed=N)
    X = ns_chain.anchor_head(D, C)[:, 2]
    S = D[:, 3] - tb.bxbt(C[2], X)
    want = X.double() @ S.double()
    split = _block_rel(matmul_nt_split_tf32(X, S).double(), want)
    single = _block_rel(matmul_nt_tf32(X, S).double(), want)
    plain = _block_rel((X @ S).double(), want)
    assert split <= 8 * max(plain, 2.0 ** -24), (split, plain)
    assert single > 20 * split, (single, split)


@pytest.mark.parametrize("B,K,N", CASES)
def test_chain_with_split_products_is_inside_ns_tol(B, K, N):
    D, C = _assembled(B, K, N, seed=10 + N)
    want = tb.factorize_X(D.double(), C.double(), ns_iters=2)
    got = chain_model(D, C, ns_iters=2)
    plain = tb.factorize_X(D, C, ns_iters=2)
    err = _block_rel(got.double(), want)
    assert err < NS_TOL, err
    # and no worse than a few times the plain float32 chain's own error
    assert err <= 4 * _block_rel(plain.double(), want) + 1e-6
    assert torch.equal(got[:, 3:K - 1], got[:, 3:K - 1].mT)


@pytest.mark.parametrize("B,K,N", CASES)
def test_chain_with_a_single_tf32_pass_is_outside_ns_tol(B, K, N):
    D, C = _assembled(B, K, N, seed=10 + N)
    want = tb.factorize_X(D.double(), C.double(), ns_iters=2)
    got = chain_model(D, C, ns_iters=2,
                                           product=matmul_nt_tf32)
    assert _block_rel(got.double(), want) > NS_TOL


def test_wrapper_rejects_an_unknown_precision():
    D, C = _assembled(2, 8, 3, seed=1)
    with pytest.raises(ValueError):
        ns_chain.factorize_X_chain_batched(D, C, ns_iters=2,
                                           ns_precision="tf32")
