"""PyTorch port, the matmul-form Cholesky (``ops/blocked_chol.py``) and
``banded.factorize_matmul``: the JAX package's ``tests/test_blocked_chol.py``
cases and tolerances, on the same seeded inputs through both packages, and
the block-tridiagonal factorization against ``factorize_xla`` at K=6,
n=36."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ba_path_planning_tpu.ops import blocked_chol as jbc

from ba_path_planning_torch.ops.blocked_chol import (chol_inv,
                                                     chol_inverse_factor,
                                                     tri_inv)
from ba_path_planning_torch.solvers.banded import (factorize_matmul,
                                                   factorize_xla)


def _spd(seed, b, n, scale=1.0):
    A = np.random.default_rng(seed).standard_normal((b, n, n)).astype(
        np.float32)
    return (np.einsum("bij,bkj->bik", A, A) / n
            + scale * np.eye(n, dtype=np.float32))


@pytest.mark.parametrize("n", [1, 3, 7, 16, 24, 60, 120])
def test_chol_inv_matches_the_library_and_jax(n):
    S = _spd(n, 4, n)
    L, Linv = chol_inv(torch.from_numpy(S))
    assert L.dtype == torch.float32
    L_ref = torch.linalg.cholesky(torch.from_numpy(S))
    np.testing.assert_allclose(L.numpy(), L_ref.numpy(), rtol=2e-4,
                               atol=2e-5)
    eye = np.eye(n, dtype=np.float32)
    np.testing.assert_allclose((L @ Linv).numpy(),
                               np.broadcast_to(eye, (4, n, n)), atol=5e-4)
    jL, jLinv = jbc.chol_inv(jnp.asarray(S))
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(chol_inverse_factor(torch.from_numpy(S))
                               .numpy(), np.asarray(jLinv), rtol=2e-3,
                               atol=5e-4)


@pytest.mark.parametrize("n", [2, 5, 16, 40])
def test_tri_inv(n):
    L = np.tril(np.random.default_rng(n + 100).standard_normal(
        (3, n, n))).astype(np.float32) + 3.0 * np.eye(n, dtype=np.float32)
    X = tri_inv(torch.from_numpy(L))
    eye = np.eye(n, dtype=np.float32)
    np.testing.assert_allclose((torch.from_numpy(L) @ X).numpy(),
                               np.broadcast_to(eye, (3, n, n)), atol=1e-4)
    np.testing.assert_allclose(X.numpy(), np.asarray(jbc.tri_inv(
        jnp.asarray(L))), rtol=1e-4, atol=1e-5)


def test_chol_inv_ill_conditioned():
    """Survives the equality-rho conditioning (~1e3 rho scale) of the
    solver's normal matrices."""
    n = 48
    rng = np.random.default_rng(7)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0].astype(np.float32)
    eigs = np.logspace(0, 4, n).astype(np.float32)   # cond 1e4
    S = (Q * eigs) @ Q.T
    S = torch.from_numpy(0.5 * (S + S.T))[None]
    L, Linv = chol_inv(S)
    resid = (L @ L.mT - S).numpy()
    assert np.max(np.abs(resid)) / 1e4 < 1e-5
    err = (L @ Linv).numpy() - np.eye(n, dtype=np.float32)
    assert np.max(np.abs(err)) < 2e-3


def test_chol_inv_takes_exact_fp32_whatever_the_caller_set():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        S = torch.from_numpy(_spd(2, 2, 24))
        L, _ = chol_inv(S)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    np.testing.assert_allclose(L.numpy(), chol_inv(S)[0].numpy(), rtol=0,
                               atol=0)


def test_factorize_matmul_matches_xla():
    """The whole block-tridiagonal factorization at solver-like shapes
    (K=6 blocks of n=36), batched, against ``factorize_xla`` (the library
    Cholesky) and the JAX package's ``factorize_matmul``."""
    from ba_path_planning_tpu.solvers.banded import (
        factorize_matmul as jfactorize_matmul)
    K, n = 6, 36
    D = np.stack([_spd(3 + b, K, n, scale=5.0) for b in range(2)])
    Bm = (0.1 * np.random.default_rng(4).standard_normal(
        (K - 1, n, n))).astype(np.float32)
    Linv_a, E_a = factorize_matmul(torch.from_numpy(D), torch.from_numpy(Bm))
    Linv_b, E_b = factorize_xla(torch.from_numpy(D), torch.from_numpy(Bm))
    assert Linv_a.shape == (2, K, n, n) and E_a.shape == (2, K - 1, n, n)
    np.testing.assert_allclose(Linv_a.numpy(), Linv_b.numpy(), rtol=5e-3,
                               atol=5e-4)
    np.testing.assert_allclose(E_a.numpy(), E_b.numpy(), rtol=5e-3,
                               atol=5e-4)
    jLinv, jE = jfactorize_matmul(jnp.asarray(D[0]), jnp.asarray(Bm))
    np.testing.assert_allclose(Linv_a[0].numpy(), np.asarray(jLinv),
                               rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(E_a[0].numpy(), np.asarray(jE), rtol=5e-3,
                               atol=5e-4)
