"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test is marked ``gpu`` and skips where there is no CUDA
device.  The file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from ba_path_planning_torch.ops import group_solve, ns_chain
from ba_path_planning_torch.ops.collisions import make_pair_index
from ba_path_planning_torch.solvers import banded as tb
from ba_path_planning_torch.utils.config import SolverConfig


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assembled(B, K, N, seed):
    """Production-shaped diagonal blocks and upper-triangular slot scalars
    (float64): the rho pattern of SolverConfig.production() and collision
    blocks from random unit directions."""
    rng = np.random.default_rng(seed)
    P = N * (N - 1) // 2
    f64 = torch.float64
    scaling = tb.row_scaling_state(K, 0.2, dtype=f64)
    rho = tb.rho_pattern_masks(
        scaling, SolverConfig.production().static_part(),
        torch.tensor(2.6, dtype=f64), torch.tensor(2.5, dtype=f64),
        n_steps=K, n_pairs=P, col_enabled=True, dtype=f64)
    eta = rng.normal(size=(B, K, P, 2))
    eta /= np.linalg.norm(eta, axis=-1, keepdims=True)
    return tb.assemble_D(rho, torch.as_tensor(eta),
                         make_pair_index(N, dtype=f64).E, h=0.2,
                         sigma=torch.tensor(1e-6, dtype=f64), n_vehicles=N)


def _sweep_case(B, K, N, seed, dtype):
    """X-form NS factors of :func:`_assembled` blocks and a right-hand
    side."""
    D, C = _assembled(B, K, N, seed)
    X = tb.factorize_X(D, C, ns_iters=2)
    b = torch.as_tensor(np.random.default_rng(seed + 1).normal(
        size=(B, K, 6 * N)))
    return X.to(dtype), C.to(dtype), b.to(dtype)


def _block_rel(got, want, block_dims):
    """Largest relative error of any (b, k) block: max |got - want| over the
    block divided by max |want| over the same block.  The production rho
    pattern spreads the blocks' scales over orders of magnitude, so an error
    confined to small blocks would hide in a whole-tensor ratio."""
    dims = tuple(range(-block_dims, 0))
    diff = (got - want).abs().amax(dim=dims)
    return float((diff / want.abs().amax(dim=dims)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("B,K,N", [(3, 10, 3), (4, 12, 4), (8, 50, 20),
                                   (2, 9, 23)])
def test_ns_chain_kernel_matches_plain(cuda, B, K, N):
    """Relative 1e-4 in every (b, k) block: the kernel sums its FP32
    products in another order than cuBLAS."""
    D, C = _assembled(B, K, N, seed=N)
    D, C = D.float().to(cuda), C.float().to(cuda)
    before = ns_chain.factorize_X_chain_batched.launches
    got = ns_chain.factorize_X_chain_batched(D, C, ns_iters=2)
    assert ns_chain.factorize_X_chain_batched.launches == before + 1
    want = ns_chain.factorize_X_chain_plain(D, C, ns_iters=2)
    torch.cuda.synchronize()
    assert _block_rel(got, want, 2) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("B,K,N", [(5, 9, 4), (64, 50, 20), (3, 10, 3)])
def test_group_solve_kernel_matches_plain(cuda, B, K, N):
    X, C, b = _sweep_case(B, K, N, seed=B, dtype=torch.float32)
    X, C, b = X.to(cuda), C.to(cuda), b.to(cuda)
    before = group_solve.solve_factorized_grouped_X.launches
    got = group_solve.solve_factorized_grouped_X(X, C, b)
    assert group_solve.solve_factorized_grouped_X.launches == before + 1
    want = group_solve.solve_factorized_grouped_X_plain(X, C, b)
    torch.cuda.synchronize()
    assert _block_rel(got, want, 1) < 1e-5


@pytest.mark.gpu
def test_kernel_wrappers_raise_on_unsupported_cuda_input(cuda):
    X, C, b = _sweep_case(2, 9, 3, seed=2, dtype=torch.float32)
    X, C, b = X.to(cuda), C.to(cuda), b.to(cuda)
    with pytest.raises(TypeError):
        group_solve.solve_factorized_grouped_X(X.double(), C.double(),
                                               b.double())
    with pytest.raises(ValueError):
        group_solve.solve_factorized_grouped_X(X[:, :-1], C, b)
    with pytest.raises(ValueError):
        group_solve.solve_factorized_grouped_X(X.mT, C, b)
    D, _ = _assembled(2, 9, 3, seed=2)
    D = D.to(cuda)
    with pytest.raises(TypeError):
        ns_chain.factorize_X_chain_batched(D, C.double(), ns_iters=2)
    with pytest.raises(ValueError):
        ns_chain.factorize_X_chain_batched(D.float(), C[:-1], ns_iters=2)
    with pytest.raises(ValueError):
        ns_chain.factorize_X_chain_batched(D.float()[:, :5], C[:4],
                                           ns_iters=2)
    static = SolverConfig.production().static_part()
    with pytest.raises(TypeError):          # the JAX router's f64 XLA chain
        tb._factorize_X_routed(D, C.double(), static)
