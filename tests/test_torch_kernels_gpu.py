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

from ba_path_planning_torch.ops import (admm_fused, banded_solve, group_solve,
                                        ns_chain)
from ba_path_planning_torch.ops.collisions import (make_pair_index,
                                                   pairwise_diffs)
from ba_path_planning_torch.ops.cuda_build import device_sms
from ba_path_planning_torch.solvers import banded as tb
from ba_path_planning_torch.solvers.scp import _warm_state
from ba_path_planning_torch.utils.config import (ProblemConfig, SolverConfig,
                                                 make_solver_params)


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
@pytest.mark.parametrize("ns_precision", ["high", "highest"])
@pytest.mark.parametrize("B,K,N", [(3, 10, 3), (4, 12, 4), (8, 50, 20),
                                   (2, 9, 23), (2, 50, 28), (2, 50, 29),
                                   (2, 50, 30), (2, 50, 40), (2, 8, 45),
                                   (2, 50, 50), (2, 50, 60), (1, 50, 40),
                                   (1, 8, 100), (2, 12, 342), (40, 9, 30)])
def test_ns_chain_kernel_matches_plain(cuda, B, K, N, ns_precision):
    """Relative 1e-4 in every (b, k) block, on the tier of
    ``ns_chain_plan`` and, by hand, on the others.  "high" takes the
    products on the tensor cores as three TF32 passes of a hi + lo split,
    "highest" as FP32 FMAs (summed in another order than cuBLAS) in the
    same tiling.  Both mirror the upper triangle of each update.  One block
    a scenario: shared memory up to N = 21, a streamed global scratch
    beyond, in one output tile up to N = 32 and several above (N = 50 and
    60: three row tiles of 128, two column tiles, the second ragged).  The
    wide tier, a block an output tile of 64, 128 or 192 (ragged at every N
    here but N = 342 in 64): every element summed in the same order as one
    block a scenario sums it, so the tiers agree bit for bit."""
    D, C = _assembled(B, K, N, seed=N)
    D, C = D.float().to(cuda), C.float().to(cuda)
    before = ns_chain.factorize_X_chain_batched.launches
    got = ns_chain.factorize_X_chain_batched(D, C, ns_iters=2,
                                             ns_precision=ns_precision)
    assert ns_chain.factorize_X_chain_batched.launches == before + 1
    want = ns_chain.factorize_X_chain_plain(D, C, ns_iters=2)
    torch.cuda.synchronize()
    # the interior is mirrored exactly
    assert torch.equal(got[:, 3:K - 1], got[:, 3:K - 1].mT)
    assert _block_rel(got, want, 2) < 1e-4
    n, head = 6 * N, ns_chain.anchor_head(D, C)
    plan = ns_chain.ns_chain_plan(B, n, ns_chain.device_sms(cuda))
    for tile in ns_chain.NS_TILES:
        if tile != plan.tile:
            other = ns_chain.chain_interior(
                D, C, head.clone(), ns_iters=2, ns_precision=ns_precision,
                _plan=ns_chain.ns_chain_plan(B, n, _tile=tile))
            torch.cuda.synchronize()
            assert torch.equal(other[:, 3:K - 1], got[:, 3:K - 1])


@pytest.mark.gpu
@pytest.mark.parametrize("ns_iters", [1, 3])
def test_ns_chain_tensor_core_kernel_iteration_counts(cuda, ns_iters):
    """One and three Newton-Schulz iterations a step: the streamed layout's
    two X buffers change roles an odd and an even number of times."""
    for B, K, N in ((2, 9, 4), (2, 9, 23), (2, 9, 34)):
        D, C = _assembled(B, K, N, seed=N)
        D, C = D.float().to(cuda), C.float().to(cuda)
        want = ns_chain.factorize_X_chain_plain(D, C, ns_iters=ns_iters)
        for ns_precision in ("high", "highest"):
            got = ns_chain.factorize_X_chain_batched(
                D, C, ns_iters=ns_iters, ns_precision=ns_precision)
            torch.cuda.synchronize()
            assert _block_rel(got, want, 2) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("ns_iters", [1, 3])
@pytest.mark.parametrize("B,K,N", [(3, 10, 3), (4, 50, 20), (2, 50, 30),
                                   (2, 9, 45)])
def test_solver_default_ns_precision_runs_the_three_pass_kernel(cuda, B, K, N,
                                                                ns_iters):
    """The solver's ``ns_precision="default"`` on the card: the NS-chain
    route launches the three-pass ("high") kernel, bit for bit, in the
    three layouts (shared memory at N = 3 and 20, S and T' streamed at
    N = 30, every operand streamed at N = 45).  Off the kernel
    (``ns_anchor > 0``) every name takes FP32 products, so "default" and
    "high" give what "highest" gives, bit for bit."""
    D, C = _assembled(B, K, N, seed=N + ns_iters)
    D, C = D.float().to(cuda), C.float().to(cuda)

    def static(ns_precision, ns_anchor=0):
        return SolverConfig.production().replace(
            ns_iters=ns_iters, ns_anchor=ns_anchor,
            ns_precision=ns_precision).static_part()
    before = ns_chain.factorize_X_chain_batched.launches
    got = tb._factorize_X_routed(D, C, static("default"))
    assert ns_chain.factorize_X_chain_batched.launches == before + 1
    want = ns_chain.factorize_X_chain_batched(D, C, ns_iters=ns_iters,
                                              ns_precision="high")
    assert torch.equal(got, want)
    fp32 = tb._factorize_X_routed(D, C, static("highest", ns_anchor=4))
    for name in ("default", "high"):
        assert torch.equal(
            tb._factorize_X_routed(D, C, static(name, ns_anchor=4)), fp32)
    assert ns_chain.factorize_X_chain_batched.launches == before + 2


# Scenarios with factors of their own; a larger batch repeats theirs.
SWEEP_DISTINCT = 64
# Its period: it divides no cluster size and no count of blocks in a wave,
# so a kernel that reads another scenario's factors does not pass.
SWEEP_PERIOD = 7


def _tiled(factors, B, K, N, seed):
    """The factors of SWEEP_PERIOD scenarios repeated to B scenarios
    (scenario b takes those of b mod SWEEP_PERIOD) and a fresh right-hand
    side for each, float32: large batches without factorizing every
    scenario."""
    idx = torch.arange(B) % factors[0].shape[0]
    b = torch.as_tensor(np.random.default_rng(seed).normal(
        size=(B, K, 6 * N)))
    return tuple(f[idx] for f in factors) + (b.float(),)


# The plans of group_solve.sweep_plan: a cluster of 4 blocks a scenario up
# to B = 32, of 2 up to B = 64, one block a scenario above (alone on its SM
# with a deep ring up to B = 132, four to an SM at B = 512), and a second
# wave of blocks beyond 528; the wide instantiation for n > 512 (N > 85),
# which the X form serves up to n = 6144 (N = 300: clusters of 4 and 2).
@pytest.mark.gpu
@pytest.mark.parametrize("B,K,N", [(5, 9, 4), (64, 50, 20), (3, 10, 3),
                                   (1, 50, 20), (3, 2, 2), (2, 500, 20),
                                   (65, 9, 21), (512, 50, 20), (600, 9, 2),
                                   (2, 50, 29), (40, 9, 40), (128, 50, 20),
                                   (2, 9, 90), (1, 2, 256), (1, 2, 300),
                                   (40, 2, 300)])
def test_group_solve_kernel_matches_plain(cuda, B, K, N):
    """Relative 1e-5 in every (b, k) block, on every branch of the plan;
    up to B = 64 also on the other tier (the wide tier where the plan takes
    a cluster, and a cluster where it takes the wide tier), which sums every
    row in the same order: the two agree bit for bit."""
    if B <= SWEEP_DISTINCT:
        X, C, b = _sweep_case(B, K, N, seed=B, dtype=torch.float32)
    else:
        X, C, _ = _sweep_case(SWEEP_PERIOD, K, N, seed=B,
                              dtype=torch.float32)
        X, b = _tiled((X,), B, K, N, seed=B + 1)
    X, C, b = X.to(cuda), C.to(cuda), b.to(cuda)
    before = group_solve.solve_factorized_grouped_X.launches
    got = group_solve.solve_factorized_grouped_X(X, C, b)
    assert group_solve.solve_factorized_grouped_X.launches == before + 1
    want = group_solve.solve_factorized_grouped_X_plain(X, C, b)
    torch.cuda.synchronize()
    assert _block_rel(got, want, 1) < 1e-5
    n = 6 * N
    wide = group_solve.sweep_wide(B, n, "X", group_solve.device_sms(cuda))
    if B <= group_solve.SWEEP_CLUSTER_B:
        other = group_solve.solve_factorized_grouped_X(
            X, C, b, _plan=group_solve.sweep_plan(B, K, n, "X",
                                                  _wide=not wide))
        torch.cuda.synchronize()
        assert torch.equal(other, got)


@pytest.mark.gpu
@pytest.mark.parametrize("form,B,K,n", [("X", 1, 2, 6144), ("X", 3, 2, 6144),
                                        ("L", 1, 2, 6144), ("L", 3, 2, 6144),
                                        ("X", 2, 50, 2052),
                                        ("X", 1, 6, 6144),
                                        ("L", 2, 50, 2052),
                                        ("L-bf16", 2, 50, 2052)])
def test_group_solve_kernel_serves_the_widest_blocks(cuda, form, B, K, n):
    """n = 6144 (N = 1024), the most the X and L forms serve, and n = 2052
    (N = 342, K = 50, the production QP's width): both forms run their
    wide tier, each scenario on a share of the card (no cluster's exchange
    buffers fit beside a ring at n = 6144, so the other tier is one block a
    scenario there, the L form's column sums added into one shared row).
    Random blocks of norm about 1 stand in for the factors (symmetric for
    X, lower triangular for L, also stored in bf16; a float64
    factorization at this size would take minutes).  Relative 1e-5 in
    every (b, k) block against the plain version; the X form's tiers agree
    bit for bit, the L form's within the same 1e-5 (their column sums meet
    in another order), and two launches of each L tier bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(B)
    A = torch.randn((B, K, n, n), generator=gen, device=cuda)
    if form == "X":
        F = (A + A.mT) / (2 * n ** 0.5)
    else:
        F = A.tril_() / n ** 0.5
    del A
    if form == "L-bf16":
        F, = tb.compress_factors(F)
    form = form[0]
    C = torch.triu(torch.randn((K - 1, 3, 3), generator=gen, device=cuda))
    if K > 2:       # slot scalars under which w_k does not grow with k
        C = C / 4
    b = torch.randn((B, K, n), generator=gen, device=cuda)
    esize = F.element_size()
    plan = group_solve.sweep_plan(B, K, n, form, esize=esize)
    assert plan.cluster == 1 and plan.spread
    kernel, plain = {
        "X": (group_solve.solve_factorized_grouped_X,
              group_solve.solve_factorized_grouped_X_plain),
        "L": (group_solve.solve_factorized_grouped_L,
              group_solve.solve_factorized_grouped_L_plain)}[form]
    got = kernel(F, C, b)
    want = plain(F, C, b)
    other = kernel(F, C, b, _plan=group_solve.sweep_plan(
        B, K, n, form, esize=esize, _wide=False))
    torch.cuda.synchronize()
    assert _block_rel(got, want, 1) < 1e-5
    if form == "X":     # one block a scenario sums every row alike
        assert torch.equal(other, got)
    else:
        assert _block_rel(other, got, 1) < 1e-5
        again = kernel(F, C, b)
        other_again = kernel(F, C, b, _plan=group_solve.sweep_plan(
            B, K, n, form, esize=esize, _wide=False))
        torch.cuda.synchronize()
        assert torch.equal(again, got)
        assert torch.equal(other_again, other)


# The L form above n = 1536 off its wide tier (batches above 32, or a plan
# named): a cluster of 2 at B = 40, one block a scenario at N = 1024.
@pytest.mark.gpu
@pytest.mark.parametrize("B,K,N,wide", [(3, 2, 300, False),
                                        (40, 2, 300, None),
                                        (2, 3, 1024, False)])
def test_l_form_above_n_1536_sums_in_a_fixed_order(cuda, B, K, N, wide):
    """The L form's instantiation above n = 1536 sums its column pairs in
    a fixed order (every thread on every row of a band, registers added
    into one shared row every 64 rows): two launches agree bit for bit,
    the result lies within 1e-5 of the plain version in every (b, k) block,
    and no farther from the float64 solve on the same factors than 4 times
    the plain float32 version (``chip_smoke.ADMM_ERR_RATIO``).  N = 1024 takes random
    lower triangular blocks of norm about 1 (see the test above)."""
    n = 6 * N
    if N == 1024:
        gen = torch.Generator(device=cuda).manual_seed(B)
        Linv = torch.randn((B, K, n, n), generator=gen,
                           device=cuda).tril_() / n ** 0.5
        C = torch.triu(torch.randn((K - 1, 3, 3), generator=gen,
                                   device=cuda)) / 4
        b = torch.randn((B, K, n), generator=gen, device=cuda)
    else:
        Linv, _, C, _ = _dense_case(min(B, SWEEP_PERIOD), K, N, seed=N)
        Linv, b = _tiled((Linv,), B, K, N, seed=B)
        Linv, C, b = Linv.to(cuda), C.to(cuda), b.to(cuda)
    plan = group_solve.sweep_plan(B, K, n, "L", _wide=wide)
    assert not plan.spread
    got = group_solve.solve_factorized_grouped_L(Linv, C, b, _plan=plan)
    again = group_solve.solve_factorized_grouped_L(Linv, C, b, _plan=plan)
    want = group_solve.solve_factorized_grouped_L_plain(Linv, C, b)
    x64 = group_solve.solve_factorized_grouped_L_plain(
        Linv.double(), C.double(), b.double())
    torch.cuda.synchronize()
    assert torch.equal(again, got)
    assert _block_rel(got, want, 1) < 1e-5
    kernel_err = _block_rel(got.double(), x64, 1)
    plain_err = _block_rel(want.double(), x64, 1)
    assert kernel_err <= 4.0 * plain_err, (kernel_err, plain_err)


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
    for name in ("default", "tf32"):    # the solver's "default" runs "high"
        with pytest.raises(ValueError):
            ns_chain.factorize_X_chain_batched(D.float(), C, ns_iters=2,
                                               ns_precision=name)
    static = SolverConfig.production().static_part()
    with pytest.raises(TypeError):          # the JAX router's f64 XLA chain
        tb._factorize_X_routed(D, C.double(), static)


def _dense_case(B, K, N, seed):
    """float32 dense (Linv, Eb) and L-only factors of :func:`_assembled`
    blocks, factorized in float64, the slot scalars and a right-hand side:
    (Linv, Eb, C, b)."""
    D, C = _assembled(B, K, N, seed)
    Linv, Eb = tb.factorize(D, tb.slot_dense(C, 2 * N))
    b = torch.as_tensor(np.random.default_rng(seed + 1).normal(
        size=(B, K, 6 * N)))
    return Linv.float(), Eb.float(), C.float(), b.float()


@pytest.mark.gpu
@pytest.mark.parametrize("B,K,N", [(3, 10, 2), (5, 9, 4), (3, 50, 20),
                                   (3, 50, 28), (3, 50, 29), (3, 50, 30),
                                   (3, 50, 40), (2, 7, 45), (1, 50, 20),
                                   (1, 9, 2), (64, 50, 20), (65, 50, 20),
                                   (512, 9, 20), (600, 2, 21), (3, 500, 4),
                                   (70, 9, 40), (2, 9, 90), (1, 2, 256),
                                   (1, 2, 300), (3, 2, 300)])
def test_group_solve_l_kernel_matches_plain(cuda, B, K, N):
    """Relative 1e-5 in every (b, k) block, one code path for every n = 6N
    and every branch of the plan (the cluster's column partial sums meet in
    distributed shared memory; at N = 45 a lane sums nine columns, at
    N = 256 48 of them; at N = 300 the block's column sums are added in
    shared memory).  Up to B = 64 also on the other tier (the wide tier
    where the plan takes a cluster, and a cluster where it takes the wide
    tier), whose column partial sums meet in another order: within the
    same 1e-5; the wide tier's result is the same bit for bit at a second
    launch."""
    if B <= SWEEP_DISTINCT:
        Linv, _, C, b = _dense_case(B, K, N, seed=N)
    else:
        Linv, _, C, _ = _dense_case(SWEEP_PERIOD, K, N, seed=N)
        Linv, b = _tiled((Linv,), B, K, N, seed=B)
    Linv, C, b = Linv.to(cuda), C.to(cuda), b.to(cuda)
    before = group_solve.solve_factorized_grouped_L.launches
    got = group_solve.solve_factorized_grouped_L(Linv, C, b)
    assert group_solve.solve_factorized_grouped_L.launches == before + 1
    want = group_solve.solve_factorized_grouped_L_plain(Linv, C, b)
    torch.cuda.synchronize()
    assert _block_rel(got, want, 1) < 1e-5
    n = 6 * N
    if B <= group_solve.SWEEP_CLUSTER_B:
        wide = group_solve.sweep_wide(B, n, "L", group_solve.device_sms(cuda))
        other_plan = group_solve.sweep_plan(B, K, n, "L", _wide=not wide)
        other = group_solve.solve_factorized_grouped_L(Linv, C, b,
                                                       _plan=other_plan)
        torch.cuda.synchronize()
        assert _block_rel(other, want, 1) < 1e-5
        wide_x, wide_plan = (got, None) if wide else (other, other_plan)
        again = group_solve.solve_factorized_grouped_L(Linv, C, b,
                                                       _plan=wide_plan)
        torch.cuda.synchronize()
        assert torch.equal(again, wide_x)


# The dense form's plans: those of the two other forms, its two blocks a
# step (4K - 3 a chain; K = 2 runs the turn after one forward pair).
@pytest.mark.gpu
@pytest.mark.parametrize("B,K,N", [(3, 10, 2), (5, 9, 4), (64, 50, 20),
                                   (3, 50, 30), (2, 7, 45), (1, 50, 20),
                                   (32, 50, 20), (128, 50, 20), (512, 50, 20),
                                   (65, 9, 21), (600, 2, 2), (1, 2, 2),
                                   (3, 500, 4), (2, 50, 40), (2, 9, 90),
                                   (1, 2, 256)])
def test_banded_solve_kernel_matches_plain(cuda, B, K, N):
    """Relative 1e-5 in every (b, k) block, on every branch of the plan;
    the factors of batches above SWEEP_DISTINCT repeat with
    SWEEP_PERIOD."""
    if B <= SWEEP_DISTINCT:
        Linv, Eb, _, b = _dense_case(B, K, N, seed=N)
    else:
        Linv, Eb, _, _ = _dense_case(SWEEP_PERIOD, K, N, seed=N)
        Linv, Eb, b = _tiled((Linv, Eb), B, K, N, seed=B)
    Linv, Eb, b = Linv.to(cuda), Eb.to(cuda), b.to(cuda)
    before = banded_solve.solve_factorized_dense.launches
    got = banded_solve.solve_factorized_dense(Linv, Eb, b)
    same = group_solve.solve_factorized_grouped(Linv, Eb, b)
    assert banded_solve.solve_factorized_dense.launches == before + 2
    want = banded_solve.solve_factorized_dense_plain(Linv, Eb, b)
    torch.cuda.synchronize()
    assert _block_rel(got, want, 1) < 1e-5
    assert torch.equal(got, same)


@pytest.mark.gpu
def test_l_form_wrappers_raise_on_unsupported_cuda_input(cuda):
    Linv, Eb, C, b = (t.to(cuda) for t in _dense_case(2, 9, 3, seed=2))
    with pytest.raises(TypeError):
        group_solve.solve_factorized_grouped_L(Linv.double(), C.double(),
                                               b.double())
    with pytest.raises(ValueError):
        group_solve.solve_factorized_grouped_L(Linv.mT, C, b)
    with pytest.raises(ValueError):
        group_solve.solve_factorized_grouped_L(Linv[:, :-1], C, b)
    with pytest.raises(TypeError):
        banded_solve.solve_factorized_dense(Linv, Eb.double(), b)
    with pytest.raises(ValueError):
        banded_solve.solve_factorized_dense(Linv, Eb[:, :-1], b)
    with pytest.raises(ValueError):
        banded_solve.solve_factorized_dense(Linv.cpu(), Eb, b)


def _to64(args):
    """float64 copies of interval arguments (a tuple, or a dict of keyword
    arguments whose tensors are converted)."""
    if isinstance(args, dict):
        return {k: v.double() if isinstance(v, torch.Tensor) else v
                for k, v in args.items()}
    return tuple(tb.tree_map(lambda t: t.double(), a) if isinstance(a, tuple)
                 else a.double() for a in args)


def _interval_case(B, K, N, seed, device, form="X", hard=False,
                   lane_rho=None):
    """Inputs of one fused ADMM interval at main-path shapes, float32:
    bounds of random start and goal positions, collision rows of random
    unit directions about the start positions (row 0 vacuous), the
    production rho pattern and X-form factors from the NS route
    (``form="X"``) or dense (Linv, Eb) factors (``form="L"``).  ``hard``
    sets the collision penalty to +inf (hard rows).  ``lane_rho`` (B,)
    gives each lane its own rho (adaptive rho): per-lane rho planes, and
    in the X form per-lane slot scalars, its factors those of M / rho
    scaled back, as the solver makes them.  The state (x, z, y) is
    warm, as an SCP iteration finds it: one float64 plain interval from x at
    rest, z = clip(A x, l, u) and y = 0.  Returns the positional and keyword
    arguments of ``admm_interval_fused_X`` or ``admm_interval_fused``."""
    rng = np.random.default_rng(seed)
    f32, h = torch.float32, 0.2
    P = N * (N - 1) // 2
    problem = ProblemConfig(n_vehicles=N, time_horizon=K * h, time_step=h,
                            min_distance=0.8)
    solver = SolverConfig.production(problem=problem)
    prm = make_solver_params(solver, f32, device)
    p0, pf = (torch.as_tensor(rng.uniform(2.0, 18.0, (B, N, 2)), dtype=f32,
                              device=device) for _ in range(2))
    v0 = torch.zeros_like(p0)
    pairs = make_pair_index(N, f32, device)
    lower, upper = tb.build_bounds(p0, v0, pf, v0, n_vehicles=N, n_steps=K,
                                   h=h, limits=problem.limits, n_pairs=P)
    eta = torch.as_tensor(rng.normal(size=(B, K, P, 2)), dtype=f32,
                          device=device)
    eta = eta / torch.linalg.vector_norm(eta, dim=-1, keepdim=True)
    x = _warm_state(torch.zeros((B, N, K, 2), dtype=f32, device=device), p0,
                    v0, h)
    prev = p0[..., None, :].expand(B, N, K, 2).contiguous()
    dist = torch.linalg.vector_norm(pairwise_diffs(prev, pairs), dim=-1)
    lower = lower._replace(col=tb.collision_lower_bounds_state(
        eta, dist, prev, pairs, min_distance=0.93))
    scaling = tb.row_scaling_state(K, h, dtype=f32, device=device)
    rho = tb.rho_pattern_masks(
        scaling, solver.static_part(),
        prm.rho if lane_rho is None else lane_rho.to(device),
        prm.col_rho_boost, n_steps=K, n_pairs=P, col_enabled=True, dtype=f32)
    D, C = tb.assemble_D(rho, eta, pairs.E, h=h, sigma=prm.sigma,
                         n_vehicles=N)
    def factorize_X(D, C):
        # the solver's X-form route: the NS chain from K = 6 on, below it
        # factorize_X
        if K >= 6:
            return ns_chain.factorize_X_chain_batched(D, C, ns_iters=2)
        return tb.factorize_X(D, C, ns_iters=2)
    if form == "X" and lane_rho is not None:
        C1 = tb.unit_slot_scalars(solver.static_part(), n_steps=K, h=h,
                                  device=device)
        scale = lane_rho.to(device, f32).reshape(-1, 1, 1, 1)
        factors = (factorize_X((D / scale).contiguous(), C1) / scale, C)
    elif form == "X":
        factors = (factorize_X(D, C), C)
    else:
        factors = tuple(t.float() for t in tb.factorize(
            D.double(), tb.slot_dense(C.double(), 2 * N)))
    z = tb.tree_map(torch.clamp, tb.apply_A(x, eta, pairs.E, h), lower, upper)
    y = tb.tree_map(torch.zeros_like, z)
    args = factors + (eta, pairs.E, lower, upper, x, z, y, rho)
    lam = torch.full_like(prm.col_penalty, np.inf) if hard \
        else prm.col_penalty
    kw = dict(h=h, sigma=prm.sigma, alpha=prm.alpha, lam=lam)
    warm = _FUSED[form][1](*_to64(args), n_iters=25, **_to64(kw))
    state = tuple(tb.tree_map(lambda t: t.float(), v) for v in warm)
    return args[:6] + state + args[9:], kw


# factor form -> (kernel wrapper, plain version)
_FUSED = {"X": (admm_fused.admm_interval_fused_X,
                admm_fused.admm_interval_fused_X_plain),
          "L": (admm_fused.admm_interval_fused,
                admm_fused.admm_interval_fused_plain)}


def _interval_rows(out, K):
    """(B, K, .) rows of an interval's (x, z, y): x stacked, and z and y as
    their static plane and collision rows side by side."""
    x, z, y = out

    def rows(rv):
        return torch.cat([admm_fused.static_plane(rv, K).flatten(-2), rv.col],
                         dim=-1)
    return tb.to_stacked(x), rows(z), rows(y)


def _fused_x_plan(cuda, B, K, N, wide):
    """The X-form fused interval's plan on this card, its wide tier or
    its one-block tier as ``wide`` says."""
    return admm_fused.fused_x_plan(B, K, N, sms=device_sms(cuda), _wide=wide)


def _check_interval(cuda, B, K, N, n_iters, form, hard, lane_rho=None,
                    bf16=False, wide=None):
    args, kw = _interval_case(B, K, N, seed=N, device=cuda, form=form,
                              hard=hard, lane_rho=lane_rho)
    if bf16:        # the factors stored in bf16, as the solver stores them
        args = tb.compress_factors(*args[:2]) + args[2:]
    kernel, plain = _FUSED[form]
    tier, counter = {}, kernel
    if form == "X":     # on the tier ``wide`` names, or on the card's plan
        plan = _fused_x_plan(cuda, B, K, N, wide)
        if wide is not None:
            tier["_plan"] = plan
            assert bool(plan.spread) == wide
        # the wide tier's kernel counts its launches apart
        counter = kernel.wide if plan.spread else kernel
    before = counter.launches
    got = kernel(*args, n_iters=n_iters, **kw, **tier)
    assert counter.launches == before + 1
    want = plain(*args, n_iters=n_iters, **kw)
    ref = _interval_rows(plain(*_to64(args), n_iters=n_iters, **_to64(kw)),
                         K)
    torch.cuda.synchronize()
    got_r, want_r = _interval_rows(got, K), _interval_rows(want, K)
    assert all(bool(torch.isfinite(g).all()) for g in got_r)
    errs = [_block_rel(g, w, 1) for g, w in zip(got_r, want_r)]
    if n_iters == 1:
        assert max(errs[:2]) < 2e-4, errs
    checked = slice(2, 3) if n_iters == 1 else slice(0, 3)
    for g, w, r in list(zip(got_r, want_r, ref))[checked]:
        kernel_err = _block_rel(g.double(), r, 1)
        plain_err = _block_rel(w.double(), r, 1)
        assert kernel_err <= 4.0 * plain_err, (kernel_err, plain_err, errs)


@pytest.mark.gpu
@pytest.mark.parametrize("n_iters", [1, 2, 25])
@pytest.mark.parametrize("B,K,N", [(3, 10, 4), (4, 50, 30), (2, 50, 40),
                                   (2, 330, 30), (1, 50, 22), (3, 50, 22),
                                   (1, 50, 40), (33, 9, 30), (3, 9, 20),
                                   (3, 9, 39), (2, 6, 90), (2, 50, 50),
                                   (2, 50, 60), (2, 2, 584), (2, 6, 341),
                                   (3, 9, 268)])
def test_admm_fused_kernel_matches_plain(cuda, B, K, N, n_iters):
    """Every (b, k) row block of x and z within 2e-4 (relative to the
    block's largest entry) of the plain version after one iteration, at
    the production N = 22, 30 and 40 (one scenario, and batches below the
    path's chunk of 128); the factor ring wraps on other (stage, phase)
    counts for other K, N and n_iters; at K = 330 the sweep plane no
    longer fits in shared memory; the kernel reads packed triangles from
    N = 39 (N = 39 has padding columns in them, N = 40 none; N = 50 and 60,
    the widest the production sweep runs, too) and whole bands below and
    at N = 90 (n = 540); short horizons of large fleets, where the router
    sends the fused route up to N = 584 at K = 2 (n = 3504, whole bands
    of 2 rows), N = 341 at K = 6 and N = 268 at K = 9.  The
    duals y = y + rho (zr - z) multiply the rounding of zr by rho (up to
    ~5e3 on the equality rows), and 25 iterations amplify rounding further
    (alpha = 1.9), so the y blocks, and every block after 25 iterations,
    may be off float64 by at most 4x the plain FP32 version's error."""
    _check_interval(cuda, B, K, N, n_iters, "X", hard=False)


@pytest.mark.gpu
@pytest.mark.parametrize("n_iters", [1, 2, 25])
@pytest.mark.parametrize("B,K,N", [(3, 10, 4), (3, 9, 4), (3, 10, 2),
                                   (3, 9, 20), (4, 50, 20), (2, 50, 29),
                                   (2, 500, 20), (3, 3, 86), (3, 3, 90),
                                   (2, 2, 147)])
def test_admm_fused_l_kernel_matches_plain(cuda, B, K, N, n_iters):
    """The L-form kernel, held as the X-form one is.  Every block comes
    through the factor ring as whole row bands, so the number of bands an
    interval streams, and with it how often the ring wraps and on which
    (stage, phase) it ends, follows from K, n_iters and the bands a block
    splits into (N = 2, 4, 20 and 29 give other counts); at K = 500 the
    sweep plane no longer fits in shared memory.  N = 86, 90 (K = 3) and
    147 (K = 2) run the wide instantiation (7 column octets a warp), where
    the router sends short horizons."""
    _check_interval(cuda, B, K, N, n_iters, "L", hard=False)


@pytest.mark.gpu
@pytest.mark.parametrize("form,N", [("X", 30), ("L", 20)])
@pytest.mark.parametrize("n_iters", [1, 25])
def test_admm_fused_kernels_with_hard_collision_rows(cuda, form, N, n_iters):
    """lam = +inf (hard collision rows) beside the disabled row k = 0
    (lower bound -inf): finite results that agree with the plain version,
    which clips a violated row onto its bound."""
    _check_interval(cuda, 3, 50, N, n_iters, form, hard=True)


@pytest.mark.gpu
@pytest.mark.parametrize("form,N", [("X", 30), ("X", 40), ("L", 20)])
@pytest.mark.parametrize("B", [1, 64, 128])
@pytest.mark.parametrize("n_iters", [1, 25])
def test_admm_fused_kernels_with_lane_rho(cuda, form, N, B, n_iters):
    """Adaptive rho: one rho a lane, spread over two decades around the
    production rho, read through the kernels' per-lane strides (rho planes,
    and the X form's slot scalars), held as the shared-rho cases are."""
    rng = np.random.default_rng(B + N)
    lane_rho = torch.as_tensor(2.6 * np.exp(rng.uniform(-2.3, 2.3, B)),
                               dtype=torch.float32)
    _check_interval(cuda, B, 50, N, n_iters, form, hard=False,
                    lane_rho=lane_rho)


# (B, K, N) of short horizons over large fleets that the router sends to
# the X-form fused route, up to its widest N at K = 2, 6 and 9
SHORT_HORIZONS = [(2, 2, 584), (2, 6, 341), (3, 9, 268)]


@pytest.mark.gpu
@pytest.mark.parametrize("n_iters", [1, 25])
@pytest.mark.parametrize("B,K,N", SHORT_HORIZONS)
def test_admm_fused_x_short_horizons_with_lane_rho(cuda, B, K, N, n_iters):
    """The X-form kernel with one rho a lane at the short horizons, held
    as :func:`test_admm_fused_kernels_with_lane_rho` holds K = 50."""
    rng = np.random.default_rng(B + N)
    lane_rho = torch.as_tensor(2.6 * np.exp(rng.uniform(-2.3, 2.3, B)),
                               dtype=torch.float32)
    _check_interval(cuda, B, K, N, n_iters, "X", hard=False,
                    lane_rho=lane_rho)


@pytest.mark.gpu
@pytest.mark.parametrize("lane", [False, True])
@pytest.mark.parametrize("B,K,N", SHORT_HORIZONS)
def test_admm_fused_x_short_horizons_bit_for_bit(cuda, B, K, N, lane):
    """Two launches of the X-form kernel on the same inputs, shared rho or
    one rho a lane, give the same bits (no atomics: every sum in a fixed
    order)."""
    lane_rho = None
    if lane:
        lane_rho = torch.as_tensor(np.linspace(0.5, 12.0, B),
                                   dtype=torch.float32)
    args, kw = _interval_case(B, K, N, seed=N, device=cuda, lane_rho=lane_rho)
    first, second = (_interval_rows(admm_fused.admm_interval_fused_X(
        *args, n_iters=25, **kw), K) for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# (B, K, N) of the X-form fused interval's wide tier: the short horizons
# and a latency shape (one scenario at the production horizon)
WIDE_TIER = SHORT_HORIZONS + [(1, 50, 40)]


@pytest.mark.gpu
@pytest.mark.parametrize("n_iters", [1, 25])
@pytest.mark.parametrize("wide", [True, False])
@pytest.mark.parametrize("B,K,N", WIDE_TIER)
def test_admm_fused_x_tiers_match_plain(cuda, B, K, N, wide, n_iters):
    """The X-form fused interval on each of its tiers at the short
    horizons and at N = 40, K = 50, B = 1, held to the plain version as
    :func:`test_admm_fused_kernel_matches_plain` holds it: the wide tier
    (each scenario over many SMs, every read of another block's rows
    through L2 after a barrier: a stale line would show after 25
    iterations) and the one-block tier."""
    _check_interval(cuda, B, K, N, n_iters, "X", hard=False, wide=wide)


@pytest.mark.gpu
@pytest.mark.parametrize("n_iters", [1, 25])
@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("B,K,N", WIDE_TIER)
def test_admm_fused_x_wide_tier_with_lane_rho(cuda, B, K, N, hard, n_iters):
    """The wide tier with one rho a lane (per-lane rho planes and slot
    scalars through the kernel's strides), with the production penalty and
    with hard collision rows (lam = +inf)."""
    rng = np.random.default_rng(B + N + K)
    lane_rho = torch.as_tensor(2.6 * np.exp(rng.uniform(-2.3, 2.3, B)),
                               dtype=torch.float32)
    _check_interval(cuda, B, K, N, n_iters, "X", hard=hard,
                    lane_rho=lane_rho, wide=True)


@pytest.mark.gpu
@pytest.mark.parametrize("B,K,N", WIDE_TIER)
def test_admm_fused_x_wide_tier_bit_for_bit(cuda, B, K, N):
    """Two launches of the wide tier on the same inputs give the same
    bits, and so does the one-block tier wherever both read whole bands
    (n > 512; the one-block tier reads packed triangles from N = 39 to 85):
    every row is summed by the same code in the same order on both."""
    args, kw = _interval_case(B, K, N, seed=N, device=cuda)
    wide = _fused_x_plan(cuda, B, K, N, True)
    first, second = (_interval_rows(admm_fused.admm_interval_fused_X(
        *args, n_iters=25, **kw, _plan=wide), K) for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    one = _fused_x_plan(cuda, B, K, N, False)
    if not one.packed:
        assert 6 * N > 512
        other = _interval_rows(admm_fused.admm_interval_fused_X(
            *args, n_iters=25, **kw, _plan=one), K)
        for a, b in zip(first, other):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_admm_fused_x_wide_tier_refused_launch_raises(cuda):
    """A wide plan whose blocks the card cannot hold all at once is a
    cooperative launch the runtime refuses: the wrapper raises, and no
    other tier or plain version runs in its place."""
    B, K, N = 2, 9, 268
    args, kw = _interval_case(B, K, N, seed=7, device=cuda)
    sms = device_sms(cuda)
    # one block too many a scenario, each taking more than half an SM's
    # shared memory: one block an SM
    plan = admm_fused.fused_wide_fit(K, N, sms // B + 1, 1)
    assert B * plan.spread > sms
    assert 2 * (plan.smem_bytes + 1024) > group_solve.SMEM_SM
    counters = (admm_fused.admm_interval_fused_X,
                admm_fused.admm_interval_fused_X.wide)
    before = [c.launches for c in counters]
    with pytest.raises(RuntimeError):
        admm_fused.admm_interval_fused_X(*args, n_iters=2, **kw, _plan=plan)
    assert [c.launches for c in counters] == before


@pytest.mark.gpu
def test_production_qp_on_the_fused_x_route_at_k6_n341(cuda, monkeypatch):
    """A production solve_qp_state at K = 6, N = 341, B = 2 (the widest N
    the router sends to ``fused_X`` at K = 6) runs on the fused kernel's
    wide tier, one launch an interval, against the same call with the
    plain interval in its place: equal iteration counts and convergence
    flags, x of every (b, k) block within 2e-4."""
    N, K, B = 341, 6, 2
    assert _fused_x_plan(cuda, B, K, N, None).spread
    args, _ = _interval_case(B, K, N, seed=341, device=cuda)
    eta, E, lower, upper, x = args[2], args[3], args[4], args[5], args[6]
    problem = ProblemConfig(n_vehicles=N, time_horizon=K * 0.2,
                            time_step=0.2, min_distance=0.8)
    solver = SolverConfig.production(problem=problem)
    static = solver.static_part()
    assert tb.qp_route(static, n_vehicles=N, n_steps=K, dtype=torch.float32,
                       col_enabled=True) == "fused_X"
    prm = make_solver_params(solver, torch.float32, cuda)

    def solve():
        return tb.solve_qp_state(lower, upper, eta, x, prm, E, h=0.2,
                                 static=static, n_vehicles=N)
    counters = (admm_fused.admm_interval_fused_X.wide,
                admm_fused.admm_interval_fused_X)
    before = [c.launches for c in counters]
    got = solve()
    launched, one_block = (c.launches - n for c, n in zip(counters, before))
    monkeypatch.setattr(admm_fused, "admm_interval_fused_X",
                        admm_fused.admm_interval_fused_X_plain)
    want = solve()
    torch.cuda.synchronize()
    assert launched == -(-int(got.iters.max()) // solver.check_interval) > 0
    assert one_block == 0
    assert torch.equal(got.iters, want.iters)
    assert torch.equal(got.converged, want.converged)
    gx, wx = tb.to_stacked(got.x), tb.to_stacked(want.x)
    assert bool(torch.isfinite(gx).all())
    assert _block_rel(gx, wx, 1) < 2e-4


@pytest.mark.gpu
@pytest.mark.parametrize("form,N", [("X", 30), ("L", 20)])
def test_admm_fused_kernels_shared_rho_bit_for_bit(cuda, form, N):
    """Stride 0 (batch-shared rho planes and slot scalars) and per-lane
    planes that all hold the same rho give the same bits."""
    args, kw = _interval_case(8, 50, N, seed=N, device=cuda, form=form)
    kernel = _FUSED[form][0]
    rho = args[-1]
    B = args[2].shape[0]
    lane = tb.RowVals(*(t.expand((B, 1) + t.shape).contiguous()
                        for t in rho[:-1]),
                      col=rho.col.expand((B,) + rho.col.shape).contiguous())
    shared = kernel(*args, n_iters=25, **kw)
    if form == "X":
        C = args[1]
        args = (args[0], C.expand((B,) + C.shape).contiguous()) + args[2:]
    per_lane = kernel(*args[:-1], lane, n_iters=25, **kw)
    for a, b in zip(_interval_rows(shared, 50), _interval_rows(per_lane, 50)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_admm_fused_wrapper_raises_on_unsupported_cuda_input(cuda):
    args, kw = _interval_case(2, 10, 3, seed=1, device=cuda)
    X = args[0]
    with pytest.raises(TypeError):
        admm_fused.admm_interval_fused_X(*_to64(args), n_iters=1,
                                         **_to64(kw))
    with pytest.raises(ValueError):
        admm_fused.admm_interval_fused_X(X.mT, *args[1:], n_iters=1, **kw)
    with pytest.raises(ValueError):
        admm_fused.admm_interval_fused_X(X[:, :-1], *args[1:], n_iters=1,
                                         **kw)
    args, kw = _interval_case(2, 10, 3, seed=1, device=cuda, form="L")
    Linv, Eb = args[:2]
    with pytest.raises(TypeError):
        admm_fused.admm_interval_fused(*_to64(args), n_iters=1, **_to64(kw))
    with pytest.raises(ValueError):
        admm_fused.admm_interval_fused(Linv.mT, *args[1:], n_iters=1, **kw)
    with pytest.raises(ValueError):
        admm_fused.admm_interval_fused(Linv, Eb[:, :-1], *args[2:],
                                       n_iters=1, **kw)


@pytest.mark.gpu
def test_graphed_interval_replays_the_eager_kernels(cuda):
    """An ADMM interval of the dense route (no hand-written kernel) as a
    CUDA graph: eager on the first call, captured on the second, replayed
    after; each call gives the bits of an eager call on its inputs."""
    from ba_path_planning_torch.utils.graphs import graphed
    args, kw = _interval_case(4, 20, 5, seed=3, device=cuda, form="L")
    Linv, Eb, eta, E, lower, upper, x, z, y, rho = args

    def interval(x, z, y):
        return tb.admm_iterations(
            x, z, y, lambda sb: tb.solve_factorized(Linv, Eb, sb), eta, E,
            lower, upper, rho, n_iters=5, **kw)
    run = graphed(interval)
    state = (x, z, y)
    for _ in range(4):
        got, want = run(*state), interval(*state)
        for g, w in zip(_interval_rows(got, 20), _interval_rows(want, 20)):
            assert torch.equal(g, w)
        state = want


@pytest.mark.gpu
def test_cg_method_on_the_card_matches_the_cpu(cuda):
    """``SCPEngine(problem)`` with the default ``SolverConfig()`` (the CG
    method, its check intervals replayed as CUDA graphs) in float64 on the
    card against the same solve on the CPU, on swap-and-cross layouts of
    three vehicles whose QPs converge: equal statuses and iteration counts,
    positions within 1e-6 m."""
    from ba_path_planning_torch.solvers.scp import SCPEngine
    problem = ProblemConfig(n_vehicles=3, time_horizon=2.0, time_step=0.2,
                            min_distance=0.3, stop_mode="feasible",
                            goal_project=True)
    rng = np.random.default_rng(0)
    ang = np.linspace(0, 2 * np.pi, 3, endpoint=False)
    p0, pf = np.zeros((4, 3, 2)), np.zeros((4, 3, 2))
    for b in range(4):
        rot = rng.uniform(0, np.pi)
        base = np.stack([np.cos(ang + rot), np.sin(ang + rot)], -1) * (
            1.2 + 0.1 * b)
        p0[b] = 10 + base + rng.normal(scale=0.05, size=(3, 2))
        pf[b] = 10 - base + rng.normal(scale=0.05, size=(3, 2))
    v0 = np.zeros_like(p0)
    out = {}
    for dev in ("cpu", cuda):
        eng = SCPEngine(problem, dtype=torch.float64, device=dev)
        out[str(dev)] = eng.solve_batch(p0, v0, pf, v0)
    cpu, gpu = out["cpu"], out[str(cuda)]
    assert bool(cpu.qp_converged_all.all())
    for name in ("status", "iterations", "qp_iterations"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name))
    assert float((gpu.positions.cpu() - cpu.positions).abs().max()) <= 1e-6


# bf16 factor storage (SolverConfig.factor_dtype="bf16"): the plans of the
# main paths (N = 20 at B = 512, 64 and 1), n = 6N no multiple of 8
# (N = 21, 30), where the rows lie on a padded stride, and n = 540 (N = 90),
# the wide instantiations (the dense form's tier of n <= 1536)
BF16_SWEEP_CASES = [(512, 50, 20), (64, 50, 20), (1, 50, 20), (128, 50, 21),
                    (128, 50, 30), (3, 9, 4), (2, 9, 90)]


def _bf16_sweep(form, B, K, N, cuda):
    """(kernel wrapper, plain version, bf16 factors, the other operand,
    b) of a sweep form on the card, the factors stored by
    ``compress_factors``."""
    if form == "X":
        X, C, b = _sweep_case(min(B, SWEEP_PERIOD), K, N, seed=N,
                              dtype=torch.float32)
        factors = (X,)
    else:
        Linv, Eb, C, b = _dense_case(min(B, SWEEP_PERIOD), K, N, seed=N)
        factors = (Linv,) if form == "L" else (Linv, Eb)
    if B > SWEEP_PERIOD:
        *factors, b = _tiled(factors, B, K, N, seed=B)
    stored = tb.compress_factors(*(f.to(cuda) for f in factors))
    second = stored[1] if form == "dense" else C.to(cuda)
    kernel, plain = {
        "X": (group_solve.solve_factorized_grouped_X,
              group_solve.solve_factorized_grouped_X_plain),
        "L": (group_solve.solve_factorized_grouped_L,
              group_solve.solve_factorized_grouped_L_plain),
        "dense": (banded_solve.solve_factorized_dense,
                  banded_solve.solve_factorized_dense_plain)}[form]
    return kernel, plain, stored[0], second, b.to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["X", "L", "dense"])
@pytest.mark.parametrize("B,K,N", BF16_SWEEP_CASES)
def test_sweep_kernels_read_bf16_factors(cuda, form, B, K, N):
    """The three sweep forms on bf16 factors (column pairs read as one
    __nv_bfloat162, widened in registers, FP32 sums) against the plain
    version on the same bf16 factors (widened to float32 block by block):
    relative 1e-5 in every (b, k) block, as on float32 factors."""
    kernel, plain, F_, G, b = _bf16_sweep(form, B, K, N, cuda)
    assert F_.dtype == torch.bfloat16 and F_.stride(-2) % 8 == 0
    before = kernel.launches
    got = kernel(F_, G, b)
    assert kernel.launches == before + 1
    want = plain(F_, G, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert _block_rel(got, want, 1) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("n_iters", [1, 25])
@pytest.mark.parametrize("B,K,N", [(128, 50, 20), (64, 50, 20), (3, 9, 4),
                                   (2, 50, 21), (3, 50, 22), (3, 50, 23),
                                   (3, 3, 90)])
def test_admm_fused_l_kernel_reads_bf16_factors(cuda, B, K, N, n_iters):
    """The L-form fused interval on bf16 (Linv, Eb), held to the plain
    version on the same bf16 factors as on float32 ones; N = 21 has padded
    rows, N = 22 and 23 (n = 132, 138) end in a part of a column group of
    the transposed products, and K = 3, N = 90 runs the widest
    instantiation."""
    _check_interval(cuda, B, K, N, n_iters, "L", hard=False, bf16=True)


@pytest.mark.gpu
def test_f32_factors_take_the_f32_instantiation(cuda, monkeypatch):
    """float32 factors launch the ``_f32`` entry points, bf16 ones the
    ``_bf16`` ones; and on factors whose float32 values are bf16 values the
    two instantiations of the X-form sweep agree within relative 1e-5 in
    every (b, k) block: their FP32 sums differ in order only (a lane of the
    bf16 one sums column pairs), so the bf16 kernel reads the same numbers
    the float32 one does (an element misread would be off by bf16's
    rounding, 4e-3)."""
    from ba_path_planning_torch.ops import cuda_build
    called = []

    class Spy:
        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, name):
            called.append(name)
            return getattr(self.lib, name)
    lib = cuda_build.load_kernels()
    monkeypatch.setattr(group_solve, "load_kernels", lambda: Spy(lib))
    X, C, b = _sweep_case(64, 50, 20, seed=3, dtype=torch.float32)
    X16, = tb.compress_factors(X.to(cuda))
    X32 = X16.float()
    C, b = C.to(cuda), b.to(cuda)
    x32 = group_solve.solve_factorized_grouped_X(X32, C, b)
    x16 = group_solve.solve_factorized_grouped_X(X16, C, b)
    Linv, _, CL, bL = (t.to(cuda) for t in _dense_case(3, 9, 4, seed=4))
    group_solve.solve_factorized_grouped_L(Linv, CL, bL)
    group_solve.solve_factorized_grouped_L(*tb.compress_factors(Linv), CL,
                                           bL)
    torch.cuda.synchronize()
    assert called == ["group_solve_x_f32", "group_solve_x_bf16",
                      "group_solve_l_f32", "group_solve_l_bf16"]
    assert _block_rel(x16, x32, 1) < 1e-5


@pytest.mark.gpu
def test_bf16_wrappers_raise_on_unsupported_layouts(cuda):
    """bf16 factors that do not lie on the rows of ``compress_factors``, or
    a pair of mixed types, are refused before any launch."""
    Linv, Eb, C, b = (t.to(cuda) for t in _dense_case(2, 9, 3, seed=2))
    with pytest.raises(ValueError):         # n = 18, rows of 18, not 24
        group_solve.solve_factorized_grouped_L(Linv.bfloat16(), C, b)
    L16, E16 = tb.compress_factors(Linv, Eb)
    with pytest.raises(TypeError):
        banded_solve.solve_factorized_dense(L16, Eb, b)
    args, kw = _interval_case(2, 10, 3, seed=1, device=cuda, form="L")
    with pytest.raises(ValueError):
        admm_fused.admm_interval_fused(args[0].bfloat16(), args[1].bfloat16(),
                                       *args[2:], n_iters=1, **kw)
    args, kw = _interval_case(2, 10, 3, seed=1, device=cuda, form="X")
    with pytest.raises(ValueError):          # the X form keeps float32
        admm_fused.admm_interval_fused_X(*tb.compress_factors(args[0]),
                                         *args[1:], n_iters=1, **kw)


# ---------------------------------------------------------------------------
# The ADMM stages and the channel interval (ops/admm_steps.py)
# ---------------------------------------------------------------------------

def _stage_rows(rows):
    """(B, K, .) rows of a Rows state: x, and z and y as their static plane
    and collision rows side by side."""
    return (rows.x, torch.cat([rows.zs.flatten(-2), rows.zc], dim=-1),
            torch.cat([rows.ys.flatten(-2), rows.yc], dim=-1))


def _channel_stages_case(cuda, B, K, N, lane_rho=None):
    """Phase 1's operands on the channel route, float32 on the card,
    without collision blocks: bounds of random start and goal positions,
    eta = 0, the collision-free QP's rho (one a lane with ``lane_rho``) and
    its per-channel factors, about half of the collision lower bounds -inf
    and the rest finite; the state warm from one float64 plain interval of
    25 iterations (x at rest, z = clip(A x, l, u), y = 0), then a random
    finite collision state (the kernel must serve any)."""
    from ba_path_planning_torch.ops import admm_steps
    rng = np.random.default_rng(B + K + N)
    f32, h = torch.float32, 0.2
    P = N * (N - 1) // 2
    problem = ProblemConfig(n_vehicles=N, time_horizon=K * h, time_step=h,
                            min_distance=0.8)
    solver = SolverConfig.production(problem=problem)
    prm = make_solver_params(solver, f32, cuda)
    p0, pf = (torch.as_tensor(rng.uniform(2.0, 18.0, (B, N, 2)), dtype=f32,
                              device=cuda) for _ in range(2))
    v0 = torch.zeros_like(p0)
    lower, upper = tb.build_bounds(p0, v0, pf, v0, n_vehicles=N, n_steps=K,
                                   h=h, limits=problem.limits, n_pairs=P)
    l_col = torch.as_tensor(rng.normal(size=(B, K, P)), dtype=f32,
                            device=cuda)
    off = torch.as_tensor(rng.uniform(size=(B, K, P)) < 0.5, device=cuda)
    lower = lower._replace(col=l_col.masked_fill(off, -np.inf))
    rho = tb.rho_pattern_masks(
        tb.row_scaling_state(K, h, dtype=f32, device=cuda),
        solver.static_part(), prm.rho if lane_rho is None else lane_rho,
        prm.col_rho_boost, n_steps=K, n_pairs=P, col_enabled=False,
        dtype=f32)
    factors = tb.factorize(*tb.assemble_channel(rho, h=h, sigma=prm.sigma))
    eta = torch.zeros((B, K, P, 2), dtype=f32, device=cuda)
    E = make_pair_index(N, f32, cuda).E
    x = _warm_state(torch.zeros((B, N, K, 2), dtype=f32, device=cuda), p0,
                    v0, h)
    z = tb.tree_map(torch.clamp, tb.apply_A(x, eta, E, h), lower, upper)
    kw = dict(h=h, sigma=prm.sigma, alpha=prm.alpha, lam=prm.col_penalty)
    c = admm_steps.row_consts(eta, E, lower, upper, rho, **kw)
    c64 = admm_steps.row_consts(
        eta.double(), E.double(), *(tb.tree_map(lambda t: t.double(), v)
                                    for v in (lower, upper, rho)),
        **_to64(kw))
    rows = admm_steps.pack_state(*(tb.tree_map(lambda t: t.double(), v)
                                   for v in (x, z, tb.tree_map(
                                       torch.zeros_like, z))))
    admm_steps.admm_channel_interval_plain(
        *(t.double() for t in factors), rows, c64, 25)
    rows = admm_steps.Rows(*(t.float() for t in rows))
    rows = rows._replace(**{k: torch.as_tensor(
        rng.normal(size=tuple(rows.zc.shape)), dtype=f32, device=cuda)
        for k in ("zc", "yc")})
    return factors, c, c64, rows, None


def _stages_case(cuda, B, K, N, lane=False, hard=False, phase1=False):
    """One check interval's operands on the grouped X route (``phase1``:
    the channel route's, :func:`_channel_stages_case`), float32 on the
    card, from :func:`_interval_case` (its warm state and bounds): the
    factors (``lane``: one rho a lane, the grouped route's factors of
    M / rho with the unit slot scalars and 1 / rho; the channel route's
    per-lane 3x3 factors), the row constants in float32 and float64, and
    the packed state."""
    from ba_path_planning_torch.ops import admm_steps
    lane_rho = (torch.as_tensor(2.6 * np.exp(np.random.default_rng(B + N)
                                             .uniform(-2.3, 2.3, B)),
                                dtype=torch.float32) if lane else None)
    if phase1:
        return _channel_stages_case(
            cuda, B, K, N, None if lane_rho is None else lane_rho.to(cuda))
    args, kw = _interval_case(B, K, N, seed=N + B, device=cuda, form="X",
                              hard=hard, lane_rho=lane_rho)
    X, C, eta, E, lower, upper, x, z, y, rho = args
    static = SolverConfig.production().static_part()
    inv_rho = None
    if lane:
        lr = lane_rho.to(cuda)
        factors = (X * lr.reshape(-1, 1, 1, 1),
                   tb.unit_slot_scalars(static, n_steps=K, h=0.2,
                                        device=cuda))
        inv_rho = 1.0 / lr
    else:
        factors = (X, C)
    c = admm_steps.row_consts(eta, E, lower, upper, rho, **kw)
    c64 = admm_steps.row_consts(
        eta.double(), E.double(), *(tb.tree_map(lambda t: t.double(), v)
                                    for v in (lower, upper, rho)),
        **_to64(kw))
    return factors, c, c64, admm_steps.pack_state(x, z, y), inv_rho


def _run_stages(rows, c, factors, n_iters, inv_rho, phase1, kernel):
    from ba_path_planning_torch.ops import admm_steps
    if phase1:
        run = (admm_steps.admm_channel_interval if kernel
               else admm_steps.admm_channel_interval_plain)
        return run(*factors, rows, c, n_iters)
    rhs, solve, update = (
        (admm_steps.admm_rhs, group_solve.solve_factorized_grouped_X,
         admm_steps.admm_update) if kernel else
        (admm_steps.admm_rhs_plain, tb.solve_factorized_X,
         admm_steps.admm_update_plain))
    inv = None if inv_rho is None else inv_rho.to(rows.x.dtype)
    for _ in range(n_iters):
        update(solve(*factors, rhs(rows, c, inv)), rows, c)


def _check_stages(cuda, B, K, N, n_iters, lane=False, hard=False,
                  phase1=False):
    """The kernels' iterations against the plain versions on the same
    float32 inputs: x and z within 2e-4 of each (b, k) block after one
    iteration, and every block no further from the float64 plain
    iterations than 4x the plain float32 version is (y = y + rho (zr - z)
    multiplies the rounding of zr by rho)."""
    from ba_path_planning_torch.ops import admm_steps
    factors, c, c64, rows, inv_rho = _stages_case(cuda, B, K, N, lane, hard,
                                                  phase1)
    got, want = (admm_steps.Rows(*(t.clone() for t in rows))
                 for _ in range(2))
    ref = admm_steps.Rows(*(t.double() for t in rows))
    counter = (admm_steps.admm_channel_interval if phase1
               else admm_steps.admm_rhs)
    before = counter.launches
    _run_stages(got, c, factors, n_iters, inv_rho, phase1, True)
    assert counter.launches == before + (1 if phase1 else n_iters)
    _run_stages(want, c, factors, n_iters, inv_rho, phase1, False)
    _run_stages(ref, c64, tuple(t.double() for t in factors), n_iters,
                inv_rho, phase1, False)
    torch.cuda.synchronize()
    got, want, ref = (_stage_rows(r) for r in (got, want, ref))
    assert all(bool(torch.isfinite(g).all()) for g in got)
    errs = [_block_rel(g, w, 1) for g, w in zip(got, want)]
    if n_iters == 1:
        assert max(errs[:2]) < 2e-4, errs
    for g, w, r in zip(got, want, ref):
        kernel_err = _block_rel(g.double(), r, 1)
        plain_err = _block_rel(w.double(), r, 1)
        assert kernel_err <= 4.0 * plain_err, (kernel_err, plain_err, errs)


# (B, K, N): the main path's chunk at N=20 and its tail chunk, the
# reference-compatible batch, one scenario, the widest grouped route at its
# tail chunk, the round record's N=10 batch, small odd shapes, one shape
# on each side of admm_rhs's switch from its table form to its direct form
# (N = 60, N = 200), the grouped routes' production QP at N = 342 (the
# wide phase's of chip_smoke.py) and the widest N the sweeps serve (N =
# 1024, n = 6144, its horizon cut to K = 6)
STAGE_CASES = [(512, 50, 20), (128, 50, 20), (64, 50, 20), (1, 50, 20),
               (128, 50, 21), (1024, 50, 10), (3, 9, 4), (2, 6, 2),
               (8, 50, 60), (2, 50, 200), (1, 50, 342), (1, 6, 1024)]
# the channel interval's besides: the N=20 main path's phase 1, a lane an
# SM, a few lanes, the N=40 path's batch; the single CLI's K=500 (the
# memory form in shared memory), K=500 at N=20, K=1200 (the memory form in
# the global scratch), K=33 (two steps a thread, idle threads), and N=60
CHANNEL_CASES = STAGE_CASES + [(1024, 50, 20), (132, 50, 20), (8, 50, 20),
                               (2048, 50, 40), (1, 500, 10), (2, 500, 20),
                               (1, 1200, 2), (5, 33, 3), (4, 50, 60)]


@pytest.mark.gpu
@pytest.mark.parametrize("n_iters", [1, 25])
@pytest.mark.parametrize("B,K,N", STAGE_CASES)
def test_admm_stages_match_plain(cuda, B, K, N, n_iters):
    """admm_rhs (its table form up to N = 170, its direct form above),
    the X-form sweep kernel and admm_update, iteration after iteration,
    against the plain stages and the plain sweep."""
    from ba_path_planning_torch.ops import admm_steps
    assert admm_steps.rhs_plan(B, K, N).table == (N <= 170)
    _check_stages(cuda, B, K, N, n_iters)


@pytest.mark.gpu
@pytest.mark.parametrize("n_iters", [1, 25])
@pytest.mark.parametrize("B,N", [(64, 20), (1, 20), (3, 4), (1, 342)])
def test_admm_stages_with_lane_rho_and_hard_rows(cuda, B, N, n_iters):
    """One rho a lane (per-lane rho planes through the strides, the grouped
    route's 1 / rho folded into the right-hand side), and hard collision
    rows (lam = +inf) beside shared rho."""
    _check_stages(cuda, B, 50, N, n_iters, lane=True)
    _check_stages(cuda, B, 50, N, n_iters, hard=True)


@pytest.mark.gpu
@pytest.mark.parametrize("n_iters", [1, 25])
@pytest.mark.parametrize("B,K,N", CHANNEL_CASES)
def test_admm_channel_interval_matches_plain(cuda, B, K, N, n_iters):
    """The collision-free interval in one launch against the plain
    iterations, on a random finite collision state with finite and -inf
    lower bounds, shared and per-lane rho: the steps in registers
    (K <= 64), in shared memory (K = 500) and in the global scratch
    (K = 1200)."""
    from ba_path_planning_torch.ops import admm_steps
    plan = admm_steps.channel_plan(B, K, N)
    assert plan.steps == (0 if K > 64 else 1 if K <= 32 else 2)
    assert plan.in_smem == (K != 1200)
    _check_stages(cuda, B, K, N, n_iters, phase1=True)
    _check_stages(cuda, B, K, N, n_iters, lane=True, phase1=True)


@pytest.mark.gpu
def test_solver_routes_run_the_stages_on_the_card(cuda, monkeypatch):
    """solve_qp_state in float32 on the grouped X route and on the channel
    route never reaches admm_iterations: three launches an iteration, one
    a channel interval; in float64 the channel route replays the plain
    interval as a graph and launches no kernel, and agrees with the CPU."""
    from ba_path_planning_torch.ops import admm_steps
    args, kw = _interval_case(4, 20, 5, seed=9, device=cuda)
    X, C, eta, E, lower, upper, x, z, y, rho = args
    solver = SolverConfig.production().replace(max_iter=20, check_interval=10)
    prm = make_solver_params(solver, torch.float32, cuda)
    plain = tb.admm_iterations

    def refuse(*a, **k):
        raise AssertionError("admm_iterations reached")
    monkeypatch.setattr(tb, "admm_iterations", refuse)
    counts = [f.launches for f in (admm_steps.admm_rhs, admm_steps.admm_update,
                                   admm_steps.admm_channel_interval)]
    for col in (True, False):
        low = lower if col else lower._replace(
            col=torch.full_like(lower.col, -np.inf))
        res = tb.solve_qp_state(low, upper, eta if col else eta * 0, x, prm,
                                E, h=0.2, static=solver.static_part(),
                                n_vehicles=5, col_enabled=col)
        assert bool(torch.isfinite(res.x.a).all())
    done = [f.launches - n for f, n in zip(
        (admm_steps.admm_rhs, admm_steps.admm_update,
         admm_steps.admm_channel_interval), counts)]
    assert done[0] == done[1] and done[0] in (10, 20) and done[2] in (1, 2)
    monkeypatch.setattr(tb, "admm_iterations", plain)
    f64 = torch.float64
    low = lower._replace(col=torch.full_like(lower.col, -np.inf))
    args64 = [tb.tree_map(lambda t: t.to(f64), v) for v in (low, upper)]
    before = admm_steps.admm_channel_interval.launches
    res = tb.solve_qp_state(*args64, (eta * 0).double(),
                            tb.tree_map(lambda t: t.double(), x),
                            make_solver_params(solver, f64, cuda), E.double(),
                            h=0.2, static=solver.static_part(), n_vehicles=5,
                            col_enabled=False)
    assert admm_steps.admm_channel_interval.launches == before
    cpu = tb.solve_qp_state(
        *(tb.tree_map(lambda t: t.cpu(), v) for v in args64),
        (eta * 0).double().cpu(), tb.tree_map(lambda t: t.double().cpu(), x),
        make_solver_params(solver, f64), E.double().cpu(), h=0.2,
        static=solver.static_part(), n_vehicles=5, col_enabled=False)
    assert torch.equal(res.iters.cpu(), cpu.iters)
    for g, w in zip(res.x, cpu.x):
        assert float((g.cpu() - w).abs().max()) <= 1e-9 * float(
            w.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("route,factor_dtype", [("grouped_X", "f32"),
                                                ("grouped_L", "f32"),
                                                ("grouped_X", "bf16")])
def test_grouped_routes_solve_past_n_341_on_the_row_stages(
        cuda, monkeypatch, route, factor_dtype):
    """solve_qp_state at N = 342 (K = 6, B = 1) on the grouped routes in
    float32, the X form also on bf16 factors: the production solver on
    ``grouped_X``, the ``SCP`` class's on ``grouped_L`` (its budget cut to
    100 iterations), through admm_rhs, the sweep and admm_update (one
    launch each an ADMM iteration, ``admm_iterations`` never reached),
    against the same call with ``interval_kind`` naming "graph"
    (``admm_iterations`` around the same sweep kernel): equal iteration
    counts and convergence flags, x of every (b, k) block within 2e-4."""
    from ba_path_planning_torch.ops import admm_steps
    from ba_path_planning_torch.solvers.scp import REFERENCE_SOLVER
    N, K, B = 342, 6, 1
    args, _ = _interval_case(B, K, N, seed=342, device=cuda)
    eta, E, lower, upper, x = args[2], args[3], args[4], args[5], args[6]
    problem = ProblemConfig(n_vehicles=N, time_horizon=K * 0.2,
                            time_step=0.2, min_distance=0.8)
    solver = (SolverConfig.production(problem=problem) if route == "grouped_X"
              else REFERENCE_SOLVER.replace(kernels=True, max_iter=100))
    solver = solver.replace(factor_dtype=factor_dtype)
    static = solver.static_part()
    assert tb.qp_route(static, n_vehicles=N, n_steps=K, dtype=torch.float32,
                       col_enabled=True) == route
    prm = make_solver_params(solver, torch.float32, cuda)

    def solve():
        return tb.solve_qp_state(lower, upper, eta, x, prm, E, h=0.2,
                                 static=static, n_vehicles=N)
    stages = (admm_steps.admm_rhs, admm_steps.admm_update)
    before = [f.launches for f in stages]
    plain = tb.admm_iterations

    def refuse(*a, **k):
        raise AssertionError("admm_iterations reached")
    monkeypatch.setattr(tb, "admm_iterations", refuse)
    got = solve()
    monkeypatch.setattr(tb, "admm_iterations", plain)
    done = [f.launches - n for f, n in zip(stages, before)]
    monkeypatch.setattr(tb, "interval_kind", lambda *a, **k: "graph")
    before = [f.launches for f in stages]
    want = solve()
    torch.cuda.synchronize()
    assert [f.launches for f in stages] == before
    assert torch.equal(got.iters, want.iters)
    assert torch.equal(got.converged, want.converged)
    assert done[0] == done[1] == int(got.iters.max()) > 0
    gx, wx = tb.to_stacked(got.x), tb.to_stacked(want.x)
    assert bool(torch.isfinite(gx).all())
    assert _block_rel(gx, wx, 1) < 2e-4


@pytest.mark.gpu
def test_admm_steps_wrappers_raise_on_unsupported_cuda_input(cuda):
    """Float64 planes, planes of other shapes, N = 1025 and factors of
    other shapes are refused before any launch."""
    from ba_path_planning_torch.ops import admm_steps
    factors, c, c64, rows, _ = _stages_case(cuda, 2, 10, 3)
    rows64 = admm_steps.Rows(*(t.double() for t in rows))
    with pytest.raises(TypeError):
        admm_steps.admm_rhs(rows64, c64)
    with pytest.raises(TypeError):
        admm_steps.admm_update(rows64.x, rows64, c64)
    with pytest.raises(ValueError):
        admm_steps.admm_rhs(rows._replace(zc=rows.zc[:, :-1].contiguous()),
                            c)
    with pytest.raises(ValueError):
        admm_steps.admm_update(rows.x[:1].contiguous(), rows, c)
    with pytest.raises(ValueError):
        admm_steps.admm_rhs(rows, c, torch.ones(3, device=cuda))
    # eta is read as float2
    odd = torch.empty(c.eta.numel() + 1, device=cuda)[1:].view(c.eta.shape)
    odd.copy_(c.eta)
    with pytest.raises(ValueError):
        admm_steps.admm_rhs(rows, c._replace(eta=odd))
    # N = 1025, past the N the grouped sweeps serve: refused before any
    # launch, as the sweeps' plan refuses it
    N, K = 1025, 2
    P = N * (N - 1) // 2
    wide = admm_steps.Rows(*(torch.zeros(shape, device=cuda) for shape in (
        (1, K, 6 * N), (1, K, 6, 2 * N), (1, K, 6, 2 * N), (1, K, P),
        (1, K, P))))
    wc = admm_steps.RowConsts(
        torch.zeros((1, K, P, 2), device=cuda), None, wide.zs, wide.zs,
        wide.zc, torch.ones((K, 6), device=cuda),
        torch.ones((K, P), device=cuda), c.fpar, 0.2, c.sigma, c.alpha,
        c.lam)
    launches = (admm_steps.admm_rhs.launches,
                admm_steps.admm_update.launches)
    with pytest.raises(ValueError):
        admm_steps.admm_rhs(wide, wc)
    with pytest.raises(ValueError):
        admm_steps.admm_update(wide.x, wide, wc)
    assert (admm_steps.admm_rhs.launches,
            admm_steps.admm_update.launches) == launches
    with pytest.raises(ValueError):
        group_solve.sweep_plan(1, K, 6 * N, "X")
    pf, pc, _, prows, _ = _stages_case(cuda, 2, 10, 3, phase1=True)
    with pytest.raises(ValueError):
        admm_steps.admm_channel_interval(pf[0][:-1].contiguous(), pf[1],
                                         prows, pc, 1)
    with pytest.raises(ValueError):
        admm_steps.admm_channel_interval(
            *pf, prows._replace(yc=prows.yc[:, :-1].contiguous()), pc, 1)
    with pytest.raises(ValueError):
        admm_steps.admm_channel_interval(
            *pf, prows, pc._replace(l_s=pc.l_s[:1].contiguous()), 1)
    with pytest.raises(TypeError):
        admm_steps.admm_channel_interval(
            *pf, prows, pc._replace(rho_c=pc.rho_c.double()), 1)
    with pytest.raises(TypeError):
        admm_steps.admm_channel_interval(*(t.double() for t in pf), prows,
                                         pc, 1)


@pytest.mark.gpu
def test_a_production_call_waits_on_the_card_only_where_it_counts(cuda):
    """Every synchronising operation of a production ``solve_compacted``
    (N=20, K=50, the benchmark's stop and goal projection; torch's sync
    debug mode) is one of the call's counted reads and writes
    (``utils.profiling.host_read`` / ``host_write``), so the call's
    ``call_s`` less ``host_read_s`` and ``host_write_s`` holds no wait on
    the card but a launch's; and under a profiler the NS chain's exact
    anchors open ``qp.anchors`` beside ``qp.ns_chain`` in ``qp.factors``."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from ba_path_planning_torch.parallel.mesh import ShardedSCPSolver
    from ba_path_planning_torch.scenarios.generator import (
        generate_scenario_batch)
    problem = ProblemConfig(n_vehicles=20, time_horizon=10.0, time_step=0.2,
                            min_distance=0.8, stop_mode="feasible",
                            goal_project=True)
    solver = ShardedSCPSolver(problem, SolverConfig.production(
        problem=problem), dtype=torch.float32, device=cuda)
    sc = generate_scenario_batch(2 ** 31 + 11, 64, n_vehicles=20,
                                 min_distance=0.8, device=cuda)
    v0 = torch.zeros_like(sc.initial)

    def call():
        return solver.solve_compacted(sc.initial, v0, sc.final, v0, chunk=32)
    call()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    t = solver.last_timing
    syncs = [w for w in caught
             if "called a synchronizing" in str(w.message)]
    assert t["loop_dispatches"] >= 2
    assert t["host_writes"] == 13 + 14 * t["loop_dispatches"]
    assert len(syncs) == t["host_reads"] + t["host_writes"]

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        call()
        torch.cuda.synchronize()
    spans = sorted(((e.start_ns(), e.end_ns(), e.name())
                    for e in p.profiler.kineto_results.events()
                    if e.name().partition(".")[0] in ("mesh", "scp", "qp")
                    and not str(e.device_type()).endswith("CUDA")),
                   key=lambda s: (s[0], -s[1]))
    parents, stack = set(), []
    for s, e, name in spans:
        while stack and stack[-1][1] <= s:
            stack.pop()
        parents.add((name, stack[-1][2] if stack else None))
        stack.append((s, e, name))
    assert {("qp.anchors", "qp.factors"), ("qp.ns_chain", "qp.factors"),
            ("mesh.call", None)} <= parents
    assert sum(n.endswith(".host_write") for *_, n in spans) == \
        solver.last_timing["host_writes"]


def _assemble_case(B, K, N, dtype, device, *, lane_rho=False, shards=1,
                   seed=0):
    """Production rho rows (one rho a lane where ``lane_rho``; about a
    third of the collision rows on the loose rho, as the solver's disabled
    rows), unit directions eta (B, K, P, 2) and E, padded to a multiple of
    ``shards`` (``PaddedPairIndex``), on ``device``."""
    from ba_path_planning_torch.parallel.pair_sharded import (
        padded_pair_index)
    rng = np.random.default_rng(seed)
    pairs = (padded_pair_index(N, shards, dtype, device) if shards > 1
             else make_pair_index(N, dtype, device))
    P = pairs.E.shape[1]
    scaling = tb.row_scaling_state(K, 0.2, dtype=dtype, device=device)
    rho = (torch.as_tensor(rng.uniform(0.5, 4.0, size=B), dtype=dtype,
                           device=device)
           if lane_rho else torch.tensor(2.6, dtype=dtype, device=device))
    rows = tb.rho_pattern_masks(
        scaling, SolverConfig.production().static_part(), rho,
        torch.tensor(2.5, dtype=dtype, device=device), n_steps=K, n_pairs=P,
        col_enabled=True, dtype=dtype)
    loose = torch.as_tensor(rng.uniform(size=(B, K, P)) < 0.3,
                            device=device)
    rows = rows._replace(col=torch.where(
        loose, torch.tensor(tb._LOOSE_RHO, dtype=dtype, device=device),
        rows.col.expand(B, K, P)).contiguous())
    eta = rng.normal(size=(B, K, P, 2)).astype(np.float32)
    eta /= np.linalg.norm(eta, axis=-1, keepdims=True)
    return rows, torch.as_tensor(eta, dtype=dtype, device=device), pairs.E


def _plain_assembly(rho, eta, E, N, sigma, ks=None):
    """The plain version's D (…, K, 6N, 6N) and C on the card; with ``ks``
    only the steps ``ks`` of D (the skeleton, plus each step's collision
    blocks from a window of two steps of eta, so that the dense product
    fits the card at N = 342 and 1024)."""
    if ks is None:
        return tb.assemble_D(rho, eta, E, h=0.2, sigma=sigma, n_vehicles=N)
    n2 = 2 * N
    D0, s = tb.assemble_skeleton(rho, h=0.2, sigma=sigma, n_vehicles=N)
    K = eta.shape[-3]
    out = D0.expand(eta.shape[:-3] + D0.shape[-3:])[..., ks, :, :].clone()
    col = rho.col.expand(eta.shape[:-1])
    for i, k in enumerate(ks):
        if k + 1 < K:
            colM = tb.collision_blocks(col[:, k:k + 2], eta[:, k:k + 2], E)
            out[:, i, n2:2 * n2, n2:2 * n2] += colM[:, 0]
            del colM
    return out, tb.b_slot_mats(s)


def _pp_diag_mask(N, device):
    """True on the diagonal vehicle blocks of the p-p slot, (6N, 6N)."""
    n2, n = 2 * N, 6 * N
    r = torch.arange(n, device=device)
    veh = torch.where((r >= n2) & (r < 2 * n2), (r - n2) // 2, -1 - r)
    return veh[:, None] == veh[None, :]


@pytest.mark.gpu
@pytest.mark.parametrize("N,K,B,dtype,lane_rho,shards", [
    (20, 50, 512, "f32", False, 1), (20, 50, 128, "f32", False, 1),
    (20, 50, 1, "f32", False, 1), (40, 50, 128, "f32", False, 1),
    (40, 50, 32, "f32", False, 1), (21, 50, 8, "f32", False, 1),
    (20, 50, 64, "f32", True, 1), (20, 50, 16, "f32", False, 4),
    (30, 20, 6, "f32", True, 7), (20, 50, 16, "f64", False, 1),
    (20, 50, 8, "f64", True, 3), (268, 9, 1, "f32", False, 1),
    (342, 50, 2, "f32", False, 1), (1024, 6, 1, "f32", False, 1)])
def test_assemble_D_kernel_matches_plain(cuda, N, K, B, dtype, lane_rho,
                                         shards):
    """``ops.assemble_d.assemble_D_fused`` against the plain
    ``banded.assemble_D`` on the card, at the production chunks, the
    fused route's shapes, the short horizon N=268 K=9 and the wide N=342
    K=50 B=2 and N=1024 K=6 B=1, with one rho a lane and pad pairs, in
    float32 and float64: C, the skeleton, the shift and the off-diagonal
    vehicle blocks bit for bit; the diagonal vehicle blocks (a sum in
    another order) no further from float64 than twice the plain version's
    own distance (in float64, within N ulps of the largest entry).  Where
    the plain dense product would not fit the card, steps 0, 1, K/2, K-2
    and K-1 are compared."""
    from ba_path_planning_torch.ops import assemble_d
    dt = torch.float32 if dtype == "f32" else torch.float64
    rho, eta, E = _assemble_case(B, K, N, dt, cuda, lane_rho=lane_rho,
                                 shards=shards, seed=N + B)
    sig = torch.tensor(1e-6, dtype=dt, device=cuda)
    before = assemble_d.assemble_D_fused.launches
    D, C = assemble_d.assemble_D_fused(rho, eta, E, h=0.2, sigma=sig,
                                       n_vehicles=N)
    torch.cuda.synchronize()
    assert assemble_d.assemble_D_fused.launches == before + 1
    P = E.shape[1]
    dense_bytes = B * K * 2 * N * P * eta.element_size()
    ks = None if dense_bytes < 2 ** 31 else sorted({0, 1, K // 2, K - 2,
                                                    K - 1})
    want, C0 = _plain_assembly(rho, eta, E, N, sig, ks)
    assert torch.equal(C, C0)
    got = D if ks is None else D[:, ks]
    mask = _pp_diag_mask(N, cuda).expand(got.shape)
    assert torch.equal(got[~mask], want[~mask])
    d_got, d_want = got[mask], want[mask]
    del D, got, want
    f64 = tb.tree_map(lambda t: t.double(), rho)
    ref, _ = _plain_assembly(f64, eta.double(), E.double(), N, sig.double(),
                             ks)
    d_ref = ref[mask]
    del ref
    err = float((d_got.double() - d_ref).abs().max())
    own = float((d_want.double() - d_ref).abs().max())
    eps = torch.finfo(dt).eps * float(d_ref.abs().max())
    if dt == torch.float64:     # the plain version is the reference: its
        assert err <= N * eps   # sums in another order
    else:
        assert err <= 2 * own + eps, (err, own)


@pytest.mark.gpu
def test_a_production_call_assembles_once_a_qp(cuda):
    """A production ``solve_compacted`` (N=20, B=1024, chunk 512) runs the
    one-pass assembly once a ``grouped_X`` QP (one a dispatch) and never
    in phase 1, and adds no copy between host and card: the writes stay
    13 + 14 a dispatch, and torch's sync debug mode finds exactly the
    counted reads and writes."""
    import warnings

    from ba_path_planning_torch.ops import assemble_d
    from ba_path_planning_torch.parallel.mesh import ShardedSCPSolver
    from ba_path_planning_torch.scenarios.generator import (
        generate_scenario_batch)
    problem = ProblemConfig(n_vehicles=20, time_horizon=10.0, time_step=0.2,
                            min_distance=0.8, stop_mode="feasible",
                            goal_project=True)
    cfg = SolverConfig.production(problem=problem)
    assert tb.qp_route(cfg.static_part(), n_vehicles=20, n_steps=50,
                       dtype=torch.float32, col_enabled=True) == "grouped_X"
    solver = ShardedSCPSolver(problem, cfg, dtype=torch.float32, device=cuda)
    sc = generate_scenario_batch(2 ** 31 + 23, 1024, n_vehicles=20,
                                 min_distance=0.8, device=cuda)
    v0 = torch.zeros_like(sc.initial)

    def call():
        return solver.solve_compacted(sc.initial, v0, sc.final, v0,
                                      chunk=512)
    call()
    torch.cuda.synchronize()
    before = assemble_d.assemble_D_fused.launches
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    t = solver.last_timing
    syncs = [w for w in caught
             if "called a synchronizing" in str(w.message)]
    assert t["loop_dispatches"] >= 2
    assert assemble_d.assemble_D_fused.launches - before == \
        t["loop_dispatches"]
    assert t["host_writes"] == 13 + 14 * t["loop_dispatches"]
    assert len(syncs) == t["host_reads"] + t["host_writes"]
    assert int((res.status <= 1).sum()) >= 1000
