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
                                   (2, 50, 30), (2, 50, 40), (2, 8, 45)])
def test_ns_chain_kernel_matches_plain(cuda, B, K, N, ns_precision):
    """Relative 1e-4 in every (b, k) block.  "high" takes the products on
    the tensor cores as three TF32 passes of a hi + lo split, "highest" as
    FP32 FMAs (summed in another order than cuBLAS) in the same tiling.
    Both mirror the upper triangle of each update; shared memory up to
    N = 21, a streamed global scratch beyond, in one output tile up to
    N = 32 and several above."""
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
    """Relative 1e-5 in every (b, k) block, on every branch of the plan."""
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


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["X", "L"])
@pytest.mark.parametrize("B", [1, 3])
def test_group_solve_kernel_serves_the_widest_blocks(cuda, B, form):
    """n = 6144 (N = 1024), the most the X and L forms serve: no cluster's
    exchange buffers fit beside a ring there, so one block a scenario runs
    it (the L form with its column sums in shared memory).  Random blocks
    of norm about 1 stand in for the factors (symmetric for X, lower
    triangular for L; a float64 factorization at this size would take
    minutes)."""
    K, n = 2, 6144
    gen = torch.Generator(device=cuda).manual_seed(B)
    A = torch.randn((B, K, n, n), generator=gen, device=cuda)
    if form == "X":
        F = (A + A.mT) / (2 * n ** 0.5)
    else:
        F = A.tril_() / n ** 0.5
    del A
    C = torch.triu(torch.randn((K - 1, 3, 3), generator=gen, device=cuda))
    b = torch.randn((B, K, n), generator=gen, device=cuda)
    assert group_solve.sweep_plan(B, K, n, form).cluster == 1
    kernel, plain = {
        "X": (group_solve.solve_factorized_grouped_X,
              group_solve.solve_factorized_grouped_X_plain),
        "L": (group_solve.solve_factorized_grouped_L,
              group_solve.solve_factorized_grouped_L_plain)}[form]
    got = kernel(F, C, b)
    want = plain(F, C, b)
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
    with pytest.raises(NotImplementedError):    # a single TF32 pass
        ns_chain.factorize_X_chain_batched(D.float(), C, ns_iters=2,
                                           ns_precision="default")
    with pytest.raises(ValueError):
        ns_chain.factorize_X_chain_batched(D.float(), C, ns_iters=2,
                                           ns_precision="tf32")
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
    shared memory)."""
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


def _interval_case(B, K, N, seed, device, form="X", hard=False):
    """Inputs of one fused ADMM interval at main-path shapes, float32:
    bounds of random start and goal positions, collision rows of random
    unit directions about the start positions (row 0 vacuous), the
    production rho pattern and X-form factors from the NS route
    (``form="X"``) or dense (Linv, Eb) factors (``form="L"``).  ``hard``
    sets the collision penalty to +inf (hard rows).  The state (x, z, y) is
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
    rho = tb.rho_pattern_masks(
        tb.row_scaling_state(K, h, dtype=f32, device=device),
        solver.static_part(), prm.rho, prm.col_rho_boost, n_steps=K,
        n_pairs=P, col_enabled=True, dtype=f32)
    D, C = tb.assemble_D(rho, eta, pairs.E, h=h, sigma=prm.sigma,
                         n_vehicles=N)
    if form == "X":
        factors = (ns_chain.factorize_X_chain_batched(D, C, ns_iters=2), C)
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


def _check_interval(cuda, B, K, N, n_iters, form, hard):
    args, kw = _interval_case(B, K, N, seed=N, device=cuda, form=form,
                              hard=hard)
    kernel, plain = _FUSED[form]
    before = kernel.launches
    got = kernel(*args, n_iters=n_iters, **kw)
    assert kernel.launches == before + 1
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
                                   (3, 9, 39), (2, 6, 90)])
def test_admm_fused_kernel_matches_plain(cuda, B, K, N, n_iters):
    """Every (b, k) row block of x and z within 2e-4 (relative to the
    block's largest entry) of the plain version after one iteration, at
    the production N = 22, 30 and 40 (one scenario, and batches below the
    path's chunk of 128); the factor ring wraps on other (stage, phase)
    counts for other K, N and n_iters; at K = 330 the sweep plane no
    longer fits in shared memory; the kernel reads packed triangles from
    N = 39 (N = 39 has padding columns in them, N = 40 none) and whole
    bands below and at N = 90 (n = 540).  The
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
