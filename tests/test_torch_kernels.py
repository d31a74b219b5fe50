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
                                     (3, 10, 5, 3), (1, 8, 40, 1)])
def test_ns_chain_plain_matches_pallas_interpret(B, K, N, G):
    """float32, max relative 1e-5, as tests/test_ns_chain.py holds the
    Pallas kernel against the XLA chain; B = 1, N = 40 is a batch the
    kernel's wide tier takes (``ns_chain_plan``)."""
    # the spread of A A^T's spectrum held to that of n = 30, where the
    # warm-started Newton-Schulz steps converge
    D, C = _spd_chain(B, K, N, seed=B * K,
                      scale=0.08 * min(1.0, (30 / (6 * N)) ** 0.5))
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


@pytest.mark.parametrize("ns_precision", ["high", "highest", "default"])
def test_factorize_X_routed_hands_ns_precision_on(monkeypatch, ns_precision):
    """``_factorize_X_routed`` passes the kernel precision that serves
    ``static.ns_precision`` to the kernel wrapper ("default" runs the
    three-pass kernel, ``banded.NS_KERNEL_PRECISION``); on the CPU the
    wrapper then runs the plain version for every value the solver options
    know."""
    seen = {}
    real = ns_chain.factorize_X_chain_batched

    def spy(D, C, **kw):
        seen.update(kw)
        return real(D, C, **kw)
    monkeypatch.setattr(ns_chain, "factorize_X_chain_batched", spy)
    D, C = map(torch.as_tensor, _spd_chain(2, 9, 3, seed=4))
    static = SolverConfig.production().replace(
        ns_precision=ns_precision).static_part()
    got = tb._factorize_X_routed(D, C, static)
    kernel = {"default": "high"}.get(ns_precision, ns_precision)
    assert seen == dict(ns_iters=static.ns_iters, ns_precision=kernel)
    assert torch.equal(got, tb.factorize_X(D, C, ns_iters=static.ns_iters))


@pytest.mark.parametrize("ns_precision", ["highest", "high", "default"])
def test_factorize_X_with_anchors_matches_jax(ns_precision):
    """``ns_anchor > 0`` takes no kernel in either package: the router
    runs ``factorize_X`` with the solver's ``ns_precision``
    (JAX ``banded.py:1169-1183``), which takes FP32 products for every name
    in the port (on the card too) and in JAX on the CPU.  float32, max
    relative 1e-5."""
    D, C = _spd_chain(1, 14, 4, seed=9)
    prec = {"highest": None, "high": jax.lax.Precision.HIGH,
            "default": jax.lax.Precision.DEFAULT}[ns_precision]
    want = jb.factorize_X(jnp.asarray(D[0]), jnp.asarray(C), ns_iters=2,
                          ns_anchor=4, ns_precision=prec)
    static = SolverConfig.production().replace(
        ns_anchor=4, ns_precision=ns_precision).static_part()
    Dt, Ct = torch.as_tensor(D), torch.as_tensor(C)
    before = ns_chain.factorize_X_chain_batched.launches
    got = tb._factorize_X_routed(Dt, Ct, static)
    assert ns_chain.factorize_X_chain_batched.launches == before
    assert torch.equal(got, tb.factorize_X(Dt, Ct, ns_iters=2, ns_anchor=4,
                                           ns_precision=ns_precision))
    assert torch.equal(got, tb.factorize_X(Dt, Ct, ns_iters=2, ns_anchor=4))
    assert _rel(got[0].numpy(), want) < 1e-5
    with pytest.raises(ValueError):
        tb.factorize_X(Dt, Ct, ns_iters=2, ns_anchor=4, ns_precision="tf32")


@pytest.mark.parametrize("ns_precision", ["default", "tf32"])
def test_ns_chain_wrapper_takes_the_kernel_precisions_only(ns_precision):
    """The wrapper serves the kernel's two precisions, "high" and
    "highest"; the solver's "default" reaches it as "high"
    (``banded.NS_KERNEL_PRECISION``), so any other name raises, on the CPU
    as on the card, and launches nothing."""
    D, C = map(torch.as_tensor, _spd_chain(2, 9, 3, seed=4))
    before = ns_chain.factorize_X_chain_batched.launches
    with pytest.raises(ValueError):
        ns_chain.factorize_X_chain_batched(D, C, ns_iters=2,
                                           ns_precision=ns_precision)
    assert ns_chain.factorize_X_chain_batched.launches == before
    assert set(tb.NS_KERNEL_PRECISION.values()) == set(ns_chain.PRECISIONS)


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


def test_ns_chain_plan_picks_the_tiers():
    """One block a scenario for the production chunks (N = 20 at B = 512,
    N = 30 and 40 at B = 128); the wide tier up to B = 32, in the tile
    that the measured wave costs favour: 192 at N = 342 (B = 2: one wave of
    each product), 128 at N = 40 and B = 32, 64 for one scenario at
    N = 40.  The tile counts are those of the kernel's walk (tile_product's:
    rows of tiles, from the diagonal in the update)."""
    for N, B in ((20, 512), (30, 128), (40, 128), (342, 33)):
        assert ns_chain.ns_chain_plan(B, 6 * N) == (0, 0, 0)
    assert ns_chain.ns_chain_plan(2, 2052) == (192, 11 * 11, 11 * 12 // 2)
    assert ns_chain.ns_chain_plan(32, 240) == (128, 4, 3)
    assert ns_chain.ns_chain_plan(1, 240) == (64, 16, 10)
    for n in (6, 120, 246, 2052):
        for tile in (64, 128, 192):
            plan = ns_chain.ns_chain_plan(1, n, _tile=tile)
            rows = range(0, n, tile)
            assert plan.tiles == len(rows) * len(range(0, n, tile))
            assert plan.upper_tiles == sum(len(range(r0, n, tile))
                                           for r0 in rows)
    with pytest.raises(ValueError):
        ns_chain.ns_chain_plan(1, 240, _tile=32)


@pytest.mark.parametrize("sms", [132, 114, 66])
def test_ns_chain_plan_follows_the_cards_sms(sms):
    """The wave cost counts the waves of each product on the card the
    plan is given (a launch gives its card's SMs): on 114 SMs (an H100
    PCIe) two scenarios at N = 342 take tiles of 128, since the 242 tiles
    of 192 of T' = X S take three waves there and two on 132 SMs; the
    production chunks keep one block a scenario on any card."""
    for N, B in ((20, 512), (30, 128), (40, 128)):
        assert ns_chain.ns_chain_plan(B, 6 * N, sms) == (0, 0, 0)
    for B in (1, 2, 8, 32):
        for n in (120, 240, 600, 2052):
            plan = ns_chain.ns_chain_plan(B, n, sms)
            assert plan.tile == min(
                ns_chain.NS_WAVE_COST,
                key=lambda t: (ns_chain.ns_wide_cost(B, n, t, sms), -t))
            r = -(-n // plan.tile)
            waves = -(-B * r * r // sms) + -(-(B * r * (r + 1) // 2) // sms)
            assert ns_chain.ns_wide_cost(B, n, plan.tile, sms) == (
                waves * ns_chain.NS_WAVE_COST[plan.tile])
    assert ns_chain.ns_chain_plan(2, 2052, sms).tile == (
        128 if sms == 114 else 192)
