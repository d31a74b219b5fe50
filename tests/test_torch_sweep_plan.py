"""The launch plan of the sweep kernels (``group_solve.sweep_plan``) and the
data flow of their cluster split, on the CPU: no JAX and no card.

The kernels themselves (``csrc/group_sweep.cuh``, in its X, L and dense
forms) run only on the card and are held to their plain versions by
``tests/test_torch_kernels_gpu.py``.  Here the plan is held to what the
kernel needs of it, and a float64 model of the kernel's split (each cluster
rank's rows, the exchanged parts, w_k or y_k overwritten by x_k in place)
to the plain sweeps.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ba_path_planning_torch.ops import group_solve as gs
from ba_path_planning_torch.solvers import banded as tb


def _check_plan(B, K, n, form, full_cluster=True):
    """What the kernel of ``form`` needs of the plan of B scenarios of K
    blocks of n x n; ``full_cluster``: a small batch runs in the clusters
    of 2 or 4 that its size asks for.  Returns the plan."""
    plan = gs.sweep_plan(B, K, n, form)
    c, band, stages = plan.cluster, plan.band_rows, plan.stages
    assert c in (1, 2, 4)
    if full_cluster or B > gs.SWEEP_CLUSTER_B:
        assert (c == 1) == (B > gs.SWEEP_CLUSTER_B)
    assert 2 <= stages <= gs.SWEEP_MAX_STAGES
    assert plan.smem_bytes == gs.sweep_smem_bytes(
        n, c, band, stages, gs.sweep_part_rows(form, n))
    assert plan.smem_bytes <= gs.SMEM_BLOCK_MAX
    # as many blocks share an SM as the plan counts on
    assert 1 <= plan.per_sm <= 4
    assert plan.per_sm * (plan.smem_bytes + 1024) <= gs.SMEM_SM
    # bands: an even number of rows, at most 4 for each consumer warp
    assert band % 2 == 0 and 2 <= band <= gs.SWEEP_MAX_BAND
    bounds = [gs.sweep_rows(q, c, n) for q in range(c + 1)]
    assert bounds[0] == 0 and bounds[-1] == n
    for lo, hi in zip(bounds, bounds[1:]):
        assert lo % 2 == 0 and hi >= lo
        for r0 in range(lo, hi, band):
            rows = min(band, hi - r0)
            # one bulk copy: bytes and address multiples of 16
            assert rows % 2 == 0 and rows * n * 4 % 16 == 0
            assert r0 * n * 4 % 16 == 0
    return plan


@pytest.mark.parametrize("N", range(2, 41))
def test_sweep_plan_fits_the_card_and_tiles_the_rows(N):
    for form in gs.SWEEP_FORMS:
        for B in (1, 64, 65, 512, 2048):
            for K in (50, 500):
                plan = _check_plan(B, K, 6 * N, form)
                # at production sizes every plan keeps its blocks per SM
                assert plan.per_sm == (2 if plan.cluster > 1
                                       else min(4, -(-B // gs.SMS)))


@pytest.mark.parametrize("N", [41, 60, 85, 86, 90, 128, 200, 227, 228, 256])
def test_sweep_plan_serves_wide_blocks(N):
    """n = 6N above the narrow instantiation's 512, up to the 1536 of the
    wide one: a ring of two stages or more always fits, with fewer blocks
    an SM where it must, in every form."""
    for form in gs.SWEEP_FORMS:
        for B in (1, 33, 64, 65, 128, 512, 2048):
            for K in (2, 50, 500):
                _check_plan(B, K, 6 * N, form)


@pytest.mark.parametrize("N", [257, 300, 341, 512, 700, 1000, 1024])
def test_sweep_plan_serves_blocks_above_n_1536(N):
    """The X form keeps no column sums, and the L form keeps them in one
    row of shared memory above n = 1536, so both serve n = 6N up to 6144
    (N = 1024): one block a scenario at least, a cluster where a ring of
    two stages fits beside the cluster's exchange buffers; the dense form
    refuses n > 1536."""
    for form in ("X", "L"):
        for B in (1, 33, 64, 65, 512):
            for K in (2, 50):
                plan = _check_plan(B, K, 6 * N, form, full_cluster=False)
                assert plan.smem_bytes == gs.sweep_smem_bytes(
                    6 * N, plan.cluster, plan.band_rows, plan.stages,
                    0 if form == "X" else 1)
        assert gs.sweep_plan(1, 50, 6 * 1024, form).cluster == 1
    with pytest.raises(ValueError):
        gs.sweep_plan(1, 50, 6 * N, "dense")


@pytest.mark.parametrize("n", [2, 4, 8, 10, 14, 100, 122, 514, 1534])
def test_sweep_plan_serves_the_dense_form_at_even_n(n):
    """The dense form needs no slot scalars, so any even n up to 1536
    (bands of whole row pairs stay 16-byte aligned); an odd n is
    refused."""
    for B in (1, 32, 33, 64, 65, 128, 512):
        for K in (2, 9, 50):
            plan = _check_plan(B, K, n, "dense")
            # the ring is no deeper than the bands of the 4K - 3 blocks
            share = max(gs.sweep_rows(c + 1, plan.cluster, n)
                        - gs.sweep_rows(c, plan.cluster, n)
                        for c in range(plan.cluster))
            assert plan.stages <= -(-share // plan.band_rows) * (4 * K - 3)
    with pytest.raises(ValueError):
        gs.sweep_plan(4, 50, n + 1, "dense")


def test_sweep_plan_branches_and_refusals():
    for form in gs.SWEEP_FORMS:
        assert [gs.sweep_plan(B, 50, 120, form).cluster
                for B in (1, 32, 33, 64, 65, 512)] == [4, 4, 2, 2, 1, 1]
        # a block alone on its SM takes a deeper ring than four blocks share
        alone = gs.sweep_plan(128, 50, 240, form)
        shared = gs.sweep_plan(512, 50, 240, form)
        assert (alone.stages * alone.band_rows
                > 2 * shared.stages * shared.band_rows)
        # a cluster of blocks of n = 1536 runs alone on its SMs where it
        # keeps column sums (the X form's exchange leaves room for two)
        assert gs.sweep_plan(1, 50, 1536, form).per_sm == (
            2 if form == "X" else 1)
    # the ring is no deeper than the bands of the whole chain: 3 blocks
    # (X, L) or 5 (dense) at K = 2
    assert gs.sweep_plan(512, 2, 12, "X").stages == 3
    assert gs.sweep_plan(512, 2, 12, "dense").stages == 5
    for form in gs.SWEEP_FORMS:
        for B, K, n in ((4, 50, 9), (4, 1, 120), (0, 50, 120), (4, 50, 6150)):
            with pytest.raises(ValueError):
                gs.sweep_plan(B, K, n, form)
    for form in ("X", "L"):           # the slot scalars need n = 6N
        with pytest.raises(ValueError):
            gs.sweep_plan(4, 50, 518, form)
    with pytest.raises(ValueError):
        gs.sweep_plan(4, 50, 1538, "dense")
    with pytest.raises(ValueError):
        gs.sweep_plan(4, 50, 120, "LX")


def _header(name):
    return (Path(gs.__file__).resolve().parents[1] / "csrc" / name).read_text()


def _constants(src):
    """The namespace-level ``constexpr`` integers of a CUDA header, by name
    (an expression of earlier ones is evaluated)."""
    out = {}
    for name, expr in re.findall(
            r"^constexpr (?:int|long) (\w+) = ([^;]+);", src, re.M):
        out[name] = eval(expr.replace("/", "//"), {}, dict(out))
    return out


def _c_function(src, name, args, consts):
    """The one ``return`` expression of an inline function of a header as a
    Python function (integer division, no casts)."""
    body = re.search(name + r"\([^)]*\)\s*\{\s*return ([^;]+);", src).group(1)
    body = re.sub(r"static_cast<\w+>\((\w+)\)", r"\1", body)
    body = re.sub(r"\b(\d+)L\b", r"\1", body).replace("/", "//")
    return eval(f"lambda {', '.join(args)}: {body}", dict(consts))


def test_plan_layout_matches_the_kernel_header():
    """The plan's copy of the kernel's layout (sizes, limits, the rows of a
    cluster rank and the shared memory of a block) is the header's."""
    ring = _constants(_header("factor_ring.cuh"))
    src = _header("group_sweep.cuh")
    k = _constants(src.replace("factor_ring::kBarrierBytes",
                               str(ring["kBarrierBytes"])).replace(
        "factor_ring::kRows", str(ring["kRows"])))
    assert gs.SWEEP_MAX_N == k["kMaxN"]
    assert gs.SWEEP_MAX_N_WIDE == k["kMaxNWide"]
    assert gs.SWEEP_WARPS == k["kWarps"]
    assert gs.SWEEP_MAX_BAND == k["kMaxBandRows"]
    assert gs.SWEEP_MAX_STAGES == ring["kMaxStages"]
    assert gs.SWEEP_BARRIER_BYTES == k["kBarrierBytes"]
    assert gs.SMEM_BLOCK_MAX == k["kSmemMax"]
    row_lo = _c_function(src, "row_lo", ("c", "cluster", "n"), k)
    smem = _c_function(src, "smem_bytes",
                       ("n", "cluster", "band_rows", "stages", "part"), k)
    # part_rows(form, n): none for the X form, kWarps for the others, one
    # row above kMaxN
    forms = {"X": k["kFormX"], "L": k["kFormL"], "dense": k["kFormDense"]}
    assert sorted(forms.values()) == [0, 1, 2]
    assert re.search(r"part_rows\(int form, int n\)\s*\{\s*return form == "
                     r"kFormX \? 0 : n > kMaxN \? 1 : kWarps;", src)
    for form, code in forms.items():
        for n in (12, 1536, 1542, 6144):
            assert gs.sweep_part_rows(form, n) == (
                0 if code == k["kFormX"] else
                1 if n > k["kMaxN"] else k["kWarps"])
    for n in (12, 120, 246, 540, 1536, 6144):
        for c in (1, 2, 4):
            assert [gs.sweep_rows(q, c, n) for q in range(c + 1)] == [
                row_lo(q, c, n) for q in range(c + 1)]
            for band, stages in ((2, 2), (30, 7), (24, 8)):
                for part in (0, 1, k["kWarps"]):
                    assert gs.sweep_smem_bytes(n, c, band, stages,
                                               part) == smem(
                        n, c, band, stages, part)


def _slot_b(c, w, n2):
    """(B w) for B = C (x) I_n2, C (3, 3) upper triangular."""
    wa, wp, wv = w[:n2], w[n2:2 * n2], w[2 * n2:]
    return np.concatenate([c[0, 0] * wa + c[0, 1] * wp + c[0, 2] * wv,
                           c[1, 1] * wp + c[1, 2] * wv, c[2, 2] * wv])


def _slot_bt(c, v, n2):
    va, vp, vv = v[:n2], v[n2:2 * n2], v[2 * n2:]
    return np.concatenate([c[0, 0] * va, c[0, 1] * va + c[1, 1] * vp,
                           c[0, 2] * va + c[1, 2] * vp + c[2, 2] * vv])


def _cluster_sweep(F, C, b, lform, cluster):
    """The kernel's data flow for one scenario: rank q owns rows
    [lo_q, hi_q) of every block; a step's vector is what the ranks exchange
    (X: their rows of the result; L: their column partial sums, plus w_k of
    their rows in the backward sweep), each rank keeping w_k of its rows in
    the output and overwriting it by x_k."""
    K, n = b.shape
    bounds = [gs.sweep_rows(q, cluster, n) for q in range(cluster + 1)]
    x, vec = np.zeros((K, n)), None
    for t in range(2 * K - 1):
        fwd = t < K
        k = t if fwd else 2 * K - 2 - t
        if fwd:
            r = b[k] if k == 0 else b[k] - _slot_b(C[k - 1], vec, n // 3)
        else:
            r = _slot_bt(C[k], vec, n // 3)
        parts = []
        for lo, hi in zip(bounds, bounds[1:]):
            w = x[k].copy() if not fwd else None
            part = np.zeros(n)
            if lform:
                for i in range(lo, hi):
                    part[:i + 1] += F[k, i, :i + 1] * (F[k, i, :i + 1]
                                                      @ r[:i + 1])
                if not fwd:
                    part = -part
                    part[lo:hi] += w[lo:hi]
            else:
                part[lo:hi] = F[k, lo:hi] @ r
                if not fwd:
                    part[lo:hi] = w[lo:hi] - part[lo:hi]
                x[k, lo:hi] = part[lo:hi]
            parts.append(part)
        vec = np.sum(parts, axis=0)
        if lform:
            x[k] = vec
    return x


@pytest.mark.parametrize("lform", [False, True])
@pytest.mark.parametrize("N,K,cluster", [(2, 2, 1), (2, 9, 4), (3, 5, 2),
                                         (4, 3, 4), (1, 6, 4)])
def test_cluster_split_reproduces_the_plain_sweeps(N, K, cluster, lform):
    """float64 to 1e-12, every cluster size the plan uses, down to a rank
    with no rows (N = 1, four ranks)."""
    rng = np.random.default_rng(N * 100 + K)
    n = 6 * N
    if lform:
        F = np.tril(rng.normal(size=(K, n, n))) + 3 * np.eye(n)
    else:
        A = rng.normal(size=(K, n, n))
        F = A + A.transpose(0, 2, 1)
    C = np.triu(rng.normal(size=(K - 1, 3, 3)))
    b = rng.normal(size=(K, n))
    plain = tb.solve_factorized_L if lform else tb.solve_factorized_X
    want = plain(torch.as_tensor(F)[None], torch.as_tensor(C),
                 torch.as_tensor(b)[None])[0].numpy()
    got = _cluster_sweep(F, C, b, lform, cluster)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def _dense_cluster_sweep(L, E, b, cluster):
    """The dense form's data flow for one scenario: 4K - 3 steps over the
    ring order Linv_0, E_0, ..., Linv_{K-1} (forward, by rows; the turn
    Linv_{K-1} by rows and columns), E_{K-2}, Linv_{K-2}, ..., Linv_0
    (backward, by columns).  Rank q owns rows [lo_q, hi_q) of every block;
    a forward step exchanges the ranks' rows of its result, a backward step
    their column partial sums, rank q's covering the columns below hi_q
    (Linv) or all (E).  The output keeps y_k of a rank's rows until x_k
    overwrites it; a backward Linv_k step reads y_k of its own rows only."""
    K, n = b.shape
    bounds = [gs.sweep_rows(q, cluster, n) for q in range(cluster + 1)]
    ranks = list(zip(bounds, bounds[1:]))
    Lt = np.tril(L)          # the kernel reads only the lower triangle
    turn, steps = 2 * K - 2, 4 * K - 3
    x = np.full((K, n), np.nan)
    rows, parts = None, None

    def summed(parts_):
        s = np.zeros(n)
        for part, cover in parts_:
            s[:cover] += part[:cover]
        return s
    for t in range(steps + 1):
        p = t if t <= turn else 2 * turn - t
        on_l, k = p % 2 == 0, p // 2
        if t == steps:                         # x_0, from Linv_0's partials
            for lo, hi in ranks:
                x[0, lo:hi] = summed(parts)[lo:hi]
            break
        if t == 0:
            r = b[0]
        elif t <= turn:
            r = rows
        elif not on_l:                          # x_{k+1} is whole
            r = summed(parts)
            for lo, hi in ranks:
                x[k + 1, lo:hi] = r[lo:hi]
        else:                                   # y_k - E_k^T x_{k+1}
            r = np.full(n, np.nan)
            s = summed(parts)
            for lo, hi in ranks:
                r[lo:hi] = x[k, lo:hi] - s[lo:hi]
        M = Lt[k] if on_l else E[k]
        new_rows, new_parts = np.full(n, np.nan), []
        for lo, hi in ranks:
            if t < turn:
                d = M[lo:hi] @ r
                if on_l:
                    x[k, lo:hi] = d
                    new_rows[lo:hi] = d
                else:
                    new_rows[lo:hi] = b[k + 1, lo:hi] - d
                continue
            w = M[lo:hi] @ r if t == turn else r[lo:hi]
            part = M[lo:hi].T @ w
            cover = hi if on_l else n
            # a triangular block's rows [lo, hi) reach no column >= hi
            assert not part[cover:].any()
            new_parts.append((part, cover))
        rows, parts = new_rows, new_parts
    return x


@pytest.mark.parametrize("N,K,cluster", [(2, 2, 1), (2, 9, 4), (3, 5, 2),
                                         (4, 3, 4), (1, 6, 4), (5, 4, 2),
                                         (3, 2, 4)])
def test_dense_cluster_split_reproduces_the_plain_sweeps(N, K, cluster):
    """The dense form's split, rows forward and column partial sums
    backward, against ``banded.solve_factorized`` in float64 to 1e-12,
    every cluster size the plan uses, down to a rank with no rows."""
    rng = np.random.default_rng(N * 10 + K + cluster)
    n = 6 * N
    L = np.tril(rng.normal(size=(K, n, n))) + 3 * np.eye(n)
    E = rng.normal(size=(K - 1, n, n)) / n
    b = rng.normal(size=(K, n))
    want = tb.solve_factorized(torch.as_tensor(L)[None],
                               torch.as_tensor(E)[None],
                               torch.as_tensor(b)[None])[0].numpy()
    got = _dense_cluster_sweep(L, E, b, cluster)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("K", [2, 50])
def test_grouped_routes_above_n_256(K):
    """Under ``kernels=True`` the auto group falls to G = 1 above N = 256,
    and the router sends both forms to their grouped sweeps (as the JAX
    router does).  Both kernels serve them up to N = 1024 (n = 6144, a
    factor block of 151 MB) and refuse what lies beyond, before any
    launch."""
    from ba_path_planning_torch.utils.config import SolverConfig
    for form in ("X", "L"):
        static = SolverConfig(method="direct", kernels=True,
                              adaptive_rho=False,
                              factor_form=form).static_part()
        for N in (255, 256, 257, 300, 1024, 1025):
            took = tb.qp_route(static, n_vehicles=N, n_steps=K,
                               dtype=torch.float32, col_enabled=True)
            assert took == f"grouped_{form}"
            if N <= 1024:
                _check_plan(1, K, 6 * N, form, full_cluster=False)
            else:
                with pytest.raises(ValueError):
                    gs.sweep_plan(1, K, 6 * N, form)
