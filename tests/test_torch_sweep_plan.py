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


def _check_wide_plan(plan, B, K, n, esize=4, sms=gs.SMS, form="X"):
    """What the wide tier of ``form`` (X or L) needs of its plan: B
    scenarios of ``spread`` blocks each, all resident at once on ``sms``
    SMs at ``per_sm`` blocks an SM, every block at least one row pair and
    at most ``sweep_wide_rows``, its ring of two stages or more beside r,
    its w_k and (L) the y of a band and the warps' row sums."""
    assert plan.cluster == 1 and plan.spread >= 1
    assert 1 <= plan.per_sm <= gs.SWEEP_WIDE_PER_SM
    assert B * plan.spread <= sms * plan.per_sm
    row_bytes = gs.sweep_row_bytes(n, esize)
    rows = gs.sweep_wide_rows(n, plan.spread)
    assert plan.smem_bytes == gs.sweep_wide_smem_bytes(
        n, rows, plan.band_rows, plan.stages, row_bytes, form)
    assert plan.smem_bytes <= gs.SMEM_BLOCK_MAX
    assert plan.per_sm * (plan.smem_bytes + 1024) <= gs.SMEM_SM
    assert 2 <= plan.stages <= gs.SWEEP_MAX_STAGES
    band = plan.band_rows
    assert band % 2 == 0 and 2 <= band <= gs.SWEEP_MAX_BAND
    bounds = [gs.sweep_rows(q, plan.spread, n) for q in range(plan.spread + 1)]
    assert bounds[0] == 0 and bounds[-1] == n
    shares = [hi - lo for lo, hi in zip(bounds, bounds[1:])]
    assert min(shares) >= 2 and max(shares) <= rows
    assert all(lo % 2 == 0 for lo in bounds)
    # the ring is no deeper than the bands of the whole chain
    assert plan.stages <= -(-rows // band) * (2 * K - 1)
    return plan


def _check_plan(B, K, n, form, full_cluster=True):
    """What the kernel of ``form`` needs of the plan of B scenarios of K
    blocks of n x n; ``full_cluster``: a small batch runs in the clusters
    of 2 or 4 that its size asks for (the wide tier, where the plan takes
    it, in one cooperative grid).  Returns the plan."""
    plan = gs.sweep_plan(B, K, n, form)
    assert bool(plan.spread) == gs.sweep_wide(B, n, form)
    if plan.spread:
        return _check_wide_plan(plan, B, K, n, form=form)
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
                if not plan.spread:
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
        # a cluster of blocks of n = 1536 runs alone on its SMs: the wide
        # instantiations' launch bounds leave registers for one block an SM
        # (the X and L forms' single scenario takes the wide tier there)
        assert gs.sweep_plan(1, 50, 1536, form, _wide=False).per_sm == 1
        assert bool(gs.sweep_plan(1, 50, 1536, form).spread) == (
            form != "dense")
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
    assert gs.SWEEP_BAND_SUMS == k["kBandSums"]
    assert gs.SWEEP_MAX_STAGES == ring["kMaxStages"]
    assert gs.SWEEP_BARRIER_BYTES == k["kBarrierBytes"]
    assert gs.SMEM_BLOCK_MAX == k["kSmemMax"]
    row_lo = _c_function(src, "row_lo", ("c", "cluster", "n"), k)
    smem = _c_function(src, "smem_bytes",
                       ("n", "cluster", "band_rows", "stages", "part",
                        "row_bytes"), k)
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
                    # float32 rows of n, and bf16 rows on the padded stride
                    assert gs.sweep_smem_bytes(n, c, band, stages,
                                               part) == smem(
                        n, c, band, stages, part, 4 * n)
                    row = gs.sweep_row_bytes(n, 2)
                    assert gs.sweep_smem_bytes(n, c, band, stages, part,
                                               row) == smem(
                        n, c, band, stages, part, row)


def _ternary(expr):
    """A C expression of right-nested ternaries, && and || as Python."""
    if "?" not in expr:
        return expr.replace("&&", " and ").replace("||", " or ")
    cond, rest = expr.split("?", 1)
    then, other = rest.split(":", 1)
    return (f"(({_ternary(then)}) if ({_ternary(cond)}) "
            f"else ({_ternary(other)}))")


def test_sweep_plan_keeps_to_the_launch_bounds():
    """``sweep_blocks_per_sm`` is the kernel's ``blocks_per_sm``, which
    picks the instantiation (and with it the launch bounds) that serves a
    plan, for every form, factor type, tier and blocks an SM; no plan puts
    more blocks on an SM than the launch bounds of the instantiation it
    runs leave registers for, and a large batch on the narrow tier puts as
    many as they allow."""
    ring = _constants(_header("factor_ring.cuh"))
    src = _header("group_sweep.cuh")
    k = _constants(src.replace("factor_ring::kBarrierBytes",
                               str(ring["kBarrierBytes"])).replace(
        "factor_ring::kRows", str(ring["kRows"])))
    # the kernel's launch bounds are its kBlocks, which launch() takes from
    # blocks_per_sm for the plan's per_sm
    assert re.search(r"template <int kForm, int kTierN, typename T, int "
                     r"kBlocks>\s*__global__ void __launch_bounds__\("
                     r"kThreads, kBlocks\)", src)
    assert re.search(r"const int blocks = blocks_per_sm\(kForm, tier, kEsize, "
                     r"per_sm\);\s*if \(smem > kSmemMax \|\| per_sm < 1 \|\| "
                     r"per_sm > blocks\)", src)
    body = re.search(r"blocks_per_sm\(int form, int tier_n,\s*int esize, "
                     r"int per_sm\)\s*\{\s*return ([^;]+);", src).group(1)
    bound = eval("lambda form, tier_n, esize, per_sm: " + _ternary(body),
                 dict(k))
    assert gs.SWEEP_NARROW_N == k["kNarrowN"]
    forms = {"X": k["kFormX"], "L": k["kFormL"], "dense": k["kFormDense"]}
    seen = set()
    for form, code in forms.items():
        for n in (6, 120, 126, 504, 510, 516, 540, 894, 1536, 1542, 6144):
            if form == "dense" and n > k["kMaxN"]:
                continue
            # the tier group_sweep::launch takes for n
            tier = (k["kNarrowN"] if n <= k["kNarrowN"] else
                    k["kMaxN"] if form == "dense" or (
                        form == "L" and n <= k["kMaxN"]) else k["kMaxNWide"])
            for esize in (4, 2):
                for per_sm in (1, 2, 3, 4):
                    assert gs.sweep_blocks_per_sm(form, n, esize, per_sm) == (
                        bound(code, tier, esize, per_sm))
                most = gs.sweep_blocks_per_sm(form, n, esize)
                assert most == max(bound(code, tier, esize, q)
                                   for q in (1, 2, 3, 4))
                for B in (1, 33, 64, 65, 128, 264, 265, 512, 2048):
                    for K in (2, 50):
                        plan = gs.sweep_plan(B, K, n, form, esize=esize)
                        if plan.spread:      # the wide tier's own kernel
                            assert (1 <= plan.per_sm
                                    <= k["kWideBlocksPerSm"])
                            continue
                        runs = bound(code, tier, esize, plan.per_sm)
                        seen.add((form, tier, esize, plan.per_sm, runs))
                        assert 1 <= plan.per_sm <= runs
                        assert (plan.per_sm * (plan.smem_bytes + 1024)
                                <= gs.SMEM_SM)
                        if tier == k["kNarrowN"] and B >= most * gs.SMS:
                            assert plan.per_sm == most
    # the narrow tier: four blocks an SM, but on bf16 factors two for the L
    # form and for the dense form where its plan puts two or fewer on an
    # SM; one on every wide tier
    narrow = {(f, e, q, m) for f, t, e, q, m in seen if t == k["kNarrowN"]}
    assert {(f, e, m) for f, e, q, m in narrow} == {
        ("X", 4, 4), ("X", 2, 4), ("L", 4, 4), ("L", 2, 2), ("dense", 4, 4),
        ("dense", 2, 2), ("dense", 2, 4)}
    assert all(m == (2 if q <= 2 else 4)
               for f, e, q, m in narrow if (f, e) == ("dense", 2))
    assert {m for f, t, e, q, m in seen if t > k["kNarrowN"]} == {1}


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


@pytest.mark.parametrize("N", [342, 512, 1024])
def test_grouped_routes_above_n_341_run_the_row_stages(N):
    """At N = 342 … 1024 the production solver routes to ``grouped_X`` and
    the ``SCP`` class's solver to ``grouped_L``; in float32 on the card
    both run their check intervals on the row stages ("rows": admm_rhs,
    the sweep, admm_update), whose admission serves these N as the sweeps'
    plan does, at the production horizon and the cut one, and refuses
    N = 1025 before any launch, as the plan does."""
    from ba_path_planning_torch.ops import admm_steps
    from ba_path_planning_torch.solvers.scp import REFERENCE_SOLVER
    from ba_path_planning_torch.utils.config import SolverConfig
    f32, cuda = torch.float32, torch.device("cuda")
    for solver, route in ((SolverConfig.production(), "grouped_X"),
                          (REFERENCE_SOLVER.replace(kernels=True),
                           "grouped_L")):
        for K in (6, 50):
            assert tb.qp_route(solver.static_part(), n_vehicles=N, n_steps=K,
                               dtype=f32, col_enabled=True) == route
        assert tb.interval_kind(route, f32, cuda) == "rows"
        form = route[-1]
        for K in (6, 50):
            _check_plan(1, K, 6 * N, form, full_cluster=False)
            assert admm_steps.row_stages_serve(K, N)
            with pytest.raises(ValueError):
                gs.sweep_plan(1, K, 6 * 1025, form)
            assert not admm_steps.row_stages_serve(K, 1025)


# The plans of the production chunks (N = 20 at B = 512, 128, 64 and 1;
# N = 21 and 30 at B = 128; K = 50), (cluster, band_rows, stages,
# smem_bytes, per_sm) for float32 and bf16 factors, as the cluster tiers
# have planned them since bf16 rows were padded; the wide tier leaves them.
PRODUCTION_PLANS = {
    "X": {(20, 512): ((1, 24, 4, 48144, 4), (1, 30, 7, 52464, 4)),
          (20, 128): ((1, 30, 8, 117264, 1), (1, 30, 8, 59664, 1)),
          (20, 64): ((2, 30, 7, 103824, 2), (2, 30, 8, 60624, 2)),
          (20, 1): ((4, 30, 7, 105744, 2), (4, 30, 8, 62544, 2)),
          (21, 128): ((1, 32, 8, 131184, 1), (1, 32, 8, 67696, 1)),
          (30, 128): ((1, 30, 8, 175824, 1), (1, 30, 8, 91344, 1))},
    "L": {(20, 512): ((1, 24, 4, 51984, 4), (1, 30, 8, 63504, 2)),
          (20, 128): ((1, 30, 8, 121104, 1), (1, 30, 8, 63504, 1)),
          (20, 64): ((2, 30, 7, 107664, 2), (2, 30, 8, 64464, 2)),
          (20, 1): ((4, 30, 7, 109584, 2), (4, 30, 8, 66384, 2)),
          (21, 128): ((1, 32, 8, 135216, 1), (1, 32, 8, 71728, 1)),
          (30, 128): ((1, 30, 8, 181584, 1), (1, 30, 8, 97104, 1))},
    "dense": {(20, 512): ((1, 24, 4, 51984, 4), (1, 30, 7, 56304, 4)),
              (20, 128): ((1, 30, 8, 121104, 1), (1, 30, 8, 63504, 1)),
              (20, 64): ((2, 30, 7, 107664, 2), (2, 30, 8, 64464, 2)),
              (20, 1): ((4, 30, 7, 109584, 2), (4, 30, 8, 66384, 2)),
              (21, 128): ((1, 32, 8, 135216, 1), (1, 32, 8, 71728, 1)),
              (30, 128): ((1, 30, 8, 181584, 1), (1, 30, 8, 97104, 1))}}


@pytest.mark.parametrize("form", gs.SWEEP_FORMS)
def test_production_plans_are_pinned(form):
    """The production chunks keep their cluster-tier plans exactly, in
    float32 and bf16 (spread 0: no wide tier)."""
    for (N, B), plans in PRODUCTION_PLANS[form].items():
        for esize, want in zip((4, 2), plans):
            got = gs.sweep_plan(B, 50, 6 * N, form, esize=esize)
            assert tuple(got) == want + (0,)


@pytest.mark.parametrize("n,B,K", [(2052, 2, 50), (6144, 1, 6), (6144, 3, 2),
                                   (2052, 1, 50), (1200, 8, 50), (600, 2, 9)])
def test_wide_tier_spreads_a_small_batch_over_the_card(n, B, K):
    """The wide plan of the X and L forms at the grouped routes' widths
    past N = 59 and small batches: the whole card between the scenarios,
    each block a few row pairs of every factor block in bands as large as
    two stages allow, in float32 and bf16; the dense form has no wide tier
    (it refuses one), and a larger batch takes the cluster tier."""
    for form in ("X", "L"):
        for esize in (4, 2):
            plan = gs.sweep_plan(B, K, n, form, esize=esize)
            assert gs.sweep_wide(B, n, form) and plan.spread
            _check_wide_plan(plan, B, K, n, esize=esize, form=form)
            # the card's blocks, shared out: no more than one wave
            assert B * plan.spread > gs.SMS * plan.per_sm - B
            # no larger band leaves two stages beside the block's vectors
            rows = gs.sweep_wide_rows(n, plan.spread)
            room = gs.SMEM_SM // plan.per_sm - 1024
            bigger = gs.sweep_wide_smem_bytes(n, rows, plan.band_rows + 2, 2,
                                              gs.sweep_row_bytes(n, esize),
                                              form)
            assert (plan.band_rows == min(gs.SWEEP_MAX_BAND, rows)
                    or bigger > room)
            most = gs.sweep_wide_most(n, form, esize)
            assert gs.sweep_plan(most + 1, K, n, form,
                                 esize=esize).spread == 0
    # the production QP's width at the wide path's batch, and N = 1024
    assert tuple(gs.sweep_plan(2, 50, 2052, "X")) == (
        1, 12, 2, 205456, 1, 66)
    assert tuple(gs.sweep_plan(1, 6, 6144, "X")) == (1, 4, 2, 221504, 1, 132)
    # the L form: two blocks an SM where their bands hold SWEEP_WIDE_L_BAND
    # rows or a block more than twice as many (bf16), else one (float32;
    # its bands of 6 or 2 rows there)
    assert tuple(gs.sweep_plan(2, 50, 2052, "L")) == (
        1, 12, 2, 206608, 1, 66)
    assert tuple(gs.sweep_plan(2, 50, 2052, "L", esize=2)) == (
        1, 12, 2, 107728, 2, 132)
    assert tuple(gs.sweep_plan(1, 6, 6144, "L")) == (1, 4, 2, 223168, 1, 132)
    assert tuple(gs.sweep_plan(1, 6, 6144, "L", esize=2)) == (
        1, 2, 3, 99424, 2, 264)
    if n <= gs.SWEEP_MAX_N:
        assert gs.sweep_plan(B, K, n, "dense").spread == 0
        with pytest.raises(ValueError):
            gs.sweep_plan(B, K, n, "dense", _wide=True)
        assert not gs.sweep_wide(B, n, "dense")


# The L form's tier at the crossover's shapes (``torch_sweep_bench.py
# --tiers``, K = 50, N = 1024 at K = 6): 1 where the wide tier was the
# faster, by N (rows) and B (columns 1, 2, 8, 32)
L_WIDE_MEASURED = {
    4: {20: (0, 0, 0, 0), 30: (0, 0, 0, 0), 40: (1, 1, 0, 0),
        60: (1, 1, 1, 1), 100: (1, 1, 1, 1), 200: (1, 1, 1, 1),
        342: (1, 1, 1, 1), 1024: (1, 1, 1, 1)},
    2: {20: (0, 0, 0, 0), 30: (0, 0, 0, 0), 40: (0, 0, 0, 0),
        60: (0, 0, 0, 0), 100: (1, 1, 1, 0), 200: (1, 1, 1, 1),
        342: (1, 1, 1, 1), 1024: (1, 1, 1, 1)}}


@pytest.mark.parametrize("esize", [4, 2])
def test_l_form_takes_the_tier_measured_faster(esize):
    """``sweep_wide`` gives the L form the tier that the crossover
    measured faster at each of its shapes, in float32 and bf16, and the
    plan follows it."""
    for N, wide in L_WIDE_MEASURED[esize].items():
        for B, want in zip((1, 2, 8, 32), wide):
            assert gs.sweep_wide(B, 6 * N, "L", esize=esize) == bool(want)
            K = 6 if N == 1024 else 50
            plan = gs.sweep_plan(B, K, 6 * N, "L", esize=esize)
            assert bool(plan.spread) == bool(want)


@pytest.mark.parametrize("sms", [132, 114, 66, 16])
def test_wide_plan_fits_the_cards_sms(sms):
    """The wide tier's grid is cooperative, so all its blocks must be
    resident at once: on a card of ``sms`` SMs (an H100 PCIe has 114; a
    partition fewer) the plan shares out that card's blocks, as many as
    fit and no more, at the production QP's width and at N = 1024, in the
    X and L forms; a batch of more scenarios than the card has SMs keeps
    the cluster tier."""
    for B, K, n in ((2, 50, 2052), (1, 6, 6144), (8, 50, 1200),
                    (32, 50, 600), (1, 50, 360)):
        for form in ("X", "L"):
            for esize in (4, 2):
                plan = gs.sweep_plan(B, K, n, form, esize=esize, sms=sms)
                if not gs.sweep_wide(B, n, form, sms, esize):
                    # beyond the card's SMs, or (L on bf16 factors) where
                    # the cluster tier was measured faster
                    assert plan.spread == 0
                    assert B > sms or (form, esize) == ("L", 2)
                    continue
                _check_wide_plan(plan, B, K, n, esize=esize, sms=sms,
                                 form=form)
                assert (B * plan.spread > sms * plan.per_sm - B
                        or plan.spread == n // 2)


def test_wide_tier_mirrors_the_kernel_header():
    """The wide tier's rows a block, its shared memory and its scratch in
    ``group_solve.py`` are ``group_sweep.cuh``'s ``wide_rows``,
    ``wide_smem_bytes`` and ``wide_vbuf_floats``,
    in both forms and element sizes; its constants are the header's."""
    ring = _constants(_header("factor_ring.cuh"))
    src = _header("group_sweep.cuh")
    k = _constants(src.replace("factor_ring::kBarrierBytes",
                               str(ring["kBarrierBytes"])).replace(
        "factor_ring::kRows", str(ring["kRows"])))
    assert gs.SWEEP_WIDE_PER_SM == k["kWideBlocksPerSm"]
    assert gs.SWEEP_WIDE_BARRIER_BYTES == k["kWideBarrierBytes"]
    # the L form's column pairs of a thread cover the widest blocks
    assert 2 * k["kConsumers"] * k["kWidePairs"] >= gs.SWEEP_MAX_N_WIDE
    rows = _c_function(src, "wide_rows", ("n", "spread"), k)
    smem = _c_function(src, "wide_smem_bytes",
                       ("n", "rows", "band_rows", "stages", "row_bytes",
                        "form"), k)
    vbuf = _c_function(src, "wide_vbuf_floats", ("B", "n", "spread", "form"),
                       k)
    forms = {"X": k["kFormX"], "L": k["kFormL"]}
    for n in (6, 120, 594, 600, 606, 1200, 2052, 6144):
        for spread in (1, 2, 3, 66, 131, 132, 264):
            if 2 * spread <= n:
                assert gs.sweep_wide_rows(n, spread) == rows(n, spread)
                for form, code in forms.items():
                    for B in (1, 2, 32):
                        assert gs.sweep_wide_vbuf_floats(
                            B, n, spread, form) == vbuf(B, n, spread, code)
        for band, stages in ((2, 2), (4, 6), (32, 8)):
            for row_bytes in (4 * n, gs.sweep_row_bytes(n, 2)):
                for form, code in forms.items():
                    assert gs.sweep_wide_smem_bytes(
                        n, 16, band, stages, row_bytes, form) == smem(
                            n, 16, band, stages, row_bytes, code)


def _wide_l_sweep(F, C, b, spread):
    """The L form's wide data flow for one scenario: block g owns rows
    [lo_g, hi_g) of every Linv_k and forms the column partials of
    Linv_k[lo:hi, :hi]^T (Linv_k[lo:hi, :hi] r), the columns below hi_g
    (backward: w_k of its own rows minus them).  The reduce-scatter: block
    g sums its own rows' partials over the blocks g' >= g, warp w those of
    g + w, g + w + SWEEP_WARPS, ..., then the warps in turn."""
    K, n = b.shape
    bounds = [gs.sweep_rows(q, spread, n) for q in range(spread + 1)]
    blocks = list(zip(bounds, bounds[1:]))
    Lt = np.tril(F)              # the kernel reads only the lower triangle
    x, vec = np.zeros((K, n)), None
    for t in range(2 * K - 1):
        fwd = t < K
        k = t if fwd else 2 * K - 2 - t
        if fwd:
            r = b[k] if k == 0 else b[k] - _slot_b(C[k - 1], vec, n // 3)
        else:
            r = _slot_bt(C[k], vec, n // 3)
        parts = []
        for lo, hi in blocks:
            M = Lt[k, lo:hi, :hi]
            part = M.T @ (M @ r[:hi])
            if not fwd:
                part = -part
                part[lo:hi] += x[k, lo:hi]
            parts.append(part)
        vec = np.zeros(n)
        for g, (lo, hi) in enumerate(blocks):
            for w in range(gs.SWEEP_WARPS):
                s = np.zeros(hi - lo)
                for q in range(g + w, spread, gs.SWEEP_WARPS):
                    s += parts[q][lo:hi]
                vec[lo:hi] += s
        x[k] = vec
    return x


@pytest.mark.parametrize("form", ["X", "L"])
@pytest.mark.parametrize("N,K,spread", [(100, 3, 264), (12, 4, 36),
                                        (5, 6, 13), (3, 9, 2)])
def test_wide_split_reproduces_the_plain_sweeps(N, K, spread, form):
    """The wide tier's data flow, down to a block of one row pair: float64
    to 1e-12 against the plain sweeps.  X: the row split over ``spread``
    blocks (each its row pairs of every step, the step's whole vector read
    back from the rows every block stored).  L: each block's column
    partials, reduced by the kernel's fixed reduce-scatter order."""
    rng = np.random.default_rng(N + K)
    n = 6 * N
    C = np.triu(rng.normal(size=(K - 1, 3, 3)))
    b = rng.normal(size=(K, n))
    assert min(gs.sweep_rows(q + 1, spread, n) - gs.sweep_rows(q, spread, n)
               for q in range(spread)) >= 2
    if form == "X":
        A = rng.normal(size=(K, n, n)) / n
        F = A + A.transpose(0, 2, 1)
        want = tb.solve_factorized_X(torch.as_tensor(F)[None],
                                     torch.as_tensor(C),
                                     torch.as_tensor(b)[None])[0].numpy()
        got = _cluster_sweep(F, C, b, False, spread)
    else:
        # lower triangular blocks (what lies above is never read) of norm
        # about 1
        F = (np.tril(rng.normal(size=(K, n, n))) + 3 * np.eye(n)) / n ** 0.5
        F += np.triu(rng.normal(size=(K, n, n)), 1)
        want = tb.solve_factorized_L(torch.as_tensor(np.tril(F))[None],
                                     torch.as_tensor(C),
                                     torch.as_tensor(b)[None])[0].numpy()
        got = _wide_l_sweep(F, C, b, spread)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
