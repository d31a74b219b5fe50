"""The column layouts of the kernels' products on bf16 factors, on the CPU:
no JAX and no card.

On bf16 factors a lane of the sweep kernels (``csrc/group_sweep.cuh``) and
of the L-form fused interval (``csrc/admm_fused_l.cu``) reads two
neighbouring columns of a row as one ``__nv_bfloat162`` and widens them
once (``csrc/factor_ring.cuh``): the row products take the pairs
j = 64 m + 2 lane and sum a warp's rows in one joint reduction
(``matvec_rows`` on a bf16 ring, ``warp_sum_rows``); the sweeps' column
products keep the partial sums of the pairs a lane owns
(``matvec_rows_cols_bf16``, written out by ``store_pair_sums``); the fused
kernel's transposed products give each lane a column pair of an octet and
every eighth row (``matvec_cols`` on a bf16 ring).  The
kernels run only on the card, where ``tests/test_torch_kernels_gpu.py``
holds them to their plain versions; here float64 models of these loops,
index for index and mask for mask, are held to the products they stand
for, and the layouts to the kernels' own constants.
"""

import numpy as np
import pytest

from test_torch_sweep_plan import _constants, _header

LANES = 32
ROWS = 4                     # factor_ring kRows: rows a warp takes at once


def _sweep_consts():
    ring = _constants(_header("factor_ring.cuh"))
    src = _header("group_sweep.cuh").replace(
        "factor_ring::kBarrierBytes", str(ring["kBarrierBytes"])).replace(
        "factor_ring::kRows", str(ring["kRows"]))
    return ring, _constants(src)


def _fused_consts():
    k = _constants(_header("admm_fused.cuh"))
    k.update(_constants(_header("admm_fused_l.cu")))
    return k


def _pair(row, j, lim):
    """factor_ring pair_below: (row[j], row[j + 1]), 0 from column lim on."""
    if j >= lim:
        return 0.0, 0.0
    return row[j], (row[j + 1] if j + 1 < lim else 0.0)


def _row_dots(M, v, rows, tri):
    """The row products of matvec_rows and matvec_rows_cols_bf16 on bf16:
    each lane's pairs, then the warp's sum, for the rows ``rows`` of M."""
    n = M.shape[1]
    out = {}
    for i in rows:
        lim = i + 1 if tri else n
        lanes = np.zeros(LANES)
        for lane in range(LANES):
            for j in range(2 * lane, lim, 64):
                e0, e1 = _pair(M[i], j, lim)
                lanes[lane] += e0 * v[j] + e1 * v[j + 1]
        out[i] = lanes.sum()
    return out


def _rows_cols(M, v, lo, hi, band, tri, dots, n_warps, pairs):
    """factor_ring matvec_rows_cols_bf16 over rows [lo, hi) in bands of
    ``band`` rows, each warp's acc[2 m], acc[2 m + 1] (the columns
    64 m + 2 lane, + 1) written out as store_pair_sums writes them (below
    ``cover``) and summed over the warps: the column partial sums."""
    n = M.shape[1]
    cover = hi if tri else n
    part = np.zeros((n_warps, n))
    for warp in range(n_warps):
        acc = np.zeros((LANES, 2 * pairs))
        for r0 in range(lo, hi, band):
            r1 = min(r0 + band, hi)
            for i in range(r0 + warp, r1, ROWS * n_warps):
                for q in range(ROWS):
                    iq = i + q * n_warps
                    if iq >= r1:
                        continue
                    lim = iq + 1 if tri else n
                    y = (_row_dots(M, v, [iq], tri)[iq] if dots else v[iq])
                    for m in range(pairs):
                        for lane in range(LANES):
                            e0, e1 = _pair(M[iq], 64 * m + 2 * lane, lim)
                            acc[lane, 2 * m] += e0 * y
                            acc[lane, 2 * m + 1] += e1 * y
        for m in range(pairs):
            for lane in range(LANES):
                j = 64 * m + 2 * lane
                if j < cover:
                    part[warp, j:j + 2] = acc[lane, 2 * m:2 * m + 2]
    return part.sum(0)


def _cols(M, v, band, tri, groups, n_warps):
    """factor_ring matvec_cols on a bf16 ring: {j: column j of M (from row j if
    ``tri``) . v}, each column written once, by the lane of row group 0
    that owns its pair."""
    n = M.shape[1]
    width = 8                              # an octet, a lane a column pair
    lanes_along, stride = width // 2, 64 // width
    out = {}
    for warp in range(n_warps):
        acc = np.zeros((LANES, groups, 2))
        for r0 in range(0, n, band):
            r1 = min(r0 + band, n)
            for u in range(groups):
                first = (warp + u * n_warps) * width
                for lane in range(LANES):
                    g, jj = lane // lanes_along, 2 * (lane % lanes_along)
                    j = first + jj
                    if j >= n or (tri and first >= r1):
                        continue
                    i = r0 + g
                    if tri and first > r0:
                        i += (first - r0) & ~(stride - 1)
                    for i in range(i, r1, stride):
                        if tri and i < j:
                            continue
                        e1 = 0.0 if tri and i == j else M[i, j + 1]
                        acc[lane, u] += (M[i, j] * v[i], e1 * v[i])
        for u in range(groups):
            for lane in range(LANES):
                g, jj = lane // lanes_along, 2 * (lane % lanes_along)
                j = (warp + u * n_warps) * width + jj
                if g == 0 and j < n:
                    # the shuffles: the lanes of the other row groups
                    mates = [lane + lanes_along * s for s in range(stride)]
                    s = acc[mates, u].sum(0)
                    assert j not in out and j + 1 not in out
                    out[j], out[j + 1] = s
    return out


def _sweep_pairs(n, tier_n):
    """The column pairs of a sweep instantiation of tier ``tier_n``: U =
    tier_n / 32 partial sums a lane, U / 2 pairs."""
    return tier_n // LANES // 2


def _sweep_tier(n, k, form):
    if n <= k["kNarrowN"]:
        return k["kNarrowN"]
    return k["kMaxN"] if form == "dense" else k["kMaxNWide"]


def test_sweep_pairs_cover_every_column_once():
    """The pairs that store_pair_sums writes, for every n = 6N, N = 1 ...
    149, on the dense (and L) instantiation that serves n: every column
    below the cover (n for E_k, a cluster rank's last row for Linv_k) once,
    and nothing beyond it."""
    _, k = _sweep_consts()
    for N in range(1, 150):
        n = 6 * N
        pairs = _sweep_pairs(n, _sweep_tier(n, k, "dense"))
        for cover in {n} | {2 * (c * (n // 2) // 4) for c in range(1, 5)}:
            cols = []
            for m in range(pairs):
                if 64 * m >= cover:
                    break
                for lane in range(LANES):
                    j = 64 * m + 2 * lane
                    if j < cover:
                        cols += [j, j + 1]
            assert sorted(cols) == list(range(cover)), (n, cover)


def _fused_layout(n, k):
    """(octets a warp, warps) of the fused L kernel's instantiation serving
    n, as its launcher chooses: the narrow octet count where n allows."""
    warps = k["kConsumers"] // LANES
    octets = (k["kNarrowOctets"] if n <= 8 * k["kNarrowOctets"] * warps
              else k["kWideOctets"])
    return octets, warps


def test_fused_column_groups_cover_every_column_once():
    """matvec_cols's octets and lanes on bf16, for every n = 6N, N = 1 ... 149
    (the fused L kernel serves n <= 896): the pairs of the lanes of row
    group 0 hold every column once, and the row groups of a lane's pair
    together every row of a band once."""
    k = _fused_consts()
    for N in range(1, 150):
        n = 6 * N
        groups, warps = _fused_layout(n, k)
        assert n <= 8 * groups * warps
        width, lanes_along, stride = 8, 4, 8
        cols = []
        for warp in range(warps):
            for u in range(groups):
                for lane in range(lanes_along):   # row group 0
                    j = (warp + u * warps) * width + 2 * lane
                    if j < n:
                        cols += [j, j + 1]
        assert sorted(cols) == list(range(n)), n
        for r0, r1 in ((0, n), (0, min(n, 30)), (n - n % 4, n)):
            rows = sorted(i for g in range(stride)
                          for i in range(r0 + g, r1, stride))
            assert rows == list(range(r0, r1))


@pytest.mark.parametrize("n,band,tri", [(6, 2, True), (120, 30, True),
                                        (120, 30, False), (126, 24, True),
                                        (138, 8, False), (138, 22, True)])
def test_fused_transposed_product_model(n, band, tri):
    """The float64 model of matvec_cols on bf16, band by band, gives M^T v
    (M lower triangular where ``tri``, the entries above the diagonal then
    never read)."""
    k = _fused_consts()
    rng = np.random.default_rng(n + band)
    M, v = rng.normal(size=(n, n)), rng.normal(size=n)
    want = (np.tril(M) if tri else M).T @ v
    if tri:
        M[np.triu_indices(n, 1)] = np.nan       # never read
    groups, warps = _fused_layout(n, k)
    got = _cols(M, v, band, tri, groups, warps)
    assert sorted(got) == list(range(n))
    np.testing.assert_allclose([got[j] for j in range(n)], want, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("n,lo,hi,band,tri,dots",
                         [(12, 0, 12, 2, True, True), (120, 0, 120, 30, True,
                                                       True),
                          (120, 60, 120, 30, True, False),
                          (120, 0, 120, 24, False, False),
                          (126, 62, 126, 32, True, True),
                          (138, 0, 70, 30, False, False)])
def test_sweep_pair_products_model(n, lo, hi, band, tri, dots):
    """The float64 model of the bf16 sweeps' products gives what each step
    needs of its rows [lo, hi) (a cluster rank's share): the row products
    of row_dots (forward steps) and the column partial sums of
    matvec_rows_cols_bf16 as store_pair_sums writes them, with y_i the row
    dot (the turn and the L form) or v_i (the dense form's backward
    steps)."""
    _, k = _sweep_consts()
    rng = np.random.default_rng(n + lo + band)
    M, v = rng.normal(size=(n, n)), rng.normal(size=n)
    L = np.tril(M) if tri else M
    if tri:
        M[np.triu_indices(n, 1)] = np.nan       # never read
    rows = _row_dots(M, v, range(lo, hi), tri)
    np.testing.assert_allclose([rows[i] for i in range(lo, hi)],
                               L[lo:hi] @ v, rtol=1e-12, atol=1e-12)
    y = L[lo:hi] @ v if dots else v[lo:hi]
    want = L[lo:hi].T @ y
    got = _rows_cols(M, v, lo, hi, band, tri, dots, k["kWarps"],
                     _sweep_pairs(n, _sweep_tier(n, k, "dense")))
    cover = hi if tri else n
    np.testing.assert_allclose(got[:cover], want[:cover], rtol=1e-12,
                               atol=1e-12)
    assert not got[cover:].any()


@pytest.mark.parametrize("rows", [1, 4, 8])
def test_joint_warp_reduction_model(rows):
    """A model of factor_ring warp_sum_rows, shuffle by shuffle: after its
    levels lane l holds the sum over the warp of value l / (32 / rows), so
    that matvec_rows on bf16 runs fn for row q on lane q (32 / rows)."""
    rng = np.random.default_rng(rows)
    a = rng.normal(size=(LANES, rows))
    want = a.sum(0)
    vals = [list(a[lane]) for lane in range(LANES)]
    count, s = rows, 16
    while count > 1:
        h = count // 2
        keep, give = [], []
        for lane in range(LANES):
            lo_half, hi_half = vals[lane][:h], vals[lane][h:]
            upper = bool(lane & s)
            keep.append(hi_half if upper else lo_half)
            give.append(lo_half if upper else hi_half)
        # a[q] = keep + __shfl_xor_sync(give, s)
        vals = [[keep[lane][q] + give[lane ^ s][q] for q in range(h)]
                for lane in range(LANES)]
        count, s = h, s // 2
    s = 16 // rows
    while s >= 1:
        vals = [[vals[lane][0] + vals[lane ^ s][0]] for lane in range(LANES)]
        s //= 2
    span = LANES // rows
    for lane in range(LANES):
        assert vals[lane][0] == pytest.approx(want[lane // span], abs=1e-12)
