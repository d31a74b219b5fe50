"""The launch plan of the fused ADMM-interval kernels
(``admm_fused.fused_plan``) and the packed upper triangles the X-form
kernel reads, on the CPU: no JAX and no card.

The kernels themselves (``csrc/admm_fused_x.cu``, ``csrc/admm_fused_l.cu``)
run only on the card and are held to their plain versions by
``tests/test_torch_kernels_gpu.py``.  Here the plan is held to the kernels'
header, each kernel's envelope to every (K, N) that the router sends to it,
and a float64 model of the X-form kernel's packed product
(U r + (strict U)^T r, from the bands it streams) to X r.  The X form's
wide tier (small batches, each scenario over many SMs) is held the same
way: its plan to the kernel's layout and to cards of several sizes, and a
float64 model of its data flow (each block's rows of each step, its shares
of the elementwise phases, in the order of the barriers) to the plain
interval.

    python -m pytest tests/test_torch_fused_plan.py -q
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ba_path_planning_torch.ops import admm_fused as af
from ba_path_planning_torch.ops import admm_steps
from ba_path_planning_torch.ops import group_solve as gs
from ba_path_planning_torch.ops.collisions import make_pair_index
from ba_path_planning_torch.solvers import banded as tb
from ba_path_planning_torch.solvers.scp import _warm_state
from ba_path_planning_torch.utils.config import (ProblemConfig, SolverConfig,
                                                 make_solver_params)

CSRC = Path(af.__file__).resolve().parents[1] / "csrc"


def _constants(src):
    """The namespace-level ``constexpr`` integers of a CUDA source, by name
    (an expression of earlier ones is evaluated)."""
    out = {}
    for name, expr in re.findall(
            r"^constexpr (?:int|long) (\w+) = ([^;]+);", src, re.M):
        out[name] = eval(expr.replace("/", "//"), {}, dict(out))
    return out


def _bands(n, stage_floats):
    """The packed mode's bands (the kernel's band table): runs of whole
    packed rows that fill a stage, as (first row, end row) pairs."""
    off = af.packed_offsets(n)
    out, r0 = [], 0
    while r0 < n:
        r1 = r0
        while r1 < n and off[r1 + 1] - off[r0] <= stage_floats:
            r1 += 1
        out.append((r0, r1))
        r0 = r1
    return out


def _check_plan(K, N, form):
    """What the kernel needs of the plan; returns it."""
    plan = af.fused_plan(K, N, form)
    n = 6 * N
    assert plan.band_rows % 2 == 0 and 2 <= plan.band_rows <= n
    assert 2 <= plan.stages <= af.FUSED_MAX_STAGES
    assert plan.packed == (form == "X" and af.FUSED_X_PACKED_MIN_N <= n
                           <= af.FUSED_X_PACKED_MAX_N)
    assert plan.smem_bytes == af.fused_smem_bytes(
        K, N, plan.band_rows, plan.stages, int(plan.plane_in_smem),
        int(plan.packed), int(form == "X"))
    assert plan.smem_bytes <= af.FUSED_SMEM_MAX
    # the plane lies in shared memory where it takes half of it at most
    assert plan.plane_in_smem == (4 * K * n <= af.FUSED_SMEM_MAX // 2)
    # a band is one bulk copy: bytes and address multiples of 16
    assert plan.band_rows * n * 4 % 16 == 0
    if plan.packed:
        width = -(-n // 4) * 4
        bands = _bands(n, plan.band_rows * width)
        # the band table holds them, each at least band_rows rows but the
        # last, each a whole number of 16-byte units from a 16-byte offset
        assert len(bands) <= af.FUSED_MAX_BANDS
        assert all(r1 - r0 >= plan.band_rows for r0, r1 in bands[:-1])
        assert all(o % 4 == 0 for o in af.packed_offsets(n))
    return plan


def _c_function(src, name, consts):
    """An inline function of a CUDA source (``const`` locals, then one
    ``return``) as a Python function: integer division, no casts or
    namespaces."""
    m = re.search(r"\b" + name + r"\(([^)]*)\)\s*\{([^}]*)\}", src)
    args = [a.split()[-1] for a in m.group(1).split(",")]
    lines = []
    for stmt in m.group(2).split(";"):
        stmt = re.sub(r"static_cast<\w+>\(", "(", " ".join(stmt.split()))
        stmt = re.sub(r"\b(\d+)L\b", r"\1", stmt).replace("/", "//")
        stmt = re.sub(r"\w+::", "", stmt)
        stmt = re.sub(r"^const (?:int|long) ", "", stmt)
        stmt = re.sub(r"^return (.+) \? (.+) : (.+)$",
                      r"return (\2) if (\1) else (\3)", stmt)
        if stmt:
            lines.append(stmt)
    code = (f"def {name}({', '.join(args)}):\n"
            + "".join(f"    {ln}\n" for ln in lines))
    scope = dict(consts)
    exec(code, scope)
    return scope[name]


def test_plan_layout_matches_the_kernel_header():
    """The plan's copy of the kernels' layout (sizes, limits, the shared
    memory of a block, the packed rows' offsets) is the headers'."""
    ring = _constants((CSRC / "factor_ring.cuh").read_text())
    src = (CSRC / "admm_fused.cuh").read_text()
    k = _constants(src)
    lform = _constants((CSRC / "admm_fused_l.cu").read_text())
    xsrc = (CSRC / "admm_fused_x.cu").read_text()
    assert af.FUSED_SMEM_MAX == k["kSmemMax"]
    assert af.FUSED_RING_BARRIER_BYTES == ring["kBarrierBytes"]
    assert af.FUSED_MAX_STAGES == ring["kMaxStages"]
    assert af.FUSED_WARPS == k["kWarps"]
    assert af.FUSED_X_PACKED_MAX_N == k["kPackedMaxN"]
    assert af.FUSED_MAX_BANDS == k["kMaxBands"]
    assert af.FUSED_L_MAX_N == 8 * lform["kWideOctets"] * k["kWarps"]
    assert 8 * lform["kNarrowOctets"] * k["kWarps"] == 512
    consts = dict(k, kBarrierBytes=ring["kBarrierBytes"])
    ring_width = _c_function(src, "ring_width", consts)
    smem = _c_function(src, "smem_bytes",
                       dict(consts, ring_width=ring_width))
    # (2, 584) and (6, 341): short horizons of large fleets, where a pair
    # table (2N(N - 1) bytes) would leave no ring
    for K, N in ((2, 2), (50, 20), (50, 40), (330, 30), (3, 147), (9, 23),
                 (2, 584), (6, 341)):
        for band, stages, plane in ((2, 2, 0), (40, 4, 1), (12, 8, 1)):
            for packed, xform in ((0, 0), (0, 1), (1, 1)):
                row = 4 * ring_width(6 * N, packed)
                assert af.fused_row_bytes(6 * N, packed) == row
                assert af.fused_smem_bytes(K, N, band, stages, plane,
                                           packed, xform) == smem(
                    K, N, band, stages, plane, packed, xform, row)
            # the L form's bf16 factors: rows on the padded stride
            row = af.fused_row_bytes(6 * N, 0, esize=2)
            assert af.fused_smem_bytes(K, N, band, stages, plane, 0, 0,
                                       row) == smem(
                K, N, band, stages, plane, 0, 0, row)
    packed_off = _c_function(xsrc, "packed_off", {})
    for n in (12, 18, 120, 180, 240, 246, 510, 512):
        width = -(-n // 4) * 4
        assert af.packed_offsets(n) == [packed_off(i, width)
                                        for i in range(n + 1)]


@pytest.mark.parametrize("N", [2, 3, 4, 20, 22, 29, 30, 40, 60, 85, 86, 149])
def test_fused_plan_fits_the_card(N):
    """Both forms at the production horizon and at long ones (the sweep
    plane in a global scratch); the L form up to n = 896."""
    for K in (2, 9, 50, 161, 162, 330, 500):
        _check_plan(K, N, "X")
        if 6 * N <= af.FUSED_L_MAX_N:
            _check_plan(K, N, "L")
    # the production plans: 4 stages of 40 rows at N = 40 (packed), of 60
    # at N = 30 (whole bands)
    assert af.fused_plan(50, 40, "X")[:4] == (40, 4, True, True)
    assert af.fused_plan(50, 30, "X")[:4] == (60, 4, True, False)
    with pytest.raises(ValueError):
        af.fused_plan(50, 150, "L")


@pytest.mark.parametrize("K", range(2, 51))
def test_fused_l_route_lies_inside_the_kernel_envelope(K):
    """Every (K, N) that ``qp_route`` sends to the L-form fused kernel, as
    the JAX router does (fused, no group, 2 K (6N)^2 4 <= 12 MiB), is one
    the kernel serves: K = 2 reaches N = 147 (n = 882), past the narrow
    instantiation's 512.  Both ways of reaching the route are asked."""
    statics = [SolverConfig(method="direct", fused=True, kernels=False,
                            adaptive_rho=False).static_part(),
               SolverConfig(method="direct", fused=True, kernels=True,
                            group=-1, adaptive_rho=False).static_part()]
    routed = []
    for N in range(2, 200):
        took = {tb.qp_route(st, n_vehicles=N, n_steps=K,
                            dtype=torch.float32, col_enabled=True)
                for st in statics}
        if "fused_L" in took:
            assert took == {"fused_L"}
            routed.append(N)
            _check_plan(K, N, "L")
    assert routed == list(range(2, routed[-1] + 1))
    assert 2 * K * (6 * (routed[-1] + 1)) ** 2 * 4 > 12 * 1024 * 1024
    if K <= 5:
        assert 6 * routed[-1] > 512      # the wide instantiation's range


# The solver options that reach the X-form fused route: the production
# solver, its latency variant and the production solver with adaptive rho
# (which routes as the shared rho does)
FUSED_X_SOLVERS = {
    "production": SolverConfig.production(),
    "latency": SolverConfig.latency(),
    "adaptive": SolverConfig.production().replace(adaptive_rho=True),
}


@functools.lru_cache(maxsize=None)
def _fused_x_routed(K):
    """The N <= 700 that ``qp_route`` sends to the X-form fused route at
    K steps (the same for the three solvers of FUSED_X_SOLVERS)."""
    statics = [s.static_part() for s in FUSED_X_SOLVERS.values()]
    routed = []
    for N in range(2, 701):
        took = {tb.qp_route(st, n_vehicles=N, n_steps=K,
                            dtype=torch.float32, col_enabled=True)
                for st in statics}
        if "fused_X" in took:
            assert took == {"fused_X"}
            routed.append(N)
    return tuple(routed)


@pytest.mark.parametrize("K", range(2, 51))
def test_fused_x_route_lies_inside_the_kernel_envelope(K):
    """Every (K, N), N <= 700, that ``qp_route`` sends to the X-form fused
    kernel, as the JAX router does (fused, auto group below 16,
    K nr8 np 4 <= 96 MiB), is one the kernel serves: short horizons reach
    N = 584 at K = 2 (n = 3504), where a pair table in shared memory would
    leave no ring (K = 2 … 9 at N = 268 … 584).  The route is the same for
    the three solvers, starts at N = 22 (the auto group falls below 16) and
    ends at the 96 MiB gate."""
    routed = list(_fused_x_routed(K))
    for N in routed:
        _check_plan(K, N, "X")
    assert routed == list(range(22, routed[-1] + 1))

    def gate(N):
        np_, nr8 = -(-6 * N // 128) * 128, -(-6 * N // 8) * 8
        return K * nr8 * np_ * 4 <= 96 * 1024 * 1024
    assert gate(routed[-1]) and not gate(routed[-1] + 1)
    if K == 2:
        assert routed[-1] == 584


def _port_X(K, N, seed):
    """The port's X-form factors (``banded.factorize_X``, float64) of
    production-shaped diagonal blocks: the rho pattern of
    ``SolverConfig.production()`` and collision blocks from random unit
    directions."""
    rng = np.random.default_rng(seed)
    P, f64 = N * (N - 1) // 2, torch.float64
    rho = tb.rho_pattern_masks(
        tb.row_scaling_state(K, 0.2, dtype=f64),
        SolverConfig.production().static_part(), torch.tensor(2.6, dtype=f64),
        torch.tensor(2.5, dtype=f64), n_steps=K, n_pairs=P, col_enabled=True,
        dtype=f64)
    eta = rng.normal(size=(1, K, P, 2))
    eta /= np.linalg.norm(eta, axis=-1, keepdims=True)
    D, C = tb.assemble_D(rho, torch.as_tensor(eta),
                         make_pair_index(N, dtype=f64).E, h=0.2,
                         sigma=torch.tensor(1e-6, dtype=f64), n_vehicles=N)
    return tb.factorize_X(D, C, ns_iters=2)[0]


def _packed_product(Xp, r, n, stage_floats):
    """The packed mode's X_k r for one block: from each band as one bulk
    copy brings it, the row dots of U r and the columns right of the
    diagonal times r_i, summed over the block's rows."""
    off = af.packed_offsets(n)
    dots, cols = np.zeros(n), np.zeros(n)
    for r0, r1 in _bands(n, stage_floats):
        band = Xp[off[r0]:off[r1]]
        for i in range(r0, r1):
            c0 = 4 * (i // 4)
            u = band[off[i] - off[r0]:off[i + 1] - off[r0]][i - c0:n - c0]
            dots[i] = u @ r[i:]
            cols[i + 1:] += u[1:] * r[i]
    return dots + cols


@pytest.mark.parametrize("N,K", [(3, 4), (4, 3), (5, 3), (39, 2)])
def test_packed_product_reproduces_x_r(N, K):
    """The packed upper triangles of the port's own X (``pack_upper``)
    hold X's entries, and U r + (strict U)^T r from them, band by band, is
    X r in float64 to 1e-12 of its largest entry (X is symmetric to the
    same order), for the plan's bands and for bands of two rows; n = 18,
    30 and 234 have padding columns, n = 24 none."""
    X = _port_X(K, N, seed=N)
    n = 6 * N
    Xn = X.numpy()
    assert np.abs(Xn - Xn.transpose(0, 2, 1)).max() <= 1e-13 * np.abs(Xn).max()
    Xp = af.pack_upper(X[None])[0].numpy()
    off = af.packed_offsets(n)
    assert Xp.shape == (K, off[-1])
    width = -(-n // 4) * 4
    for i in range(n):
        c0 = 4 * (i // 4)
        np.testing.assert_array_equal(Xp[:, off[i]:off[i] + n - c0],
                                      Xn[:, i, c0:])
    plan = af.fused_plan(K, N, "X")
    r = np.random.default_rng(N + 1).normal(size=n)
    for rows in (plan.band_rows, 2):
        for k in range(K):
            got = _packed_product(Xp[k], r, n, rows * width)
            want = Xn[k] @ r
            assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


# ---------------------------------------------------------------------------
# The X form's wide tier
# ---------------------------------------------------------------------------

# cards of the SM counts a plan must fit: the H100 SXM, the H100 PCIe and
# a smaller part
WIDE_SMS = (132, 114, 78)
# (B, K, N) the router sends to the fused X route at small batches: the
# short horizons of large fleets and the latency shapes at K = 50
WIDE_SHAPES = [(2, 2, 584), (2, 6, 341), (1, 9, 268), (1, 2, 302),
               (8, 9, 277), (1, 50, 22), (1, 50, 40), (32, 50, 30),
               (2, 50, 100), (32, 2, 584)]


def _check_wide_plan(plan, B, K, N, sms=af.SMS):
    """What the wide kernel needs of its plan: B scenarios of ``spread``
    blocks, all resident at once on ``sms`` SMs at ``per_sm`` blocks an
    SM, every block at least one row pair and at most ``sweep_wide_rows``,
    its ring of two stages or more of whole rows beside r, w_k and the
    slot scalars, the planes in the global scratch."""
    n = 6 * N
    assert plan.spread >= 1 and 1 <= plan.per_sm <= gs.SWEEP_WIDE_PER_SM
    assert not plan.packed and not plan.plane_in_smem
    assert B * plan.spread <= sms * plan.per_sm
    rows = gs.sweep_wide_rows(n, plan.spread)
    assert plan.smem_bytes == af.fused_wide_smem_bytes(
        K, N, rows, plan.band_rows, plan.stages)
    assert plan.smem_bytes <= af.FUSED_SMEM_MAX
    assert plan.per_sm * (plan.smem_bytes + 1024) <= gs.SMEM_SM
    assert 2 <= plan.stages <= af.FUSED_MAX_STAGES
    assert plan.band_rows % 2 == 0
    assert 2 <= plan.band_rows <= min(gs.SWEEP_MAX_BAND, rows)
    bounds = [gs.sweep_rows(g, plan.spread, n)
              for g in range(plan.spread + 1)]
    assert bounds[0] == 0 and bounds[-1] == n
    shares = [hi - lo for lo, hi in zip(bounds, bounds[1:])]
    assert min(shares) >= 2 and max(shares) <= rows
    return plan


def test_wide_plan_mirrors_the_kernel_header():
    """The wide tier's shared memory, scratch and elementwise shares in
    ``admm_fused.py`` are ``admm_fused_x.cu``'s ``fused_wide_smem_bytes``,
    ``fused_wide_scratch_floats`` and ``fused_wide_share``, and its limits
    the headers' (as ``test_torch_sweep_plan.py::
    test_wide_tier_mirrors_the_kernel_header`` holds the sweep's)."""
    ring = _constants((CSRC / "factor_ring.cuh").read_text())
    sweep = _constants((CSRC / "group_sweep.cuh").read_text().replace(
        "factor_ring::kBarrierBytes", str(ring["kBarrierBytes"])).replace(
        "factor_ring::kRows", str(ring["kRows"])))
    assert af.FUSED_X_WIDE_MAX_N == sweep["kMaxNWide"]
    assert gs.SWEEP_WIDE_PER_SM == sweep["kWideBlocksPerSm"]
    assert gs.SWEEP_MAX_BAND == sweep["kMaxBandRows"]
    # the slots a consumer thread preloads cover the widest n
    assert 3 * sweep["kConsumers"] * sweep["kWideSlots"] >= (
        af.FUSED_X_WIDE_MAX_N)
    xsrc = (CSRC / "admm_fused_x.cu").read_text()

    def sweep_smem(n, rows, band, stages, row_bytes, form):
        return gs.sweep_wide_smem_bytes(
            n, rows, band, stages, row_bytes,
            "X" if form == sweep["kFormX"] else "L")
    smem = _c_function(xsrc, "fused_wide_smem_bytes",
                       dict(sweep, wide_smem_bytes=sweep_smem))
    scratch = _c_function(xsrc, "fused_wide_scratch_floats", {})
    share = _c_function(xsrc, "fused_wide_share", {})
    for K, N in ((2, 584), (6, 341), (9, 268), (50, 22), (50, 40), (3, 3)):
        n = 6 * N
        for spread in (1, 2, 3, 66, 132, 264):
            if 2 * spread > n:
                continue
            rows = gs.sweep_wide_rows(n, spread)
            for band, stages in ((2, 2), (6, 2), (32, 8)):
                assert af.fused_wide_smem_bytes(K, N, rows, band,
                                                stages) == smem(
                    K, n, rows, band, stages)
            for items in (K * 2 * N, K * (N * (N - 1) // 2)):
                got = [af.fused_wide_share(g, spread, items)
                       for g in range(spread + 1)]
                assert got == [share(g, spread, items)
                               for g in range(spread + 1)]
                assert got[0] == 0 and got[-1] == items
                assert got == sorted(got)
        for B in (1, 2, 32):
            assert af.fused_wide_scratch_floats(B, K, N) == scratch(B, K, n)


@pytest.mark.parametrize("sms", WIDE_SMS)
@pytest.mark.parametrize("B,K,N", WIDE_SHAPES)
def test_wide_plan_fits_cards_of_several_sizes(B, K, N, sms):
    """At small batches the plan takes the wide tier where FUSED_X_WIDE
    says so, and its blocks fit a card of 132, 114 or 78 SMs all at once
    (the plan reads the card's count, never a constant 132); the short
    horizons take it on every card."""
    plan = af.fused_x_plan(B, K, N, sms=sms)
    assert bool(plan.spread) == af.fused_x_wide(B, N, sms)
    if plan.spread:
        _check_wide_plan(plan, B, K, N, sms)
        # the card's blocks, shared out: no more than one wave
        assert B * plan.spread > sms * plan.per_sm - B or (
            plan.spread == 3 * N)
    else:
        assert plan == af.fused_plan(K, N, "X")
    if K <= 9:
        assert plan.spread
    # each tier may be named, and the wide one fits this card too
    _check_wide_plan(af.fused_x_plan(B, K, N, sms=sms, _wide=True), B, K, N,
                     sms)
    assert af.fused_x_plan(B, K, N, sms=sms, _wide=False) == af.fused_plan(
        K, N, "X")
    # the X form keeps its factors in float32 on either tier
    for wide in (None, True, False):
        with pytest.raises(ValueError):
            af.fused_x_plan(B, K, N, sms=sms, esize=2, _wide=wide)


@pytest.mark.parametrize("K", range(2, 51))
def test_fused_x_route_has_a_plan_at_every_small_batch(K):
    """Every (K, N) that ``qp_route`` sends to the X-form fused kernel has
    a plan at every B <= 32 on the H100 and on a card of 78 SMs: the wide
    plan where the tier switch takes it, and the wide plan can be named at
    every one of them (the card tests' and the bench's ``_wide``)."""
    for N in _fused_x_routed(K):
        for B in range(1, 33):
            for sms in (af.SMS, 78):
                plan = af.fused_x_plan(B, K, N, sms=sms)
                if plan.spread:
                    _check_wide_plan(plan, B, K, N, sms)
                wide = af.fused_x_wide_plan(B, K, N, sms)
                assert B * wide.spread <= sms * wide.per_sm
                assert wide.smem_bytes <= af.FUSED_SMEM_MAX


# The production chunks' one-block plans, pinned: (N, B) -> FusedPlan
FUSED_X_PRODUCTION = {(30, 128): (60, 4, True, False, 211412, 0, 1),
                      (40, 128): (40, 4, True, True, 221796, 0, 1)}


def test_production_chunks_keep_the_one_block_plan():
    """The production chunks (N = 30, 40 at B = 128) and every batch above
    32 keep the one-block plan, exactly."""
    for (N, B), want in FUSED_X_PRODUCTION.items():
        assert tuple(af.fused_x_plan(B, 50, N)) == want
    for N in (22, 30, 40, 50, 60, 100):
        for B in (33, 64, 128, 512):
            assert af.fused_x_plan(B, 50, N) == af.fused_plan(50, N, "X")
            assert not af.fused_x_wide(B, N)


# The shapes the tier switch was read from (``torch_sweep_bench.py
# --tiers``, case F, both tiers in turns on the H100; PERF.md): (N, B) ->
# whether the wide tier was the faster
WIDE_CROSSOVER = {(22, 1): True, (22, 8): True, (22, 16): True,
                  (22, 32): False, (30, 1): True, (30, 2): True,
                  (30, 8): True, (30, 32): True, (40, 1): True,
                  (40, 32): True, (50, 32): True, (60, 32): True,
                  (100, 32): True, (268, 1): True, (277, 32): True,
                  (302, 32): True, (341, 2): True, (584, 2): True,
                  (30, 128): False, (40, 128): False}


def test_wide_tier_switch_is_the_measured_crossover():
    """``fused_x_wide`` takes the wide tier exactly where it was the
    faster at the measured shapes."""
    for (N, B), wide in WIDE_CROSSOVER.items():
        assert af.fused_x_wide(B, N) == wide, (N, B)


def _wide_case(B, K, N, seed, lane=False):
    """Inputs of the X-form interval in float64 on the CPU: bounds of
    random start and goal positions, collision rows of random unit
    directions about the starts, the production rho pattern (one rho a
    lane where ``lane``, with one set of slot scalars a lane), X-form
    factors of the assembled blocks, x at rest, z = clip(A x, l, u) and
    nonzero duals.  Returns the positional and keyword arguments of
    ``admm_interval_fused_X_plain``."""
    rng = np.random.default_rng(seed)
    f64, h = torch.float64, 0.2
    P = N * (N - 1) // 2
    problem = ProblemConfig(n_vehicles=N, time_horizon=K * h, time_step=h,
                            min_distance=0.8)
    solver = SolverConfig.production(problem=problem)
    prm = make_solver_params(solver, f64, "cpu")
    p0, pf = (torch.as_tensor(rng.uniform(2.0, 18.0, (B, N, 2)))
              for _ in range(2))
    v0 = torch.zeros_like(p0)
    pairs = make_pair_index(N, f64)
    lower, upper = tb.build_bounds(p0, v0, pf, v0, n_vehicles=N, n_steps=K,
                                   h=h, limits=problem.limits, n_pairs=P)
    lower = lower._replace(col=torch.as_tensor(
        rng.uniform(-0.5, 0.5, (B, K, P))))
    eta = torch.as_tensor(rng.normal(size=(B, K, P, 2)))
    eta = eta / torch.linalg.vector_norm(eta, dim=-1, keepdim=True)
    x = _warm_state(torch.zeros((B, N, K, 2), dtype=f64), p0, v0, h)
    lane_rho = (torch.as_tensor(2.6 * np.exp(rng.uniform(-2.3, 2.3, B)))
                if lane else prm.rho)
    rho = tb.rho_pattern_masks(
        tb.row_scaling_state(K, h, dtype=f64), solver.static_part(),
        lane_rho, prm.col_rho_boost, n_steps=K, n_pairs=P, col_enabled=True,
        dtype=f64)
    D, C = tb.assemble_D(rho, eta, pairs.E, h=h, sigma=prm.sigma,
                         n_vehicles=N)
    if lane:
        # the solver's factors of M / rho, scaled back; C one set a lane
        C1 = tb.unit_slot_scalars(solver.static_part(), n_steps=K, h=h,
                                  dtype=f64)
        scale = lane_rho.reshape(-1, 1, 1, 1)
        X = tb.factorize_X(D / scale, C1, ns_iters=2) / scale
        C = C.expand((B,) + C.shape[-3:]).contiguous()
    else:
        X = tb.factorize_X(D, C, ns_iters=2)
    z = tb.tree_map(torch.clamp, tb.apply_A(x, eta, pairs.E, h), lower,
                    upper)
    y = tb.tree_map(lambda t: torch.as_tensor(
        rng.normal(scale=0.1, size=t.shape)), z)
    return (X, C, eta, pairs.E, lower, upper, x, z, y, rho), dict(
        h=h, sigma=prm.sigma, alpha=prm.alpha, lam=prm.col_penalty)


def _slot(C, w, transpose=False):
    """(C (x) I) w, or its transpose, for slot scalars C (B, 3, 3) and
    vectors w (B, 6N)."""
    B = w.shape[0]
    eq = "bji,bjq->biq" if transpose else "bij,bjq->biq"
    return torch.einsum(eq, C, w.reshape(B, 3, -1)).reshape(B, -1)


def _wide_interval(X, C, eta, E, lower, upper, x, z, y, rho, *, h, sigma,
                   alpha, lam, n_iters, spread, order, one_plane=False):
    """The wide kernel's data flow for B scenarios of ``spread`` blocks
    each, block by block in ``order`` between two barriers, every read
    taking the planes and the state as they stand: the right-hand side of
    each block's static rows (``admm_fused.fused_wide_share``) into the
    right-hand-side plane; each sweep step's rows [lo, hi) of each block
    (``group_solve.sweep_rows``), r formed from the right-hand-side plane
    and the sweep plane's previous row; the update of each block's static
    and collision rows.  ``one_plane``: the sweep overwrites b in one plane
    instead, as the one-block kernel does.  Returns (x, z, y)."""
    B, K, n = X.shape[:3]
    N, P = n // 6, E.shape[1]
    n2 = 2 * N
    c = admm_steps.row_consts(eta, E, lower, upper, rho, h=h, sigma=sigma,
                              alpha=alpha, lam=lam)
    rows = admm_steps.pack_state(x, z, y)
    Cb = C if C.dim() == 4 else C.expand((B,) + C.shape)
    bp = torch.zeros((B, K, n), dtype=X.dtype)
    xp = bp if one_plane else torch.zeros_like(bp)
    bounds = [gs.sweep_rows(g, spread, n) for g in range(spread + 1)]

    def share(g, items):
        return torch.arange(af.fused_wide_share(g, spread, items),
                            af.fused_wide_share(g + 1, spread, items))
    for _ in range(n_iters):
        for g in order:
            b = admm_steps.admm_rhs_plain(rows, c)
            idx = share(g, K * n2)
            k, q = idx // n2, idx % n2
            for s in range(3):
                bp[:, k, s * n2 + q] = b[:, k, s * n2 + q]
        for t in range(2 * K - 1):
            fwd = t < K
            k = t if fwd else 2 * K - 2 - t
            for g in order:
                lo, hi = bounds[g], bounds[g + 1]
                if fwd:
                    r = bp[:, k].clone()
                    if k > 0:
                        r -= _slot(Cb[:, k - 1], xp[:, k - 1])
                else:
                    r = _slot(Cb[:, k], xp[:, k + 1], transpose=True)
                prod = torch.einsum("bij,bj->bi", X[:, k, lo:hi], r)
                xp[:, k, lo:hi] = prod if fwd else xp[:, k, lo:hi] - prod
        for g in order:
            new = admm_steps.Rows(*(t.clone() for t in rows))
            admm_steps.admm_update_plain(xp, new, c)
            idx = share(g, K * n2)
            k, q = idx // n2, idx % n2
            for s in range(3):
                rows.x[:, k, s * n2 + q] = new.x[:, k, s * n2 + q]
            rows.zs[:, k, :, q] = new.zs[:, k, :, q]
            rows.ys[:, k, :, q] = new.ys[:, k, :, q]
            idx = share(g, K * P)
            for mine, theirs in ((rows.zc, new.zc), (rows.yc, new.yc)):
                mine.view(B, -1)[:, idx] = theirs.view(B, -1)[:, idx]
    return admm_steps.unpack(rows, N)


def _interval_rows(out, K):
    """(B, K, .) rows of an interval's (x, z, y)."""
    x, z, y = out

    def rows(rv):
        return torch.cat([af.static_plane(rv, K).flatten(-2), rv.col], -1)
    return tb.to_stacked(x), rows(z), rows(y)


@pytest.mark.parametrize("B,K,N,lane,spreads", [
    (2, 3, 3, False, (1, 2, 4, 9)),       # 9: a block of one row pair
    (2, 2, 4, True, (3, 5, 12)),          # 12 blocks > K P = 12 rows
    (1, 4, 2, False, (2, 6))])            # N = 2: one collision pair
def test_wide_data_flow_matches_the_plain_interval(B, K, N, lane, spreads):
    """The wide kernel's data flow (:func:`_wide_interval`), with the
    blocks of each phase taken in either order, is the plain interval in
    float64 to 1e-12 of each leaf's largest entry, after 3 iterations, at
    several counts of blocks a scenario, down to a block of one row pair;
    so its barriers and planes leave no block reading what another block
    of the same phase writes.  The same flow on one plane, b overwritten
    by the sweep as in the one-block kernel, does not match once a
    scenario has two blocks: the right-hand side needs its own plane."""
    args, kw = _wide_case(B, K, N, seed=10 * N + K, lane=lane)
    want = _interval_rows(af.admm_interval_fused_X_plain(
        *args, n_iters=3, **kw), K)
    for spread in spreads:
        for order in (range(spread), range(spread - 1, -1, -1)):
            got = _interval_rows(_wide_interval(
                *args, n_iters=3, spread=spread, order=order, **kw), K)
            for g, w in zip(got, want):
                assert float((g - w).abs().max()) <= 1e-12 * float(
                    w.abs().max())
        if spread > 1:
            bad = _interval_rows(_wide_interval(
                *args, n_iters=3, spread=spread, order=range(spread),
                one_plane=True, **kw), K)
            assert float((bad[0] - want[0]).abs().max()) > 1e-6 * float(
                want[0].abs().max())
