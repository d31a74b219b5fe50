"""The launch plan of the fused ADMM-interval kernels
(``admm_fused.fused_plan``) and the packed upper triangles the X-form
kernel reads, on the CPU: no JAX and no card.

The kernels themselves (``csrc/admm_fused_x.cu``, ``csrc/admm_fused_l.cu``)
run only on the card and are held to their plain versions by
``tests/test_torch_kernels_gpu.py``.  Here the plan is held to the kernels'
header, each kernel's envelope to every (K, N) that the router sends to it,
and a float64 model of the X-form kernel's packed product
(U r + (strict U)^T r, from the bands it streams) to X r.

    python -m pytest tests/test_torch_fused_plan.py -q
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ba_path_planning_torch.ops import admm_fused as af
from ba_path_planning_torch.ops.collisions import make_pair_index
from ba_path_planning_torch.solvers import banded as tb
from ba_path_planning_torch.utils.config import SolverConfig

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


@pytest.mark.parametrize("K", range(2, 51))
def test_fused_x_route_lies_inside_the_kernel_envelope(K):
    """Every (K, N), N <= 700, that ``qp_route`` sends to the X-form fused
    kernel, as the JAX router does (fused, auto group below 16,
    K nr8 np 4 <= 96 MiB), is one the kernel serves: short horizons reach
    N = 584 at K = 2 (n = 3504), where a pair table in shared memory would
    leave no ring (K = 2 … 9 at N = 268 … 584).  The route is the same for
    the three solvers, starts at N = 22 (the auto group falls below 16) and
    ends at the 96 MiB gate."""
    statics = [s.static_part() for s in FUSED_X_SOLVERS.values()]
    routed = []
    for N in range(2, 701):
        took = {tb.qp_route(st, n_vehicles=N, n_steps=K,
                            dtype=torch.float32, col_enabled=True)
                for st in statics}
        if "fused_X" in took:
            assert took == {"fused_X"}
            routed.append(N)
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
