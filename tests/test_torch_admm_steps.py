"""PyTorch port, the ADMM stages of ``ops/admm_steps.py``: the plain
versions of ``admm_rhs``, ``admm_update`` and ``admm_channel_interval`` on
their packed planes against ``banded.admm_iterations`` (float64, 1e-12 of
each leaf's scale), and ``solve_qp_state`` on the routes that run them
(``grouped_X``, ``grouped_L``, ``resident``, ``channel``) against the JAX
package's ``solve_qp_state`` (its sweeps in plain JAX, ``pallas=False``;
1e-8, equal iteration counts and convergence flags).  Inputs from numpy
seeds at N=4-5, K=6-10.
"""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ba_path_planning_tpu.utils import config as jcfg

from ba_path_planning_torch.ops import admm_fused, admm_steps
from ba_path_planning_torch.ops.collisions import make_pair_index
from ba_path_planning_torch.solvers import banded as tb
from ba_path_planning_torch.utils.config import (ProblemConfig, SolverConfig,
                                                 make_solver_params)
from ba_path_planning_torch.utils.convert import (config_from_jax,
                                                  rowvals_from_numpy)

from test_torch_adaptive_rho import _jax_lanes, _port
from test_torch_admm_fused import _iteration_qp
from test_torch_banded import _check_qp, _close_tree, _qp_inputs

F64 = torch.float64
H = 0.2

# route -> the port's solver options that take it (N=5, K=8, float64)
ROUTE_SOLVERS = {
    "grouped_X": dict(),
    "grouped_L": dict(factor_form="L", fused=False, group=2),
    "resident": dict(factor_form="L", fused=False, group=-1),
    "channel": dict(),
}


def _stage_case(route, lane, lam, seed, N=5, K=8, B=3):
    """One check interval's inputs on ``route``, float64: bounds of random
    start and goal positions; on the sweep routes collision rows of random
    unit directions (row 0 and a few more disabled by -inf), on the channel
    route phase 1's (eta = 0, every row disabled); rho shared or, with
    ``lane``, one a lane (the grouped routes then factorize M / rho, as the
    solver does); a random state.  Returns the arguments of
    ``banded._interval_fn`` and the route's plain x-update."""
    rng = np.random.default_rng(seed)
    P = N * (N - 1) // 2
    problem = ProblemConfig(n_vehicles=N, time_horizon=K * H, time_step=H,
                            min_distance=0.8)
    solver = SolverConfig.production(problem=problem).replace(
        col_penalty=lam, **ROUTE_SOLVERS[route])
    static = solver.static_part()
    col = route != "channel"
    assert tb.qp_route(static, n_vehicles=N, n_steps=K, dtype=F64,
                       col_enabled=col) == route
    prm = make_solver_params(solver, F64)
    p0, pf = (torch.as_tensor(rng.uniform(2.0, 18.0, (B, N, 2)))
              for _ in range(2))
    v0 = torch.zeros_like(p0)
    pairs = make_pair_index(N, F64)
    lower, upper = tb.build_bounds(p0, v0, pf, v0, n_vehicles=N, n_steps=K,
                                   h=H, limits=problem.limits, n_pairs=P)
    if col:
        eta = torch.as_tensor(rng.normal(size=(B, K, P, 2)))
        eta = eta / torch.linalg.vector_norm(eta, dim=-1, keepdim=True)
        l_col = torch.as_tensor(rng.normal(size=(B, K, P)))
        l_col[:, 0] = -np.inf
        l_col[:, 3, ::2] = -np.inf
        lower = lower._replace(col=l_col)
    else:
        eta = torch.zeros((B, K, P, 2), dtype=F64)
    scaling = tb.row_scaling_state(K, H, dtype=F64)
    rho_l = (torch.as_tensor(2.6 * np.exp(rng.uniform(-2, 2, B)))
             if lane else None)
    rho_b = tb.rho_pattern_masks(scaling, static,
                                 prm.rho if rho_l is None else rho_l,
                                 prm.col_rho_boost, n_steps=K, n_pairs=P,
                                 col_enabled=col, dtype=F64)
    if col:
        rho_b = rho_b._replace(col=torch.where(
            torch.isinf(lower.col), torch.full_like(lower.col, 1e-6),
            rho_b.col))
    scaled = lane and route in ("grouped_X", "grouped_L")
    C1 = (tb.unit_slot_scalars(static, n_steps=K, h=H, dtype=F64,
                               device="cpu")
          if lane and route in tb.SHARED_C_ROUTES else None)
    factors = tb._route_factors(route, rho_b, eta, pairs.E, static, N, H,
                                prm.sigma, rho_lane=rho_l, C1=C1)
    x = tb.StateVars(*(torch.as_tensor(rng.normal(size=(B, N, K, 2)) * s)
                       for s in (1.0, 5.0, 2.0)))
    z = tb.tree_map(torch.clamp, tb.apply_A(x, eta, pairs.E, H), lower,
                    upper)
    y = tb.tree_map(lambda t: torch.as_tensor(
        rng.normal(size=t.shape)), z)
    step = dict(h=H, sigma=prm.sigma, alpha=prm.alpha, lam=prm.col_penalty)
    inv_rho = 1.0 / rho_l if scaled else None

    if route == "channel":
        def solve(sb):
            return tb.solve_factorized_channel(
                *factors, sb.reshape(B, K, 3, 2 * N)).reshape(sb.shape)
    elif route == "resident":
        def solve(sb):
            return tb.solve_factorized(*factors, sb)
    else:
        plain = (tb.solve_factorized_X if route == "grouped_X"
                 else tb.solve_factorized_L)
        C = C1 if lane else factors[1]

        def solve(sb):
            return plain(factors[0], C, sb if inv_rho is None
                         else sb * inv_rho[:, None, None])
    args = dict(route=route, factors=factors, rho_b=rho_b, lower=lower,
                upper=upper, eta=eta, E=pairs.E, n_vehicles=N, C1=C1,
                inv_rho=inv_rho)
    return args, step, (x, z, y), solve


@pytest.mark.parametrize("n_iters", [1, 9])
@pytest.mark.parametrize("lam", [50.0, np.inf])
@pytest.mark.parametrize("lane", [False, True])
@pytest.mark.parametrize("route", list(ROUTE_SOLVERS))
def test_plain_stages_match_admm_iterations(route, lane, lam, n_iters):
    """The interval of ``_interval_fn`` on the CPU (the plain stages on the
    packed planes) against ``admm_iterations`` with the route's plain
    x-update; finite and +inf penalty weights, rows disabled by -inf lower
    bounds, shared and per-lane rho."""
    args, step, state, solve = _stage_case(route, lane, lam, seed=7)
    assert tb.interval_kind(route, F64, torch.device("cpu")) == "rows"
    before = [tb.tree_map(torch.clone, v) for v in state]
    got = tb._interval_fn(**args, step=dict(step, n_iters=n_iters))(*state)
    want = tb.admm_iterations(*state, solve, args["eta"], args["E"],
                              args["lower"], args["upper"], args["rho_b"],
                              **step, n_iters=n_iters)
    for g, w in zip(got, want):
        _close_tree(g, w, rtol=1e-12)
    # the interval's inputs are not modified
    for v, w in zip(state, before):
        assert all(torch.equal(a, b) for a, b in zip(v, w))


@pytest.mark.parametrize("lane", [False, True])
def test_plain_stages_one_by_one(lane):
    """admm_rhs and admm_update alone against the steps of
    ``admm_iterations`` on the grouped X route."""
    args, step, (x, z, y), solve = _stage_case("grouped_X", lane, np.inf,
                                               seed=3)
    c = admm_steps.row_consts(args["eta"], args["E"], args["lower"],
                              args["upper"], args["rho_b"], **step)
    rows = admm_steps.pack_state(x, z, y)
    b = admm_steps.admm_rhs(rows, c, args["inv_rho"])
    rzy = tb.tree_map(lambda zz, yy, rr: rr * zz - yy, z, y, args["rho_b"])
    want_b = tb.to_stacked(tb.apply_AT(rzy, args["eta"], args["E"], H)) \
        + step["sigma"] * tb.to_stacked(x)
    if args["inv_rho"] is not None:
        want_b = want_b * args["inv_rho"][:, None, None]
    _close_tree((b,), (want_b,), rtol=1e-12)
    xt = torch.as_tensor(np.random.default_rng(4).normal(size=b.shape))
    admm_steps.admm_update(xt, rows, c)
    want = tb.admm_iterations(x, z, y, lambda sb: xt, args["eta"],
                              args["E"], args["lower"], args["upper"],
                              args["rho_b"], **step, n_iters=1)
    for g, w in zip(admm_steps.unpack(rows, x.a.shape[-3]), want):
        _close_tree(g, w, rtol=1e-12)


def test_row_and_channel_plans():
    """admm_rhs's k-tiles fill the card at B = 1 and give a thread a static
    row at the production chunk (the table form up to N = 170),
    admm_update's about five items; the
    channel interval keeps its steps in registers up to K = 64, takes
    blocks of 4 channels at the production batches, narrower ones where
    the SMs would idle (B = 8), and puts
    a block's region in a global scratch only where it does not fit shared
    memory; at N = 342 and 1024 both stages take one step a block,
    admm_rhs in its direct form."""
    rhs = admm_steps.rhs_plan
    assert rhs(1, 50, 20) == (1, True, 3040)
    assert rhs(512, 50, 20) == (6, True, 6 * 20 * 19 * 8)
    assert rhs(1024, 50, 10) == (12, True, 12 * 10 * 9 * 8)
    assert rhs(128, 50, 21) == (6, True, 6 * 21 * 21 * 8)
    assert rhs(4, 3, 2) == (1, True, 16)
    assert rhs(8, 50, 60) == (1, True, 60 * 59 * 8)
    assert rhs(2, 50, 200) == (1, False, 0)
    assert admm_steps.update_plan(1, 50, 20) == 1
    assert admm_steps.update_plan(512, 50, 20) == 4
    assert admm_steps.update_plan(1024, 50, 10) == 12
    assert admm_steps.update_plan(4, 3, 2) == 1
    plan = admm_steps.channel_plan
    assert plan(1024, 50, 20) == (2, 4, True)
    assert plan(132, 50, 20) == (2, 4, True)
    assert plan(8, 50, 20) == (2, 2, True)
    assert plan(1, 50, 20) == (2, 1, True)
    assert plan(1024, 50, 10) == (2, 4, True)
    assert plan(128, 50, 21) == (2, 4, True)
    assert plan(3, 9, 4) == (1, 1, True)
    assert plan(1, 500, 10) == (0, 1, True)
    assert plan(1, 1184, 10) == (0, 1, True)
    assert plan(1, 1185, 10) == (0, 1, False)
    assert admm_steps.channel_region_floats(50, 4, 2) == 32 * 9 * (
        3 * 2 + 10) + 50 * 25
    assert admm_steps.channel_region_floats(500, 1, 0) == 500 * 7 \
        + 32 * 42 * 16
    for B, K, N in ((1, 50, 342), (2, 50, 342), (1, 6, 1024), (4, 6, 1024)):
        assert rhs(B, K, N) == (1, False, 0)
        assert admm_steps.update_plan(B, K, N) == 1


def _pair_first(p, N):
    """The kernels' closed form of the first vehicle of pair p
    (``csrc/admm_rows.cuh`` pair_first), in float32 as it computes it."""
    m = np.float32(2 * N - 1)
    root = np.sqrt(m * m - np.float32(8) * p.astype(np.float32))
    i = np.clip((np.float32(0.5) * (m - root)).astype(np.int64), 0, N - 2)

    def base(i):
        return i * (2 * N - i - 1) // 2
    while True:
        down = (i > 0) & (base(i) > p)
        up = base(i + 1) <= p
        if not (down.any() or up.any()):
            return i
        i = i - down + up


def _rhs_rows(w, eta, N):
    """The rows of admm_rhs's transposed pair table: row (k, v) holds
    vehicle v's N - 1 partner terms w eta of the collision rows at k + 1 in
    ascending partner order (+ in the first vehicle's row, - in the
    second's), from the kernels' closed form of the pairs.  w (K, P), eta
    (K, P, 2) -> (K - 1, N, N - 1, 2)."""
    K, P = w.shape
    p = np.arange(P)
    i = _pair_first(p, N)
    j = p - i * (2 * N - i - 1) // 2 + i + 1
    assert np.array_equal(i, np.triu_indices(N, 1)[0])
    table = np.full((K - 1, N, max(N - 1, 1), 2), np.nan, dtype=w.dtype)
    t = w[1:, :, None] * eta[1:]
    table[:, i, j - 1] = t
    table[:, j, i] = -t
    return table


def _rhs_table_model(w, eta, N):
    """Model of admm_rhs's collision term in its table form
    (``csrc/admm_steps.cu``, N <= 170), in the dtype of w: phase A writes
    each collision row's terms once into the transposed table
    (:func:`_rhs_rows`), phase B sums each row in one sum, slot by slot.
    w (K, P), eta (K, P, 2) -> (N, K, 2), zero at K - 1."""
    table = _rhs_rows(w, eta, N)
    col = np.zeros((N, w.shape[0], 2), dtype=w.dtype)
    for s in range(N - 1):
        col[:, :-1] += table[:, :, s].transpose(1, 0, 2)
    return col


def _rhs_direct_model(w, eta, N, acc=4):
    """Model of the direct form's collision term (``rhs_pair_sum``, N >
    170), in the dtype of w: the same terms in the same order, vehicle v's
    partners u < v in partial sum u % acc and its partners u > v in
    partial sum (u - v - 1) % acc, the sums joined pairwise."""
    table = _rhs_rows(w, eta, N)
    K1 = table.shape[0]
    parts = np.zeros((K1, N, acc, 2), dtype=w.dtype)
    v = np.arange(N)
    for s in range(N - 1):
        slot = np.where(s < v, s, s - v) % acc
        parts[:, v, slot] = parts[:, v, slot] + table[:, :, s]
    width = acc // 2
    while width:
        parts[:, :, :width] = (parts[:, :, :width]
                               + parts[:, :, width:2 * width])
        width //= 2
    col = np.zeros((N, w.shape[0], 2), dtype=w.dtype)
    col[:, :-1] = parts[:, :, 0].transpose(1, 0, 2)
    return col


@pytest.mark.parametrize("N", [2, 4, 20, 21, 170, 171, 342])
def test_rhs_table_model_matches_jax_collision_term(N):
    """The table form's phase A and phase B (it runs at N <= 170) and the
    direct form's partial sums (it runs past the switch: N = 171, and N =
    342, the grouped routes' production QP of the wide phase; K = 2
    there, where the incidence E is 160 MB), each against the collision
    term of JAX's ``apply_AT``
    (``ba_path_planning_tpu/solvers/banded.py:133``): 1e-12 of the term's
    scale; the closed form of the pairs equals triu_indices."""
    from ba_path_planning_tpu.solvers import banded as jb
    K = 2 if N > 300 else 3 if N > 100 else 6
    P = N * (N - 1) // 2
    rng = np.random.default_rng(N)
    w, eta = rng.normal(size=(K, P)), rng.normal(size=(K, P, 2))
    assert admm_steps.rhs_plan(1, K, N).table == (N <= 170)
    ii, jj = np.triu_indices(N, 1)
    E = np.zeros((N, P))
    E[ii, np.arange(P)], E[jj, np.arange(P)] = 1.0, -1.0
    zero = jnp.zeros((N, K, 2))
    y = jb.RowVals(dyn_p=zero, dyn_v=zero, jerk=zero[:, 1:], acc=zero,
                   vbox=zero, pbox=zero, col=jnp.asarray(w))
    want = np.asarray(jb.apply_AT(y, jnp.asarray(eta), jnp.asarray(E),
                                  H).p)
    for model in (_rhs_table_model, _rhs_direct_model):
        got = model(w, eta, N)
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_rhs_direct_partial_sums_round_closer_than_one_sum():
    """At N = 1024 in float32, the direct form's four partial sums of a
    row's 1023 pair terms (the kernel's kRhsAcc) land closer to the
    float64 sum than one serial sum of the same terms in the same order
    (the table form's way, and the direct form's before): the largest
    error over the rows, against the rows' largest term."""
    from test_torch_sweep_plan import _constants
    src = (Path(admm_steps.__file__).resolve().parents[1] / "csrc"
           / "admm_steps.cu").read_text()
    assert _constants(src[:src.index("namespace chan")])["kRhsAcc"] == 4
    N, K = 1024, 2
    P = N * (N - 1) // 2
    rng = np.random.default_rng(1024)
    w = rng.normal(size=(K, P)).astype(np.float32)
    eta = rng.normal(size=(K, P, 2)).astype(np.float32)
    exact = _rhs_table_model(w.astype(np.float64), eta.astype(np.float64), N)
    scale = np.abs(w[1:, :, None] * eta[1:]).max()
    serial, parts = (np.abs(model(w, eta, N)[:, 0] - exact[:, 0]).max()
                     / scale for model in (_rhs_table_model,
                                           _rhs_direct_model))
    assert parts < 0.5 * serial, (parts, serial)


def test_rhs_pair_first_closed_form_up_to_1024():
    """The kernels' float32 closed form of a pair's first vehicle holds
    for every pair of the N the stages serve (N <= 1024, every N the
    grouped sweeps serve), on both sides of N = 341, the fused kernels'
    limit while they kept a pair table."""
    for N in (2, 3, 20, 60, 171, 255, 341, 342, 512, 1023, 1024):
        P = N * (N - 1) // 2
        assert np.array_equal(_pair_first(np.arange(P), N),
                              np.triu_indices(N, 1)[0])


def _small_div(i, d):
    """The kernels' SmallDiv (``csrc/admm_steps.cu``) in float32 as they
    compute it: the truncated product with the rounded reciprocal, then
    one correction either way."""
    inv = np.float32(1) / np.float32(d)
    q = (i.astype(np.float32) * inv).astype(np.int64)
    r = i - q * d
    return q + (r >= d) - (r < 0)



def test_pair_first_closed_form_over_the_fused_kernels_plans():
    """The fused kernels find a collision row's pair by the same closed
    form (they keep no pair table): it holds for every pair up to the
    widest N that either fused plan accepts, the X form's with its sweep
    plane in a global scratch (K = 50), and at the widest N of K = 2."""
    from ba_path_planning_torch.ops.admm_fused import fused_plan

    def widest(K):
        for N in range(2100, 1, -1):
            try:
                fused_plan(K, N, "X")
                return N
            except ValueError:
                pass
    top, short = widest(50), widest(2)
    assert 1900 < top < 2100 and 584 < short < top
    for N in (585, short, 1500, top - 1, top):
        P = N * (N - 1) // 2
        assert np.array_equal(_pair_first(np.arange(P), N),
                              np.triu_indices(N, 1)[0])

@pytest.mark.parametrize("B,K,N", [(1, 50, 342), (2, 50, 342), (1, 6, 1024),
                                   (4, 6, 1024)])
def test_small_div_is_exact_over_the_plans_at_n_342_and_1024(B, K, N):
    """SmallDiv over the index ranges the two plans give at N = 342 and
    1024: admm_update divides a block's items by N (its static slot pairs,
    6N a step) and its collision rows by P; admm_rhs's table form divides
    by 2N and P, its direct form (every N past 170) by ``/``.  Each
    divisor's quotients are exact over the block's range and up to the
    host checks' bound, 2^22, and the host checks admit the plans."""
    P = N * (N - 1) // 2
    ku, rhs = admm_steps.update_plan(B, K, N), admm_steps.rhs_plan(B, K, N)
    kr = rhs.k_tile
    assert not rhs.table and ku == kr == 1
    # the host checks of admm_update_f32 and admm_rhs_f32
    assert ku * (12 * N + P) < 2 ** 22 and kr * (2 * N + P) < 2 ** 22
    for d, hi in ((N, ku * 6 * N), (P, ku * P), (2 * N, kr * 2 * N),
                  (P, kr * P)):
        for i in (np.arange(hi), np.arange(2 ** 22)):
            assert np.array_equal(_small_div(i, d), i // d), (d, hi)


def test_row_stages_admission_mirrors_the_kernels():
    """The row stages' admission (``row_stages_serve``, which ``_operands``
    applies before any launch) is the kernels' ``row_args_ok``, evaluated
    from the source: N up to ROW_STAGES_MAX_N, every N the grouped sweeps
    serve (n = 6N up to group_solve.SWEEP_MAX_N_WIDE), and a lane's rows
    within int indexing."""
    import re
    from ba_path_planning_torch.ops import group_solve as gs
    from test_torch_sweep_plan import _c_function, _constants
    src = (Path(admm_steps.__file__).resolve().parents[1] / "csrc"
           / "admm_steps.cu").read_text()
    k = _constants(src[:src.index("namespace chan")])
    assert (k["kRowStagesMaxN"] == admm_steps.ROW_STAGES_MAX_N
            == gs.SWEEP_MAX_N_WIDE // 6 == 1024)
    ok = _c_function(re.sub(r"\s+", " ", src).replace("&&", "and"),
                     "row_args_ok", ("B", "K", "N", "k_tile"), k)
    for N in (1, 2, 20, 170, 171, 341, 342, 512, 1023, 1024, 1025, 2000):
        for K in (1, 2, 6, 50, 500, 4052, 4053):
            assert ok(1, K, N, 1) == admm_steps.row_stages_serve(K, N), (K, N)
    assert admm_steps.row_stages_serve(4052, 1024)
    assert not admm_steps.row_stages_serve(4053, 1024)


def test_rhs_plan_fills_blocks_and_fits_the_kernel_table():
    """admm_rhs's plan: a block's static rows (2N a step) fill its
    ROW_THREADS threads as far as whole steps do; the grid has at least
    ROW_MIN_BLOCKS blocks where B * K allows; the table (the kernel's own
    rhs_table_bytes) leaves room for four blocks an SM where a block takes
    more than one step, and the table form runs wherever one step's table
    fits a block (N <= 170), the direct form above (to N = 1024)."""
    from test_torch_sweep_plan import _c_function, _constants
    src = (Path(admm_steps.__file__).resolve().parents[1] / "csrc"
           / "admm_steps.cu").read_text()
    # the row stages' constants (the channel kernel's follow them)
    k = _constants(src[:src.index("namespace chan")])
    assert k["kRowThreads"] == admm_steps.ROW_THREADS
    assert k["kSmemMax"] == admm_steps.SMEM_MAX
    stride = _c_function(src, "rhs_table_stride", ("N",), k)
    table = _c_function(src, "rhs_table_bytes", ("k_tile", "N"),
                        dict(k, rhs_table_stride=stride))
    for N in (1, 2, 3, 10, 20, 21, 60, 170):
        assert admm_steps.rhs_table_stride(N) == stride(N)
        assert stride(N) % 2 == 1 and stride(N) >= N - 1
        for kt in (1, 2, 6, 12):
            assert admm_steps.rhs_table_bytes(kt, N) == table(kt, N)
    switch = max(N for N in range(2, 342)
                 if table(1, N) <= k["kSmemMax"])
    assert switch == 170
    threads, min_blocks = admm_steps.ROW_THREADS, admm_steps.ROW_MIN_BLOCKS
    for N in (2, 4, 10, 20, 21, 30, 40, 60, 100, 170, 171, 200, 341, 342,
              1024):
        for B in (1, 2, 8, 64, 128, 512, 1024, 4096):
            for K in (2, 6, 50):
                plan = admm_steps.rhs_plan(B, K, N)
                kt = plan.k_tile
                assert 1 <= kt <= K
                assert plan.table == (N <= switch)
                assert plan.smem_bytes == (table(kt, N) if plan.table
                                           else 0)
                assert plan.smem_bytes <= k["kSmemMax"]
                if kt > 1:
                    assert kt * 2 * N <= threads
                    assert 4 * plan.smem_bytes <= k["kSmemMax"]
                # no whole step more fits the threads, the grid's fill
                # or the shared memory
                assert (kt == K or (kt + 1) * 2 * N > threads
                        or B * K // (kt + 1) < min_blocks
                        or 4 * table(kt + 1, N) > k["kSmemMax"]), (
                    B, K, N, plan)
                grid = B * -(-K // kt)
                assert grid >= min_blocks or kt == 1


def test_admm_stage_cost_counts_by_hand():
    """The tracer's cost model of the stages at N=3, K=4 (P=3): 12 static
    (vehicle, axis, step) rows and 12 collision rows."""
    from ba_path_planning_torch.utils.profiling import admm_stage_cost
    assert admm_stage_cost("admm_rhs", 3, 4) == {
        "flops": 2 * 12 * (40 + 8), "hbm_bytes": 4 * (36 * 12 + 5 * 12)}
    assert admm_stage_cost("admm_update", 3, 4) == {
        "flops": 2 * 12 * 75 + 12 * 15, "hbm_bytes": 4 * (90 * 12 + 8 * 12)}
    assert admm_stage_cost("admm_channel_interval", 3, 4, n_iters=2) == {
        "flops": 2 * (2 * 12 * 48 + 2 * 12 * 75 + 12 * 15 + 2 * 12 * 78),
        "hbm_bytes": 4 * (84 * 12 + 7 * 12)}
    with pytest.raises(ValueError):
        admm_stage_cost("admm_sweep", 3, 4)


def test_admm_stage_cost_collision_free_counts_by_hand():
    """The collision-free count of the channel interval at N=3, K=4
    (P=3), 2 iterations: 40 + 75 + 78 operations a static row and
    iteration, 84 floats a vehicle and step, 6 a collision row."""
    from ba_path_planning_torch.utils.profiling import admm_stage_cost
    assert admm_stage_cost("admm_channel_interval", 3, 4, n_iters=2,
                           eta_terms=False) == {
        "flops": 2 * 2 * 12 * (40 + 75 + 78),
        "hbm_bytes": 4 * (84 * 12 + 6 * 12)}


def _channel_case(lane, lam, dtype, seed=11):
    """Phase 1's operands on the channel route (N=5, K=8, B=3) with a
    random finite collision state and collision lower bounds of which
    about half are -inf; returns the factors, the row constants and the
    packed state in ``dtype``."""
    args, step, (x, z, y), _ = _stage_case("channel", lane, lam, seed=seed)
    rng = np.random.default_rng(seed)
    B, K, P = args["eta"].shape[:3]
    l_col = torch.as_tensor(rng.normal(size=(B, K, P)))
    l_col[torch.as_tensor(rng.uniform(size=(B, K, P)) < 0.5)] = -np.inf
    z = z._replace(col=torch.as_tensor(rng.normal(size=(B, K, P))))
    y = y._replace(col=torch.as_tensor(rng.normal(size=(B, K, P))))

    def cast(v):
        return tb.tree_map(lambda t: t.to(dtype), v)
    c = admm_steps.row_consts(
        args["eta"].to(dtype), args["E"].to(dtype),
        cast(args["lower"]._replace(col=l_col)), cast(args["upper"]),
        cast(args["rho_b"]),
        **{k: v.to(dtype) if torch.is_tensor(v) else v
           for k, v in step.items()})
    factors = tuple(t.to(dtype) for t in args["factors"])
    return factors, c, admm_steps.pack_state(cast(x), cast(z), cast(y))


@pytest.mark.parametrize("dtype", [F64, torch.float32])
@pytest.mark.parametrize("n_iters", [1, 9])
@pytest.mark.parametrize("lam", [50.0, np.inf])
@pytest.mark.parametrize("lane", [False, True])
def test_channel_plain_equals_full_plain_on_eta_zero(lane, lam, n_iters,
                                                     dtype):
    """The collision-free plain interval (static rows by channel, the
    collision rows' recurrence) equals the full plain iterations (A^T and
    A with their pair terms, on eta = 0) exactly, on a nonzero finite
    collision state, finite and -inf collision lower bounds, shared and
    per-lane rho."""
    factors, c, rows = _channel_case(lane, lam, dtype)
    got = admm_steps.Rows(*(t.clone() for t in rows))
    want = admm_steps.Rows(*(t.clone() for t in rows))
    admm_steps.admm_channel_interval(*factors, got, c, n_iters)
    B, K, n = rows.x.shape
    for _ in range(n_iters):
        b = admm_steps.admm_rhs_plain(want, c)
        xt = tb.solve_factorized_channel(*factors, b.reshape(B, K, 3, n // 3))
        admm_steps.admm_update_plain(xt.reshape(B, K, n), want, c)
    assert float(want.zc.abs().max()) > 0 and float(want.yc.abs().max()) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_channel_plain_reads_no_eta():
    """The channel interval is the function of eta = 0 whatever ``c.eta``
    holds: the plain version never reads it."""
    factors, c, rows = _channel_case(False, 50.0, F64)
    got = admm_steps.Rows(*(t.clone() for t in rows))
    want = admm_steps.Rows(*(t.clone() for t in rows))
    admm_steps.admm_channel_interval(*factors, got, c._replace(
        eta=torch.full_like(c.eta, np.nan)), 3)
    admm_steps.admm_channel_interval(*factors, want, c, 3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _warp_scan_sweeps(Linv, Eb, b, noise=None):
    """float64 model of the sweeps of the channel kernel
    (csrc/admm_steps.cu): thread t of a warp of 32 owns steps t S + j,
    S = ceil(K / 32), steps past K - 1 pass their input through (L = 0,
    M = N = I); each thread folds its steps, a Kogge-Stone scan over the
    32 threads with the tables' matrices joins the folds (a thread reads
    its partner's value of the level before), each thread unfolds from its
    neighbour's result; then the backward boundaries are refined: each
    thread's first step minus its boundary, scanned with the same maps,
    corrects the steps.  ``noise`` (32, 3) is added to the backward
    boundaries before the refinement, which removes any such error.
    Linv (K, 3, 3), Eb (K-1, 3, 3), b (K, 3)."""
    K, W, lv = Linv.shape[0], 32, 5
    S = -(-K // W)
    eye, zero = np.eye(3), np.zeros((3, 3))

    def mats(k):
        if k >= K:
            return zero, eye, eye
        Lk = Linv[k]
        M = -Lk @ Eb[k - 1] if k > 0 else zero
        Nk = -Lk.T @ Eb[k].T if k < K - 1 else zero
        return Lk, M, Nk
    tab = [[mats(t * S + j) for j in range(S)] for t in range(W)]
    # the scans' tables
    A, Bc = [], []
    for t in range(W):
        a = tab[t][0][1]
        for j in range(1, S):
            a = tab[t][j][1] @ a
        c = tab[t][S - 1][2]
        for j in range(S - 2, -1, -1):
            c = tab[t][j][2] @ c
        A.append(a)
        Bc.append(c)
    Af, Ab = [], []
    for level in range(lv):
        off = 1 << level
        Af.append(list(A))
        Ab.append(list(Bc))
        A = [A[t] @ A[t - off] if t >= off else A[t] for t in range(W)]
        Bc = [Bc[t] @ Bc[t + off] if t + off < W else Bc[t]
              for t in range(W)]
    # one solve
    cv = [[tab[t][j][0] @ (b[t * S + j] if t * S + j < K else np.zeros(3))
           for j in range(S)] for t in range(W)]
    d = []
    for t in range(W):
        v = cv[t][0]
        for j in range(1, S):
            v = tab[t][j][1] @ v + cv[t][j]
        d.append(v)
    for level in range(lv):
        off = 1 << level
        d = [Af[level][t] @ d[t - off] + d[t] if t >= off else d[t]
             for t in range(W)]
    g = [[None] * S for _ in range(W)]
    for t in range(W):
        u = d[t - 1] if t > 0 else np.zeros(3)
        for j in range(S):
            u = tab[t][j][1] @ u + cv[t][j]
            g[t][j] = tab[t][j][0].T @ u
    e = []
    for t in range(W):
        v = g[t][S - 1]
        for j in range(S - 2, -1, -1):
            v = tab[t][j][2] @ v + g[t][j]
        e.append(v)
    def suffix_scan(v):
        for level in range(lv):
            off = 1 << level
            v = [Ab[level][t] @ v[t + off] + v[t] if t + off < W else v[t]
                 for t in range(W)]
        return v

    def unfold(e):
        x = np.zeros((W * S, 3))
        for t in range(W):
            u = e[t + 1] if t < W - 1 else np.zeros(3)
            for j in range(S - 1, -1, -1):
                u = tab[t][j][2] @ u + g[t][j]
                x[t * S + j] = u
        return x
    e = suffix_scan(e)
    if noise is not None:
        e = [v + n for v, n in zip(e, noise)]
    x = unfold(e)
    fix = suffix_scan([x[t * S] - e[t] for t in range(W)])
    for t in range(W - 1):
        u = fix[t + 1]
        for j in range(S - 1, -1, -1):
            u = tab[t][j][2] @ u
            x[t * S + j] += u
    return x[:K]


@pytest.mark.parametrize("K", [2, 9, 17, 32, 33, 40, 50, 64])
def test_warp_scan_sweeps_model_solves_the_channel_system(K):
    """The channel kernel's fold / warp scan / unfold of the two block
    sweeps and its refinement of the backward boundaries (its register
    form, K <= 64: one or two steps a thread, idle threads past K),
    modelled in float64, solves the per-channel system as
    ``banded.solve_factorized_channel`` does, also with errors put into
    the boundaries before the refinement."""
    solver = SolverConfig.production(problem=ProblemConfig(
        n_vehicles=3, time_horizon=K * H, time_step=H, min_distance=0.8))
    prm = make_solver_params(solver, F64)
    rho = tb.rho_pattern_masks(tb.row_scaling_state(K, H, dtype=F64),
                               solver.static_part(), prm.rho,
                               prm.col_rho_boost, n_steps=K, n_pairs=3,
                               col_enabled=False, dtype=F64)
    Linv, Eb = tb.factorize(*tb.assemble_channel(rho, h=H, sigma=prm.sigma))
    b = np.random.default_rng(K).normal(size=(K, 3))
    want = tb.solve_factorized_channel(Linv, Eb, torch.as_tensor(b)[..., None])
    rng = np.random.default_rng(K + 1)
    for noise in (None, rng.normal(size=(32, 3)) * float(want.abs().max())):
        got = _warp_scan_sweeps(Linv.numpy(), Eb.numpy(), b, noise)
        np.testing.assert_allclose(got, want[..., 0].numpy(), rtol=1e-9,
                                   atol=1e-9 * float(want.abs().max()))


def test_interval_kind_names_the_float64_channel_rule():
    """On the card the channel route in float64 replays the plain interval
    as a CUDA graph; in float32, and on the CPU in either dtype, it runs on
    the planes; the sweep routes always do (their kernels raise for
    float64); a pair-sharded group keeps admm_iterations."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tb.interval_kind("channel", F64, cuda) == "graph"
    assert tb.interval_kind("channel", torch.float32, cuda) == "rows"
    assert tb.interval_kind("channel", F64, cpu) == "rows"
    for route in ("grouped_X", "grouped_L", "resident"):
        assert tb.interval_kind(route, F64, cuda) == "rows"
    assert tb.interval_kind("dense", torch.float32, cuda) == "graph"
    assert tb.interval_kind("fused_X", torch.float32, cuda) == "fused"
    assert tb.interval_kind("channel", torch.float32, cuda,
                            group=object()) == "eager"


def test_static_plane_round_trip():
    """static_plane and planes_to_rows invert each other; the jerk block's
    row K-1 is zero."""
    rng = np.random.default_rng(0)
    B, N, K = 2, 3, 5
    rv = tb.RowVals(*(torch.as_tensor(rng.normal(size=(B, N, K - (
        name == "jerk"), 2))) for name in tb.RowVals._fields[:-1]),
        col=torch.zeros((B, K, 3), dtype=F64))
    plane = admm_fused.static_plane(rv, K)
    assert plane.shape == (B, K, 6, 2 * N) and plane.is_contiguous()
    assert bool((plane[:, K - 1, 2] == 0).all())
    back = admm_fused.planes_to_rows(plane, rv.col, N)
    for g, w in zip(back, rv):
        assert torch.equal(g, w)


# route -> (the JAX options of the reference route, the port's change)
JAX_ROUTES = {
    "grouped_X": (dict(group=2), dict()),
    "grouped_L": (dict(factor_form="L", group=2), dict()),
    "resident": (dict(factor_form="L"), dict(kernels=True, group=-1)),
    "channel": (dict(group=2), dict()),
}


def _port_solve(route, problem, jsolver, tchange, lo, up, eta, x0, y0,
                col):
    N, K = problem.n_vehicles, problem.n_steps
    _, tsolver = config_from_jax(problem, jsolver)
    tsolver = tsolver.replace(**tchange)
    assert tb.qp_route(tsolver.static_part(), n_vehicles=N, n_steps=K,
                       dtype=F64, col_enabled=col) == route
    E = torch.as_tensor(np.array(make_pair_index(N, F64).E))
    return tb.solve_qp_state(
        rowvals_from_numpy(lo), rowvals_from_numpy(up),
        torch.as_tensor(np.array(eta), dtype=F64),
        tb.StateVars(*(torch.as_tensor(np.array(t), dtype=F64) for t in x0)),
        make_solver_params(tsolver, F64), E, h=problem.time_step,
        static=tsolver.static_part(), n_vehicles=N,
        y_init=rowvals_from_numpy(y0), col_enabled=col)


def _jax_solve(problem, jsolver, lo, up, eta, x0, y0, col):
    from ba_path_planning_tpu.ops import collisions as jcol
    from ba_path_planning_tpu.solvers import banded as jb
    from ba_path_planning_tpu.solvers.admm import make_solver_params as jp
    N = problem.n_vehicles
    E = jcol.make_pair_index(N, dtype=jnp.float64).E
    prm = jp(jsolver, jnp.float64)
    return jax.vmap(lambda l, u, e, x, y: jb.solve_qp_state(
        l, u, e, x, prm, E, h=problem.time_step,
        static=jsolver.static_part(), n_vehicles=N, y_init=y,
        col_enabled=col))(lo, up, eta, x0, y0)


@pytest.mark.parametrize("lam", [np.inf, 50.0])
@pytest.mark.parametrize("check", [1, 9])
@pytest.mark.parametrize("route", list(JAX_ROUTES))
def test_solve_qp_state_matches_jax(route, check, lam):
    """One QP on each route that runs the stages, against JAX: phase 1 on
    the channel route, else the QP of an SCP iteration (rows at k = 0
    disabled, hard rows at lam = +inf); check intervals of 1 and 9."""
    jchange, tchange = JAX_ROUTES[route]
    if route == "channel":
        problem, p0, v0, pf, lo, up, x0 = _qp_inputs(N=4, K=10, B=3, seed=5)
        B, K, P = p0.shape[0], problem.n_steps, problem.n_pairs
        eta = jnp.zeros((B, K, P, 2))
        y0 = jax.tree.map(jnp.zeros_like, lo)
        col = False
    else:
        problem, lo, up, eta, x0, y0 = _iteration_qp(N=4, K=10, B=3, seed=5)
        col = True
    jsolver = jcfg.SolverConfig.production(
        pallas=False, problem=problem).replace(
            check_interval=check, max_iter=27, col_penalty=lam, **jchange)
    res = _port_solve(route, problem, jsolver, tchange, lo, up, eta, x0, y0, col)
    _check_qp(res, _jax_solve(problem, jsolver, lo, up, eta, x0, y0, col))


@pytest.mark.parametrize("route", list(JAX_ROUTES))
def test_solve_qp_state_lane_rho_matches_jax(route):
    """Adaptive rho (one rho a lane, the adapting lanes refactorized) on
    each route that runs the stages, against JAX lane by lane."""
    from test_torch_adaptive_rho import B, K, N, RHO
    jchange, tchange = JAX_ROUTES[route]
    if route == "channel":
        problem, p0, v0, pf, lo, up, x0 = _qp_inputs(N=N, K=K, B=B, seed=5)
        eta = jnp.zeros((B, K, problem.n_pairs, 2))
        y0 = jax.tree.map(jnp.zeros_like, lo)
        col, rho = False, 0.02
    else:
        problem, lo, up, eta, x0, y0 = _iteration_qp(N=N, K=K, B=B, seed=5)
        col, rho = True, RHO
    jsolver = jcfg.SolverConfig.production(
        pallas=False, problem=problem).replace(
            adaptive_rho=True, rho=rho, max_iter=90, check_interval=9,
            **jchange)
    _, tsolver = config_from_jax(problem, jsolver)
    res = _port(tsolver.replace(**tchange), lo, up, eta, x0, y0,
                col_enabled=col)
    want = _jax_lanes(jsolver, lo, up, eta, x0, y0, col_enabled=col)
    np.testing.assert_array_equal(res.iters.numpy(), want.iters)
    np.testing.assert_array_equal(res.converged.numpy(), want.converged)
    _close_tree(res.x, want.x, rtol=1e-8)
    _close_tree(res.y, want.y, rtol=1e-8)
