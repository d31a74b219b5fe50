"""PyTorch port, bf16 factor storage (``SolverConfig.factor_dtype="bf16"``):
``banded.compress_factors`` and its padded row stride, the plain bf16
sweeps and the plain L-form fused interval against the JAX package on the
same bf16 factors, one QP on every bf16 route against JAX's bf16 QP, the
router, and the JAX bf16 factors carried across by ``utils/convert.py``.

The plain versions widen the stored bf16 elements to the working dtype and
multiply there, which is JAX's promotion of bf16 x f64; in float64 they
agree with the JAX functions to 1e-10.  A bf16 QP cannot be held to JAX at a
tight tolerance end to end (rounding the factors moves the iterates by the
bf16 precision), so a bf16 QP is held to JAX's by its status and by its
error against the float64 solution with float64 factors: within twice
JAX's error plus 1e-6.  The CUDA kernels that read the bf16 factors are held
to the plain versions in ``test_torch_kernels_gpu.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ba_path_planning_tpu.ops import collisions as jcol
from ba_path_planning_tpu.ops.pallas import admm_fused as jaf
from ba_path_planning_tpu.ops.pallas import banded_solve as jbs
from ba_path_planning_tpu.ops.pallas import group_solve as jgs
from ba_path_planning_tpu.solvers import banded as jb
from ba_path_planning_tpu.solvers.admm import make_solver_params as jparams
from ba_path_planning_tpu.utils import config as jcfg

from ba_path_planning_torch.ops import admm_fused, banded_solve, group_solve
from ba_path_planning_torch.ops.cuda_build import bf16_row_stride
from ba_path_planning_torch.solvers import banded as tb
from ba_path_planning_torch.utils.config import SolverConfig
from ba_path_planning_torch.utils.convert import (config_from_jax,
                                                  factors_from_numpy)

from test_torch_adaptive_rho import _jax_lanes, _port
from test_torch_admm_fused import _interval_inputs, _iteration_qp
from test_torch_banded import _close, _close_tree
from test_torch_kernels_gpu import _assembled
from test_torch_lform import _jax_route

F64, BF16 = torch.float64, torch.bfloat16
H = 0.2


def _jbf16(t):
    """A float64 tensor as a JAX bf16 array (JAX's own rounding)."""
    return jnp.asarray(t.numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("N", [1, 3, 4, 20, 21, 30])
def test_compress_factors_pads_the_row_stride_to_8_elements(N):
    """Rows of n = 6N elements lie ld = n rounded up to 8 apart (16 bytes),
    the columns from n on are zero, and the values are JAX's bf16
    rounding."""
    n = 6 * N
    F_ = torch.as_tensor(np.random.default_rng(N).normal(size=(2, 3, n, n)))
    Fb, Gb = tb.compress_factors(F_, 2 * F_)
    ld = -(-n // 8) * 8
    assert bf16_row_stride(n) == ld and ld % 8 == 0 and ld - n < 8
    for t in (Fb, Gb):
        assert t.dtype == BF16 and t.shape == F_.shape
        assert t.stride() == (3 * n * ld, n * ld, ld, 1)
        store = torch.as_strided(t, (2, 3, n, ld), t.stride())
        assert not bool(store[..., n:].float().any())
    np.testing.assert_array_equal(
        Fb.float().numpy(), np.asarray(_jbf16(F_).astype(jnp.float32)))


def test_factors_from_numpy_carries_jax_bf16_factors():
    """JAX's bf16 factors, lane-padded to 128 by ``pad_factors``, cross as
    their bits, unpadded and on the port's 8-element stride; float arrays
    cross as before."""
    n = 6 * 3
    F_ = torch.as_tensor(np.random.default_rng(3).normal(size=(2, 4, n, n)))
    jF = _jbf16(F_)
    C = np.random.default_rng(4).normal(size=(3, 3, 3))
    got, gotC = factors_from_numpy(jgs.pad_factors(jF), C, n=n)
    assert got.dtype == BF16 and got.shape == (2, 4, n, n)
    assert got.stride(-2) == bf16_row_stride(n)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jF.astype(jnp.float32)))
    assert gotC.dtype == F64 and np.array_equal(gotC.numpy(), C)


def _sweep_inputs(form, B=3, K=8, N=3, seed=7):
    """float64 factors of :func:`_assembled` blocks in ``form``, stored in
    bf16 by JAX, the same bf16 factors in the port's layout, and a float64
    right-hand side: (JAX arrays, port tensors, C, b)."""
    D, C = _assembled(B, K, N, seed)
    if form == "X":
        wide = (tb.factorize_X(D, C, ns_iters=2),)
    elif form == "L":
        wide = (tb.factorize_L(D, C),)
    else:
        wide = tb.factorize(D, tb.slot_dense(C, 2 * N))
    jf = tuple(_jbf16(f) for f in wide)
    b = torch.as_tensor(np.random.default_rng(seed + 1).normal(
        size=(B, K, 6 * N)))
    return jf, factors_from_numpy(*jf), C, b


@pytest.mark.parametrize("body", ["X", "L", "grouped", "resident_batched",
                                  "resident_vmapped"])
def test_plain_bf16_sweep_matches_pallas_interpret(body):
    """The Pallas sweep bodies in interpret mode on bf16 factors and a
    float64 right-hand side (their products promote to float64) against
    the port's wrappers, which run the plain versions here: 1e-10
    relative."""
    form = body if body in ("X", "L") else "dense"
    jf, tf, C, b = _sweep_inputs(form)
    jC, jrhs = jnp.asarray(C.numpy()), jnp.asarray(b.numpy())
    if body == "X":
        want = jgs.solve_factorized_grouped_X(jgs.pad_factors(jf[0]), jC,
                                              jrhs, group=2, interpret=True)
        got = group_solve.solve_factorized_grouped_X(tf[0], C, b)
    elif body == "L":
        want = jgs.solve_factorized_grouped_L(jgs.pad_factors(jf[0]), jC,
                                              jrhs, group=2, interpret=True)
        got = group_solve.solve_factorized_grouped_L(tf[0], C, b)
    else:
        if body == "grouped":
            want = jgs.solve_factorized_grouped(*jgs.pad_factors(*jf), jrhs,
                                                group=2, interpret=True)
        elif body == "resident_batched":
            want = jbs.solve_factorized_pallas(*jf, jrhs, interpret=True)
        else:
            with pltpu.force_tpu_interpret_mode():
                want = jax.vmap(jbs.solve_factorized_single)(*jf, jrhs)
        got = banded_solve.solve_factorized_dense(*tf, b)
    assert got.dtype == F64 and np.asarray(want).dtype == np.float64
    _close(got, want)


def _jax_dense_interval(inp, jL, jEb, n_iters):
    """JAX's dense-route ADMM iterations (the body of its
    ``solve_qp_state``'s ``admm_iter``, composed of the JAX package's own
    ``apply_A``, ``apply_AT`` and ``solve_factorized``), vmapped over the
    lanes, on the bf16 factors: what the L-form fused interval computes."""
    N, prm = inp["N"], inp["prm"]
    sigma, alpha, lam = (float(prm.sigma), float(prm.alpha),
                         float(prm.col_penalty))

    def j(t):
        return jnp.asarray(t.numpy())

    def jrv(rv):
        return jb.RowVals(*(j(t.contiguous()) for t in rv))
    rho = jrv(inp["rho"])
    E = j(inp["E"])

    def one(eta, lo, up, x, z, y, L, Eb):
        tm = jax.tree.map
        for _ in range(n_iters):
            rzy = tm(lambda zz, yy, rr: rr * zz - yy, z, y, rho)
            b_sv = tm(lambda bb, xx: bb + sigma * xx,
                      jb.apply_AT(rzy, eta, E, H), x)
            x_t = jb.from_stacked(
                jb.solve_factorized(L, Eb, jb.to_stacked(b_sv)), N)
            x = tm(lambda xt, xx: alpha * xt + (1 - alpha) * xx, x_t, x)
            z_rel = tm(lambda az, zz: alpha * az + (1 - alpha) * zz,
                       jb.apply_A(x_t, eta, E, H), z)
            z_new = tm(lambda zr, yy, rr, l_, u_: jnp.clip(zr + yy / rr, l_,
                                                            u_),
                       z_rel, y, rho, lo, up)
            w_col = z_rel.col + y.col / rho.col
            z_new = z_new._replace(col=jnp.where(
                w_col >= lo.col, w_col,
                jnp.minimum(w_col + lam / rho.col, lo.col)))
            y = tm(lambda yy, zr, zn, rr: yy + rr * (zr - zn), y, z_rel,
                   z_new, rho)
            z = z_new
        return x, z, y
    return jax.vmap(one)(j(inp["eta"]), jrv(inp["lower"]),
                         jrv(inp["upper"]), jb.StateVars(*map(j, inp["x"])),
                         jrv(inp["z"]), jrv(inp["y"]), jL, jEb)


def _jax_fused_body(inp, jL, jEb, n_iters):
    """The Pallas body ``_admm_kernel`` in interpret mode on the same
    inputs, its planes converted back to StateVars / RowVals."""
    N, K, P, prm = inp["N"], inp["K"], inp["P"], inp["prm"]

    def j(t):
        return jnp.asarray(t.numpy())

    def jrv(rv):
        return jb.RowVals(*(j(t.contiguous()) for t in rv))
    l_s, _ = jaf.bound_planes(jrv(inp["lower"]), -jnp.inf)
    u_s, _ = jaf.bound_planes(jrv(inp["upper"]), jnp.inf)
    zs, zc = jaf.rowvals_to_planes(jrv(inp["z"]))
    ys, yc = jaf.rowvals_to_planes(jrv(inp["y"]))
    rho_sk, rho_c = jaf.rho_planes(jrv(inp["rho"]), jb._LOOSE_RHO)
    B = inp["eta"].shape[0]
    fpar = jnp.asarray([H, float(prm.sigma), float(prm.alpha),
                        float(prm.col_penalty)], jnp.float64)
    out = jaf._fused_batched(
        fpar, jnp.asarray([n_iters], jnp.int32), jL, jEb,
        j(inp["eta"]).reshape(B, K, 2 * P), l_s, u_s, j(inp["lower"].col),
        j(tb.to_stacked(inp["x"])), zs, zc, ys, yc, rho_sk, rho_c,
        *jaf.pair_matrices(N, jnp.float64), interpret=True)
    xp, zsp, zcp, ysp, ycp = (np.array(t) for t in out)
    return (tb.from_stacked(torch.as_tensor(xp), N),
            jaf.planes_to_rowvals(zsp, zcp, N, jb.RowVals),
            jaf.planes_to_rowvals(ysp, ycp, N, jb.RowVals))


@pytest.mark.parametrize("reference", ["dense_iterations", "pallas_body"])
def test_plain_bf16_fused_l_interval_matches_jax(reference):
    """Two iterations of the L-form fused interval on bf16 (Linv, Eb) in
    float64 (the wrapper runs its plain version here).  Against the JAX
    package's dense ADMM iterations on the same factors: 1e-10 of each
    leaf's scale.  Against the Pallas body ``_admm_kernel`` in interpret
    mode: 1e-5, since that body forms its pair-coupling products with
    ``preferred_element_type=float32`` and so is float32-limited in float64
    (about 1e-7 off the dense iterations)."""
    inp = _interval_inputs(np.float64)
    N, prm = inp["N"], inp["prm"]
    D, C = tb.assemble_D(inp["rho"], inp["eta"], inp["E"], h=H,
                         sigma=prm.sigma, n_vehicles=N)
    jL, jEb = (_jbf16(f) for f in tb.factorize(D, tb.slot_dense(C, 2 * N)))
    Linv, Eb = factors_from_numpy(jL, jEb)
    before = admm_fused.admm_interval_fused.launches
    got = admm_fused.admm_interval_fused(
        Linv, Eb, inp["eta"], inp["E"], inp["lower"], inp["upper"],
        inp["x"], inp["z"], inp["y"], inp["rho"], h=H, sigma=prm.sigma,
        alpha=prm.alpha, lam=prm.col_penalty, n_iters=2)
    assert admm_fused.admm_interval_fused.launches == before   # plain
    if reference == "dense_iterations":
        want, rtol = _jax_dense_interval(inp, jL, jEb, 2), 1e-10
    else:
        want, rtol = _jax_fused_body(inp, jL, jEb, 2), 1e-5
    for g, w in zip(got, want):
        _close_tree(g, w, rtol=rtol)


# route -> (the JAX options of the reference route, the port's change): the
# JAX package's resident kernel does not run under its solve_qp_state on the
# CPU, so the resident route is held to JAX's dense route, the same algebra
ROUTES = {
    "grouped_X": (dict(group=2), dict()),
    "grouped_L": (dict(factor_form="L", group=2), dict()),
    "resident": (dict(factor_form="L", group=-1), dict(kernels=True)),
    "dense": (dict(factor_form="L", group=-1), dict()),
    "fused_L": (dict(factor_form="L", group=-1, fused=True), dict()),
}


def _qp(problem, route, dtype, lo, up, eta, xw, y0, adaptive):
    """JAX's and the port's QP on one route, factors in ``dtype`` ("f32" or
    "bf16"): JAX vmapped, or lane by lane with adaptive rho (JAX's kernel
    routes refuse a per-lane rho under vmap)."""
    N = problem.n_vehicles
    jchange, tchange = ROUTES[route]
    jsolver = jcfg.SolverConfig.production(pallas=False, problem=problem)
    jsolver = jsolver.replace(factor_dtype=dtype, adaptive_rho=adaptive,
                              max_iter=400 if adaptive else 100, **jchange)
    _, tsolver = config_from_jax(problem, jsolver)
    tsolver = tsolver.replace(**tchange)
    if adaptive:
        jres = _jax_lanes(jsolver, lo, up, eta, xw, y0)
    else:
        E = jcol.make_pair_index(N, dtype=jnp.float64).E
        prm = jparams(jsolver, jnp.float64)
        jres = jax.vmap(lambda l_, u_, e, x, y: jb.solve_qp_state(
            l_, u_, e, x, prm, E, h=H, static=jsolver.static_part(),
            n_vehicles=N, y_init=y))(lo, up, eta, xw, y0)
    return jres, _port(tsolver, lo, up, eta, xw, y0), tsolver


def _err(res, ref):
    return max(float(np.max(np.abs(np.asarray(g) - np.asarray(w))))
               for g, w in zip(res.x, ref.x))


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("route", list(ROUTES))
def test_bf16_qp_matches_jax_bf16_qp(route, adaptive):
    """The QP of an SCP iteration (N=3, K=10, B=3, float64) with bf16
    factors on each route that stores them, with the shared rho and with
    adaptive rho (the lanes that adapt are refactorized into the bf16
    storage): the port's and JAX's statuses (convergence flags and
    iteration counts) are equal, and the port's x is no further from JAX's
    float64 solution with float64 factors than twice JAX's bf16 x is, plus
    1e-6."""
    problem, lo, up, eta, xw, y0 = _iteration_qp(N=3, K=10, B=3, seed=5)
    jres, res, tsolver = _qp(problem, route, "bf16", lo, up, eta, xw, y0,
                             adaptive)
    assert tb.qp_route(tsolver.static_part(), n_vehicles=3, n_steps=10,
                       dtype=F64, col_enabled=True) == route
    ref, _, _ = _qp(problem, route, "f32", lo, up, eta, xw, y0, adaptive)
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(jres.converged))
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(jres.iters))
    e_port, e_jax = _err(res, ref), _err(jres, ref)
    assert e_jax > 1e-9        # bf16 moved JAX's solution: the path ran
    assert e_port <= 2 * e_jax + 1e-6, (e_port, e_jax)


@pytest.mark.parametrize("N", [2, 4, 20, 21, 22, 29, 30, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_qp_route_sends_bf16_where_jax_does(N, dtype):
    """The JAX router's gates count the working dtype's item size whatever
    the factor dtype (``banded.py:1216-1217``), so bf16 routes as f32 does,
    and the factors of the routes that JAX compresses are stored in bf16
    (``banded.py:1306-1317``): not those of ``channel`` and ``fused_X``."""
    isz = 4 if dtype == torch.float32 else 8
    for form in ("X", "L"):
        for kernels, fused, group in ((True, False, 0), (True, True, 0),
                                      (False, False, -1), (True, False, -1),
                                      (False, True, -1), (False, False, 2)):
            cfg = SolverConfig.production().replace(
                factor_form=form, kernels=kernels, fused=fused, group=group,
                factor_dtype="bf16")
            route = tb.qp_route(cfg.static_part(), n_vehicles=N, n_steps=50,
                                dtype=dtype, col_enabled=True)
            assert route == _jax_route(N, 50, isz, form, kernels, fused,
                                       group)
            assert route == tb.qp_route(
                cfg.replace(factor_dtype="f32").static_part(), n_vehicles=N,
                n_steps=50, dtype=dtype, col_enabled=True)
            assert (route in tb.BF16_ROUTES) == (route != "fused_X")
            assert tb.qp_route(cfg.static_part(), n_vehicles=N, n_steps=50,
                               dtype=dtype, col_enabled=False) == "channel"


@pytest.mark.parametrize("route", ["channel", "fused_X"] + list(ROUTES))
def test_route_factors_store_bf16_where_jax_does(route):
    """The factors of each route in the storage JAX gives them under bf16:
    bf16 on the rows of ``compress_factors`` for the grouped routes and the
    dense pair, the working dtype for ``channel`` and ``fused_X``; the slot
    scalars stay in the working dtype."""
    N, K, B = 3, 8, 2
    change = {"channel": dict(), "fused_X": dict(group=0, fused=True),
              **{r: {**c, **t} for r, (c, t) in ROUTES.items()}}[route]
    static = SolverConfig.production().replace(**{
        "kernels": False, "fused": False, "factor_dtype": "bf16",
        **change}).static_part()
    assert route == tb.qp_route(static, n_vehicles=N, n_steps=K, dtype=F64,
                                col_enabled=route != "channel")
    rng = np.random.default_rng(1)
    P = N * (N - 1) // 2
    rho = tb.rho_pattern_masks(tb.row_scaling_state(K, H, dtype=F64), static,
                               2.6, 2.5, n_steps=K, n_pairs=P,
                               col_enabled=route != "channel", dtype=F64)
    eta = torch.as_tensor(rng.normal(size=(B, K, P, 2)))
    E = torch.as_tensor(np.array(jcol.make_pair_index(N).E), dtype=F64)
    factors = tb._route_factors(route, rho, eta, E, static, N, H, 1e-6)
    blocks = factors[:1] if route in tb.SHARED_C_ROUTES else factors
    for F_ in blocks:
        if route in tb.BF16_ROUTES:
            assert F_.dtype == BF16
            assert F_.stride(-2) == bf16_row_stride(F_.shape[-1])
        else:
            assert F_.dtype == F64
    if route in tb.SHARED_C_ROUTES:
        assert factors[1].dtype == F64


def test_compress_factors_writes_the_kernels_layout():
    """The layout the card's launch check asks of bf16 factors
    (``cuda_build.padded_strides`` on ``bf16_row_stride``) is the one
    ``compress_factors`` writes, and a contiguous bf16 tensor of n = 18 is
    not it; on the CPU the wrappers take either (the plain version widens
    it) and give the same solution."""
    from ba_path_planning_torch.ops.cuda_build import padded_strides
    n = 18
    t = torch.zeros(2, 3, n, n, dtype=BF16)
    assert t.stride() != padded_strides(t.shape, bf16_row_stride(n))
    stored, = tb.compress_factors(t)
    assert stored.stride() == padded_strides(t.shape, bf16_row_stride(n))
    x = torch.ones(2, 3, n, dtype=F64)
    C = torch.zeros(2, 3, 3, dtype=F64)
    torch.testing.assert_close(
        group_solve.solve_factorized_grouped_X(t, C, x),
        group_solve.solve_factorized_grouped_X(stored, C, x))
