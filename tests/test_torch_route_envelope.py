"""Every route the router picks is one the card serves, on the CPU: no JAX
and no card.

``banded.qp_route`` mirrors the JAX router, whose byte gates were set for
a TPU's VMEM; the kernels' launch plans were set for an H100's shared
memory.  Where the two disagree, a QP that the JAX package solves raises
on the card before any launch (``fused_L`` at K <= 5 and N >= 86, the row
stages past N = 341, ``fused_X`` at K = 2 … 9 and N = 268 … 584 while the
fused kernels kept a pair table).  Here each solver configuration the
port runs is walked over K and N, and the plan function of every kernel
the picked route launches must accept the shape; the one refusal is the
decided limit of the grouped routes, N <= 1024.

    python -m pytest tests/test_torch_route_envelope.py -q
"""

import pytest
import torch

from ba_path_planning_torch.ops import (admm_fused, admm_steps, assemble_d,
                                        group_solve)
from ba_path_planning_torch.ops import ns_chain
from ba_path_planning_torch.solvers import banded as tb
from ba_path_planning_torch.solvers.scp import REFERENCE_SOLVER
from ba_path_planning_torch.utils.config import SolverConfig

# The solver configurations the port runs on the card: the production
# solver in float32 and on bf16 factor storage, and the ``SCP`` class's
# solver on its three kernel routes (``chip_smoke.py`` FACADE_ROUTES), in
# float32 and on bf16 factors
SCP_ROUTES = {"grouped_L": dict(kernels=True),
              "resident": dict(kernels=True, group=-1),
              "fused_L": dict(kernels=True, group=-1, fused=True)}
SOLVERS = {
    "production": SolverConfig.production(),
    "production_bf16": SolverConfig.production().replace(
        factor_dtype="bf16"),
    **{f"scp_{route}_{dt}": REFERENCE_SOLVER.replace(factor_dtype=dt,
                                                     **change)
       for route, change in SCP_ROUTES.items() for dt in ("f32", "bf16")},
}

# The batches the sweeps' plan is asked at: one scenario and two (the
# latency solve, the wide phase), the wide tiers' edge (32, 33), the
# cluster tier's (64) and the production chunk (512)
SWEEP_BATCHES = (1, 2, 32, 33, 64, 512)
KS = tuple(range(2, 13)) + (20, 50, 500)
# Every N to 120, then a coarser grid to the grouped routes' limit
NS = tuple(range(2, 121)) + tuple(range(121, 1024, 9)) + (1023, 1024)
# The decided limit (ROADMAP, Decided, PR 16): the grouped routes serve
# N <= 1024 (n = 6N <= 6144, the sweeps' envelope); above it the port
# refuses before any launch, where the JAX router still sends them
GROUPED_LIMIT = ("the grouped routes serve N <= 1024 (the sweeps' "
                 "envelope, n <= 6144); above it the port refuses them by "
                 "decision")
GROUPED_FORMS = {"grouped_X": "X", "grouped_L": "L", "resident": "dense"}


def _rows_ok(K, N):
    """admm_rhs and admm_update serve (K, N) at every batch: the plans'
    admission (``row_stages_serve``) and each kernel's own limits (the
    table's shared memory; a block's element indices below 2^22)."""
    assert admm_steps.row_stages_serve(K, N)
    P = N * (N - 1) // 2
    for B in SWEEP_BATCHES:
        rhs = admm_steps.rhs_plan(B, K, N)
        assert rhs.smem_bytes <= admm_steps.SMEM_MAX
        assert rhs.k_tile * (2 * N + P) < 2 ** 22
        assert admm_steps.update_plan(B, K, N) * (12 * N + P) < 2 ** 22


def _channel_ok(K, N):
    """Phase 1's channel interval has a plan the kernel takes: the
    register form (K <= 32 steps a thread) keeps its region in shared
    memory, the memory form takes one channel a block."""
    for B in SWEEP_BATCHES:
        plan = admm_steps.channel_plan(B, K, N)
        if plan.steps:
            assert K <= 32 * plan.steps and plan.in_smem
        else:
            assert plan.warps == 1


def _route_ok(route, K, N, esize):
    """The plan of every kernel ``route`` launches accepts (K, N); each
    route but phase 1's assembles D in one kernel."""
    n = 6 * N
    for B in SWEEP_BATCHES:        # D in the working dtype
        assemble_d.assemble_plan(B, K, N, 4)
    if route in ("grouped_X", "fused_X") and K >= 6:     # the NS chain
        for B in SWEEP_BATCHES:
            ns_chain.ns_chain_plan(B, n)
    if route in GROUPED_FORMS:
        for B in SWEEP_BATCHES:
            group_solve.sweep_plan(B, K, n, GROUPED_FORMS[route],
                                   esize=esize)
        _rows_ok(K, N)
    elif route == "fused_X":       # its factors stay in the working dtype
        admm_fused.fused_plan(K, N, "X")
        for B in SWEEP_BATCHES:    # small batches on the wide tier
            admm_fused.fused_x_plan(B, K, N)
    elif route == "fused_L":
        admm_fused.fused_plan(K, N, "L", esize=esize)
    else:
        assert route == "dense"    # no hand-written kernel


@pytest.mark.parametrize("K", KS)
def test_every_route_lies_inside_its_kernels_envelope(K):
    """For each configuration of :data:`SOLVERS` and every N of :data:`NS`
    up to 1024, the route ``qp_route`` picks in float32 has a plan in each
    of its kernels (``fused_plan``, ``fused_x_plan`` and ``sweep_plan`` at
    every batch of :data:`SWEEP_BATCHES`, the row stages' and the NS
    chain's plans), and
    phase 1's channel interval has one."""
    seen = set()
    for name, solver in SOLVERS.items():
        static = solver.static_part()
        esize = 2 if static.factor_dtype == "bf16" else 4
        for N in NS:
            _channel_ok(K, N)
            route = tb.qp_route(static, n_vehicles=N, n_steps=K,
                                dtype=torch.float32, col_enabled=True)
            try:
                _route_ok(route, K, N, esize)
            except (ValueError, AssertionError) as err:
                raise AssertionError(f"{name}: route {route} at K={K}, "
                                     f"N={N} is refused: {err}") from err
            seen.add(route)
    assert {"grouped_X", "grouped_L"} <= seen
    if K <= 9:
        assert "fused_X" in seen


@pytest.mark.parametrize("K", (2, 6, 50))
@pytest.mark.parametrize("N", (1025, 1100, 2000))
def test_grouped_routes_above_n_1024_are_the_decided_refusal(K, N):
    """Past N = 1024 the JAX router still sends the production solver to
    ``grouped_X`` and the ``SCP`` class to ``grouped_L``; the port refuses
    them there by decision (:data:`GROUPED_LIMIT`): the sweeps' plan
    raises and the row stages do not serve, so the solve raises before any
    launch."""
    for name in ("production", "production_bf16", "scp_grouped_L_f32",
                 "scp_grouped_L_bf16"):
        static = SOLVERS[name].static_part()
        route = tb.qp_route(static, n_vehicles=N, n_steps=K,
                            dtype=torch.float32, col_enabled=True)
        assert route in ("grouped_X", "grouped_L"), (name, route)
        esize = 2 if static.factor_dtype == "bf16" else 4
        with pytest.raises(ValueError, match="up to 6144"):
            group_solve.sweep_plan(1, K, 6 * N, GROUPED_FORMS[route],
                                   esize=esize)
        assert not admm_steps.row_stages_serve(K, N), GROUPED_LIMIT
