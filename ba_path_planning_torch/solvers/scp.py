"""Sequential Convex Programming engine (counterpart of
``ba_path_planning_tpu.solvers.scp``): the direct (state-space) method and
the CG (acceleration-space) method.

Control flow of the reference solver:

  1. solve the initial QP without collision rows;
  2. roll out; if the initial guess is already collision-free, skip the loop;
  3. while iter < max_iterations and the stopping rule has not fired:
     re-linearize the collisions about the previous iterate, re-solve the QP
     warm-started at the previous state and duals;
  4. final rollout and status codes.

Every function works on a batch of scenarios (the leading axis).  The direct
method's loop is resumable: :class:`SCPCarry` holds everything an iteration
needs, so a driver can pause a batch, drop finished lanes and resume
(``parallel.mesh.ShardedSCPSolver.solve_compacted``).  The CG method's
loop, :func:`_scp_solve`, runs in one piece, as the JAX package's does.
:class:`SCP` is the reference-compatible class API on top of
:class:`SCPEngine`.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..models.double_integrator import DoubleIntegrator2D
from ..ops.collisions import (PairIndex, check_feasible, collision_lower_bounds,
                              degenerate_angles, linearize, make_pair_index)
from ..ops.constraints import ConstraintBlocks, static_bounds
from ..ops.rollout import rollout
from ..utils.config import (ProblemConfig, SolverConfig, SolverParams,
                            SolverStatic, make_solver_params, resolve_device)
from ..utils.profiling import host_read, span
from .admm import (Preconditioner, QPData, build_static_normal_inverse,
                   solve_qp_impl)
from .banded import (RowVals, StateVars, build_bounds,
                     collision_lower_bounds_state, lane_mask, polish_qp_state,
                     solve_qp_state, tree_map)

STATUS_FEASIBLE_INITIAL = 0   # initial QP already collision-free
STATUS_CONVERGED = 1          # the active stopping rule fired
STATUS_MAX_ITERS = 2          # hit max_iterations


class SCPResult(NamedTuple):
    positions: torch.Tensor        # (B, N, K, 2)
    velocities: torch.Tensor       # (B, N, K, 2)
    accelerations: torch.Tensor    # (B, N, K, 2)
    iterations: torch.Tensor       # (B,) SCP iterations run
    status: torch.Tensor           # (B,) status code above
    converged: torch.Tensor        # (B,) step-norm converged
    feasible_initial: torch.Tensor  # (B,) pre-loop feasibility
    feasible_final: torch.Tensor   # (B,) final trajectory collision-free
    qp_iterations: torch.Tensor    # (B,) total ADMM iterations
    qp_converged_all: torch.Tensor  # (B,) every QP solve converged
    rel_step: torch.Tensor         # (B,) last relative step norm


class SCPCarry(NamedTuple):
    """Resumable per-lane SCP loop state (leading batch axis)."""
    a: torch.Tensor                # (B, N, K, 2) current accelerations
    y: RowVals                     # dual warm start
    it: torch.Tensor               # (B,) int32 SCP iterations run so far
    converged: torch.Tensor        # (B,) bool
    stop: torch.Tensor             # (B,) bool: active stopping rule fired
    rel: torch.Tensor              # (B,) last relative step norm
    qp_iters: torch.Tensor         # (B,) int32 total ADMM iterations
    qp_ok: torch.Tensor            # (B,) bool: every QP solve converged
    feasible_initial: torch.Tensor  # (B,) bool


# An angle source: (lane ids (B,), global SCP iteration (B,)) -> (B, K, P).
AngleFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _warm_state(a, p0, v0, h):
    """StateVars warm start: p and v from the exact rollout of ``a``,
    shifted to k = 1..K with the terminal state extrapolated."""
    pos, vel = rollout(a, p0, v0, h)
    model = DoubleIntegrator2D(n_steps=a.shape[-2], time_step=h)
    pK, vK = model.terminal_state(pos, vel, a)
    p_var = torch.cat([pos[..., 1:, :], pK[..., None, :]], dim=-2)
    v_var = torch.cat([vel[..., 1:, :], vK[..., None, :]], dim=-2)
    return StateVars(a=a, p=p_var, v=v_var)


def _goal_projected(a, p0, v0, pf, vf, problem: ProblemConfig):
    model = DoubleIntegrator2D(n_steps=problem.n_steps,
                               time_step=problem.time_step)
    return model.goal_projection(a, p0, v0, pf, vf)


def _divergence_guard(a_new, a, problem: ProblemConfig):
    """Keep the previous iterate of a lane whose QP failed: a valid QP
    solution respects the acceleration box, so an iterate far outside it
    (or not finite) marks a failed solve."""
    acc_cap = 2.0 * max(abs(problem.acc_min), abs(problem.acc_max))
    flat_new = a_new.flatten(1)
    bad = (~torch.isfinite(flat_new).all(-1)
           | (flat_new.abs().amax(-1) > acc_cap))
    return torch.where(lane_mask(bad, a), a, a_new)


def _direct_body(carry: SCPCarry, p0, v0, pf, vf, angle, lower_s, upper_s, *,
                 params: SolverParams, pairs: PairIndex,
                 problem: ProblemConfig, solver: SolverStatic,
                 group=None) -> SCPCarry:
    """One SCP iteration of every lane in the batch (``group``: ``pairs``
    is this rank's share, and the QP and the feasibility check reduce over
    the group)."""
    N, h, R = problem.n_vehicles, problem.time_step, problem.min_distance
    a = carry.a
    with span("scp.linearize"):
        prev_pos, _ = rollout(a, p0, v0, h)
        eta, dist = linearize(prev_pos, pairs, angle)
        # constraint tightening: solve for R + margin, check feasibility at R
        col_lo = collision_lower_bounds_state(
            eta, dist, prev_pos, pairs, min_distance=R + params.col_margin)
        lower_it = lower_s._replace(col=col_lo)
        x_warm = _warm_state(a, p0, v0, h)
    qp = solve_qp_state(lower_it, upper_s, eta, x_warm, params, pairs.E, h=h,
                        static=solver, n_vehicles=N, y_init=carry.y,
                        group=group)
    a_new = qp.x.a
    if solver.polish:
        a_new = polish_qp_state(lower_it, upper_s, eta, qp.x, qp.y, pairs.E,
                                h=h, n_vehicles=N, group=group).a
    with span("scp.check"):
        a_new = _divergence_guard(a_new, a, problem)
        step = torch.linalg.vector_norm((a_new - a).flatten(1), dim=-1)
        denom = torch.clamp_min(
            torch.linalg.vector_norm(a.flatten(1), dim=-1), 1e-30)
        rel_step = step / denom
        converged = rel_step <= problem.convergence_tolerance
        if problem.stop_mode == "feasible":
            a_stop = (_goal_projected(a_new, p0, v0, pf, vf, problem)
                      if problem.goal_project else a_new)
            new_pos, _ = rollout(a_stop, p0, v0, h)
            stop = check_feasible(new_pos, pairs, R, group)
        else:
            stop = converged
    return SCPCarry(a=a_new, y=qp.y, it=carry.it + 1, converged=converged,
                    stop=stop, rel=rel_step,
                    qp_iters=carry.qp_iters + qp.iters,
                    qp_ok=carry.qp_ok & qp.converged,
                    feasible_initial=carry.feasible_initial)


def _direct_cond(carry: SCPCarry, cap) -> torch.Tensor:
    return (carry.it < cap) & ~carry.stop & ~carry.feasible_initial


def _scp_start_direct(p0, v0, pf, vf, *, params: SolverParams,
                      pairs: PairIndex, problem: ProblemConfig,
                      solver: SolverStatic, group=None) -> SCPCarry:
    """Phase 1: the collision-free initial QP and the feasibility
    pre-check, as a resumable carry.  p0/v0/pf/vf (B, N, 2); ``group``: the
    pairs are sharded over its ranks (P is the local count)."""
    N, K, P = problem.n_vehicles, problem.n_steps, pairs.E.shape[1]
    h, R = problem.time_step, problem.min_distance
    B, dtype, dev = p0.shape[0], p0.dtype, p0.device
    lower_s, upper_s = build_bounds(p0, v0, pf, vf, n_vehicles=N, n_steps=K,
                                    h=h, limits=problem.limits, n_pairs=P)
    eta0 = torch.zeros((B, K, P, 2), dtype=dtype, device=dev)
    x0 = _warm_state(torch.zeros((B, N, K, 2), dtype=dtype, device=dev),
                     p0, v0, h)
    qp0 = solve_qp_state(lower_s, upper_s, eta0, x0, params, pairs.E, h=h,
                         static=solver, n_vehicles=N, col_enabled=False,
                         group=group)
    a = qp0.x.a
    if solver.polish:
        a = polish_qp_state(lower_s, upper_s, eta0, qp0.x, qp0.y, pairs.E,
                            h=h, n_vehicles=N, group=group).a
    a_chk = (_goal_projected(a, p0, v0, pf, vf, problem)
             if problem.goal_project else a)
    pos_init, _ = rollout(a_chk, p0, v0, h)
    feasible_initial = check_feasible(pos_init, pairs, R, group)
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    return SCPCarry(a=a, y=qp0.y,
                    it=torch.zeros(B, dtype=torch.int32, device=dev),
                    converged=false, stop=false.clone(),
                    rel=torch.full((B,), float("inf"), dtype=dtype,
                                   device=dev),
                    qp_iters=qp0.iters, qp_ok=qp0.converged,
                    feasible_initial=feasible_initial)


def _scp_step_direct(carry: SCPCarry, p0, v0, pf, vf, lane_ids, it_cap, *,
                     params: SolverParams, pairs: PairIndex,
                     problem: ProblemConfig, solver: SolverStatic,
                     angle_fn: AngleFn, group=None) -> SCPCarry:
    """Run SCP iterations from ``carry`` until each lane's stopping rule
    fires or its ``it`` reaches ``min(it_cap, max_iterations)``.  Lanes that
    are done keep their state.  ``lane_ids`` (B,) and the lane's global
    iteration key the degenerate-pair angles through ``angle_fn``, which
    gives the angles of ``pairs`` (this rank's share under ``group``).
    The host reads two flags an iteration and one more at the end
    (``utils.profiling.host_read``); the call is the span ``scp.step``."""
    with span("scp.step"):
        N, K, P = problem.n_vehicles, problem.n_steps, pairs.E.shape[1]
        lower_s, upper_s = build_bounds(p0, v0, pf, vf, n_vehicles=N,
                                        n_steps=K, h=problem.time_step,
                                        limits=problem.limits, n_pairs=P)
        cap = torch.clamp_max(torch.as_tensor(it_cap, dtype=torch.int32,
                                              device=p0.device),
                              problem.max_iterations)
        while True:
            active = _direct_cond(carry, cap)
            if not bool(host_read("scp", active.any())):
                return carry
            new = _direct_body(carry, p0, v0, pf, vf,
                               angle_fn(lane_ids, carry.it), lower_s, upper_s,
                               params=params, pairs=pairs, problem=problem,
                               solver=solver, group=group)
            if not bool(host_read("scp", active.all())):
                with span("scp.merge"):
                    new = tree_map(
                        lambda n_, o_: torch.where(lane_mask(active, n_), n_,
                                                   o_), new, carry)
            carry = new


def _scp_finalize_direct(carry: SCPCarry, p0, v0, pf, vf, *,
                         pairs: PairIndex, problem: ProblemConfig,
                         group=None) -> SCPResult:
    """Final rollout and status codes.  With ``goal_project`` the output is
    the exact-terminal projection wherever that is collision-free; the
    feasibility checks reduce over ``group`` where the pairs are
    sharded."""
    h = problem.time_step
    a_out = carry.a
    if problem.goal_project:
        a_proj = _goal_projected(carry.a, p0, v0, pf, vf, problem)
        pos_p, _ = rollout(a_proj, p0, v0, h)
        feas_p = check_feasible(pos_p, pairs, problem.min_distance, group)
        a_out = torch.where(lane_mask(feas_p, a_proj), a_proj, carry.a)
    positions, velocities = rollout(a_out, p0, v0, h)
    feasible_final = check_feasible(positions, pairs, problem.min_distance,
                                    group)
    status = torch.where(
        carry.feasible_initial, STATUS_FEASIBLE_INITIAL,
        torch.where(carry.stop, STATUS_CONVERGED, STATUS_MAX_ITERS))
    return SCPResult(positions=positions, velocities=velocities,
                     accelerations=a_out, iterations=carry.it,
                     status=status.to(torch.int32), converged=carry.converged,
                     feasible_initial=carry.feasible_initial,
                     feasible_final=feasible_final,
                     qp_iterations=carry.qp_iters,
                     qp_converged_all=carry.qp_ok, rel_step=carry.rel)


def _scp_solve(p0, v0, pf, vf, lane_ids, *, params: SolverParams,
               pairs: PairIndex, Minv: Preconditioner,
               problem: ProblemConfig, solver: SolverStatic,
               angle_fn: AngleFn) -> SCPResult:
    """The SCP loop over the acceleration-space QP of the CG method
    (:func:`solvers.admm.solve_qp_impl`), for a batch: p0/v0/pf/vf
    (B, N, 2), ``lane_ids`` (B,) the scenario ids that key the
    degenerate-pair draws.  The control flow and the statuses are the
    direct path's; a lane that has stopped keeps its state while the others
    go on (only the lanes that go on are solved), and the host reads which
    lanes those are once per SCP iteration."""
    N, K, P = problem.n_vehicles, problem.n_steps, pairs.E.shape[1]
    h, R = problem.time_step, problem.min_distance
    B, dtype, dev = p0.shape[0], p0.dtype, p0.device
    lo_s, up_s = static_bounds(p0, v0, pf, vf, n_vehicles=N, n_steps=K, h=h,
                               limits=problem.limits)
    col_up = torch.full((B, K, P), float("inf"), dtype=dtype, device=dev)
    E = pairs.E

    # phase 1: the QP without collision rows
    data0 = QPData(eta=torch.zeros((B, K, P, 2), dtype=dtype, device=dev),
                   col_mask=torch.zeros((), dtype=dtype, device=dev),
                   lower=ConstraintBlocks(col=-col_up, **lo_s),
                   upper=ConstraintBlocks(col=col_up, **up_s))
    qp0 = solve_qp_impl(data0, E, Minv,
                        torch.zeros((B, N, K, 2), dtype=dtype, device=dev),
                        params, h=h, static=solver)
    a, y = qp0.x, qp0.y
    a_chk = (_goal_projected(a, p0, v0, pf, vf, problem)
             if problem.goal_project else a)
    feasible_initial = check_feasible(rollout(a_chk, p0, v0, h)[0], pairs, R)

    # phase 2: the SCP iterations, on the lanes that go on
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    converged = torch.zeros(B, dtype=torch.bool, device=dev)
    stop = converged.clone()
    rel = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    qp_iters, qp_ok = qp0.iters.clone(), qp0.converged.clone()
    y = ConstraintBlocks(*(t.clone() for t in y))
    one = torch.ones((), dtype=dtype, device=dev)
    while True:
        act = torch.nonzero((it < problem.max_iterations) & ~stop
                            & ~feasible_initial).squeeze(1)
        if act.numel() == 0:
            break
        a_l, p0_l, v0_l, pf_l, vf_l = (t[act] for t in (a, p0, v0, pf, vf))
        prev_pos, _ = rollout(a_l, p0_l, v0_l, h)
        eta, dist = linearize(prev_pos, pairs,
                              angle_fn(lane_ids[act], it[act]))
        # constraint tightening: enforce R + margin, check feasibility at R
        col_lo = collision_lower_bounds(eta, dist, prev_pos, p0_l, v0_l,
                                        pairs, h=h,
                                        min_distance=R + params.col_margin)
        data = QPData(eta=eta, col_mask=one,
                      lower=ConstraintBlocks(col=col_lo, **{
                          k: v[act] for k, v in lo_s.items()}),
                      upper=ConstraintBlocks(col=col_up[act], **{
                          k: v[act] for k, v in up_s.items()}))
        qp = solve_qp_impl(data, E, Minv, a_l, params,
                           ConstraintBlocks(*(t[act] for t in y)), h=h,
                           static=solver)
        a_new = _divergence_guard(qp.x, a_l, problem)
        step = torch.linalg.vector_norm((a_new - a_l).flatten(1), dim=-1)
        rel[act] = step / torch.clamp_min(
            torch.linalg.vector_norm(a_l.flatten(1), dim=-1), 1e-30)
        converged[act] = rel[act] <= problem.convergence_tolerance
        if problem.stop_mode == "feasible":
            a_stop = (_goal_projected(a_new, p0_l, v0_l, pf_l, vf_l, problem)
                      if problem.goal_project else a_new)
            stop[act] = check_feasible(rollout(a_stop, p0_l, v0_l, h)[0],
                                       pairs, R)
        else:
            stop[act] = converged[act]
        a[act] = a_new
        for full, part in zip(y, qp.y):
            full[act] = part
        it[act] += 1
        qp_iters[act] += qp.iters
        qp_ok[act] &= qp.converged

    carry = SCPCarry(a=a, y=y, it=it, converged=converged, stop=stop,
                     rel=rel, qp_iters=qp_iters, qp_ok=qp_ok,
                     feasible_initial=feasible_initial)
    return _scp_finalize_direct(carry, p0, v0, pf, vf, pairs=pairs,
                                problem=problem)


class SCPEngine:
    """SCP solver for a fixed (problem, solver) configuration on one device
    (``device=None``: the card).  The solver's ``method`` picks the QP:
    "direct" (state space, banded factors; resumable through
    :meth:`start`, :meth:`step` and :meth:`finalize`), else the CG method
    (the acceleration-space ADMM of ``solvers/admm.py``, whose
    preconditioner the engine builds once), as in the JAX engine."""

    def __init__(self, problem: ProblemConfig,
                 solver: SolverConfig | None = None, dtype=torch.float32,
                 device=None, seed: int = 0):
        if problem.n_steps < 2:
            raise ValueError(
                f"K = int(T/h) = {problem.n_steps}; need K >= 2")
        solver = solver if solver is not None else SolverConfig()
        self.problem = problem
        self.solver = solver
        self.dtype = dtype
        self.device = resolve_device(device)
        self.seed = seed
        self.pairs = make_pair_index(problem.n_vehicles, dtype=dtype,
                                     device=self.device)
        self.Minv = build_static_normal_inverse(
            problem.n_steps, problem.time_step, solver, dtype=dtype,
            device=self.device)
        self.solver_static = solver.static_part()
        self.solver_params = make_solver_params(solver, dtype, self.device)

    def _direct_only(self):
        if self.solver_static.method != "direct":
            raise NotImplementedError(
                "resumable SCP requires the direct (state-space) solver")

    def _kw(self):
        return dict(params=self.solver_params, pairs=self.pairs,
                    problem=self.problem, solver=self.solver_static)

    def default_angle_fn(self) -> AngleFn:
        K = self.problem.n_steps

        def angles(lane_ids, it):
            return degenerate_angles(self.seed, lane_ids, it, self.pairs, K,
                                     dtype=self.dtype)
        return angles

    def as_inputs(self, *arrays):
        return [torch.as_tensor(a, dtype=self.dtype, device=self.device)
                for a in arrays]

    def start(self, p0, v0, pf, vf) -> SCPCarry:
        self._direct_only()
        return _scp_start_direct(p0, v0, pf, vf, **self._kw())

    def step(self, carry, p0, v0, pf, vf, lane_ids, it_cap,
             angle_fn: AngleFn | None = None) -> SCPCarry:
        self._direct_only()
        return _scp_step_direct(carry, p0, v0, pf, vf, lane_ids, it_cap,
                                angle_fn=angle_fn or self.default_angle_fn(),
                                **self._kw())

    def finalize(self, carry, p0, v0, pf, vf) -> SCPResult:
        self._direct_only()
        return _scp_finalize_direct(carry, p0, v0, pf, vf, pairs=self.pairs,
                                    problem=self.problem)

    def solve_fn(self):
        """The per-scenario solve, ``(p0, v0, pf, vf, angle_fn=None) ->
        SCPResult`` on (N, 2) state arrays with no batch axis, for callers
        that compose their own loop around it.  The JAX engine hands its
        closure to ``jit``/``vmap``/``lax.map``; the port has no such
        transforms, so this is :meth:`solve` itself: each call runs eagerly
        on the engine's device as lane 0."""
        return self.solve

    def solve(self, p0, v0, pf, vf,
              angle_fn: AngleFn | None = None) -> SCPResult:
        """One scenario: state arrays (N, 2); the result has no batch
        axis."""
        res = self.solve_batch(*(torch.as_tensor(a)[None]
                                 for a in (p0, v0, pf, vf)),
                               angle_fn=angle_fn)
        return SCPResult(*(t[0] for t in res))

    def solve_batch(self, p0, v0, pf, vf, lane_ids=None,
                    angle_fn: AngleFn | None = None) -> SCPResult:
        """All state arrays (B, N, 2); every lane runs to its end."""
        p0, v0, pf, vf = self.as_inputs(p0, v0, pf, vf)
        if lane_ids is None:
            lane_ids = torch.arange(p0.shape[0], device=self.device)
        if self.solver_static.method != "direct":
            return _scp_solve(p0, v0, pf, vf, lane_ids, Minv=self.Minv,
                              angle_fn=angle_fn or self.default_angle_fn(),
                              **self._kw())
        carry = self.start(p0, v0, pf, vf)
        carry = self.step(carry, p0, v0, pf, vf, lane_ids,
                          self.problem.max_iterations, angle_fn)
        return self.finalize(carry, p0, v0, pf, vf)


# The ``SCP`` class's default solver, the JAX class's: the direct method on
# L-form factors with hard collision rows, up to 2000 ADMM iterations per QP
# checked every 25, on the plain route (``kernels=False``).
REFERENCE_SOLVER = SolverConfig(method="direct", polish=False,
                                adaptive_rho=False, max_iter=2000)


class SCP:
    """Drop-in equivalent of the reference ``path_planning.SCP`` class:
    the same constructor signature, ``set_initial_states`` /
    ``set_final_states`` / ``generate_trajectories`` and the
    ``trajectories`` dict of (N, K, 2) numpy arrays, backed by
    :class:`SCPEngine`.  The default solver is the reference-compatible one:
    the direct method on L-form factors with hard collision rows, stopping
    on step-norm convergence, up to 2000 ADMM iterations per QP checked
    every 25.  ``device=None`` runs on the card."""

    def __init__(self, n_vehicles=5, time_horizon=3.0, time_step=0.1,
                 min_distance=0.1, space_dims=None, *, solver=None,
                 dtype=None, device=None, verbose=True):
        if space_dims is None:
            space_dims = [0, 0, 20, 20]
        self.N = n_vehicles
        self.T = time_horizon
        self.h = time_step
        self.K = int(time_horizon / time_step)
        self.R = min_distance
        self.space_dims = list(space_dims)
        self.convergence_tolerance = 1.5e-2
        self.trajectories = None
        self.result: SCPResult | None = None
        self.initial_positions = None
        self.initial_velocities = None
        self.final_positions = None
        self.final_velocities = None
        self._solver_cfg = REFERENCE_SOLVER if solver is None else solver
        self._dtype = dtype if dtype is not None else torch.float32
        self._device = resolve_device(device)
        self._engine_cache: dict[tuple[int, int], SCPEngine] = {}
        if verbose:
            print("---=== SCP Problem initialized (PyTorch engine) ===---")
            print(f"Number of timesteps: {self.K}")
            print(f"Timestep: {self.h}")
            print(f"Minimum distance between vehicles: {self.R}")
            print(f"Space dimensions: {self.space_dims}")

    def _set_states(self, positions, velocities):
        positions = np.asarray(positions, dtype=float).reshape(self.N, 2)
        if velocities is None:
            velocities = np.zeros((self.N, 2))
        velocities = np.asarray(velocities, dtype=float).reshape(self.N, 2)
        return positions.reshape(-1), velocities.reshape(-1)

    def set_initial_states(self, positions, velocities=None):
        self.initial_positions, self.initial_velocities = self._set_states(
            positions, velocities)

    def set_final_states(self, positions, velocities=None):
        self.final_positions, self.final_velocities = self._set_states(
            positions, velocities)

    def _engine(self, max_iterations: int, seed: int) -> SCPEngine:
        if (max_iterations, seed) not in self._engine_cache:
            problem = ProblemConfig(
                n_vehicles=self.N, time_horizon=self.T, time_step=self.h,
                min_distance=self.R, space_dims=tuple(self.space_dims),
                max_iterations=max_iterations)
            self._engine_cache[max_iterations, seed] = SCPEngine(
                problem, self._solver_cfg, dtype=self._dtype,
                device=self._device, seed=seed)
        return self._engine_cache[max_iterations, seed]

    def generate_trajectories(self, max_iterations=15, seed=0):
        if self.initial_positions is None or self.final_positions is None:
            raise ValueError("Set initial and final states first")
        t0 = time.time()
        res = self._engine(max_iterations, seed).solve(
            *(a.reshape(self.N, 2) for a in (
                self.initial_positions, self.initial_velocities,
                self.final_positions, self.final_velocities)))
        res = SCPResult(*(t.cpu().numpy() for t in res))
        self.result = res
        self.trajectories = {
            "positions": res.positions,
            "velocities": res.velocities,
            "accelerations": res.accelerations,
        }
        print(f"Trajectory generation completed in {time.time() - t0:.3f} "
              f"seconds ({int(res.iterations)} SCP iterations, "
              f"status={int(res.status)})")
        return self.trajectories

    def visualize_trajectories(self, show_animation=False,
                               save_path="trajectories.pdf"):
        from ..viz.plots import plot_trajectories
        if self.trajectories is None:
            raise ValueError("Trajectories not generated yet")
        return plot_trajectories(self.trajectories["positions"],
                                 self.space_dims, self.R,
                                 save_path=save_path, show=show_animation)

    def visualize_time_snapshots(self, num_snapshots=5, save_path=None):
        from ..viz.plots import plot_time_snapshots
        if self.trajectories is None:
            raise ValueError("Trajectories not generated yet")
        return plot_time_snapshots(self.trajectories["positions"],
                                   self.space_dims, self.R, self.h,
                                   num_snapshots=num_snapshots,
                                   save_path=save_path)
