"""Sequential Convex Programming engine, direct (state-space) method
(counterpart of ``ba_path_planning_tpu.solvers.scp``).

Control flow of the reference solver:

  1. solve the initial QP without collision rows;
  2. roll out; if the initial guess is already collision-free, skip the loop;
  3. while iter < max_iterations and the stopping rule has not fired:
     re-linearize the collisions about the previous iterate, re-solve the QP
     warm-started at the previous state and duals;
  4. final rollout and status codes.

Every function works on a batch of scenarios (the leading axis).  The loop
is resumable: :class:`SCPCarry` holds everything an iteration needs, so a
driver can pause a batch, drop finished lanes and resume
(``parallel.mesh.ShardedSCPSolver.solve_compacted``).  :class:`SCP` is the
reference-compatible class API on top of :class:`SCPEngine`.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..models.double_integrator import DoubleIntegrator2D
from ..ops.collisions import (PairIndex, check_feasible, degenerate_angles,
                              linearize, make_pair_index)
from ..ops.rollout import rollout
from ..utils.config import (ProblemConfig, SolverConfig, SolverParams,
                            SolverStatic, make_solver_params, resolve_device)
from .banded import (RowVals, StateVars, build_bounds,
                     collision_lower_bounds_state, lane_mask, solve_qp_state,
                     tree_map)

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


def _direct_body(carry: SCPCarry, p0, v0, pf, vf, angle, lower_s, upper_s, *,
                 params: SolverParams, pairs: PairIndex,
                 problem: ProblemConfig, solver: SolverStatic) -> SCPCarry:
    """One SCP iteration of every lane in the batch."""
    N, h, R = problem.n_vehicles, problem.time_step, problem.min_distance
    a = carry.a
    prev_pos, _ = rollout(a, p0, v0, h)
    eta, dist = linearize(prev_pos, pairs, angle)
    # constraint tightening: solve for R + margin, check feasibility at R
    col_lo = collision_lower_bounds_state(eta, dist, prev_pos, pairs,
                                          min_distance=R + params.col_margin)
    lower_it = lower_s._replace(col=col_lo)
    x_warm = _warm_state(a, p0, v0, h)
    qp = solve_qp_state(lower_it, upper_s, eta, x_warm, params, pairs.E, h=h,
                        static=solver, n_vehicles=N, y_init=carry.y)
    a_new = qp.x.a
    # divergence guard: a valid QP solution respects the acceleration box,
    # so an iterate far outside it (or not finite) marks a failed solve;
    # keep the previous iterate
    acc_cap = 2.0 * max(abs(problem.acc_min), abs(problem.acc_max))
    flat_new = a_new.flatten(1)
    bad = (~torch.isfinite(flat_new).all(-1)
           | (flat_new.abs().amax(-1) > acc_cap))
    a_new = torch.where(lane_mask(bad, a), a, a_new)
    step = torch.linalg.vector_norm((a_new - a).flatten(1), dim=-1)
    denom = torch.clamp_min(torch.linalg.vector_norm(a.flatten(1), dim=-1),
                            1e-30)
    rel_step = step / denom
    converged = rel_step <= problem.convergence_tolerance
    if problem.stop_mode == "feasible":
        a_stop = (_goal_projected(a_new, p0, v0, pf, vf, problem)
                  if problem.goal_project else a_new)
        new_pos, _ = rollout(a_stop, p0, v0, h)
        stop = check_feasible(new_pos, pairs, R)
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
                      solver: SolverStatic) -> SCPCarry:
    """Phase 1: the collision-free initial QP and the feasibility
    pre-check, as a resumable carry.  p0/v0/pf/vf (B, N, 2)."""
    N, K, P = problem.n_vehicles, problem.n_steps, pairs.E.shape[1]
    h, R = problem.time_step, problem.min_distance
    B, dtype, dev = p0.shape[0], p0.dtype, p0.device
    lower_s, upper_s = build_bounds(p0, v0, pf, vf, n_vehicles=N, n_steps=K,
                                    h=h, limits=problem.limits, n_pairs=P)
    eta0 = torch.zeros((B, K, P, 2), dtype=dtype, device=dev)
    x0 = _warm_state(torch.zeros((B, N, K, 2), dtype=dtype, device=dev),
                     p0, v0, h)
    qp0 = solve_qp_state(lower_s, upper_s, eta0, x0, params, pairs.E, h=h,
                         static=solver, n_vehicles=N, col_enabled=False)
    a = qp0.x.a
    a_chk = (_goal_projected(a, p0, v0, pf, vf, problem)
             if problem.goal_project else a)
    pos_init, _ = rollout(a_chk, p0, v0, h)
    feasible_initial = check_feasible(pos_init, pairs, R)
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
                     angle_fn: AngleFn) -> SCPCarry:
    """Run SCP iterations from ``carry`` until each lane's stopping rule
    fires or its ``it`` reaches ``min(it_cap, max_iterations)``.  Lanes that
    are done keep their state.  ``lane_ids`` (B,) and the lane's global
    iteration key the degenerate-pair angles through ``angle_fn``."""
    N, K, P = problem.n_vehicles, problem.n_steps, pairs.E.shape[1]
    lower_s, upper_s = build_bounds(p0, v0, pf, vf, n_vehicles=N, n_steps=K,
                                    h=problem.time_step,
                                    limits=problem.limits, n_pairs=P)
    cap = torch.clamp_max(torch.as_tensor(it_cap, dtype=torch.int32,
                                          device=p0.device),
                          problem.max_iterations)
    while True:
        active = _direct_cond(carry, cap)
        if not bool(active.any()):
            return carry
        new = _direct_body(carry, p0, v0, pf, vf,
                           angle_fn(lane_ids, carry.it), lower_s, upper_s,
                           params=params, pairs=pairs, problem=problem,
                           solver=solver)
        if not bool(active.all()):
            new = tree_map(
                lambda n_, o_: torch.where(lane_mask(active, n_), n_, o_),
                new, carry)
        carry = new


def _scp_finalize_direct(carry: SCPCarry, p0, v0, pf, vf, *,
                         pairs: PairIndex,
                         problem: ProblemConfig) -> SCPResult:
    """Final rollout and status codes.  With ``goal_project`` the output is
    the exact-terminal projection wherever that is collision-free."""
    h = problem.time_step
    a_out = carry.a
    if problem.goal_project:
        a_proj = _goal_projected(carry.a, p0, v0, pf, vf, problem)
        pos_p, _ = rollout(a_proj, p0, v0, h)
        feas_p = check_feasible(pos_p, pairs, problem.min_distance)
        a_out = torch.where(lane_mask(feas_p, a_proj), a_proj, carry.a)
    positions, velocities = rollout(a_out, p0, v0, h)
    feasible_final = check_feasible(positions, pairs, problem.min_distance)
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


class SCPEngine:
    """SCP solver for a fixed (problem, solver) configuration on one device
    (``device=None``: the card), direct method only."""

    def __init__(self, problem: ProblemConfig,
                 solver: SolverConfig | None = None, dtype=torch.float32,
                 device=None, seed: int = 0):
        if problem.n_steps < 2:
            raise ValueError(
                f"K = int(T/h) = {problem.n_steps}; need K >= 2")
        solver = solver if solver is not None else SolverConfig()
        if solver.method != "direct":
            raise NotImplementedError(
                "the CG (acceleration-space) method is not ported yet "
                "(ROADMAP Queue 1 item 7)")
        if solver.polish:
            raise NotImplementedError(
                "the active-set polish is not ported yet "
                "(ROADMAP Queue 1 item 7)")
        self.problem = problem
        self.solver = solver
        self.dtype = dtype
        self.device = resolve_device(device)
        self.seed = seed
        self.pairs = make_pair_index(problem.n_vehicles, dtype=dtype,
                                     device=self.device)
        self.solver_static = solver.static_part()
        self.solver_params = make_solver_params(solver, dtype, self.device)

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
        return _scp_start_direct(p0, v0, pf, vf, **self._kw())

    def step(self, carry, p0, v0, pf, vf, lane_ids, it_cap,
             angle_fn: AngleFn | None = None) -> SCPCarry:
        return _scp_step_direct(carry, p0, v0, pf, vf, lane_ids, it_cap,
                                angle_fn=angle_fn or self.default_angle_fn(),
                                **self._kw())

    def finalize(self, carry, p0, v0, pf, vf) -> SCPResult:
        return _scp_finalize_direct(carry, p0, v0, pf, vf, pairs=self.pairs,
                                    problem=self.problem)

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
        carry = self.start(p0, v0, pf, vf)
        carry = self.step(carry, p0, v0, pf, vf, lane_ids,
                          self.problem.max_iterations, angle_fn)
        return self.finalize(carry, p0, v0, pf, vf)


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
        if solver is None:
            solver = SolverConfig(method="direct", polish=False,
                                  adaptive_rho=False, max_iter=2000)
        self._solver_cfg = solver
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

    def _no_viz(self, *args, **kwargs):
        raise NotImplementedError(
            "the plots of the facade wait for the CLIs and the viz layer "
            "(ROADMAP Queue 1 item 8)")

    visualize_trajectories = _no_viz
    visualize_time_snapshots = _no_viz
