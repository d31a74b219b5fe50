"""Configuration layer of the PyTorch port.

Same frozen dataclasses and the same field values as
``ba_path_planning_tpu.utils.config``, with one rename: the JAX option
``pallas`` (route through the Pallas TPU kernels) is ``kernels`` here (route
through the hand-written CUDA kernels of ``ops/``).  ``SolverParams`` and
``make_solver_params`` mirror ``ba_path_planning_tpu.solvers.admm``: the
numeric settings as 0-d tensors of the working dtype.  ``load_yaml``,
``problem_from_dict`` and ``solver_from_dict`` read the JAX package's config
files; :func:`solver_from_dict` maps their ``pallas`` to ``kernels``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``.  None means the card: an entry
    point runs on "cuda" unless its caller names another device, and fails
    where there is no card instead of falling back to the CPU."""
    return torch.device("cuda" if device is None else device)


@dataclass(frozen=True)
class Limits:
    """State-space box limits (reference defaults)."""
    vel_min: float = -2.0
    vel_max: float = 2.0
    acc_min: float = -15.0
    acc_max: float = 15.0
    jerk_min: float = -20.0
    jerk_max: float = 20.0
    pos_min: tuple[float, float] = (0.0, 0.0)
    pos_max: tuple[float, float] = (20.0, 20.0)


@dataclass(frozen=True)
class ProblemConfig:
    """SCP problem definition.

    ``stop_mode``: "reference" stops on step-norm convergence only;
    "feasible" keeps iterating until the iterate is collision-free.
    ``goal_project``: close the terminal residual of the fixed-budget ADMM
    with the exact least-norm acceleration correction
    (``DoubleIntegrator2D.goal_projection``).
    """
    n_vehicles: int = 5
    time_horizon: float = 3.0
    time_step: float = 0.1
    min_distance: float = 0.1
    space_dims: tuple[float, float, float, float] = (0.0, 0.0, 20.0, 20.0)
    max_iterations: int = 15
    convergence_tolerance: float = 1.5e-2
    stop_mode: str = "reference"
    goal_project: bool = False
    vel_min: float = -2.0
    vel_max: float = 2.0
    acc_min: float = -15.0
    acc_max: float = 15.0
    jerk_min: float = -20.0
    jerk_max: float = 20.0

    @property
    def n_steps(self) -> int:
        """K = int(T/h), truncating like the reference."""
        return int(self.time_horizon / self.time_step)

    @property
    def n_pairs(self) -> int:
        return self.n_vehicles * (self.n_vehicles - 1) // 2

    @property
    def limits(self) -> Limits:
        return Limits(vel_min=self.vel_min, vel_max=self.vel_max,
                      acc_min=self.acc_min, acc_max=self.acc_max,
                      jerk_min=self.jerk_min, jerk_max=self.jerk_max,
                      pos_min=tuple(self.space_dims[:2]),
                      pos_max=tuple(self.space_dims[2:]))

    def replace(self, **kw) -> "ProblemConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class SolverStatic:
    """Structural solver options: they choose code paths, not numbers."""
    rho_eq_scale: float = 1e3
    adaptive_rho: bool = True
    polish: bool = True
    operator_impl: str = "scan"
    method: str = "cg"
    kernels: bool = False
    fused: bool = False
    group: int = 0
    factor_dtype: str = "f32"
    factor_form: str = "L"
    ns_iters: int = 0
    ns_anchor: int = 0
    ns_precision: str = "highest"
    assemble_precision: str = "highest"


@dataclass(frozen=True)
class SolverConfig:
    """Batched ADMM QP solver settings (OSQP-compatible defaults).

    Field for field the JAX ``SolverConfig``; see its docstrings for the
    meaning of each.  ``kernels`` replaces ``pallas``.
    """
    rho: float = 0.1
    sigma: float = 1e-6
    alpha: float = 1.6
    eps_abs: float = 1e-3
    eps_rel: float = 1e-3
    max_iter: int = 4000
    check_interval: int = 25
    rho_eq_scale: float = 1e3
    adaptive_rho: bool = True
    cg_iters: int = 20
    cg_tol: float = 1e-7
    polish: bool = True
    polish_cg_iters: int = 40
    operator_impl: str = "scan"
    method: str = "cg"
    kernels: bool = False
    fused: bool = False
    group: int = 0
    factor_dtype: str = "f32"
    factor_form: str = "L"
    ns_iters: int = 0
    ns_anchor: int = 0
    # accepted as in JAX; on the card the NS-chain kernel serves "default"
    # with its three-pass products, and banded.factorize_X takes the
    # products in FP32 for each value (banded.NS_KERNEL_PRECISION)
    ns_precision: str = "highest"
    # accepted as in JAX, assembled in FP32 for each value (banded.qp_route)
    assemble_precision: str = "highest"
    col_penalty: float = float("inf")
    col_rho_boost: float = 1.0
    collision_margin: float = 0.0

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)

    def static_part(self) -> SolverStatic:
        return SolverStatic(**{f.name: getattr(self, f.name)
                               for f in dataclasses.fields(SolverStatic)})

    @classmethod
    def production(cls, kernels: bool | None = None,
                   n_vehicles: int | None = None,
                   problem: ProblemConfig | None = None) -> "SolverConfig":
        """The high-throughput configuration: state-space direct solver,
        X-form factors from 2 Newton-Schulz iterations, a fixed 25-iteration
        ADMM budget without adaptive rho or polish, and constraint
        tightening.  The values are the JAX package's; their validated
        envelope is N=10..40 at K=50, h=0.2, R=0.8.

        ``kernels=None`` routes through the kernel wrappers of ``ops/``.
        That route is valid on every device: a wrapper launches its CUDA
        kernel for CUDA tensors and runs its plain PyTorch version for CPU
        tensors.
        """
        if kernels is None:
            kernels = True
        cfg = cls(method="direct", kernels=kernels, fused=kernels, rho=2.6,
                  max_iter=25, check_interval=25, collision_margin=0.13,
                  polish=False, adaptive_rho=False, factor_form="X",
                  ns_iters=2, alpha=1.9, col_rho_boost=2.5,
                  ns_precision="high", assemble_precision="default")
        if problem is not None and n_vehicles is None:
            n_vehicles = problem.n_vehicles
        if n_vehicles is not None and n_vehicles >= 25:
            cfg = cfg.replace(rho=5.2)
        if problem is not None:
            in_envelope = (problem.n_steps == 50
                           and abs(problem.time_step - 0.2) < 1e-9
                           and abs(problem.min_distance - 0.8) < 1e-9)
            if not in_envelope:
                cfg = cfg.replace(assemble_precision="highest")
        return cfg

    @classmethod
    def latency(cls, kernels: bool | None = None) -> "SolverConfig":
        """Single-scenario latency configuration: :meth:`production` with
        the ADMM budget split into 9-iteration intervals and a residual
        check after each, so a scenario pays the intervals it needs (at most
        three) instead of the whole 25-iteration budget."""
        return cls.production(kernels).replace(max_iter=27, check_interval=9)


class SolverParams(NamedTuple):
    """Numeric solver settings as 0-d tensors."""
    rho: torch.Tensor
    sigma: torch.Tensor
    alpha: torch.Tensor
    eps_abs: torch.Tensor
    eps_rel: torch.Tensor
    cg_tol: torch.Tensor
    col_penalty: torch.Tensor
    col_rho_boost: torch.Tensor
    col_margin: torch.Tensor
    max_iter: torch.Tensor
    check_interval: torch.Tensor
    cg_iters: torch.Tensor
    polish_cg_iters: torch.Tensor


def make_solver_params(cfg: SolverConfig, dtype=torch.float32,
                       device=None) -> SolverParams:
    """Float settings on ``device``; the integer ones are loop bounds read
    by the host, so they stay on the CPU."""
    def f(v):
        return torch.tensor(v, dtype=dtype, device=device)

    def i(v):
        return torch.tensor(v, dtype=torch.int32)

    return SolverParams(rho=f(cfg.rho), sigma=f(cfg.sigma), alpha=f(cfg.alpha),
                        eps_abs=f(cfg.eps_abs), eps_rel=f(cfg.eps_rel),
                        cg_tol=f(cfg.cg_tol), col_penalty=f(cfg.col_penalty),
                        col_rho_boost=f(cfg.col_rho_boost),
                        col_margin=f(cfg.collision_margin),
                        max_iter=i(cfg.max_iter),
                        check_interval=i(cfg.check_interval),
                        cg_iters=i(cfg.cg_iters),
                        polish_cg_iters=i(cfg.polish_cg_iters))


def load_yaml(path: str) -> dict[str, Any]:
    """Load a YAML config file (PyYAML if available, minimal parser
    otherwise)."""
    try:
        import yaml
    except ImportError:
        return _parse_simple_yaml(path)
    with open(path) as f:
        return yaml.safe_load(f)


# YAML's boolean and null words, as PyYAML reads them.  The JAX package's
# fallback parser keeps them as strings, so there ``kernels: false`` would
# be the truthy string "false".
_YAML_WORDS = {**dict.fromkeys(("true", "yes", "on"), True),
               **dict.fromkeys(("false", "no", "off"), False),
               **dict.fromkeys(("null", "~"), None)}


def _parse_simple_yaml(path: str) -> dict[str, Any]:
    """Tiny fallback parser: flat and one-level-nested 'key: value' YAML,
    values as Python literals or YAML's boolean and null words."""
    import ast
    out: dict[str, Any] = {}
    stack = [out]
    indents = [0]
    with open(path) as f:
        for raw in f:
            line = raw.split('#', 1)[0].rstrip()
            if not line.strip():
                continue
            indent = len(line) - len(line.lstrip())
            key, _, val = line.strip().partition(':')
            val = val.strip()
            while indent < indents[-1]:
                stack.pop()
                indents.pop()
            if not val:
                child: dict[str, Any] = {}
                stack[-1][key] = child
                stack.append(child)
                indents.append(indent + 2)
            elif val.lower() in _YAML_WORDS:
                stack[-1][key] = _YAML_WORDS[val.lower()]
            else:
                try:
                    stack[-1][key] = ast.literal_eval(val)
                except (ValueError, SyntaxError):
                    stack[-1][key] = val
    return out


def problem_from_dict(d: dict[str, Any]) -> ProblemConfig:
    """A ProblemConfig from the known fields of ``d``; others are ignored."""
    fields = {f.name for f in dataclasses.fields(ProblemConfig)}
    kw = {k: v for k, v in d.items() if k in fields}
    if 'space_dims' in kw:
        kw['space_dims'] = tuple(kw['space_dims'])
    return ProblemConfig(**kw)


def solver_from_dict(d: dict[str, Any]) -> SolverConfig:
    """A SolverConfig from the known fields of ``d``; others are ignored.
    The JAX package's ``pallas`` is read as ``kernels``; ValueError if
    both are given and differ."""
    d = dict(d)
    if 'pallas' in d:
        pallas = d.pop('pallas')
        if 'kernels' in d and d['kernels'] != pallas:
            raise ValueError(
                f"pallas={pallas!r} and kernels={d['kernels']!r} disagree; "
                "kernels is the port's name for the JAX option pallas")
        d['kernels'] = pallas
    fields = {f.name for f in dataclasses.fields(SolverConfig)}
    return SolverConfig(**{k: v for k, v in d.items() if k in fields})
