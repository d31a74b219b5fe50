"""PyTorch/CUDA port of the SCP multi-vehicle path planner.

Mirrors the layout and function names of ``ba_path_planning_tpu`` (the JAX
reference, which stays beside it), with the same public API: ``SCP``,
``generate_positions`` and ``make_boxplot`` of the reference package, plus
``SCPEngine``, ``ShardedSCPSolver`` and ``generate_scenario_batch``.  Plain
tensor code is PyTorch; the Pallas kernels of the JAX package are
hand-written CUDA kernels for Hopper (``csrc/``), built with ``nvcc`` at
first use.  This package never imports JAX.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy exports: importing the package builds no kernel and imports
    # neither the solver stack nor matplotlib.
    if name == "SCP":
        from .solvers.scp import SCP
        return SCP
    if name == "SCPEngine":
        from .solvers.scp import SCPEngine
        return SCPEngine
    if name == "SCPResult":
        from .solvers.scp import SCPResult
        return SCPResult
    if name == "ShardedSCPSolver":
        from .parallel.mesh import ShardedSCPSolver
        return ShardedSCPSolver
    if name == "generate_positions":
        from .scenarios import generate_positions
        return generate_positions
    if name == "generate_scenario_batch":
        from .scenarios import generate_scenario_batch
        return generate_scenario_batch
    if name == "make_boxplot":
        from .viz.boxplot import make_boxplot
        return make_boxplot
    if name in ("ProblemConfig", "SolverConfig", "Limits"):
        from .utils import config as _c
        return getattr(_c, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["SCP", "SCPEngine", "SCPResult", "ShardedSCPSolver",
           "generate_positions", "generate_scenario_batch", "make_boxplot",
           "ProblemConfig", "SolverConfig", "Limits"]
