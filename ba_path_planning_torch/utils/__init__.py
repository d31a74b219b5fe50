"""Configuration, config files and checkpoints of the PyTorch port."""

from .config import (Limits, ProblemConfig, SolverConfig, load_yaml,
                     problem_from_dict, solver_from_dict)

__all__ = ["Limits", "ProblemConfig", "SolverConfig", "load_yaml",
           "problem_from_dict", "solver_from_dict"]
