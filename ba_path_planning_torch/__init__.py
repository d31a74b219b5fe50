"""PyTorch/CUDA port of the SCP multi-vehicle path planner.

Mirrors the layout and function names of ``ba_path_planning_tpu`` (the JAX
reference, which stays beside it).  Plain tensor code is PyTorch; the two
Pallas kernels of the main path are hand-written CUDA kernels for Hopper
(``csrc/``), built with ``nvcc`` at first use.  This package never imports
JAX.
"""

__version__ = "0.1.0"
