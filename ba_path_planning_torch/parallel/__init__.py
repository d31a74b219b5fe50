"""Parallel axes of the PyTorch port over ``torch.distributed``: scenarios
(``mesh.py``), agent pairs (``pair_sharded.py``) and the horizon
(``horizon_sharded.py``), and the multi-process plumbing
(``distributed.py``)."""

from .mesh import (SCENARIO_AXIS, Mesh, ShardedSCPSolver, make_mesh,
                   pad_to_multiple)
from .pair_sharded import (PAIR_AXIS, PairShardedSCPSolver, make_pair_mesh,
                           padded_pair_index)

__all__ = ["SCENARIO_AXIS", "Mesh", "ShardedSCPSolver", "make_mesh",
           "pad_to_multiple", "PAIR_AXIS", "PairShardedSCPSolver",
           "make_pair_mesh", "padded_pair_index"]
