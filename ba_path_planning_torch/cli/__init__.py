"""Command-line tools of the PyTorch port (counterparts of
``ba_path_planning_tpu.cli``): ``compute_trajectories``,
``compute_trajectories_batch``, ``position_generator`` and ``boxplot``, each
run as ``python -m ba_path_planning_torch.cli.<name>``."""
