"""Scenario generation of the PyTorch port (``torch.Generator`` draws)."""

from .generator import (Scenario, generate_scenario, generate_scenario_batch,
                        generate_positions, minimum_distance,
                        print_distance_analysis, visualize_scenario)

__all__ = ["Scenario", "generate_scenario", "generate_scenario_batch",
           "generate_positions", "minimum_distance",
           "print_distance_analysis", "visualize_scenario"]
