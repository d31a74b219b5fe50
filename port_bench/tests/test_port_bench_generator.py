"""The frozen generator draws what the program's generator draws today."""

import pytest
import torch

from ba_path_planning_torch.scenarios import generate_scenario_batch
from port_bench.generator import scenario_batch


@pytest.mark.parametrize("seed,batch,n", [(0, 5, 3), (123, 16, 6),
                                          (2 ** 31 + 7, 9, 20)])
def test_frozen_generator_draws_the_programs_scenarios(seed, batch, n):
    init, final, ok = scenario_batch(seed, batch, n, 0.8)
    sc = generate_scenario_batch(seed, batch, n_vehicles=n,
                                 min_distance=0.8, dtype=torch.float64,
                                 device="cpu")
    assert torch.equal(init, sc.initial)
    assert torch.equal(final, sc.final)
    assert torch.equal(ok, sc.ok)
