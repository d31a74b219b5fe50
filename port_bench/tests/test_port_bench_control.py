"""The lower-precision control must come out as not correct: the
reference put in the program's place with every matrix product on TF32
operands fails the configuration's limits.  On the CPU at a size a test
run holds; on a card (marked ``gpu``) at a larger one."""

import pytest
import torch

from helpers import small_cell
from port_bench import control, run
from port_bench.reference import judge

# the production preset's rho from N = 25 on
_PRESET_RHO = {26: {"rho": 5.2}, 40: {"rho": 5.2}}


def _readings(cell, device, seed):
    solver = run.build_solver(cell.config, device)
    r = control.readings_for_seed(cell, solver, seed, device)
    ctl_ok, checks = judge.verdict(r["control"], cell.config["limits"])
    return r, ctl_ok, checks


@pytest.mark.parametrize("n", [20, 26])      # the grouped sweep, the fused X
def test_the_control_is_not_correct_on_the_cpu(n):
    cell = small_cell(n_vehicles=n, batch=4, chunk=4, sample=4,
                      solver=_PRESET_RHO.get(n))
    r, ctl_ok, checks = _readings(cell, "cpu", 3)
    assert not ctl_ok, checks
    # four answers are too few for the program's limits; the control's
    # gaps stand far above the program's all the same
    assert r["control"]["gap_p75_m"] > 10 * r["program"]["gap_p75_m"]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [20, 40])
def test_the_control_is_not_correct_on_the_card(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = small_cell(n_vehicles=n, batch=64, chunk=32, sample=32,
                      solver=_PRESET_RHO.get(n))
    r, ctl_ok, checks = _readings(cell, "cuda:0", 5)
    if n == 20:          # the configuration's own size, where its limits hold
        assert judge.verdict(r["program"], cell.config["limits"])[0], r
    assert not ctl_ok, checks
    assert r["control"]["gap_p75_m"] > 10 * r["program"]["gap_p75_m"]
