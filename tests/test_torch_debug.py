"""PyTorch port, the numerical sanitizer (``utils/debug.py``): the JAX
package's ``tests/test_debug.py`` cases (a clean solve fires no check, a
NaN input is caught, ``find_nan_lanes`` flags only the poisoned lane), and
what the checkify counterpart must keep: Inf is not a failure, a division
by zero is, the hand-written kernels' outputs are checked through their
wrappers' reports, and the postconditions on the result."""

import numpy as np
import pytest
import torch

from ba_path_planning_torch.solvers.scp import SCPEngine
from ba_path_planning_torch.utils import debug
from ba_path_planning_torch.utils.config import ProblemConfig, SolverConfig
from ba_path_planning_torch.utils.debug import (checked, checked_jit,
                                                find_nan_lanes)


def _engine():
    problem = ProblemConfig(n_vehicles=3, time_horizon=2.0, time_step=0.4,
                            min_distance=0.5, max_iterations=3)
    solver = SolverConfig(method="direct", polish=False, adaptive_rho=False,
                          max_iter=60, check_interval=30)
    return SCPEngine(problem, solver, dtype=torch.float32, device="cpu")


def _inputs(N=3):
    p0 = torch.tensor([[5.0, 5.0], [10.0, 10.0], [15.0, 5.0]])
    pf = torch.tensor([[15.0, 15.0], [5.0, 12.0], [10.0, 15.0]])
    v0 = torch.zeros((N, 2))
    return p0, v0, pf, v0


def test_clean_solve_passes_checks():
    eng = _engine()
    err, res = checked_jit(eng.solve_fn())(*_inputs())
    err.throw()          # no check fired
    assert err.get() is None
    assert bool(torch.isfinite(res.positions).all())
    # the checked call computes what the unchecked one does
    ref = eng.solve_fn()(*_inputs())
    np.testing.assert_array_equal(res.positions.numpy(),
                                  ref.positions.numpy())


def test_nan_input_is_caught():
    eng = _engine()
    p0, v0, pf, vf = _inputs()
    p0[1, 0] = float("nan")
    err, _ = checked(eng.solve_fn())(p0, v0, pf, vf)
    with pytest.raises(FloatingPointError, match="nan"):
        err.throw()


def test_find_nan_lanes_flags_only_poisoned_lane():
    eng = _engine()
    p0, v0, pf, vf = _inputs()
    B = 4
    p0b = p0.expand(B, 3, 2).clone()
    p0b[2, 0, 0] = float("nan")
    res = eng.solve_batch(p0b, v0.expand(B, 3, 2), pf.expand(B, 3, 2),
                          vf.expand(B, 3, 2))
    bad = find_nan_lanes(res).numpy()
    assert bad[2]
    assert not bad[0] and not bad[1] and not bad[3]


def test_inf_is_not_a_failure_and_division_by_zero_is():
    def open_bounds(x):
        return torch.clamp(x, -float("inf"), float("inf")) / 2.0
    err, out = checked(open_bounds, postconditions=False)(torch.ones(3))
    assert err.get() is None and float(out.sum()) == 1.5

    def divide(x, d):
        return x / d
    err, _ = checked(divide, postconditions=False)(torch.ones(3),
                                                   torch.tensor([1.0, 0.0,
                                                                 2.0]))
    with pytest.raises(FloatingPointError, match="division by zero"):
        err.throw()
    err, _ = checked(divide, postconditions=False)(torch.ones(3), 0)
    assert "division by zero" in err.get()
    err, _ = checked(divide, errors=debug.NAN_CHECKS,
                     postconditions=False)(torch.ones(3), 0)
    assert err.get() is None


def test_kernel_outputs_are_reported():
    """A kernel bound through ctypes is invisible to the dispatch mode: its
    wrapper's report is what the harness checks, and the first failure
    wins.  ``report`` does nothing outside a checked call."""
    debug.report("free", torch.tensor([float("nan")]))

    def fake_kernel_call(x):
        assert debug.active()
        y = x + 1.0
        debug.report("fake_kernel", y * float("nan"), y)
        return y
    err, _ = checked(fake_kernel_call, postconditions=False)(torch.ones(2))
    assert err.get() == ("nan in the output of aten.mul.Tensor")
    assert not debug.active()

    def quiet_kernel_call(x):
        out = torch.empty_like(x)     # the kernel's output buffer
        out.copy_(x)
        debug.report("fake_kernel", torch.tensor([float("nan")]))
        return out
    err, _ = checked(quiet_kernel_call, postconditions=False)(torch.ones(2))
    assert err.get() == "nan in the output of kernel fake_kernel"


def test_postconditions_fire_on_a_non_finite_result():
    res = SolverResult(positions=torch.tensor([[1.0, float("inf")]]),
                       accelerations=torch.zeros(1, 2),
                       iterations=torch.tensor([1]))
    err, _ = checked(lambda: res)()
    assert err.get() == "non-finite positions in SCP result"


class SolverResult:
    def __init__(self, **fields):
        self.__dict__.update(fields)
