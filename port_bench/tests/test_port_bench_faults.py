"""A run with the timed path broken underneath comes out as not correct,
once for each fault the cells can have: an SCP step that returns its state
unchanged, half of the batch left out (its answers copied from the other
half), and an answer altered where it is produced, in every lane or in a
fifth of them.  (There is no exchange between chips: every cell runs on
one.)  The look for a card is skipped; on the CPU the run is made at a
small size, on a card (marked ``gpu``) at the cell's own batch and chunk."""

import pytest
import torch

from ba_path_planning_torch.parallel import mesh
from ba_path_planning_torch.solvers import scp
from helpers import small_cell
from port_bench import registry, run


def _state_unchanged(monkeypatch):
    body = scp._direct_body

    def stuck(carry, *args, **kw):
        new = body(carry, *args, **kw)
        return new._replace(a=carry.a, y=carry.y, stop=carry.stop)
    monkeypatch.setattr(scp, "_direct_body", stuck)


def _half_left_out(monkeypatch):
    solve = mesh.ShardedSCPSolver.solve_compacted

    def half(self, p0, v0, pf, vf, *args, **kw):
        B = p0.shape[0] // 2
        res = solve(self, p0[:B], v0[:B], pf[:B], vf[:B], *args,
                    **dict(kw, chunk=min(kw.get("chunk") or B, B)))
        return type(res)(*(torch.cat([t, t]) for t in res))
    monkeypatch.setattr(mesh.ShardedSCPSolver, "solve_compacted", half)


def _altered(monkeypatch, share):
    final = scp._scp_finalize_direct

    def altered(carry, *args, **kw):
        a = carry.a.clone()
        lo = a.shape[0] - int(a.shape[0] * share)
        a[lo:, 0, :5, 0] += 1.0
        return final(carry._replace(a=a), *args, **kw)
    monkeypatch.setattr(scp, "_scp_finalize_direct", altered)


def _answer_altered(monkeypatch):
    _altered(monkeypatch, 1.0)


def _fifth_altered(monkeypatch):
    _altered(monkeypatch, 0.2)


FAULTS = [_state_unchanged, _half_left_out, _answer_altered, _fifth_altered]


@pytest.mark.parametrize("fault", FAULTS,
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    line, checks = run.run_cell(small_cell(batch=10, chunk=5, sample=40),
                                2 ** 31 + 3, 0.3, False, "cpu")
    assert not line["correct"], checks


@pytest.mark.gpu
@pytest.mark.parametrize("fault", FAULTS,
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("workload", ["fleet20.batch4096"])
def test_a_broken_timed_path_is_not_correct_on_the_card(workload, fault,
                                                        monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fault(monkeypatch)
    line, checks = run.run_cell(registry.cell(workload), 2 ** 31 + 5, 1.0,
                                False, "cuda:0")
    print(workload, fault.__name__, checks)
    assert not line["correct"], checks
