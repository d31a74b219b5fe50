"""What counts as a solve, and the comparison that decides ``correct``.

A solve counts (it is "ok") when the accelerations it returns, rolled out
in float64 from the scenario's start at rest, keep every pair of vehicles
at least R - 0.01 apart at every step and end within ``GOAL_TOL`` of every
goal.

``correct`` compares the program's answers with the reference's, scenario
by scenario, on a sample drawn from the seed (``compare``): the gap of an
answer is the widest distance, over vehicles and steps, between the
positions the program returned and the reference's float64 solve of the
same scenario.  Beside those readings ``not_ok_pct`` is the share of
answers that are not ok: of every answer of the window for the program, of
the sample for the control.  The numbers compared and their limits are the
configuration's (``limits`` in its file).
"""

from __future__ import annotations

import torch

from . import scp

GOAL_TOL = 0.05        # [m]


def ok(accelerations, p0, pf, spec: scp.Spec, block: int = 4096):
    """(B,) bool: each answer collision-free and goal-exact, judged in
    float64 on the device of ``accelerations`` in blocks of scenarios."""
    B, N = p0.shape[:2]
    i, j = scp.pair_index(N, accelerations.device)
    out = []
    for lo in range(0, B, block):
        a = accelerations[lo:lo + block].to(torch.float64)
        q0 = p0[lo:lo + block].to(a.device, torch.float64)
        qf = pf[lo:lo + block].to(a.device, torch.float64)
        pos, _, pK, _ = scp.rollout(a, q0, torch.zeros_like(q0), spec.h)
        goal = (pK - qf).norm(dim=-1).amax(-1) < GOAL_TOL
        out.append(goal & scp.collision_free(pos, spec.R, i, j))
    return torch.cat(out)


def gaps(positions, ref_positions):
    """(S,) the widest position gap [m] of each answer."""
    d = positions.to(torch.float64) - ref_positions.to(torch.float64)
    return d.norm(dim=-1).flatten(1).amax(1)


def readings(prog: dict, ref: scp.Result) -> dict:
    """The numbers of the comparison, from the program's answers ``prog``
    (positions, iterations, status of the sampled scenarios) and the
    reference's solve of the same scenarios:

    * ``gap_p50_m``, ``gap_p75_m``, ``gap_p90_m``: quantiles over the sample
      of the answers' widest position gap;
    * ``gap_max_m``: the widest gap of an answer whose SCP count and status
      equal the reference's (inf where none does);
    * ``count_mismatch_pct``: the share of answers whose SCP count or status
      differs from the reference's.

    The configuration's ``limits`` name those that decide ``correct``.
    """
    g = gaps(prog["positions"], ref.positions.cpu())
    same = ((prog["iterations"].to(torch.int64) == ref.iterations.cpu())
            & (prog["status"].to(torch.int64) == ref.status.cpu()))
    q = torch.quantile(g, torch.tensor([0.5, 0.75, 0.9], dtype=g.dtype))
    return {
        "gap_p50_m": float(q[0]), "gap_p75_m": float(q[1]),
        "gap_p90_m": float(q[2]),
        "gap_max_m": float(g[same].max()) if bool(same.any())
        else float("inf"),
        "count_mismatch_pct": 100.0 * float((~same).double().mean()),
    }


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}) for the
    numbers that ``limits`` names."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    good = all(c["value"] <= c["limit"] for c in checks.values())
    return good, checks
