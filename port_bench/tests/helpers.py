"""Small cells for the CPU tests: a cell of BENCHMARK.json cut to a few
vehicles, a few scenarios a call and a short window."""

import copy

from port_bench import registry


def small_cell(workload="fleet20.batch4096", n_vehicles=8, batch=8,
               chunk=4, sample=8, horizon=10.0, max_scp=15, solver=None):
    """``solver``: settings that the program's preset changes at
    ``n_vehicles`` (its rho from N = 25 on)."""
    c = registry.cell(workload)
    cfg = copy.deepcopy(c.config)
    cfg["problem"].update(n_vehicles=n_vehicles, time_horizon=horizon,
                          max_iterations=max_scp)
    cfg["solver"].update(solver or {})
    cfg["ref_block"] = sample
    tr = dict(c.traffic, batch=batch, chunk=chunk, pool_batches=2,
              warmup_calls=1, check_sample=sample, trace_calls=2)
    return registry.Cell(c.workload, cfg, tr, c.end_to_end, c.per_layer)
