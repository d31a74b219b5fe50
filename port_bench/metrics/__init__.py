"""Per-layer metrics, one module each, found by name
(``registry.metric_module``).  A module gives its ``LAYER``, ``UNIT``,
``BETTER``, ``SOURCE``, the end-to-end metric it ``MOVES``, and
``read(ctx)``: the metric's value from a run's context
(``port_bench.run.Context``), or None where the run has nothing to read it
from; the run then leaves it out of its line."""
