"""The program's own spans in a ``torch.profiler`` trace, kept in memory.

The program names ranges of its solve path ``<layer>.<what>``
(``ba_path_planning_torch.utils.profiling.span``: ``mesh.call``,
``scp.step``, ``qp.factors``, ...); they are host ranges in the same event
stream as the card's operations, on the same clock.  Per span name this
gives the count, the host time (whole, and self: less the time of its
child spans), the device time and operations launched in it (whole, and
self: those whose innermost program span it is), and the card's idle time
whose innermost program span it is.

A device operation belongs to the innermost program span open when its
launch started on the host: the launch is the runtime or driver call of
the same correlation id (``cuda*`` and ``cu*`` host events: a profiler
whose events give no activity type names them only so; an operator's own
ids are of another count), and an operation whose launch is not in the
trace goes to ``(launch not found)``.  An idle gap belongs to the innermost
program span open at its middle, as ``tracing`` names gaps by host range.
Operations and gaps outside every program span go to
``(no program span)``.  Self device times of all names, those two rows
included, add up to ``device_s``; idle times to ``idle_s``.

:func:`reduce` and :func:`layer_numbers` are the reusable part.
:func:`from_events` finds the window, the busy union and the idle gaps
again, as ``tracing.summarize`` does; it goes once ``summarize`` hands
:func:`reduce` its own.  ``run.py`` does not call this module: the
benchmark's line carries none of these numbers.
"""

from __future__ import annotations

from . import tracing

PROGRAM_LAYERS = ("mesh", "scp", "qp")
NO_SPAN = "(no program span)"
NOT_FOUND = "(launch not found)"
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
FIELDS = ("count", "host_s", "self_s", "device_s", "device_self_s",
          "device_ops", "device_ops_self", "idle_s")


def is_program_span(name: str) -> bool:
    layer, dot, _ = name.partition(".")
    return bool(dot) and layer in PROGRAM_LAYERS


def _innermost(spans, times):
    """For each of ``times`` (sorted), the index in ``spans`` ((start, end)
    sorted by start, then by end, longest first) of the innermost span open
    at it, or None."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and spans[stack[-1]][1] < spans[i][0]:
                stack.pop()
            stack.append(i)
            i += 1
        while stack and spans[stack[-1]][1] < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def reduce(spans, launches, ops, idle) -> dict:
    """``spans``: (start, end, name) of the program spans; ``launches``:
    correlation id -> start of the host call that launched it; ``ops``:
    (start, end, correlation id or None) of the device operations, clipped
    to the window; ``idle``: (start, end) of the idle gaps.  Times in ns;
    the result in seconds: ``device_s``, ``idle_s`` and ``by_span``, name
    -> the fields of ``FIELDS``."""
    spans = sorted(spans, key=lambda sp: (sp[0], -sp[1]))
    ivs = [(s, e) for s, e, _ in spans]
    parent, stack = [], []
    for s, e in ivs:
        while stack and ivs[stack[-1]][1] <= s:
            stack.pop()
        parent.append(stack[-1] if stack else None)
        stack.append(len(parent) - 1)

    rows: dict = {}

    def row(name):
        return rows.setdefault(name, dict.fromkeys(FIELDS, 0))

    child_ns = [0] * len(spans)
    for i, (s, e, name) in enumerate(spans):
        r = row(name)
        r["count"] += 1
        r["host_s"] += e - s
        if parent[i] is not None:
            child_ns[parent[i]] += e - s
    for i, (s, e, name) in enumerate(spans):
        rows[name]["self_s"] += e - s - child_ns[i]

    found = sorted((launches[c], e - s) for s, e, c in ops
                   if c is not None and c in launches)
    lost = [e - s for s, e, c in ops if c is None or c not in launches]
    row(NO_SPAN)
    row(NOT_FOUND).update(device_self_s=sum(lost), device_ops_self=len(lost),
                          device_s=sum(lost), device_ops=len(lost))
    for (_, d), i in zip(found, _innermost(ivs, [t for t, _ in found])):
        r = row(NO_SPAN if i is None else spans[i][2])
        r["device_self_s"] += d
        r["device_ops_self"] += 1
        if i is None:
            r["device_s"] += d
            r["device_ops"] += 1
        seen = set()
        while i is not None:
            name = spans[i][2]
            if name not in seen:          # a name nested in itself counts once
                seen.add(name)
                rows[name]["device_s"] += d
                rows[name]["device_ops"] += 1
            i = parent[i]

    idle = sorted(idle)
    for (s, e), i in zip(idle, _innermost(ivs, [(s + e) // 2
                                                for s, e in idle])):
        row(NO_SPAN if i is None else spans[i][2])["idle_s"] += e - s

    ns = ("host_s", "self_s", "device_s", "device_self_s", "idle_s")
    by_span = {name: {k: (v * 1e-9 if k in ns else v) for k, v in r.items()}
               for name, r in rows.items()}
    return {"device_s": sum(e - s for s, e, _ in ops) * 1e-9,
            "idle_s": sum(e - s for s, e in idle) * 1e-9,
            "by_span": by_span}


def from_events(events) -> dict:
    """:func:`reduce` of raw profiler events
    (``prof.profiler.kineto_results.events()``) over the window of the
    ``tracing.CALL_RANGE`` ranges, with the window's ``window_s``,
    ``busy_s`` and ``calls``; {} where the trace has no call."""
    calls, marks, launches, dev = [], [], {}, []
    for ev in events:
        kind, name = tracing._kind(ev), ev.name()
        s, e = ev.start_ns(), ev.end_ns()
        get = getattr(ev, "correlation_id", None)
        corr = get() if get is not None else None
        if kind in tracing.DEVICE_KINDS:
            dev.append((s, e, corr))
        elif kind in LAUNCH_KINDS or (kind == "cpu_op"
                                      and name.startswith("cu")):
            launches[corr] = s
        elif kind in tracing.HOST_KINDS and name == tracing.CALL_RANGE:
            calls.append((s, e))
        elif kind in tracing.HOST_KINDS and is_program_span(name):
            marks.append((s, e, name))
    if not calls:
        return {}
    w0, w1 = min(s for s, _ in calls), max(e for _, e in calls)
    dev = [(max(s, w0), min(e, w1), c) for s, e, c in dev
           if e > w0 and s < w1]
    busy = tracing._union((s, e) for s, e, _ in dev)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    out = reduce(marks, launches, dev, idle)
    out.update(window_s=(w1 - w0) * 1e-9, calls=len(calls),
               busy_s=sum(e - s for s, e in busy) * 1e-9)
    return out


def layer_numbers(red: dict) -> dict:
    """The layers' numbers of a :func:`from_events` result, a traced call:
    the device time launched in the QP's set-up (``qp.factors``) and ADMM
    intervals (``qp.interval``) in ms, the host time of ``mesh.call`` less
    its waits on the card (the ``*.host_read`` and ``*.host_write`` spans)
    in ms, and the share of the window in which the card is idle with a
    span of each layer innermost, or none, in %."""
    rows, n = red["by_span"], red["calls"]

    def device_ms(name):
        return 1e3 * rows[name]["device_s"] / n if name in rows else None

    def idle_pct(names):
        return 100.0 * sum(rows[k]["idle_s"] for k in names
                           if k in rows) / red["window_s"]
    waits = sum(r["host_s"] for k, r in rows.items()
                if k.endswith((".host_read", ".host_write")))
    out = {"qp_factor_device_ms": device_ms("qp.factors"),
           "admm_interval_device_ms": device_ms("qp.interval"),
           "host_enqueue_traced_ms": (None if "mesh.call" not in rows else
                                      1e3 * (rows["mesh.call"]["host_s"]
                                             - waits) / n),
           "device_idle_pct": 100.0 * red["idle_s"] / red["window_s"]}
    for key, layer in (("driver", "mesh"), ("scp", "scp"), ("qp", "qp")):
        out[f"{key}_idle_pct"] = idle_pct(
            [k for k in rows if k.startswith(layer + ".")])
    out["unspanned_idle_pct"] = idle_pct([NO_SPAN])
    out["mesh_call_self_idle_pct"] = idle_pct(["mesh.call"])
    out["launch_not_found_pct"] = 100.0 * rows[NOT_FOUND]["device_self_s"] \
        / max(red["device_s"], 1e-30)
    return out


def table(reduced: dict, calls: int) -> list[str]:
    """The per-span table, a line a name, in ms a traced call, by device
    time launched (whole) first."""
    rows = sorted(reduced["by_span"].items(),
                  key=lambda kv: (-kv[1]["device_s"], kv[0]))
    out = [f"{'span':<20}{'count':>9}{'host':>10}{'self':>10}{'device':>10}"
           f"{'dev self':>10}{'ops':>9}{'ops self':>9}{'idle':>9}"]
    k = 1e3 / max(calls, 1)
    for name, r in rows:
        out.append(f"{name:<20}{r['count'] / max(calls, 1):>9.2f}"
                   f"{r['host_s'] * k:>10.3f}{r['self_s'] * k:>10.3f}"
                   f"{r['device_s'] * k:>10.3f}{r['device_self_s'] * k:>10.3f}"
                   f"{r['device_ops'] / max(calls, 1):>9.1f}"
                   f"{r['device_ops_self'] / max(calls, 1):>9.1f}"
                   f"{r['idle_s'] * k:>9.3f}")
    return out
