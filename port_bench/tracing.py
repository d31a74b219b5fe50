"""Reduce a ``torch.profiler`` trace, kept in memory, to the numbers the
traced run reports: the traced window (from the start of the first of the
benchmark's ``port_bench.call`` ranges to the end of the last), the device
busy time (the union of the kernel, copy and set intervals in it), the
device operations, the device's share of the top kernels, and the idle gaps
by what the host was doing in them (the innermost host range open at the
middle of the gap).  No trace file is written."""

from __future__ import annotations

from collections import defaultdict

CALL_RANGE = "port_bench.call"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _innermost(host, times):
    """For each time of ``times`` (sorted), the name of the innermost host
    range open at it (the latest-starting one that covers it), else
    "(no host range)": one sweep over ``host`` (sorted by start) with a
    stack of the open ranges."""
    names, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        names.append(stack[-1][2] if stack else "(no host range)")
    return names


def _kind(ev) -> str:
    """The profiler's activity type of a raw event (read from its device
    and name where the event does not give it)."""
    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    annotation = getattr(ev, "is_user_annotation", lambda: False)()
    if str(ev.device_type()).endswith("CUDA"):
        name = ev.name()
        if annotation or name == CALL_RANGE:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    return "user_annotation" if annotation else "cpu_op"


def summarize(events) -> dict:
    """From raw profiler events (``prof.profiler.kineto_results.events()``):
    ``window_s``, ``busy_s``, ``device_ops`` (the count of device
    operations in the window), ``calls`` (the traced calls), ``breakdown``
    (top device operations and idle gaps, seconds each)."""
    calls, dev, host = [], [], []
    for ev in events:
        kind = _kind(ev)
        s, e = ev.start_ns(), ev.end_ns()
        if kind in DEVICE_KINDS:
            dev.append((s, e, ev.name()))
        elif kind in HOST_KINDS:
            if ev.name() == CALL_RANGE:
                calls.append((s, e))
            host.append((s, e, ev.name()))
    if not calls:
        return {}
    w0 = min(s for s, _ in calls)
    w1 = max(e for _, e in calls)
    dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev
           if e > w0 and s < w1]
    busy = _union((s, e) for s, e, _ in dev)
    busy_ns = sum(e - s for s, e in busy)
    by_kernel = defaultdict(int)
    for s, e, n in dev:
        by_kernel[n] += e - s
    host.sort(key=lambda h: (h[0], -h[1]))
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    gaps = defaultdict(int)
    for (s, e), name in zip(idle, _innermost(host, [(s + e) // 2
                                                    for s, e in idle])):
        gaps[name] += e - s

    def top(d):
        return [[k, v * 1e-9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy_ns * 1e-9,
            "device_ops": len(dev), "calls": len(calls),
            "breakdown": {"device_ops": top(by_kernel),
                          "idle_gaps": top(gaps)}}
