"""The program's spans in a trace (``port_bench/spans.py``): hand-made
events with correlation ids give the device time, launches and idle time
by span, self time against whole time and the bucket of operations whose
launch is not in the trace, and what comes off ``mesh.call``'s host time
as waits; a small profiled call on the CPU gives every span of the solve
path and as many reads and writes as the call counted."""

from pytest import approx

from helpers import small_cell
from port_bench import run, spans, tracing

from test_port_bench_tracing import Ev


class CEv(Ev):
    def __init__(self, kind, name, s, e, corr=None):
        super().__init__(kind, name, s, e)
        self.c = corr

    def correlation_id(self):
        return self.c


def _events():
    """One call [0, 200): mesh.call [10, 190) holds scp.step [20, 120),
    which holds qp.factors [30, 60) and scp.host_read [100, 118); the
    launches start at 35 (in qp.factors), 70 (in scp.step), 150 (in
    mesh.call alone) and 195 (in no span); one kernel's launch is not in
    the trace."""
    return [
        CEv("user_annotation", tracing.CALL_RANGE, 0, 200),
        CEv("user_annotation", "mesh.call", 10, 190),
        CEv("user_annotation", "scp.step", 20, 120),
        CEv("user_annotation", "qp.factors", 30, 60),
        CEv("user_annotation", "scp.host_read", 100, 118),
        CEv("cpu_op", "aten::mm", 33, 40, corr=1),      # a CPU op's own id
        CEv("cuda_runtime", "cudaLaunchKernel", 35, 37, corr=7),
        CEv("cuda_runtime", "cudaLaunchKernel", 70, 72, corr=8),
        CEv("cuda_runtime", "cudaMemcpyAsync", 150, 152, corr=9),
        CEv("cuda_driver", "cuLaunchKernel", 195, 196, corr=10),
        CEv("kernel", "chain", 40, 80, corr=7),
        CEv("kernel", "sweep", 80, 110, corr=8),
        CEv("gpu_memcpy", "Memcpy DtoH", 160, 170, corr=9),
        CEv("kernel", "tail", 196, 198, corr=10),
        CEv("kernel", "lost", 175, 180, corr=99),
        CEv("gpu_user_annotation", "qp.factors", 40, 80),
    ]


def test_device_time_and_launches_by_span():
    red = spans.from_events(_events())
    rows = red["by_span"]
    assert red["calls"] == 1 and red["window_s"] == approx(200e-9)
    assert red["device_s"] == approx((40 + 30 + 10 + 2 + 5) * 1e-9)
    assert rows["qp.factors"]["device_s"] == approx(40e-9)
    assert rows["qp.factors"]["device_ops"] == 1
    # scp.step launched the sweep itself and holds qp.factors' chain
    assert rows["scp.step"]["device_self_s"] == approx(30e-9)
    assert rows["scp.step"]["device_s"] == approx(70e-9)
    assert rows["scp.step"]["device_ops"] == 2
    assert rows["mesh.call"]["device_s"] == approx(80e-9)
    assert rows["mesh.call"]["device_ops_self"] == 1
    assert rows[spans.NO_SPAN]["device_s"] == approx(2e-9)
    assert rows[spans.NOT_FOUND]["device_s"] == approx(5e-9)
    assert rows[spans.NOT_FOUND]["device_ops"] == 1
    assert sum(r["device_self_s"] for r in rows.values()) == approx(
        red["device_s"])
    assert sum(r["device_ops_self"] for r in rows.values()) == 5


class BareEv:
    """An event of a profiler whose events give no activity type: the
    runtime's calls then read as CPU operators."""

    def __init__(self, ev):
        self.ev = ev

    def __getattr__(self, name):
        if name == "activity_type":
            raise AttributeError(name)
        return getattr(self.ev, name)

    def device_type(self):
        kind = self.ev.activity_type()
        return "DeviceType.CUDA" if kind in ("kernel", "gpu_memcpy",
                                             "gpu_user_annotation") \
            else "DeviceType.CPU"

    def is_user_annotation(self):
        return self.ev.activity_type() in ("user_annotation",
                                           "gpu_user_annotation")


def test_launches_are_found_without_activity_types():
    assert not hasattr(BareEv(_events()[0]), "activity_type")
    bare = spans.from_events([BareEv(ev) for ev in _events()])
    assert bare == spans.from_events(_events())


def test_self_time_is_whole_time_less_the_children():
    rows = spans.from_events(_events())["by_span"]
    assert rows["mesh.call"]["host_s"] == approx(180e-9)
    assert rows["mesh.call"]["self_s"] == approx((180 - 100) * 1e-9)
    assert rows["scp.step"]["self_s"] == approx((100 - 30 - 18) * 1e-9)
    assert rows["qp.factors"]["self_s"] == approx(30e-9)
    assert rows["scp.host_read"]["count"] == 1
    assert "port_bench.call" not in rows and "aten::mm" not in rows


def test_idle_time_by_span_and_layer():
    red = spans.from_events(_events())
    rows = red["by_span"]
    # busy [40, 110), [160, 170), [175, 180), [196, 198); idle [0, 40)
    # (middle 20: scp.step), [110, 160) (135: mesh.call), [170, 175)
    # (172: mesh.call), [180, 196) (188: mesh.call), [198, 200) (199: none)
    assert red["idle_s"] == approx((40 + 50 + 5 + 16 + 2) * 1e-9)
    assert rows["scp.step"]["idle_s"] == approx(40e-9)
    assert rows["mesh.call"]["idle_s"] == approx(71e-9)
    assert rows[spans.NO_SPAN]["idle_s"] == approx(2e-9)
    assert red["busy_s"] == approx(tracing.summarize(_events())["busy_s"])
    num = spans.layer_numbers(red)
    assert num["device_idle_pct"] == approx(100 * 113 / 200)
    assert num["scp_idle_pct"] == approx(100 * 40 / 200)
    assert num["driver_idle_pct"] == approx(100 * 71 / 200)
    assert num["qp_idle_pct"] == approx(0.0)
    assert (num["driver_idle_pct"] + num["scp_idle_pct"] + num["qp_idle_pct"]
            + num["unspanned_idle_pct"]) == approx(num["device_idle_pct"])
    assert num["qp_factor_device_ms"] == approx(40e-6)
    assert num["host_enqueue_traced_ms"] == approx((180 - 18) * 1e-6)
    assert num["launch_not_found_pct"] == approx(100 * 5 / 87)


def test_events_without_correlation_ids_land_in_one_bucket():
    """The tracing test's hand-made events carry no correlation id and no
    program span: every operation's launch is not found, every idle gap is
    outside the program's spans, and ``summarize`` reads them as before."""
    events = [Ev("user_annotation", tracing.CALL_RANGE, 0, 100),
              Ev("cuda_runtime", "cudaLaunchKernel", 10, 12),
              Ev("kernel", "k1", 20, 50), Ev("kernel", "k2", 45, 60)]
    red = spans.from_events(events)
    rows = red["by_span"]
    assert set(rows) == {spans.NO_SPAN, spans.NOT_FOUND}
    assert rows[spans.NOT_FOUND]["device_s"] == approx(45e-9)
    assert rows[spans.NO_SPAN]["idle_s"] == approx(60e-9)
    assert set(tracing.summarize(events)) == {
        "window_s", "busy_s", "device_ops", "calls", "breakdown"}
    assert spans.from_events(events[1:]) == {}


def test_host_enqueue_leaves_out_reads_and_writes():
    """A copy to the card waits as a read does: both come off
    ``mesh.call``'s host time."""
    events = _events() + [CEv("user_annotation", "mesh.host_write", 150,
                              157)]
    num = spans.layer_numbers(spans.from_events(events))
    assert num["host_enqueue_traced_ms"] == approx((180 - 18 - 7) * 1e-6)


def test_a_small_traced_run_on_the_cpu_names_every_layer():
    """A profiled call of a small cell on the CPU, reduced as the card's
    traced runs are: every layer's spans, one ``mesh.call``, as many
    ``*.host_read`` and ``*.host_write`` spans as the call counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cell = small_cell(n_vehicles=4, batch=4, chunk=4, horizon=4.0)
    solver = run.build_solver(cell.config, torch.device("cpu"))
    inputs = [(p0.float(), pf.float()) for p0, pf in
              run.draw_pool(cell.config, cell.traffic, 2 ** 31 + 5)]
    run._call(solver, inputs, 0, cell.traffic["chunk"])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tracing.CALL_RANGE):
            c = run._call(solver, inputs, 1, cell.traffic["chunk"])
    red = spans.from_events(prof.profiler.kineto_results.events())
    rows = red["by_span"]
    assert {"mesh.call", "mesh.phase1", "scp.step", "qp.factors",
            "qp.interval", "qp.ns_chain", "scp.host_read",
            "qp.host_write"} <= set(rows)
    assert rows["mesh.call"]["count"] == 1 and red["calls"] == 1
    count = {kind: sum(r["count"] for k, r in rows.items()
                       if k.endswith(f".host_{kind}"))
             for kind in ("read", "write")}
    assert count == {"read": c.timing["host_reads"],
                     "write": c.timing["host_writes"]}
    assert spans.layer_numbers(red)["qp_factor_device_ms"] is not None
    assert spans.table(red, 1)[0].startswith("span")
