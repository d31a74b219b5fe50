"""The trace reduction on hand-made events: the window from the call
ranges, busy as the union of device intervals, idle gaps named by the
innermost host range open in them."""

from pytest import approx

from port_bench import tracing


class Ev:
    def __init__(self, kind, name, s, e):
        self.kind, self.n, self.s, self.e = kind, name, s, e

    def activity_type(self):
        return self.kind

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e


def test_summarize_hand_made_trace():
    events = [
        Ev("user_annotation", tracing.CALL_RANGE, 0, 100),
        Ev("cpu_op", "aten::mm", 5, 40),
        Ev("cuda_runtime", "cudaLaunchKernel", 10, 12),
        Ev("kernel", "k1", 20, 50),
        Ev("kernel", "k2", 45, 60),
        Ev("gpu_memcpy", "Memcpy DtoH", 90, 95),
        Ev("cpu_op", "aten::copy_", 85, 100),
        Ev("user_annotation", tracing.CALL_RANGE, 120, 200),
        Ev("kernel", "k1", 150, 170),
        Ev("kernel", "outside", 300, 400),
    ]
    out = tracing.summarize(events)
    assert out["calls"] == 2 and out["device_ops"] == 4
    assert out["window_s"] == approx(200e-9)
    assert out["busy_s"] == approx((40 + 5 + 20) * 1e-9)
    ops = dict(out["breakdown"]["device_ops"])
    assert ops["k1"] == approx(50e-9) and "outside" not in ops
    gaps = dict(out["breakdown"]["idle_gaps"])
    # idle: [0, 20) (its middle, 10, in the launch inside aten::mm), [60,
    # 90) in the call, [95, 150) (its middle, 122, in the second call),
    # [170, 200)
    assert gaps["cudaLaunchKernel"] == approx(20e-9)
    assert gaps[tracing.CALL_RANGE] == approx((30 + 55 + 30) * 1e-9)
