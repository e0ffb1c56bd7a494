"""The trace reader on a synthetic profile: device work assigned to the
spans that launched it by correlation, busy time as a union, idle gaps
by what the host was doing."""

import pytest

pytest.importorskip("torch")

from perfbench.trace import Trace  # noqa: E402


class Ev:
    def __init__(self, kind, name, start, dur, corr=0, link=0, tid=1):
        self.k, self.n, self.s, self.d = kind, name, start, dur
        self.c, self.l, self.t = corr, link, tid

    def activity_type(self):
        return self.k

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def correlation_id(self):
        return self.c

    def linked_correlation_id(self):
        return self.l

    def start_thread_id(self):
        return self.t


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {
            "events": lambda _self: events})()


def synthetic():
    return Prof([
        Ev("user_annotation", "pb::window", 0, 1000, corr=1),
        Ev("user_annotation", "pb::attention_core", 100, 100, corr=2),
        Ev("cpu_op", "aten::mm", 300, 50, corr=3),
        Ev("cuda_runtime", "cudaLaunchKernel", 120, 5, corr=900),
        Ev("cuda_runtime", "cudaLaunchKernel", 310, 5, corr=901),
        # the attention kernel, launched by ctypes inside the span: tied
        # to the span by its runtime call only
        Ev("kernel", "flash", 400, 200, corr=900, link=0),
        # a product tied to its operator
        Ev("kernel", "gemm", 550, 150, corr=901, link=3),
        Ev("kernel", "lost", 800, 10, corr=5555, link=0),
    ])


def test_device_work_goes_to_the_span_that_launched_it():
    tr = Trace(synthetic())
    assert tr.window_s == pytest.approx(1e-6)
    assert tr.span_device_s["attention_core"] == pytest.approx(200e-9)
    assert tr.unlinked == 1
    assert tr.device_s == pytest.approx(360e-9)
    assert tr.busy_s == pytest.approx(310e-9)          # 400-700, 800-810


def test_breakdown_lists_ops_and_idle_gaps():
    tr = Trace(synthetic())
    assert tr.top_device_ops()[0] == ["flash", pytest.approx(200e-9)]
    gaps = dict((k, v) for k, v in tr.idle_gaps())
    # gaps 0-400 (mid 200: inside the span), 700-800 and 810-1000
    assert gaps["pb::attention_core"] == pytest.approx(400e-9)
    assert sum(gaps.values()) == pytest.approx(690e-9)
