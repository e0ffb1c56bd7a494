"""The program's spans and counters read from a synthetic profile
(``program_trace.ProgramTrace``): device work assigned to the ``model::``
span that launched it by correlation, a ``ctypes`` launch by its runtime
call alone; the device's idle time inside a span; the MoE slot counters
taken over the stretch; what ``Trace`` reads left as it is.  Then each
reader of the program's spans on a synthetic run, and on runs outside
its cell kind or of a program without spans, where it reads nothing."""

import types

import pytest

pytest.importorskip("torch")

import test_perfbench_trace as base  # noqa: E402
import torch  # noqa: E402

from perfbench import counts, harness  # noqa: E402
from perfbench.program_trace import ProgramTrace, install  # noqa: E402
from perfbench.trace import Trace  # noqa: E402
from repro_torch.obs import spans  # noqa: E402

Ev, Prof = base.Ev, base.Prof
NEW = ("norm_rope_device_share.prefill", "moe_device_share.prefill",
       "moe_slot_use.prefill", "decode_idle_in_step_ms",
       "attn_kernel_roofline_in_program.prefill",
       "ssd_device_share_in_program.prefill",
       "decode_attn_device_ms_in_program")


def prefill_profile():
    def span(name, start, dur, corr):
        return Ev("user_annotation", "model::" + name, start, dur, corr=corr)

    def launch(at, corr):
        return Ev("cuda_runtime", "cudaLaunchKernel", at, 5, corr=corr)

    return Prof([
        Ev("user_annotation", "pb::window", 0, 1000, corr=1),
        span("prefill", 50, 900, 10),
        # the attention kernel, launched through ctypes inside the span:
        # tied to it by its runtime call only
        span("attention_core", 100, 100, 2), launch(120, 900),
        Ev("kernel", "flash", 400, 200, corr=900),
        span("ssd_layer", 220, 70, 13), launch(230, 903),
        Ev("kernel", "scan", 600, 40, corr=903),
        # an operator's kernel, tied to its operator
        span("rms_norm", 300, 60, 11),
        Ev("cpu_op", "aten::mul", 310, 30, corr=3), launch(315, 901),
        Ev("kernel", "mul", 640, 60, corr=901, link=3),
        span("rope", 370, 20, 14), launch(375, 904),
        Ev("kernel", "rot", 700, 20, corr=904),
        span("moe_layer", 700, 80, 12), launch(710, 902),
        Ev("kernel", "expert", 820, 50, corr=902),
        Ev("kernel", "lost", 900, 10, corr=5555),
    ])


def decode_profile():
    return Prof([
        Ev("user_annotation", "pb::window", 0, 1000, corr=1),
        Ev("user_annotation", "model::decode_step", 0, 400, corr=2),
        Ev("user_annotation", "model::decode_attention", 100, 100, corr=3),
        Ev("cuda_runtime", "cudaLaunchKernel", 150, 5, corr=900),
        Ev("kernel", "gemv", 150, 250, corr=900),
        Ev("user_annotation", "model::decode_step", 500, 400, corr=4),
        Ev("user_annotation", "model::decode_attention", 600, 100, corr=5),
        Ev("cuda_runtime", "cudaLaunchKernel", 650, 5, corr=901),
        Ev("kernel", "gemv", 700, 250, corr=901),
    ])


@pytest.fixture(autouse=True)
def fresh_counters():
    spans.reset()
    yield
    spans.reset()


def test_program_spans_take_the_device_work_they_launched():
    tr = ProgramTrace(prefill_profile())
    want = {"attention_core": 200, "ssd_layer": 40, "rms_norm": 60,
            "rope": 20, "moe_layer": 50, "prefill": 370}
    assert set(tr.program_span_device_s) == set(want)
    for name, ns in want.items():
        assert tr.program_span_device_s[name] == pytest.approx(ns * 1e-9)
    assert tr.program_spans["rms_norm"] == [(300, 360)]
    assert tr.device_s == pytest.approx(380e-9)


def test_idle_within_a_span():
    tr = ProgramTrace(prefill_profile())
    # busy 400-720, 820-870, 900-910
    assert tr.idle_within("prefill") == pytest.approx(520e-9)
    assert tr.idle_within("moe_layer") == pytest.approx(60e-9)
    assert tr.idle_within("attention_core") == pytest.approx(100e-9)
    assert tr.idle_within("no_such_span") == 0.0
    tr = ProgramTrace(decode_profile())
    # busy 150-400, 700-950; steps 0-400, 500-900
    assert tr.idle_within("decode_step") == pytest.approx(350e-9)


@pytest.mark.parametrize("profile", [prefill_profile, decode_profile,
                                     base.synthetic])
def test_what_trace_reads_is_left_as_it_is(profile):
    plain, program = Trace(profile()), ProgramTrace(profile())
    for field in ("device", "ops", "spans", "span_device_s", "unlinked",
                  "t0", "t1", "tid", "window_s"):
        assert getattr(program, field) == getattr(plain, field), field
    assert program.busy() == plain.busy()
    assert program.idle_gaps() == plain.idle_gaps()
    assert program.top_device_ops() == plain.top_device_ops()


def test_the_moe_slots_are_taken_over_the_stretch():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]), \
            torch.no_grad():
        spans.count_moe_slots(torch.tensor([[True, False, True]]), 4, 2)
    tr = ProgramTrace(prefill_profile())
    assert tr.moe_slots == {"routed": 3, "kept": 2, "capacity": 8}
    assert spans.counters() == {"routed": 0, "kept": 0, "capacity": 0}


def test_install_points_the_harness_at_the_program_trace():
    install()
    assert harness.Trace is ProgramTrace
    install()
    assert harness.Trace is ProgramTrace


def prefill_run(trace, calls=()):
    return harness.Run(kind="prefill", trace=trace, trace_steps=1,
                       spans=types.SimpleNamespace(
                           calls={"attention_core": list(calls)},
                           host_s={}))


def test_prefill_readers():
    call = counts.attention_call(1, 64, 64, 4, 2, 16, True, 0, 2)
    tr = ProgramTrace(prefill_profile())
    tr.moe_slots = {"routed": 100, "kept": 96, "capacity": 125}
    run = prefill_run(tr, [call])
    got = {name: harness.metric_module(name).read(run) for name in NEW}
    assert got == {
        "norm_rope_device_share.prefill": pytest.approx(100 * 80 / 380),
        "moe_device_share.prefill": pytest.approx(100 * 50 / 380),
        "moe_slot_use.prefill": pytest.approx(100 * 96 / 125),
        "ssd_device_share_in_program.prefill": pytest.approx(100 * 40 / 380),
        "attn_kernel_roofline_in_program.prefill": pytest.approx(
            100 * counts.roofline_s(*call) / 200e-9),
        "decode_idle_in_step_ms": None,
        "decode_attn_device_ms_in_program": None}


def test_decode_readers():
    run = harness.Run(kind="decode", trace=ProgramTrace(decode_profile()),
                      trace_steps=2)
    got = {name: harness.metric_module(name).read(run) for name in NEW}
    assert got == {name: None for name in NEW} | {
        "decode_idle_in_step_ms": pytest.approx(1e3 * 350e-9 / 2),
        "decode_attn_device_ms_in_program": pytest.approx(
            1e3 * 2 * 250e-9 / 2)}


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_readers_read_nothing_without_the_program_spans(kind):
    """A program without spans or counters (a plain ``Trace``, an empty
    ``ProgramTrace``) and an untraced run: no reading, and no error."""
    call = counts.attention_call(1, 64, 64, 4, 2, 16, True, 0, 2)
    empty = ProgramTrace(base.synthetic())
    empty.moe_slots = None
    for trace in (Trace(base.synthetic()), empty, None):
        run = prefill_run(trace, [call])
        run.kind = kind
        for name in NEW:
            assert harness.metric_module(name).read(run) is None, name
