"""``perfbench/step_idle.py`` on the CPU: host-clock events in place of
the card's, a sleep that does nothing.  Every ``every``-th call is
timed as slept; the medians are taken apart by kind; the decode cell's
window runs through the timed ``decode_step``, which is put back after."""

import time

import pytest
from conftest import small_cell

pytest.importorskip("torch")

from perfbench import harness  # noqa: E402
from perfbench.step_idle import StepTimer  # noqa: E402
from repro_torch.models import transformer  # noqa: E402


class Event:
    """An event stamped with the host clock (or a given time, in ms)."""

    def __init__(self, at=None):
        self.at = at

    def record(self):
        if self.at is None:
            self.at = time.perf_counter() * 1e3

    def elapsed_time(self, other):
        return other.at - self.at


def test_the_summary_takes_plain_and_slept_steps_apart():
    timer = StepTimer(3, Event, lambda: None, sleep_ms=400.0)
    # (slept, entry ms, return ms, host s): plain steps 10 ms of device
    # time, slept ones 8; 2 ms from a plain return to the next entry
    timer.steps = [(False, Event(0), Event(10), 0.006),
                   (False, Event(12), Event(22), 0.007),
                   (True, Event(500), Event(508), 0.5),
                   (False, Event(520), Event(530), 0.008)]
    got = timer.summary(skip=0)
    assert got == {"steps": 3, "slept_steps": 1, "blocked": 1,
                   "step_ms": 10, "work_ms": 8, "host_ms": 7.0,
                   "between_ms": 2, "idle_in_step_ms": 2}


def test_the_decode_window_runs_through_the_timer(fixed_clock):
    cell = small_cell("granite-8b.decode-longctx")
    fn = transformer.decode_step
    timer = StepTimer(4, Event, lambda: None, sleep_ms=400.0)
    with timer.around(transformer, "decode_step"):
        result, run, *_ = harness.run(cell, 4310000031, 0.32, False, "cpu",
                                      0.0)
    assert transformer.decode_step is fn
    assert result["correct"], result["checks"]
    slept = [s[0] for s in timer.steps]
    assert slept == [i % 4 == 3 for i in range(len(timer.steps))]
    assert len(timer.steps) >= 8
    got = timer.summary(skip=2)
    assert got["steps"] + got["slept_steps"] == len(timer.steps) - 2
    assert got["step_ms"] > 0 and got["work_ms"] > 0
    assert got["between_ms"] is not None and got["blocked"] == 0
