"""The harness driven on the CPU past its look for a card, at a small
size: sound runs come out correct, and runs with the timed path broken
underneath come out not correct, once for each fault a cell can have (a
step that returns its state unchanged; half of the batch left out; a
token altered where it is produced).  One chip, so no exchange between
chips can be left out."""

import copy

import pytest
from conftest import CELLS, small_cell

torch = pytest.importorskip("torch")

from perfbench import harness  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402

SEED = 2 ** 31 + 977


def drive(workload, trace=False):
    cell = small_cell(workload)
    result, _run, checked, _p, numbers = harness.run(
        cell, SEED, 0.32, trace, "cpu", 0.0)
    return result, checked, numbers


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(workload, trace, fixed_clock):
    result, checked, _ = drive(workload, trace=trace)
    assert result["correct"], result["checks"]
    assert checked.sequences and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    cell = small_cell(workload)
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert set(result["metrics"]) <= names


def _half(fn):
    """Half of the batch left out: the second half's rows take the first
    half's answers."""
    def wrapped(params, *args):
        logits, cache = fn(params, *args)
        half = logits.shape[0] // 2
        logits = logits.clone()
        logits[half:2 * half] = logits[:half]
        return logits, cache
    return wrapped


def _altered(fn):
    """A token altered where it is produced: one vocabulary entry lifted
    above every other in each answer."""
    def wrapped(params, *args):
        logits, cache = fn(params, *args)
        logits = logits.clone()
        logits[:, 7] = logits.max() + 10.0
        return logits, cache
    return wrapped


def _frozen(fn):
    """A step that returns its state unchanged: it runs on a copy of the
    cache and hands back the cache it was given."""
    def wrapped(params, cache, *args):
        logits, _ = fn(params, copy.deepcopy(cache), *args)
        return logits, cache
    return wrapped


FAULTS = {"half_batch": _half, "token_altered": _altered,
          "state_unchanged": _frozen}


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in CELLS for f in FAULTS
    if f != "state_unchanged" or "decode" in w])
def test_broken_timed_path_is_not_correct(workload, fault, monkeypatch,
                                         fixed_clock):
    if fault == "state_unchanged":
        real = steps.build_decode_step
        monkeypatch.setattr(steps, "build_decode_step",
                            lambda cfg: _frozen(real(cfg)))
    else:
        name = ("build_prefill_step" if "prefill" in workload
                else "build_decode_step")
        real = getattr(steps, name)
        monkeypatch.setattr(steps, name, lambda *a, **k: FAULTS[fault](
            real(*a, **k)))
    result, _, _ = drive(workload)
    assert not result["correct"], result["checks"]
