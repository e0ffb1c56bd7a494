"""Spans and counters inside the model path, on the profiler's clock.

- :func:`span` decorates a model function.  While a ``torch.profiler``
  records, each call runs inside a profiler range ``model::<name>``
  (torch's ``_RecordFunctionFast``, where it has one, else
  ``record_function``): the call becomes a host event of the trace
  beside the device kernels, copies and sets it launched, tied to them
  by the trace's correlation ids (a kernel launched through ``ctypes``
  by its runtime launch call).  The spans keep no clock of their own.
  With no profiler recording a call costs one flag check and the call
  itself: ``record_function`` alone costs microseconds a call even then,
  and some ten times ``_RecordFunctionFast``'s while recording, which
  would lengthen the traced host time it is there to divide.  Spans of
  one name do not nest: a call made inside a span of its own name (the
  DTensor path re-enters ``attention_core`` on each rank's heads) runs
  without one.
- The MoE slot counters (:func:`count_moe_slots`) count the serving
  path's calls (autograd off) while a profiler records: a training
  step's recompute would count each call twice.  Routed ``(token, k)``
  slots and the capacity slots the expert products compute are host
  integers from shapes; kept slots are summed on the device into a
  running int64 tensor, so the layer waits for nothing.
  :func:`counters` reads the three (one synchronisation).  On DTensors
  each rank counts the batch rows it holds.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Dict

import torch
from torch.autograd import profiler as _profiler

__all__ = ["PREFIX", "span", "count_moe_slots", "counters", "reset"]

#: the name prefix of every span in a profiler trace
PREFIX = "model::"

_open = threading.local()       # the span names open on this thread
#: the profiler range a span opens
_record = getattr(torch._C._profiler, "_RecordFunctionFast",
                  torch.profiler.record_function)


def span(name: str) -> Callable:
    """Decorator: run the function inside span ``model::<name>`` while a
    profiler records (torch's own flag, set by the profiler's start and
    stop, is the one check made when none does)."""
    label = PREFIX + name

    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            names = _open.__dict__.setdefault("names", set())
            if label in names:
                return fn(*args, **kwargs)
            names.add(label)
            try:
                with _record(label):
                    return fn(*args, **kwargs)
            finally:
                names.discard(label)
        return spanned
    return wrap


class _MoeSlots:
    """The running MoE slot counts of this process."""

    def __init__(self):
        self.lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self.lock:
            self.routed = 0
            self.capacity = 0
            self.kept: Dict[torch.device, torch.Tensor] = {}

    def add(self, keep: torch.Tensor, n_experts: int, capacity: int):
        if hasattr(keep, "to_local"):           # a DTensor: this rank's rows
            keep = keep.to_local()
        kept = keep.sum()
        with self.lock:
            acc = self.kept.get(keep.device)
            if acc is None:
                # a normal tensor, so that it can be added to in and out
                # of inference mode alike
                with torch.inference_mode(False), torch.no_grad():
                    acc = torch.zeros((), dtype=torch.int64,
                                      device=keep.device)
                self.kept[keep.device] = acc
            acc.add_(kept)
            self.routed += keep.numel()
            self.capacity += n_experts * keep.shape[0] * capacity

    def read(self) -> Dict[str, int]:
        with self.lock:
            kept = list(self.kept.values())
            routed, capacity = self.routed, self.capacity
        return {"routed": routed, "kept": sum(int(t) for t in kept),
                "capacity": capacity}


_MOE = _MoeSlots()


def count_moe_slots(keep: torch.Tensor, n_experts: int,
                    capacity: int) -> None:
    """Count one MoE layer's call made with autograd off while a
    profiler records: ``keep`` (B, S*K) bool, whether each routed slot
    is within the capacity of ``capacity`` per expert and batch row."""
    if _profiler._is_profiler_enabled and not torch.is_grad_enabled():
        _MOE.add(keep, n_experts, capacity)


def counters() -> Dict[str, int]:
    """The slots counted since the process started or the last
    :func:`reset`: ``routed`` (token, k) slots, ``kept`` of them within
    capacity, ``capacity`` slots the expert products computed."""
    return _MOE.read()


def reset() -> None:
    _MOE.reset()

