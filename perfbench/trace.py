"""Spans around the program's functions, and the reading of a profiler
trace into what the per-layer metrics take.

``Spans`` wraps named program functions (``module:function``) in
``torch.profiler.record_function("pb::<name>")``, keeps each call's host
time and, where a metric asks for it, what the call was given.  The
wrappers are installed in a traced run only and removed after it.

``Trace`` reads the profiler's own events (``kineto_results``): device
kernels, copies and sets, the host operations and the ``pb::`` spans.  A
device operation belongs to every span that encloses, on the host, the
operation or runtime call that launched it: the trace's correlation ids
tie the two, so kernel names are never read to assign work.
"""

from __future__ import annotations

import bisect
import importlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

PREFIX = "pb::"
#: activity types of device work, and of the host's launching calls
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")


class Spans:
    """Host-side spans around program functions, by span name."""

    def __init__(self):
        self.host_s: Dict[str, List[float]] = defaultdict(list)
        self.calls: Dict[str, List[dict]] = defaultdict(list)
        self.recording = True       # host times kept (the window)
        self.tagging = False        # call records kept (the traced stretch)
        self._undo: List[Tuple[object, str, Callable, str]] = []

    def wrap(self, name: str, target: str,
             on_call: Optional[Callable] = None) -> None:
        """Wrap ``target`` (``package.module:function``) as span
        ``name``; ``on_call(*args, **kwargs)`` returns a record of the
        call kept while ``tagging``."""
        if any(u[3] == name for u in self._undo):   # shared by metrics
            return
        mod_name, fn_name = target.split(":")
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, fn_name)
        label = PREFIX + name

        def wrapped(*args, **kwargs):
            if self.tagging and on_call is not None:
                self.calls[name].append(on_call(*args, **kwargs))
            t0 = time.perf_counter()
            with torch.profiler.record_function(label):
                out = fn(*args, **kwargs)
            if self.recording:
                self.host_s[name].append(time.perf_counter() - t0)
            return out

        setattr(mod, fn_name, wrapped)
        self._undo.append((mod, fn_name, fn, name))

    def unwrap(self) -> None:
        for mod, fn_name, fn, _ in reversed(self._undo):
            setattr(mod, fn_name, fn)
        self._undo.clear()


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def _kind(e) -> str:
    """An event's activity type; older builds' events lack the method,
    and are told apart by device and by name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if e.device_type() != torch.autograd.DeviceType.CPU:
        if e.name().startswith(PREFIX) or e.is_user_annotation():
            return "gpu_user_annotation"
        name = e.name().lower()
        return ("gpu_memcpy" if "memcpy" in name else
                "gpu_memset" if "memset" in name else "kernel")
    if e.name().startswith(("cuda", "cu")):
        return "cuda_runtime"
    return "cpu_op"


class Trace:
    """One profiled stretch, read from ``prof`` (a finished
    ``torch.profiler.profile``) between host times ``t0_ns`` and
    ``t1_ns`` of the trace's clock (``time.perf_counter_ns`` is not
    it: the window is the span of the ``pb::window`` annotation)."""

    def __init__(self, prof):
        events = prof.profiler.kineto_results.events()
        self.device: List[tuple] = []            # (name, start, end, corr, link)
        host_ops: Dict[int, Tuple[int, int]] = {}
        launches: Dict[int, Tuple[int, int]] = {}
        self.ops: List[tuple] = []               # (start, end, tid, name)
        spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        window = None
        for e in events:
            kind = _kind(e)
            start = e.start_ns()
            end = start + e.duration_ns()
            if kind in DEVICE_KINDS:
                self.device.append((e.name(), start, end, e.correlation_id(),
                                    e.linked_correlation_id()))
            elif kind in LAUNCH_KINDS:
                launches[e.correlation_id()] = (start, e.start_thread_id())
            elif kind in ("cpu_op", "user_annotation"):
                name = e.name()
                host_ops[e.correlation_id()] = (start, e.start_thread_id())
                self.ops.append((start, end, e.start_thread_id(), name))
                if name == PREFIX + "window":
                    window = (start, end, e.start_thread_id())
                elif name.startswith(PREFIX):
                    spans[name[len(PREFIX):]].append((start, end))
        if window is None:
            raise RuntimeError("the trace holds no pb::window span")
        self.t0, self.t1, self.tid = window
        self.window_s = (self.t1 - self.t0) / 1e9
        self.device = [d for d in self.device
                       if d[2] > self.t0 and d[1] < self.t1]
        self.spans = {k: sorted(v) for k, v in spans.items()}
        self._starts = {k: [s for s, _ in v] for k, v in self.spans.items()}
        self.unlinked = 0
        self.span_device_s: Dict[str, float] = defaultdict(float)
        for name, start, end, corr, link in self.device:
            host = host_ops.get(link) if link else None
            if host is None:
                host = launches.get(corr)
            if host is None:
                self.unlinked += 1
                continue
            for span in self._enclosing(host[0]):
                self.span_device_s[span] += (end - start) / 1e9

    def _enclosing(self, t: int) -> List[str]:
        out = []
        for name, ivs in self.spans.items():
            i = bisect.bisect_right(self._starts[name], t) - 1
            # spans of one name do not nest, so only the latest start
            # before t can hold it
            if i >= 0 and ivs[i][1] >= t:
                out.append(name)
        return out

    @property
    def device_s(self) -> float:
        """Device time of every operation in the window, summed."""
        return sum(min(e, self.t1) - max(s, self.t0)
                   for _, s, e, _, _ in self.device) / 1e9

    def busy(self) -> List[Tuple[int, int]]:
        return _union([(max(s, self.t0), min(e, self.t1))
                       for _, s, e, _, _ in self.device])

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return sum(hi - lo for lo, hi in self.busy()) / 1e9

    def top_device_ops(self, n: int = 10) -> List[list]:
        """The ``n`` device operations with the most time: [name, s]."""
        by: Dict[str, float] = defaultdict(float)
        for name, s, e, _, _ in self.device:
            by[name[:160]] += (min(e, self.t1) - max(s, self.t0)) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda x: -x[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The device's idle time in the window by what the host's main
        thread was doing at each gap's middle (its innermost span or
        operation): the ``n`` largest totals, [name, s]."""
        busy = self.busy()
        gaps, at = [], self.t0
        for lo, hi in busy:
            if lo > at:
                gaps.append((at, lo))
            at = max(at, hi)
        if at < self.t1:
            gaps.append((at, self.t1))
        ops = sorted((s, -e, name) for s, e, tid, name in self.ops
                     if tid == self.tid and name != PREFIX + "window")
        by: Dict[str, float] = defaultdict(float)
        stack: List[Tuple[int, str]] = []
        i = 0
        for lo, hi in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (lo + hi) // 2
            while i < len(ops) and ops[i][0] <= mid:
                start, neg_end, name = ops[i]
                while stack and stack[-1][0] < start:
                    stack.pop()
                stack.append((-neg_end, name))
                i += 1
            while stack and stack[-1][0] < mid:
                stack.pop()
            by[stack[-1][1] if stack else "(host outside any operation)"] += \
                (hi - lo) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda x: -x[1])[:n]]
