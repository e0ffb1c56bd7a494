"""The program's own spans and counters in a traced stretch.

The port records spans inside its model path (``repro_torch.obs.spans``:
``record_function("model::<name>")`` while a profiler records) and
counts its MoE slots while a profiler records.  ``ProgramTrace`` is a
``trace.Trace`` that reads these too; what ``Trace`` reads is left as it
is:

- ``program_spans``: each ``model::`` span's host intervals, by name;
- ``program_span_device_s``: the device seconds of the window's
  operations launched inside each span, by the rule ``Trace`` applies to
  the benchmark's own spans (the launching operator by its correlation
  id, else the runtime call that launched the operation: a kernel
  launched through ``ctypes`` has only that);
- ``idle_within(name)``: the window's device-idle seconds while the
  host is inside span ``name``;
- ``moe_slots``: the program's MoE slot counters (``routed``, ``kept``,
  ``capacity``) over the stretch, or None where the program has none.

The harness builds its trace as ``harness.Trace(prof)``; ``install()``
points that name at ``ProgramTrace``, so that a metric reading the
program's spans works with the harness as it is.  A program without
spans gives empty readings.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from .trace import LAUNCH_KINDS, Trace, _kind, _union

PROGRAM_PREFIX = "model::"


class ProgramTrace(Trace):

    def __init__(self, prof):
        super().__init__(prof)
        host_ops: Dict[int, int] = {}
        launches: Dict[int, int] = {}
        spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        for e in prof.profiler.kineto_results.events():
            kind = _kind(e)
            if kind in LAUNCH_KINDS:
                launches[e.correlation_id()] = e.start_ns()
            elif kind in ("cpu_op", "user_annotation"):
                host_ops[e.correlation_id()] = e.start_ns()
                name = e.name()
                if name.startswith(PROGRAM_PREFIX):
                    spans[name[len(PROGRAM_PREFIX):]].append(
                        (e.start_ns(), e.start_ns() + e.duration_ns()))
        self.program_spans = {k: sorted(v) for k, v in spans.items()}
        starts = {k: [s for s, _ in v] for k, v in self.program_spans.items()}
        self.program_span_device_s: Dict[str, float] = defaultdict(float)
        for _, start, end, corr, link in self.device:
            host = host_ops.get(link) if link else None
            if host is None:
                host = launches.get(corr)
            if host is None:
                continue
            for name, ivs in self.program_spans.items():
                # spans of one name do not nest: only the latest start
                # before the launch can hold it
                i = bisect.bisect_right(starts[name], host) - 1
                if i >= 0 and ivs[i][1] >= host:
                    self.program_span_device_s[name] += (end - start) / 1e9
        self.moe_slots = _take_moe_slots()

    def idle_within(self, name: str) -> float:
        """Seconds of the window in which the host was inside span
        ``name`` and no device operation ran."""
        inside = _union([(max(s, self.t0), min(e, self.t1))
                         for s, e in self.program_spans.get(name, ())
                         if e > self.t0 and s < self.t1])
        busy = self.busy()
        idle, j = 0, 0
        for lo, hi in inside:
            idle += hi - lo
            while j < len(busy) and busy[j][1] <= lo:
                j += 1
            k = j
            while k < len(busy) and busy[k][0] < hi:
                idle -= min(hi, busy[k][1]) - max(lo, busy[k][0])
                k += 1
        return idle / 1e9


def _take_moe_slots() -> Optional[Dict[str, int]]:
    """The program's MoE slot counts, reset once read: they count only
    while a profiler records, so they cover the stretch just traced."""
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    slots = spans.counters()
    spans.reset()
    return slots


def install() -> None:
    """Have the harness build its traces as ``ProgramTrace``."""
    from . import harness
    if not issubclass(harness.Trace, ProgramTrace):
        harness.Trace = ProgramTrace

