"""Action-stream reconciler — the integrity check between derived and
The port of ``repro/policy/reconciler.py``.
ground-truth state (the related repo's ``hsm-stream-reconciler``).

Two maps are built and diffed:

1. **Stream-derived state**: a full replay of the action stream (an
   *ephemeral* ``Subscription(replay=True)`` with the ``CL_ACTION_*``
   op-type mask pushed down, so no other record is ever copied), folded
   with the lifecycle reducer: NEW/UPDATE/COMPLETED set the cookie's
   status, PURGED drops it.  The ephemeral mode matters: an audit scan
   must never block the journal trim or join a delivery group.
2. **Ground truth**: the engine's live action table
   (``PolicyEngine.live_state()``) — the analogue of scanning the MDTs'
   ``hsm/actions`` files.

The report lists cookies **missing** from the stream (ground truth has
them, the stream does not — lost records), **extra** in the stream
(stream says live, truth says gone — a lost PURGED), and
**mismatched** status.  A healthy deployment reconciles to zero of
each, through proxy restarts and single-shard failovers — that is the
acceptance invariant of the whole policy subsystem.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from ..core import records as R
from ..core.session import Subscription, connect
from .engine import PolicyEngine

#: cookie -> (target key, rule, status)
ActionState = Dict[int, Tuple[Tuple[int, int, int], str, str]]


def replay_action_state(target, producer: str = "actions",
                        rounds: int = 10000) -> ActionState:
    """Rebuild the live-action map from a full replay of the action
    stream against ``target`` (a proxy, service, cluster, or address)."""
    session = connect(target)
    stream = session.subscribe(Subscription(
        mode="ephemeral", replay=True, types=R.CL_ACTION_TYPES,
        max_records=4096))
    state: ActionState = {}
    try:
        for _ in range(rounds):
            pairs = stream.fetch(8192)
            for pid, batch in pairs:
                if pid != producer:
                    continue
                for i in range(len(batch)):
                    rec = batch.record(i)
                    x = rec.xattr or {}
                    cookie = x.get("cookie")
                    if cookie is None:
                        continue
                    if rec.type == R.CL_ACTION_PURGED:
                        state.pop(cookie, None)
                    else:
                        state[cookie] = (rec.key(), x.get("rule", ""),
                                         x.get("status", ""))
            if not pairs and not stream.replaying:
                return state
        raise RuntimeError("action replay did not drain")
    finally:
        session.close()


@dataclass
class ReconcileReport:
    missing: List[int] = field(default_factory=list)     # truth only
    extra: List[int] = field(default_factory=list)       # stream only
    mismatched: List[Tuple[int, str, str]] = field(default_factory=list)
    truth_live: int = 0
    stream_live: int = 0

    @property
    def ok(self) -> bool:
        return not (self.missing or self.extra or self.mismatched)

    def __str__(self) -> str:
        if self.ok:
            return (f"reconciled: {self.truth_live} live actions, "
                    f"zero discrepancies")
        return (f"DISCREPANCIES: {len(self.missing)} missing from stream, "
                f"{len(self.extra)} extra in stream, "
                f"{len(self.mismatched)} status mismatches "
                f"({self.truth_live} truth / {self.stream_live} stream)")


def reconcile(engine: PolicyEngine, target=None,
              derived: ActionState = None) -> ReconcileReport:
    """Diff the engine's ground truth against the stream-derived state
    (replayed from ``target``, or passed pre-built via ``derived``)."""
    if derived is None:
        derived = replay_action_state(target, engine.producer)
    truth = engine.live_state()
    report = ReconcileReport(truth_live=len(truth),
                             stream_live=len(derived))
    for cookie in sorted(truth.keys() - derived.keys()):
        report.missing.append(cookie)
    for cookie in sorted(derived.keys() - truth.keys()):
        report.extra.append(cookie)
    for cookie in sorted(truth.keys() & derived.keys()):
        t_status, d_status = truth[cookie][2], derived[cookie][2]
        if t_status != d_status:
            report.mismatched.append((cookie, t_status, d_status))
    return report
