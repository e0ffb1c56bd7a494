"""Declarative policy rules + the action lifecycle stream.
The port of ``repro/policy/engine.py``.

One difference, in cost only: the live-action and age-in tables are
indexed by target (``_TargetIndexed``), so reaping a vanished target
touches only its own entries instead of scanning every live action and
waiter.  The index keeps insertion order, so purges are emitted in the
reference's order and the engine ends in the same state.

The Robinhood half: ``PolicyRule``s are evaluated *incrementally*
against the ``NamespaceMirror`` (only targets the stream dirtied since
the last evaluation), and a match emits an **action record** — a
first-class changelog record (``CL_ACTION_*``, records.py) with the
lifecycle the ``lustre-hsm-action-stream`` toolkit ships for HSM
coordinators:

    NEW -> UPDATE(started) -> COMPLETED(succeeded|failed) -> PURGED

Action records are written to the engine's own journal (an ``Llog``
under producer id ``actions``) and that journal is registered with the
proxy — or with the cluster coordinator, which push-feeds each shard's
``PushSource`` and routes by target FID, so one action's whole chain
lands on one shard and never splits.  Because the journal is the
durable source (reader watermarks persist on the journal, not in the
proxy), a proxy restart re-attaches at its own acked watermark:
acknowledged actions are never re-ingested, unacknowledged ones are —
the same exactly-once-through-restart contract the changelog itself
has.  With a raw (uncompacted) history store attached, the full action
stream stays replayable forever — which is what the reconciler audits.

The **janitor** (``janitor_sweep``) is the stream's garbage collector:
it PURGEs completed action chains (dropping them from every stream-
derived state) and reaps zombies — live actions whose target has
disappeared from the mirror.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from ..core import records as R
from ..core.history import HistoryStore
from ..core.llog import Llog
from .mirror import Key, MirrorEntry, NamespaceMirror

#: action statuses (the HSM coordinator vocabulary)
WAITING = "WAITING"
STARTED = "STARTED"
SUCCEED = "SUCCEED"
FAILED = "FAILED"

_TERMINAL = frozenset({SUCCEED, FAILED})


class _TargetIndexed(dict):
    """A dict keyed by ``(target, rule name)`` that also indexes its
    keys by target, each target's rules in insertion order (the order in
    which the dict itself holds them), so one target's entries are found
    without a scan of the whole table.  Only ``[key] =``, ``del`` and
    ``pop`` keep the index; the engine mutates the tables by no other
    method."""

    def __init__(self):
        super().__init__()
        self._by_target: Dict[Key, Dict[str, None]] = {}

    def __setitem__(self, key_rule: Tuple[Key, str], value) -> None:
        if key_rule not in self:
            self._by_target.setdefault(key_rule[0], {})[key_rule[1]] = None
        super().__setitem__(key_rule, value)

    def __delitem__(self, key_rule: Tuple[Key, str]) -> None:
        super().__delitem__(key_rule)
        self._unindex(key_rule)

    def pop(self, key_rule: Tuple[Key, str], *default):
        if key_rule in self:
            self._unindex(key_rule)
        return super().pop(key_rule, *default)

    def _unindex(self, key_rule: Tuple[Key, str]) -> None:
        rules = self._by_target[key_rule[0]]
        del rules[key_rule[1]]
        if not rules:
            del self._by_target[key_rule[0]]

    def keys_of(self, key: Key) -> List[Tuple[Key, str]]:
        """``(key, rule)`` entries of target ``key``, in insertion order."""
        return [(key, rule) for rule in self._by_target.get(key, ())]


@dataclass(frozen=True)
class PolicyRule:
    """Declarative match against mirror entries.

    name          rule identity (stamped into every action record)
    action        what to do with a match ("archive", "purge", ...)
    types         op-type mask: the *last* operation that touched the
                  entry must be in this set (None = any)
    flags_all     CLF_* bits the last writer's record must have carried
                  (attr_shard => CLF_SHARD, attr_jobid => CLF_JOBID,
                  attr_metrics => CLF_METRICS)
    min_age_s     entry age (stream clock - creation time) threshold
    min_idle_s    idle time (stream clock - last touch) threshold
    metrics_min   last writer's metrics[0] lower bound
    metrics_max   last writer's metrics[0] upper bound
    predicate     arbitrary extra check fn(key, entry, clock_ns) -> bool
    """

    name: str
    action: str = "archive"
    types: Optional[frozenset] = None
    flags_all: int = 0
    min_age_s: Optional[float] = None
    min_idle_s: Optional[float] = None
    metrics_min: Optional[float] = None
    metrics_max: Optional[float] = None
    predicate: Optional[Callable[[Key, MirrorEntry, int], bool]] = \
        field(default=None, compare=False)

    def __post_init__(self):
        if self.types is not None and not isinstance(self.types, frozenset):
            object.__setattr__(self, "types", frozenset(self.types))

    def static_ok(self, key: Key, entry: MirrorEntry,
                  clock_ns: int) -> bool:
        """Every condition except the time gates."""
        if self.types is not None and entry.last_type not in self.types:
            return False
        if self.flags_all:
            have = 0
            if entry.attr_shard is not None:
                have |= R.CLF_SHARD
            if entry.attr_jobid:
                have |= R.CLF_JOBID
            if entry.attr_metrics is not None:
                have |= R.CLF_METRICS
            if (have & self.flags_all) != self.flags_all:
                return False
        if self.metrics_min is not None or self.metrics_max is not None:
            m = entry.attr_metrics
            v = m[0] if m else None
            if v is None:
                return False
            if self.metrics_min is not None and v < self.metrics_min:
                return False
            if self.metrics_max is not None and v > self.metrics_max:
                return False
        if self.predicate is not None and \
                not self.predicate(key, entry, clock_ns):
            return False
        return True

    def ready_at(self, entry: MirrorEntry) -> int:
        """Stream time (ns) at which the time gates open for ``entry``
        — 0 when the rule carries none.  Lets the engine re-examine a
        quiescent entry once it ages in, without new activity on it."""
        at = 0
        if self.min_age_s is not None:
            at = max(at, entry.ctime + int(self.min_age_s * 1e9))
        if self.min_idle_s is not None:
            at = max(at, entry.mtime + int(self.min_idle_s * 1e9))
        return at

    def matches(self, key: Key, entry: MirrorEntry, clock_ns: int) -> bool:
        return (self.static_ok(key, entry, clock_ns)
                and self.ready_at(entry) <= clock_ns)


class Action:
    """One live action: the engine-side ground truth of its lifecycle."""

    __slots__ = ("cookie", "key", "rule", "kind", "status")

    def __init__(self, cookie: int, key: Key, rule: str, kind: str):
        self.cookie = cookie
        self.key = key
        self.rule = rule
        self.kind = kind
        self.status = WAITING


class PolicyEngine:
    """Evaluates rules against a mirror; owns the action stream.

    ``target`` is the proxy or cluster the action journal registers
    with (both expose ``add_producer``); pass ``target=None`` to defer
    and call ``attach(proxy_or_cluster)`` later — and call ``attach``
    again after a proxy restart to re-register the journal with the
    new incarnation (it resumes at its own acked watermark).
    """

    def __init__(self, mirror: NamespaceMirror, rules: Iterable[PolicyRule],
                 target=None, producer: str = "actions",
                 path: Optional[str] = None, run_id: int = 1):
        self.mirror = mirror
        self.rules = list(rules)
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {names}")
        self.producer = producer
        self.run_id = run_id
        # raw retained history: the action stream must stay fully
        # replayable after trim — the reconciler's audit depends on it
        self.log = Llog(producer, path=path,
                        history=HistoryStore(path + ".hist" if path else None,
                                             compactor=None))
        # arm logging before any target attaches (an unarmed Llog
        # silently drops records); this reader never acks, so records
        # emitted while detached are retained until a real target's
        # reader takes over the trim gate in attach()
        self._arm_rid = self.log.register_reader("engine-arm",
                                                 resume=True)
        self._cookie_seq = itertools.count(1)
        self.actions: Dict[int, Action] = {}          # live, by cookie
        self._live_by_target: Dict[Tuple[Key, str], int] = _TargetIndexed()
        #: (target, rule name) -> stream time at which its time gates
        #: open — quiescent entries are re-examined when they age in
        self._waiting: Dict[Tuple[Key, str], int] = _TargetIndexed()
        self.stats = {"evaluated": 0, "emitted": 0, "completed": 0,
                      "purged": 0, "zombies_reaped": 0, "recovered": 0}
        self._recover()
        if target is not None:
            self.attach(target)

    def _recover(self) -> None:
        """Rebuild the live-action table (and the cookie sequence) from
        the journal + its raw history: a restarted engine over a
        persistent ``path`` continues the previous incarnation's
        lifecycle instead of reusing its cookies or forgetting its
        live chains."""
        from ..core.history import JournalReplayReader
        reader = JournalReplayReader(self.log)
        pos, last = reader.available_lo(), self.log.last_index
        hi_cookie = 0
        while pos <= last:
            batch, pos = reader.read(pos, 1024)
            # columnar replay: types/keys off the header columns, and
            # only the xattr blobs themselves decoded — never a full
            # per-record unpack
            types = batch.types_np().tolist()
            keys = batch.keys()
            for i, x in enumerate(batch.xattrs_col()):
                cookie = (x or {}).get("cookie")
                if cookie is None:
                    continue
                hi_cookie = max(hi_cookie, cookie)
                if types[i] == R.CL_ACTION_PURGED:
                    act = self.actions.pop(cookie, None)
                    if act is not None:
                        self._live_by_target.pop((act.key, act.rule), None)
                else:
                    act = self.actions.get(cookie)
                    if act is None:
                        act = Action(cookie, keys[i], x.get("rule", ""),
                                     x.get("action", ""))
                        self.actions[cookie] = act
                        self._live_by_target[(act.key, act.rule)] = cookie
                    act.status = x.get("status", act.status)
        if hi_cookie:
            self._cookie_seq = itertools.count(hi_cookie + 1)
            self.stats["recovered"] = len(self.actions)

    # -- wiring ----------------------------------------------------------------
    def attach(self, target) -> None:
        """Register the action journal with a proxy or cluster
        coordinator (idempotent across restarts: the journal's reader
        watermark survives, so a restarted target resumes exactly at
        its own acked position).  Records emitted before the first
        attach are part of the new reader's backlog — nothing emitted
        while detached is lost."""
        target.add_producer(self.producer, self.log)
        if self._arm_rid is not None:
            # the target's reader now gates the trim; the arming
            # reader must stop holding retention back
            self.log.deregister_reader(self._arm_rid)
            self._arm_rid = None

    # -- lifecycle emission ----------------------------------------------------
    def _emit(self, rtype: int, act: Action, status: str) -> Optional[int]:
        act.status = status
        return self.log.log(R.ChangelogRecord(
            type=rtype, tfid=R.Fid(*act.key),
            pfid=R.Fid(self.run_id, 0, 0), name=act.kind.encode(),
            time=self.mirror.clock,      # stream time (0 -> journal stamps)
            xattr={"cookie": act.cookie, "rule": act.rule,
                   "action": act.kind, "status": status}))

    def evaluate(self) -> List[Action]:
        """One incremental pass: match the rules against every target
        the stream dirtied since the last pass — plus every queued
        (target, rule) whose time gate has opened since (an age-out
        rule must fire on a file nobody touches again) — emit NEW
        actions, and reap zombies (live actions whose target
        disappeared).  Returns the newly emitted actions."""
        dirty = self.mirror.drain_dirty()
        clock = self.mirror.clock
        entries = self.mirror.entries
        by_name = {r.name: r for r in self.rules}
        # (key, rule) pairs to examine: dirtied targets against every
        # rule; aged-in waiters against theirs.  Dirty recomputation
        # supersedes a stale waiting slot.
        pairs: List[Tuple[Key, PolicyRule]] = []
        for key in dirty:
            if entries.get(key) is None:
                self._reap_target(key)
                continue
            for rule in self.rules:
                self._waiting.pop((key, rule.name), None)
                pairs.append((key, rule))
        for (key, rname), at in list(self._waiting.items()):
            if at <= clock:
                del self._waiting[(key, rname)]
                rule = by_name.get(rname)
                if rule is not None:
                    pairs.append((key, rule))
        out: List[Action] = []
        for key, rule in pairs:
            entry = entries.get(key)
            if entry is None:
                continue                # vanished since queueing
            self.stats["evaluated"] += 1
            if (key, rule.name) in self._live_by_target:
                continue                # one live action per (target, rule)
            if not rule.static_ok(key, entry, clock):
                continue
            at = rule.ready_at(entry)
            if at > clock:
                self._waiting[(key, rule.name)] = at   # age in later
                continue
            act = Action(next(self._cookie_seq), key, rule.name,
                         rule.action)
            self.actions[act.cookie] = act
            self._live_by_target[(key, rule.name)] = act.cookie
            self._emit(R.CL_ACTION_NEW, act, WAITING)
            self.stats["emitted"] += 1
            out.append(act)
        return out

    def _reap_target(self, key: Key) -> None:
        """Target gone: purge its live actions (the related repo's
        janitor calls these zombies) and forget its age-in waiters."""
        for k_rule in self._live_by_target.keys_of(key):
            self.purge(self._live_by_target[k_rule])
            self.stats["zombies_reaped"] += 1
        for k_rule in self._waiting.keys_of(key):
            del self._waiting[k_rule]

    def start(self, cookie: int) -> None:
        act = self.actions[cookie]
        self._emit(R.CL_ACTION_UPDATE, act, STARTED)

    def complete(self, cookie: int, ok: bool = True) -> None:
        act = self.actions[cookie]
        self._emit(R.CL_ACTION_COMPLETED, act, SUCCEED if ok else FAILED)
        self.stats["completed"] += 1

    def purge(self, cookie: int) -> None:
        act = self.actions.pop(cookie, None)
        if act is None:
            return
        self._live_by_target.pop((act.key, act.rule), None)
        self._emit(R.CL_ACTION_PURGED, act, act.status)
        self.stats["purged"] += 1

    def janitor_sweep(self) -> int:
        """Purge every action in a terminal state, closing its chain
        (the stream-side state drops it; the journal's collective ack
        can then trim it).  Returns chains purged."""
        done = [c for c, a in self.actions.items() if a.status in _TERMINAL]
        for cookie in done:
            self.purge(cookie)
        return len(done)

    # -- ground truth ----------------------------------------------------------
    def live_state(self) -> Dict[int, Tuple[Key, str, str]]:
        """cookie -> (target, rule, status) for every unpurged action —
        the 'hsm/actions file' the reconciler diffs the stream
        against."""
        return {c: (a.key, a.rule, a.status)
                for c, a in self.actions.items()}

    def run_pending(self, executor: Optional[Callable[[Action], bool]] = None,
                    ) -> int:
        """Drive WAITING actions through start -> complete, using
        ``executor`` (returns success) or succeeding by default — the
        in-process stand-in for an HSM copytool fleet."""
        n = 0
        for act in list(self.actions.values()):
            if act.status != WAITING:
                continue
            self.start(act.cookie)
            ok = True if executor is None else bool(executor(act))
            self.complete(act.cookie, ok=ok)
            n += 1
        return n
