"""Typed internal metrics: counters, gauges, histograms, atomic snapshots.
The port of ``repro/obs/registry.py``.

The registry unifies the ad-hoc ``proxy.stats`` / ``cluster.stats``
dicts into labeled instruments with one wire-friendly snapshot format.
Two publishing styles are supported:

- **push**: code holds an instrument child and calls ``inc()`` /
  ``set()`` / ``observe()`` on the hot path (cheap: one lock, one add).
- **pull**: a *collector* callable is registered and invoked at
  ``snapshot()`` time, yielding ``(name, kind, help, labels, value)``
  tuples read from live state (the proxy exports its ``stats`` dict and
  per-group ack-tracker depths this way, so the hot path pays nothing).

``snapshot()`` returns a plain msgpack-able dict — the payload of the
``metrics`` RPC verb — and :func:`merge_snapshots` folds per-shard
snapshots into one cluster view (summing counters/histograms, relabeling
by shard so gauges never collide).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "merge_snapshots",
    "DEFAULT_BUCKETS",
]

#: default histogram buckets (seconds) — spans sub-ms pump latencies up
#: to multi-second stalls.
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
    0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class Counter:
    """Monotonically increasing value."""

    __slots__ = ("_lock", "_value")
    kind = "counter"

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _sample(self) -> float:
        return self.value


class Gauge:
    """Point-in-time value; may also be bound to a callable."""

    __slots__ = ("_lock", "_value", "_fn")
    kind = "gauge"

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    def set_function(self, fn: Callable[[], float]) -> None:
        """Read ``fn()`` at snapshot time instead of a stored value."""
        self._fn = fn

    @property
    def value(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        with self._lock:
            return self._value

    def _sample(self) -> float:
        return self.value


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics)."""

    __slots__ = ("_lock", "buckets", "_counts", "_sum", "_count")
    kind = "histogram"

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        b = sorted(float(x) for x in buckets)
        if not b:
            raise ValueError("histogram needs at least one bucket")
        self._lock = threading.Lock()
        self.buckets = tuple(b)
        self._counts = [0] * len(b)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        with self._lock:
            self._sum += value
            self._count += 1
            # linear probe: pump latencies cluster in the low buckets
            for i, le in enumerate(self.buckets):
                if value <= le:
                    self._counts[i] += 1
                    break

    def _sample(self) -> dict:
        with self._lock:
            cum, out = 0, []
            for le, c in zip(self.buckets, self._counts):
                cum += c
                out.append([le, cum])
            return {"buckets": out, "sum": self._sum, "count": self._count}


class _Family:
    """A named metric with a fixed label schema; children per label set."""

    __slots__ = ("name", "help", "kind", "labelnames", "_make", "_lock",
                 "_children")

    def __init__(self, name: str, help: str, kind: str,
                 labelnames: Tuple[str, ...], make: Callable[[], object]):
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames = labelnames
        self._make = make
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not labelnames:                    # usable directly when unlabeled
            self._children[()] = make()

    def labels(self, **kv: object):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(kv))}")
        key = tuple(str(kv[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make()
            return child

    # unlabeled convenience: family proxies to its single child
    def inc(self, amount: float = 1.0) -> None:
        self._children[()].inc(amount)          # type: ignore[attr-defined]

    def set(self, value: float) -> None:
        self._children[()].set(value)           # type: ignore[attr-defined]

    def dec(self, amount: float = 1.0) -> None:
        self._children[()].dec(amount)          # type: ignore[attr-defined]

    def observe(self, value: float) -> None:
        self._children[()].observe(value)       # type: ignore[attr-defined]

    def set_function(self, fn: Callable[[], float]) -> None:
        self._children[()].set_function(fn)     # type: ignore[attr-defined]

    @property
    def value(self):
        return self._children[()].value         # type: ignore[attr-defined]

    def _samples(self) -> List[list]:
        with self._lock:
            items = list(self._children.items())
        out = []
        for key, child in items:
            labels = dict(zip(self.labelnames, key))
            out.append([labels, child._sample()])  # type: ignore[attr-defined]
        return out


#: collector yield type: (name, kind, help, labels, value)
CollectorSample = Tuple[str, str, str, Dict[str, str], float]


class MetricsRegistry:
    """Instrument factory + atomic snapshot over instruments and collectors."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}
        self._collectors: List[Callable[[], Iterable[CollectorSample]]] = []

    # ------------------------------------------------------------ factories
    def _family(self, name: str, help: str, kind: str,
                labels: Sequence[str], make: Callable[[], object]) -> _Family:
        labelnames = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} re-registered as {kind}"
                        f"{labelnames}, was {fam.kind}{fam.labelnames}")
                return fam
            fam = self._families[name] = _Family(
                name, help, kind, labelnames, make)
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> _Family:
        return self._family(name, help, "counter", labels, Counter)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> _Family:
        return self._family(name, help, "gauge", labels, Gauge)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Family:
        return self._family(name, help, "histogram", labels,
                            lambda: Histogram(buckets))

    def register_collector(
            self, fn: Callable[[], Iterable[CollectorSample]]) -> None:
        with self._lock:
            self._collectors.append(fn)

    # ------------------------------------------------------------- snapshot
    def snapshot(self) -> Dict[str, dict]:
        """One msgpack-able view: ``{name: {type, help, samples}}`` where
        each sample is ``[labels_dict, value]`` (histogram values are
        ``{buckets: [[le, cumulative], ...], sum, count}``)."""
        with self._lock:
            families = list(self._families.values())
            collectors = list(self._collectors)
        out: Dict[str, dict] = {}
        for fam in families:
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "samples": fam._samples()}
        for fn in collectors:
            for name, kind, help, labels, value in fn():
                ent = out.setdefault(
                    name, {"type": kind, "help": help, "samples": []})
                ent["samples"].append([dict(labels), value])
        return out


def _merge_value(kind: str, a, b):
    if kind == "histogram":
        # bucket schemas match across shards (same code built them)
        buckets = [[le, ca + cb] for (le, ca), (_, cb)
                   in zip(a["buckets"], b["buckets"])]
        return {"buckets": buckets, "sum": a["sum"] + b["sum"],
                "count": a["count"] + b["count"]}
    return a + b


def merge_snapshots(per_shard: Dict[str, Dict[str, dict]],
                    shard_label: str = "shard") -> Dict[str, dict]:
    """Fold per-shard snapshots into one cluster snapshot.

    Counters and histograms with identical label sets are summed;
    gauges keep a ``shard`` label so per-shard depths stay visible
    (summing outbox depth across shards hides a hot shard).
    """
    out: Dict[str, dict] = {}
    for sid, snap in sorted(per_shard.items()):
        for name, ent in snap.items():
            tgt = out.setdefault(
                name, {"type": ent["type"], "help": ent.get("help", ""),
                       "samples": []})
            for labels, value in ent["samples"]:
                labels = dict(labels)
                if ent["type"] == "gauge":
                    labels[shard_label] = str(sid)
                for row in tgt["samples"]:
                    if row[0] == labels:
                        row[1] = _merge_value(ent["type"], row[1], value)
                        break
                else:
                    tgt["samples"].append([labels, value])
    return out
