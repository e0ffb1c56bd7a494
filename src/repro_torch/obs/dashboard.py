"""``top`` for the activity stream — a curses-free live terminal view.
The port of ``repro/obs/dashboard.py``.

Renders, from an :class:`ActivityAggregator` plus optional session /
cluster handles:

- headline window rates and totals with a per-window sparkline,
- the busiest jobids / op types / shards of the newest pane(s) with
  trend arrows (diff vs the previous same-width span),
- consumer lag per (group, producer) — dispatch watermark minus the
  group's ack cursor (``Session.lag`` / ``ClusterSession.lag``),
- shard health (alive/dead, slots owned, routing counters) when a
  ``LcapCluster`` handle is given.

``render()`` returns the frame as a string (what the tests drive);
``run()`` repaints in place with ANSI clear — no curses dependency, so
it works over any dumb pipe and in CI logs.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

__all__ = ["ActivityTop"]

_SPARK = "▁▂▃▄▅▆▇█"


def _spark(values: List[float], width: int = 24) -> str:
    if not values:
        return ""
    tail = values[-width:]
    hi = max(tail) or 1.0
    return "".join(_SPARK[min(len(_SPARK) - 1,
                              int(v / hi * (len(_SPARK) - 1)))]
                   for v in tail)


def _arrow(delta: float) -> str:
    if delta > 0:
        return f"↑{delta:+,.0f}"
    if delta < 0:
        return f"↓{delta:+,.0f}"
    return "·"


def _fmt_count(v: float) -> str:
    return f"{v:,.0f}"


class ActivityTop:
    def __init__(self, aggregator, session=None, cluster=None,
                 k: int = 8, sliding: int = 1, width: int = 78):
        self.agg = aggregator
        self.session = session        # Session or ClusterSession (lag())
        self.cluster = cluster        # LcapCluster (shard health)
        self.k = k
        self.sliding = sliding
        self.width = width

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> dict:
        """The structured data one frame renders (stable test surface)."""
        agg = self.agg
        snap = {
            "window_ns": agg.window_ns,
            "windows": agg.totals(),
            "stats": dict(agg.stats),
            "top": {dim: agg.top(dim, k=self.k, sliding=self.sliding)
                    for dim in ("jobid", "op", "producer", "shard")},
            "lag": {},
            "shards": [],
        }
        if self.session is not None:
            try:
                lag = self.session.lag()
            except (ConnectionError, OSError):
                lag = {}
            snap["lag"] = {g: v for g, v in lag.items()
                           if g != "per_shard"}
        if self.cluster is not None:
            owned = [0] * len(self.cluster.shards)
            for o in self.cluster.slot_owner:
                owned[o] += 1
            snap["shards"] = [
                {"index": i, "alive": bool(self.cluster.alive[i]),
                 "slots": owned[i]}
                for i in range(len(self.cluster.shards))]
            snap["cluster_stats"] = dict(self.cluster.stats)
        return snap

    # -------------------------------------------------------------- render
    def render(self) -> str:
        s = self.snapshot()
        w = self.width
        lines: List[str] = []
        secs = s["window_ns"] / 1e9
        windows = s["windows"]
        total = sum(c for _, c, _ in windows)
        cur_rate = (windows[-1][1] / secs) if windows else 0.0
        lines.append(f"lcap top — pane {secs:g}s · {len(windows)} retained "
                     f"· {_fmt_count(total)} records "
                     f"· {_fmt_count(cur_rate)} rec/s")
        lines.append(_spark([c for _, c, _ in windows]) or "(no traffic yet)")
        st = s["stats"]
        lines.append(f"folded {_fmt_count(st['records'])} in "
                     f"{_fmt_count(st['batches'])} batches · late "
                     f"{_fmt_count(st['late_dropped'])} · evicted "
                     f"{_fmt_count(st['windows_evicted'])} panes")
        lines.append("─" * w)

        for dim, title in (("jobid", "BUSIEST JOBS"),
                           ("op", "BUSIEST OPS"),
                           ("shard", "BUSIEST SHARDS"),
                           ("producer", "BUSIEST PRODUCERS")):
            rows = s["top"][dim]
            if not rows:
                continue
            lines.append(f"{title:<24}{'COUNT':>12}{'RATE/S':>12}"
                         f"{'VALUE':>14}{'TREND':>12}")
            for r in rows:
                label = str(r["label"]) or "(none)"
                lines.append(f"  {label[:22]:<22}"
                             f"{_fmt_count(r['count']):>12}"
                             f"{r['rate']:>12,.1f}"
                             f"{r['value_sum']:>14,.2f}"
                             f"{_arrow(r['delta']):>12}")
            lines.append("")

        if s["lag"]:
            lines.append(f"{'CONSUMER LAG':<18}{'PRODUCER':>12}"
                         f"{'DISPATCH':>12}{'ACK':>12}{'LAG':>9}"
                         f"{'IN-FLIGHT':>11}")
            for group in sorted(s["lag"]):
                for pid in sorted(s["lag"][group]):
                    ent = s["lag"][group][pid]
                    lines.append(f"  {group[:16]:<16}{pid:>12}"
                                 f"{ent['dispatch_hw']:>12,}"
                                 f"{ent['ack']:>12,}{ent['lag']:>9,}"
                                 f"{ent['in_flight']:>11,}")
            lines.append("")

        if s["shards"]:
            health = "  ".join(
                f"shard{e['index']}[{'UP' if e['alive'] else 'DOWN'}"
                f" {e['slots']}sl]" for e in s["shards"])
            lines.append(f"SHARDS  {health}")
            cs = s.get("cluster_stats", {})
            if cs:
                lines.append(f"  routed {_fmt_count(cs.get('routed', 0))} "
                             f"· rounds {_fmt_count(cs.get('routing_rounds', 0))} "
                             f"· failed {cs.get('shards_failed', 0)} "
                             f"· failover redelivered "
                             f"{_fmt_count(cs.get('failover_redelivered', 0))}")
        return "\n".join(lines)

    # ----------------------------------------------------------- live loop
    def run(self, interval: float = 1.0, iterations: Optional[int] = None,
            out=None, clear: bool = True, poll: bool = True) -> None:
        """Repaint every ``interval`` seconds (``iterations=None`` runs
        until interrupted).  With ``poll`` the aggregator's stream is
        drained before each frame — one-process demos need no separate
        consumer thread."""
        out = out or sys.stdout
        n = 0
        try:
            while iterations is None or n < iterations:
                if poll:
                    self.agg.run_once()
                frame = self.render()
                if clear:
                    out.write("\x1b[2J\x1b[H")
                out.write(frame + "\n")
                out.flush()
                n += 1
                if iterations is not None and n >= iterations:
                    break
                time.sleep(interval)
        except KeyboardInterrupt:
            pass
