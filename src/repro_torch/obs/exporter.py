"""Metric export edges: Prometheus text scrape + Ganglia-shaped push.
The port of ``repro/obs/exporter.py``.

Both edges render the same source — a ``MetricsRegistry`` snapshot
(which already folds in any registered aggregator collectors) — so
everything visible on the dashboard is also visible to the fleet
monitoring stack.

- :class:`PrometheusExporter`: a stdlib-only threaded HTTP server whose
  ``GET /metrics`` serves text exposition format 0.0.4 (``# HELP`` /
  ``# TYPE`` heads, escaped labels, ``_bucket``/``_sum``/``_count``
  histogram expansion).
- :class:`GangliaPusher`: flattens the same snapshot into gmond-module
  shaped metric dicts — dotted names built from a ``name_map`` plus the
  label values, with units, like the lustre gmond module's per-target
  stats — handed to a pluggable ``send`` callable (gmetric spawn, UDP
  socket, or the default in-memory list for tests).
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional

__all__ = ["render_prometheus", "PrometheusExporter", "GangliaPusher"]


# ------------------------------------------------------------- text format
def _sanitize_name(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        ok = ch.isascii() and (ch.isalpha() or ch == "_"
                               or (ch.isdigit() and i > 0) or ch == ":")
        out.append(ch if ok else "_")
    return "".join(out)


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_sanitize_name(k)}="{_escape_label(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(snapshot: Dict[str, dict]) -> str:
    """Render a registry snapshot as Prometheus exposition text."""
    lines: List[str] = []
    for name in sorted(snapshot):
        ent = snapshot[name]
        mname = _sanitize_name(name)
        kind = ent.get("type", "untyped")
        help_ = ent.get("help", "")
        if help_:
            lines.append(f"# HELP {mname} {_escape_label(help_)}")
        lines.append(f"# TYPE {mname} {kind}")
        for labels, value in ent.get("samples", []):
            if kind == "histogram":
                for le, cum in value["buckets"]:
                    lb = dict(labels, le=_fmt_value(le))
                    lines.append(f"{mname}_bucket{_fmt_labels(lb)} {cum}")
                inf = dict(labels, le="+Inf")
                lines.append(
                    f"{mname}_bucket{_fmt_labels(inf)} {value['count']}")
                lines.append(f"{mname}_sum{_fmt_labels(labels)} "
                             f"{_fmt_value(value['sum'])}")
                lines.append(f"{mname}_count{_fmt_labels(labels)} "
                             f"{value['count']}")
            else:
                lines.append(
                    f"{mname}{_fmt_labels(labels)} {_fmt_value(value)}")
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------ HTTP scrape
class PrometheusExporter:
    """Serve ``GET /metrics`` for a registry (or any ``snapshot()``-
    shaped source, e.g. ``LcapCluster.metrics``)."""

    content_type = "text/plain; version=0.0.4; charset=utf-8"

    def __init__(self, registry=None, snapshot_fn: Optional[
            Callable[[], Dict[str, dict]]] = None,
            host: str = "127.0.0.1", port: int = 0):
        if (registry is None) == (snapshot_fn is None):
            raise ValueError("pass exactly one of registry / snapshot_fn")
        self._snapshot = snapshot_fn or registry.snapshot
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):                          # noqa: N802
                if self.path.split("?", 1)[0] != "/metrics":
                    self.send_error(404)
                    return
                body = exporter.render().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", exporter.content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):              # quiet
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.address = self._httpd.server_address
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)

    @property
    def url(self) -> str:
        return f"http://{self.address[0]}:{self.address[1]}/metrics"

    def render(self) -> str:
        return render_prometheus(self._snapshot())

    def start(self) -> "PrometheusExporter":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


# ------------------------------------------------------------ Ganglia push
class GangliaPusher:
    """Push-mode export, shaped like a gmond python module.

    Each ``push()`` flattens the current snapshot into
    ``{"name", "value", "type", "units", "group"}`` dicts — the keyword
    surface of ``gmetric``/``gmond`` metric descriptors — and hands each
    to ``send``.  Names are dotted: ``prefix.short_name.label_values``,
    with ``name_map`` renaming the wire-format metric names to the short
    operator-facing ones (the lustre gmond module idiom)."""

    #: registry name -> (short name, units); everything else passes
    #: through with its units guessed from the name suffix
    name_map = {
        "lcap_proxy_ingested_total": ("ingested", "records"),
        "lcap_proxy_dispatched_total": ("dispatched", "records"),
        "lcap_proxy_filtered_out_total": ("filtered", "records"),
        "lcap_proxy_redelivered_total": ("redelivered", "records"),
        "lcap_proxy_ephemeral_drops_total": ("eph_drops", "records"),
        "lcap_buffered_records": ("buffered", "records"),
        "lcap_consumer_outbox_depth": ("outbox", "records"),
        "lcap_consumer_in_flight": ("in_flight", "records"),
        "lcap_ack_watermark": ("ack_wm", "index"),
        "lcap_ack_in_flight": ("unacked", "records"),
        "lcap_ack_delivered_records_total": ("delivered", "records"),
        "lcap_ack_acked_records_total": ("acked", "records"),
        "lcap_ingest_watermark": ("ingest_wm", "index"),
        "lcap_cluster_routed_total": ("routed", "records"),
        "lcap_cluster_failover_redelivered_total": ("refed", "records"),
        "lcap_shard_alive": ("alive", "boolean"),
        "lcap_shard_slots_owned": ("slots", "slots"),
        "lcap_agg_records_total": ("agg_records", "records"),
        "lcap_agg_late_dropped_total": ("agg_late", "records"),
        "lcap_pump_latency_seconds": ("pump_latency", "seconds"),
        "lcap_window_records": ("win_records", "records"),
        "lcap_window_value_sum": ("win_value", "units"),
        "lcap_transport_bytes_total": ("net_bytes", "bytes"),
        "lcap_transport_messages_total": ("net_msgs", "frames"),
    }

    def __init__(self, registry=None, snapshot_fn: Optional[
            Callable[[], Dict[str, dict]]] = None,
            send: Optional[Callable[[dict], None]] = None,
            prefix: str = "lcap", group: str = "lustre_activity"):
        if (registry is None) == (snapshot_fn is None):
            raise ValueError("pass exactly one of registry / snapshot_fn")
        self._snapshot = snapshot_fn or registry.snapshot
        self.prefix = prefix
        self.group = group
        self.sent: List[dict] = []
        self._send = send or self.sent.append

    def _name(self, name: str, labels: Dict[str, str]) -> str:
        short = self.name_map.get(name, (name, None))[0]
        parts = [self.prefix, short]
        parts.extend(str(labels[k]) for k in sorted(labels) if labels[k])
        return ".".join(p.replace(".", "_").replace(" ", "_")
                        for p in parts if p)

    def _units(self, name: str, kind: str) -> str:
        mapped = self.name_map.get(name)
        if mapped and mapped[1]:
            return mapped[1]
        if name.endswith("_seconds"):
            return "seconds"
        if name.endswith("_bytes_total") or name.endswith("_bytes"):
            return "bytes"
        return "count" if kind == "counter" else "value"

    def push(self) -> int:
        """Flatten and send one snapshot; returns metrics pushed.
        Histograms ship their ``_count`` and ``_sum`` (gmond has no
        histogram type)."""
        n = 0
        for name, ent in sorted(self._snapshot().items()):
            kind = ent.get("type", "gauge")
            for labels, value in ent.get("samples", []):
                base = self._name(name, labels)
                if kind == "histogram":
                    emit = [(base + ".count", value["count"], "count"),
                            (base + ".sum", value["sum"],
                             self._units(name, kind))]
                else:
                    emit = [(base, value, self._units(name, kind))]
                for mname, mval, units in emit:
                    self._send({"name": mname, "value": mval,
                                "type": "counter" if kind == "counter"
                                else "gauge",
                                "units": units, "group": self.group})
                    n += 1
        return n
