"""Observability plane over the LCAP stream; the port of ``repro.obs``.

Three layers, each owning a different kind of signal:

- :mod:`repro_torch.obs.registry` — typed internal metrics (counter /
  gauge / histogram) that the proxy, cluster, ack tracker, and
  transport publish into.  These describe the *fabric*: dispatch
  latency, outbox depth, backpressure parks, redeliveries.
- :mod:`repro_torch.obs.aggregator` — a windowed aggregation consumer
  that folds the *stream itself* into per-(op, jobid, producer, shard)
  tumbling windows with sliding views and trend deltas.
- :mod:`repro_torch.obs.exporter` / :mod:`repro_torch.obs.dashboard` —
  the edges: a Prometheus-text HTTP endpoint, a Ganglia-shaped pusher,
  and a ``top``-style terminal view.

:mod:`repro_torch.obs.spans` observes the model path instead: spans
kept as ``torch.profiler`` events while a profiler records, and the MoE
layers' slot counters of the serving calls made meanwhile.
"""

from .registry import (          # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, merge_snapshots,
)
from .aggregator import ActivityAggregator   # noqa: F401
from .exporter import (          # noqa: F401
    PrometheusExporter, GangliaPusher, render_prometheus,
)
from .dashboard import ActivityTop           # noqa: F401
