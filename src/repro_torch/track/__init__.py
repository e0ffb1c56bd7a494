"""repro_torch.track — LCAP integrated as the framework's activity
backbone; the port of ``repro.track``.

Producers: every runtime shard owns an ``ActivityTracker`` (an ``Llog``
producer) and emits a changelog record for each state-modifying training
operation.  Consumers are LCAP groups: a load-balanced metrics database
(the Robinhood analogue), the checkpoint committer, the straggler
detector, the elastic controller, serving-side cache invalidation
(the Ganesha analogue) and per-jobid audit trails.
"""

from .tracker import ActivityTracker
from .audit import AuditTrail, JobTrail
from .consumers import (CacheInvalidator, CheckpointCommitter, ElasticController,
                        MetricsDB, StragglerDetector)
from .bootstrap import synthesize_index_stream

__all__ = ["ActivityTracker", "MetricsDB", "CheckpointCommitter",
           "StragglerDetector", "ElasticController", "CacheInvalidator",
           "AuditTrail", "JobTrail", "synthesize_index_stream"]
