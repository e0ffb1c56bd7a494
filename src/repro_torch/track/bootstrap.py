"""Fast object-index traversal (paper §IV-C-2).
The port of ``repro/track/bootstrap.py``.

Instead of a POSIX-style scan to populate a fresh policy/metrics
database, synthesize "a special changelog stream, filled with entries
from the MDT object index, and consumed by instances of the policy
engine".  Here the object index is the framework's checkpoint/object
manifest; the synthetic stream is consumed through ordinary Session
subscriptions by load-balanced MetricsDB instances exactly like live
records — no separate scan path:

    proxy = LcapProxy({"index0": synthesize_index_stream(index)})
    workers = [MetricsDB(proxy, db_path) for _ in range(4)]
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

from ..core import records as R
from ..core.llog import Llog


def synthesize_index_stream(index: Iterable[Tuple[int, int, str, int]],
                            run_id: int = 0,
                            producer_id: str = "index0") -> Llog:
    """Build an Llog pre-filled with one CL_MARK record per index entry.

    ``index`` yields (oid, version, name, nbytes).  The returned journal
    is handed to an LcapProxy as an extra producer; a consumer group
    drains it collaboratively (this is what makes the traversal fast —
    it parallelizes like any other changelog stream).
    """
    log = Llog(producer_id)
    log.register_reader("bootstrap-hold")  # arms logging; holds trim
    log.log_batch(R.ChangelogRecord(
        type=R.CL_MARK, tfid=R.Fid(run_id, oid, ver),
        name=name.encode(), metrics=(float(nbytes),),
        xattr={"bootstrap": True}) for oid, ver, name, nbytes in index)
    return log
