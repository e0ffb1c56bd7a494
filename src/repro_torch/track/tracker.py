"""ActivityTracker — the per-host changelog producer (the MDT analogue).
The port of ``repro/track/tracker.py``, over the port's ``Llog``.

One tracker per runtime shard/host.  Every state-modifying operation of
the training run is logged as a changelog record with the LU-1996
extensions: ``jobid`` = run name, ``shard`` = (pod, host, mesh_row,
mesh_col), ``metrics``/``xattr`` as each event type needs.

fid convention (see records.Fid): seq = run id, oid = object id within
the event type's namespace, ver = step / version.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from ..core import records as R
from ..core.llog import Llog


class ActivityTracker:
    def __init__(self, run_id: int, host_id: int, jobid: str = "run",
                 shard: Tuple[int, int, int, int] = (0, 0, 0, 0),
                 path: Optional[str] = None,
                 mask: Optional[Sequence[int]] = None):
        self.run_id = run_id
        self.host_id = host_id
        self.jobid = jobid.encode()[:32]
        self.shard = shard
        self.llog = Llog(f"host{host_id}", path=path, mask=mask)

    def _log(self, rtype: int, oid: int, ver: int = 0, name: bytes = b"",
             pfid: R.Fid = R.NULL_FID, **ext) -> Optional[int]:
        rec = R.ChangelogRecord(
            type=rtype, tfid=R.Fid(self.run_id, oid, ver), pfid=pfid,
            name=name, jobid=self.jobid, shard=self.shard, **ext)
        return self.llog.log(rec)

    # -- training events ----------------------------------------------------
    def step_commit(self, step: int, loss: float, step_time_s: float,
                    tokens: int) -> Optional[int]:
        return self._log(R.CL_STEP_COMMIT, oid=self.host_id, ver=step,
                         name=b"step", metrics=(loss, step_time_s,
                                                float(tokens)))

    def ckpt_write(self, step: int, shard_id: int, nbytes: int,
                   path: str, total_shards: int) -> Optional[int]:
        return self._log(R.CL_CKPT_WRITE, oid=shard_id, ver=step,
                         name=path.encode(),
                         metrics=(float(nbytes),),
                         xattr={"total_shards": total_shards})

    def data_consume(self, step: int, shard_id: int, lo: int, hi: int) -> Optional[int]:
        """Record that sample range [lo, hi) of data shard ``shard_id``
        was consumed — the replay log for exact restart."""
        return self._log(R.CL_DATA_CONSUME, oid=shard_id, ver=step,
                         name=b"range", xattr={"lo": lo, "hi": hi})

    def heartbeat(self, step: int, step_time_s: float) -> Optional[int]:
        return self._log(R.CL_HEARTBEAT, oid=self.host_id, ver=step,
                         metrics=(step_time_s,))

    def elastic(self, joined: bool, n_hosts: int, step: int) -> Optional[int]:
        return self._log(R.CL_ELASTIC_JOIN if joined else R.CL_ELASTIC_LEAVE,
                         oid=self.host_id, ver=step,
                         xattr={"n_hosts": n_hosts})

    def evict(self, object_id: int, version: int, reason: str = "stale") -> Optional[int]:
        """Cache-invalidation notice (Ganesha analogue, paper §IV-C-1)."""
        return self._log(R.CL_EVICT, oid=object_id, ver=version,
                         name=reason.encode())

    # -- filesystem-flavoured events (kept for fidelity/benchmarks) ---------
    def fs_op(self, rtype: int, oid: int, name: bytes,
              parent_oid: int = 0) -> Optional[int]:
        return self._log(rtype, oid=oid, name=name,
                         pfid=R.Fid(self.run_id, parent_oid, 0))
