"""DEPRECATED changelog reader shims — use ``session.connect`` instead.

``LocalReader``/``RemoteReader`` were the seed's split consumer
bindings (paper §II's four-phase loop as raw plumbing: register, fetch,
ack, stop).  They survive as thin shims over the one ``Session``
backend so existing callers keep working, but new code should speak the
declarative API:

    session = connect(proxy_or_address)
    stream = session.subscribe(group, flags=..., types=...)

See ``session.py`` for the subscription contract (durable consumers,
op-type pushdown, auto-committing streams) and ARCHITECTURE.md for the
old-call -> new-call migration table.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from . import records as R
from .proxy import EPHEMERAL, PERSISTENT, LcapProxy  # noqa: F401 (re-export)
from .session import Subscription, connect


class _ReaderShim:
    """Shared deprecated reader surface over a Session backend."""

    def __init__(self, target, group: Optional[str], flags: Optional[int],
                 mode: str):
        self._session = connect(target)
        self._backend = self._session._backend
        self.flags = R.normalize_flags(flags)
        info = self._backend.attach(
            Subscription(group=group, mode=mode, flags=flags))
        self.cid = info["cid"]
        self.mode = mode

    def fetch_batches(self, max_records: int = 256,
                      ) -> List[Tuple[str, R.RecordBatch]]:
        # local remap: add (zero-fill) missing requested fields (§IV-A)
        return [(pid, batch.remap(self.flags))
                for pid, batch in self._backend.fetch(self.cid, max_records)]

    # record-level convenience over the batch path ---------------------------
    def fetch(self, max_records: int = 256,
              ) -> List[Tuple[str, R.ChangelogRecord]]:
        return [(pid, batch.record(i))
                for pid, batch in self.fetch_batches(max_records)
                for i in range(len(batch))]

    def ack(self, pid: str, index: int) -> None:
        self._backend.commit(self.cid, {pid: [index]})

    def ack_batch(self, pid: str, indices: Iterable[int]) -> None:
        self._backend.commit(self.cid, {pid: list(indices)})

    def close(self, failed: bool = False) -> None:
        if failed:
            # simulate a crash: the connection just drops; the proxy's
            # disconnect handling redelivers (or parks durable state)
            self._backend.crash(self.cid)
        else:
            try:
                self._backend.unsubscribe(self.cid)
            finally:
                self._backend.close()


class LocalReader(_ReaderShim):
    def __init__(self, proxy: LcapProxy, group: Optional[str],
                 flags: Optional[int] = None, mode: str = PERSISTENT):
        super().__init__(proxy, group, flags, mode)
        self.proxy = proxy


class RemoteReader(_ReaderShim):
    def __init__(self, address, group: Optional[str],
                 flags: Optional[int] = None, mode: str = PERSISTENT):
        # connect() accepts (host, port) and "host:port" alike
        super().__init__(address, group, flags, mode)
        self.rpc = self._backend.rpc
