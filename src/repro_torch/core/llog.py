"""Per-producer persistent changelog journal (paper §II, Lustre LLOG).

One ``Llog`` per producer (an MDT in Lustre; a host/runtime-shard in the
training framework).  Semantics follow the paper:

- Logging is armed as soon as at least one reader is registered.
- The administrator selects which operation types are logged (``mask``).
- Records receive a monotonically increasing ``cr_index`` and a
  ``cr_prev`` pointing at the previous record touching the same target.
- Records are kept (on disk when a path is given) *until read and
  acknowledged by all registered readers*; the trim point is the minimum
  acknowledged index across readers.
- Readers poll with an explicit start index (the paper calls out that the
  start command addresses a changelog index on a given MDT, not a reader
  ID — we reproduce that, and LCAP papers over it).

Storage is *segmented* (Lustre's llog is a chain of fixed-size log
objects — same idea): records append to the active segment, a full
segment is sealed and a new one started, and trimming drops whole
sealed segments in O(1) instead of rewriting the journal.  Each segment
doubles as a ``RecordBatch``: ``read()`` returns a batch view over the
segment buffer, so the consume path never materializes per-record
objects.

On-disk layout (when ``path`` is given): one file per segment,
``<path>.seg.<first-index>``, each a sequence of ``u32 length + packed
record``; reader positions live in the ``<path>.readers`` sidecar.  A
truncated final record (crash mid-append) is dropped on load.

With a ``history`` store attached (history.py), trimming *archives*
fully acknowledged segments instead of destroying them: the segment
file is adopted by the store with one rename (same framing), so a late
consumer can still bootstrap from compacted history while the live
journal stays aggressively trimmed.
"""

from __future__ import annotations

import bisect
import glob as _glob
import json
import os
import struct
import threading
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from . import records as R

_LEN = struct.Struct("<I")

DEFAULT_SEGMENT_RECORDS = 1024


class _Segment:
    """A run of contiguous records [first, first+len) backed by one
    append-only buffer (and, when persistent, one file)."""

    __slots__ = ("first", "data", "offsets", "lengths", "path")

    def __init__(self, first: int, path: Optional[str] = None):
        self.first = first
        self.data = bytearray()
        self.offsets: List[int] = []
        self.lengths: List[int] = []
        self.path = path

    def __len__(self) -> int:
        return len(self.offsets)

    @property
    def last(self) -> int:
        return self.first + len(self.offsets) - 1

    def append(self, buf: bytes) -> None:
        self.offsets.append(len(self.data))
        self.lengths.append(len(buf))
        self.data += buf

    def seal(self) -> None:
        """Freeze the segment: immutable bytes (batch views then
        extract records with a single copy instead of locking a live
        bytearray) and int64 offset/length columns (batch views slice
        them zero-copy instead of re-materializing per read)."""
        self.data = bytes(self.data)
        self.offsets = np.asarray(self.offsets, dtype=np.int64)
        self.lengths = np.asarray(self.lengths, dtype=np.int64)

    def batch(self, lo: int, count: int) -> R.RecordBatch:
        """Batch view over records [lo, lo+count) (segment-relative)."""
        return R.RecordBatch(self.data, self.offsets[lo:lo + count],
                             self.lengths[lo:lo + count])


class Llog:
    def __init__(self, producer_id: str, path: Optional[str] = None,
                 mask: Optional[Iterable[int]] = None,
                 segment_records: int = DEFAULT_SEGMENT_RECORDS,
                 history=None):
        self.producer_id = producer_id
        self.path = path
        self.mask = set(mask) if mask is not None else None  # None = all
        self.segment_records = max(1, segment_records)
        if history is True:                 # convenience: co-located store
            from .history import HistoryStore
            history = HistoryStore(path + ".hist" if path else None)
        self.history = history
        self._segments: List[_Segment] = []
        self._firsts: List[int] = []      # seg.first per segment (for bisect)
        self._first = 1                   # logical trim point (first live)
        self._next = 1
        self._prev_by_key: Dict[tuple, int] = {}
        self._readers: Dict[str, int] = {}   # reader_id -> acked-through index
        self._reader_seq = 0
        self._lock = threading.Lock()
        self._fh = None                   # handle on the active segment file
        self.stats = {"segments_dropped": 0, "segments_rolled": 0,
                      "truncated_dropped": 0}
        if path:
            self._load()

    # -- persistence --------------------------------------------------------
    def _sidecar(self) -> str:
        return self.path + ".readers"

    def _seg_path(self, first: int) -> str:
        return f"{self.path}.seg.{first:016d}"

    def _parse_segment_file(self, path: str, first: int) -> _Segment:
        seg = _Segment(first, path)
        with open(path, "rb") as fh:
            data = fh.read()
        off = 0
        while True:
            if off + 4 > len(data):
                if off < len(data):
                    # torn mid-prefix: truncate the stray bytes too, or
                    # post-recovery appends land after garbage and are
                    # destroyed by the *next* recovery
                    self.stats["truncated_dropped"] += 1
                    with open(path, "r+b") as fh:
                        fh.truncate(off)
                break
            (ln,) = _LEN.unpack_from(data, off)
            if off + 4 + ln > len(data) or ln < R.HDR_SIZE:
                # crash mid-append: drop the truncated tail record
                self.stats["truncated_dropped"] += 1
                with open(path, "r+b") as fh:
                    fh.truncate(off)
                break
            seg.append(data[off + 4:off + 4 + ln])
            off += 4 + ln
        return seg

    def _load(self) -> None:
        seg_files = sorted(_glob.glob(self.path + ".seg.*"))
        if not seg_files and os.path.exists(self.path):
            # migrate a legacy single-file journal into segment 0
            legacy = self._parse_segment_file(self.path, 0)
            if len(legacy):
                first_idx = legacy.batch(0, 1).packed_index(0)
                legacy.first = first_idx
                legacy.path = self._seg_path(first_idx)
                with open(legacy.path, "wb") as fh:
                    off = 0
                    for o, ln in zip(legacy.offsets, legacy.lengths):
                        fh.write(_LEN.pack(ln))
                        fh.write(bytes(legacy.data[o:o + ln]))
                self._segments.append(legacy)
            os.remove(self.path)
        else:
            for path in seg_files:
                first = int(path.rsplit(".", 1)[1])
                seg = self._parse_segment_file(path, first)
                if len(seg):
                    self._segments.append(seg)
                else:
                    os.remove(path)
        if self._segments:
            for seg in self._segments[:-1]:      # only the last stays active
                seg.seal()
            self._first = self._segments[0].first
            self._next = self._segments[-1].last + 1
        self._firsts = [seg.first for seg in self._segments]
        if os.path.exists(self._sidecar()):
            with open(self._sidecar()) as fh:
                meta = json.load(fh)
            self._readers = {k: int(v) for k, v in meta["readers"].items()}
            self._reader_seq = meta.get("seq", len(self._readers))
            self._first = meta.get("first", self._first)
            self._next = max(self._next, meta.get("next", self._next))

    def _persist_meta(self) -> None:
        if not self.path:
            return
        tmp = self._sidecar() + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"readers": self._readers, "seq": self._reader_seq,
                       "first": self._first, "next": self._next}, fh)
        os.replace(tmp, self._sidecar())

    def _append_disk(self, seg: _Segment, buf: bytes) -> None:
        if not self.path:
            return
        if self._fh is None:
            self._fh = open(seg.path, "ab")
        self._fh.write(_LEN.pack(len(buf)) + buf)
        self._fh.flush()

    # -- segment management --------------------------------------------------
    def _active_segment(self) -> _Segment:
        if self._segments and len(self._segments[-1]) < self.segment_records:
            return self._segments[-1]
        # seal the active segment, roll a new one
        if self._segments:
            self._segments[-1].seal()
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        seg = _Segment(self._next,
                       self._seg_path(self._next) if self.path else None)
        self._segments.append(seg)
        self._firsts.append(seg.first)
        if self._segments[:-1]:
            self.stats["segments_rolled"] += 1
        return seg

    @property
    def segment_count(self) -> int:
        return len(self._segments)

    # -- reader registry -----------------------------------------------------
    @property
    def enabled(self) -> bool:
        return bool(self._readers)

    def register_reader(self, name: Optional[str] = None,
                        resume: bool = False) -> str:
        """Register (or, with ``resume``, re-attach to) a reader.
        Registrations are persistent — a restarted reader resumes at its
        acknowledged position and replays everything unacknowledged
        (at-least-once across restarts)."""
        with self._lock:
            self._reader_seq += 1
            rid = name or f"cl{self._reader_seq}"
            if rid in self._readers:
                if resume:
                    return rid
                raise ValueError(f"reader {rid} already registered")
            # a new reader only owes acks for records logged from now on
            self._readers[rid] = self._next - 1
            self._persist_meta()
            return rid

    def deregister_reader(self, rid: str) -> None:
        with self._lock:
            self._readers.pop(rid, None)
            self._trim_locked()
            self._persist_meta()

    def attach_reader(self, name: str) -> Tuple[str, int]:
        """Register (or re-attach) a *consuming* reader under ``name``
        and return ``(rid, start index)``.

        A brand-new consuming reader starts at the journal's first live
        record and owes acknowledgements for all of it (position
        ``first_index - 1`` — unlike ``register_reader``, whose new
        readers only owe acks for records logged from then on).  An
        existing reader resumes right after its *own* acked watermark,
        never at a trim point a slower co-registered reader holds back,
        and never before ``first_index``.  Both halves are what
        at-least-once needs across restarts: backlog delivered but not
        yet acked is re-ingested; backlog already acked is not."""
        with self._lock:
            if name not in self._readers:
                self._readers[name] = self._first - 1
                self._persist_meta()
            return name, max(self._first, self._readers[name] + 1)

    def has_reader(self, rid: str) -> bool:
        with self._lock:
            return rid in self._readers

    def reader_position(self, rid: str) -> int:
        """The highest index reader ``rid`` has acknowledged.  A restarted
        reader resumes at ``max(first_index, reader_position + 1)`` —
        records before its own watermark were already consumed, even when
        a slower co-registered reader holds the trim point further back."""
        with self._lock:
            if rid not in self._readers:
                raise KeyError(f"unknown reader {rid}")
            return self._readers[rid]

    # -- producing -----------------------------------------------------------
    def _log_locked(self, rec: R.ChangelogRecord) -> Optional[int]:
        if self.mask is not None and rec.type not in self.mask:
            return None
        rec.index = self._next
        rec.prev = self._prev_by_key.get(rec.key(), 0)
        self._prev_by_key[rec.key()] = rec.index
        if not rec.time:
            rec.time = R.now_ns()
        buf = R.pack(rec)
        seg = self._active_segment()
        seg.append(buf)
        self._next += 1
        self._append_disk(seg, buf)
        return rec.index

    def log(self, rec: R.ChangelogRecord) -> Optional[int]:
        """Append a record; returns its index, or None when not logged
        (no registered reader, or type masked out)."""
        with self._lock:
            if not self._readers:
                return None
            return self._log_locked(rec)

    def log_batch(self, recs: Iterable[R.ChangelogRecord]) -> List[int]:
        """Append many records under one lock acquisition; returns the
        indices of the records actually logged."""
        out: List[int] = []
        with self._lock:
            if not self._readers:
                return out
            for rec in recs:
                idx = self._log_locked(rec)
                if idx is not None:
                    out.append(idx)
        return out

    # -- consuming -----------------------------------------------------------
    @property
    def first_index(self) -> int:
        return self._first

    @property
    def last_index(self) -> int:
        return self._next - 1

    def read(self, start: int, max_records: int = 1024) -> R.RecordBatch:
        """Return a ``RecordBatch`` view of packed records with index >=
        ``start`` (at most ``max_records``).  ``start`` is a changelog
        index, per the paper.  The batch shares the segment buffers —
        zero copy until a consumer extracts a record."""
        with self._lock:
            if start < self._first:
                start = self._first
            return self._read_locked(start, max_records)

    def read_raw(self, start: int, max_records: int = 1024) -> R.RecordBatch:
        """Like ``read`` but without clamping ``start`` to the logical
        trim point: records logically trimmed but still physically
        present (their segment not yet fully acknowledged and dropped)
        are served.  Replay-bootstrap readers use this for the span
        between compacted history and the live trim point, keeping the
        history+journal union gapless."""
        with self._lock:
            return self._read_locked(start, max_records)

    def _read_locked(self, start: int, max_records: int) -> R.RecordBatch:
        views: List[R.RecordBatch] = []
        want = max_records
        # first segment that may hold ``start``: the last one whose
        # first index is <= start — O(log n) with thousands of
        # sealed segments instead of a whole-list scan
        pos = bisect.bisect_right(self._firsts, start) - 1
        for seg in self._segments[max(0, pos):]:
            if want <= 0:
                break
            if seg.last < start or not len(seg):
                continue
            lo = max(0, start - seg.first)
            take = min(want, len(seg) - lo)
            if take > 0:
                views.append(seg.batch(lo, take))
                want -= take
        if not views:
            return R.RecordBatch.empty()
        if len(views) == 1:
            return views[0]
        return R.RecordBatch.concat(views)

    def ack(self, rid: str, index: int) -> None:
        """Acknowledge (clear) records up to ``index`` for reader ``rid``;
        trims storage up to the minimum acked index across readers."""
        with self._lock:
            if rid not in self._readers:
                raise KeyError(f"unknown reader {rid}")
            if index > self._readers[rid]:
                self._readers[rid] = index
            self._trim_locked()
            self._persist_meta()

    def _trim_locked(self) -> None:
        if not self._readers:
            return
        # an over-ack (index beyond anything logged) must not push the
        # trim point past the records that actually exist
        horizon = min(min(self._readers.values()), self._next - 1)
        if horizon < self._first:
            return
        self._first = horizon + 1
        # drop whole segments below the logical trim point — O(1) per
        # segment, never a journal rewrite.  With a history store the
        # drop is an *archive*: the store adopts the segment file by
        # rename (same framing) before the journal forgets it.
        while self._segments and self._segments[0].last < self._first:
            seg = self._segments.pop(0)
            self._firsts.pop(0)
            if len(self._segments) == 0 and self._fh is not None:
                self._fh.close()
                self._fh = None
            adopted = False
            if self.history is not None and len(seg):
                adopted = self.history.archive(seg.batch(0, len(seg)),
                                               seg.first, seg.last,
                                               move_from=seg.path)
            if not adopted and seg.path and os.path.exists(seg.path):
                os.remove(seg.path)
            self.stats["segments_dropped"] += 1

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def from_packed(producer_id: str, buf, offsets, lengths,
                first_index: int = 1, path: Optional[str] = None,
                segment_records: int = DEFAULT_SEGMENT_RECORDS,
                history=None) -> Llog:
    """A journal that holds the packed records ``buf[offsets[i]:
    offsets[i] + lengths[i]]`` at indices ``first_index, first_index +
    1, ...`` — each record's own ``cr_index`` must already say so.

    This is how a journal crosses from the reference package (or any
    producer that packs records itself) into the port with its indices
    identical: the records are cut into segments exactly as appends
    would have cut them, the ``cr_prev`` chain state is rebuilt from
    their target FIDs, and with ``path`` the segment files are written
    in the on-disk framing ``Llog`` loads.  Like a fresh journal, it has
    no readers yet; ``path`` must not hold a journal already."""
    offsets = np.asarray(offsets, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    if offsets.shape != lengths.shape or offsets.ndim != 1:
        raise ValueError("offsets and lengths must be equal-length 1-D")
    log = Llog(producer_id, path=path, segment_records=segment_records,
               history=history)
    if log._segments or log._readers:
        raise ValueError(f"journal {path!r} already holds records")
    buf = bytes(buf)
    n = len(offsets)
    if n:
        batch = R.RecordBatch(buf, offsets, lengths)
        want = np.arange(first_index, first_index + n, dtype=np.uint64)
        if not np.array_equal(batch.indices_np(), want):
            raise ValueError("record indices must run first_index, "
                             "first_index + 1, ... in order")
        log._prev_by_key = dict(zip(batch.keys(), batch.indices()))
    log._first = log._next = first_index
    step = log.segment_records
    for lo in range(0, n, step):
        seg = _Segment(first_index + lo,
                       log._seg_path(first_index + lo) if path else None)
        for o, ln in zip(offsets[lo:lo + step].tolist(),
                         lengths[lo:lo + step].tolist()):
            seg.append(buf[o:o + ln])
        if seg.path:
            with open(seg.path, "wb") as fh:
                fh.write(b"".join(
                    _LEN.pack(ln) + bytes(seg.data[o:o + ln])
                    for o, ln in zip(seg.offsets, seg.lengths)))
        if lo + step < n:
            seg.seal()                     # only the last stays active
        log._segments.append(seg)
        log._firsts.append(seg.first)
        log._next = seg.last + 1
    log.stats["segments_rolled"] = max(0, len(log._segments) - 1)
    return log
