"""Compacted history tier — replayable past for the changelog stream.

The live journal (``Llog``) keeps records only *until read and
acknowledged by all registered readers*; a consumer that arrives late
gets nothing and must fall back to the full-namespace scan that
Robinhood exists to avoid (PAPERS.md).  The history tier closes that
gap the way ``lustre-hsm-action-stream`` keeps a replayable stream
whose state can reconstruct ground truth: instead of unlinking a fully
acknowledged segment, the journal *archives* it here, and the store
coalesces the records per target FID into immutable compacted segments
that still carry the covered journal-index range.

Compaction is state-preserving, not record-preserving:

- **CREATE+UNLINK annihilation** — an object created and destroyed
  inside the covered range never existed as far as final state is
  concerned, so its whole lifetime (creation, setattrs, renames,
  destruction) is dropped.  Hardlinked lifetimes are kept whole (an
  UNLINK may remove only one name).
- **rename-chain folding** — successive renames of one object fold to
  a single rename from the original source to the final target.
- **last-writer-wins thinning** — idempotent full-state operations
  (SETATTR, HEARTBEAT, MARK) keep only the newest record per target.

A replay-bootstrap consumer therefore reconstructs the *same final
state* as a from-the-start live consumer, from far fewer records.

Storage: archiving a sealed on-disk journal segment is an
``os.replace`` (the framing is identical — u32 length + packed record),
so the journal's trim path stays O(1) per segment; compaction runs only
when ``merge_factor`` segments have accumulated (or on an explicit
``compact_now()``), rewriting the tail into one compacted segment via
write-to-tmp + atomic rename.  File names encode the covered range
(``<base>.<first016>.<last016>``); recovery parses segments with the
same torn-tail truncation as ``Llog``, deletes stray ``.tmp`` files
(a crash mid-merge), and drops segments whose range another segment
already covers (a crash between writing a merged segment and deleting
its sources).
"""

from __future__ import annotations

import bisect
import glob as _glob
import os
import struct
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import records as R

_LEN = struct.Struct("<I")

#: operations that begin an object lifetime
CREATES = frozenset({R.CL_CREATE, R.CL_MKDIR, R.CL_MKNOD, R.CL_SOFTLINK})
#: operations that end one
DESTROYS = frozenset({R.CL_UNLINK, R.CL_RMDIR})
#: idempotent full-state operations: only the last per target matters
IDEMPOTENT = frozenset({R.CL_SETATTR, R.CL_HEARTBEAT, R.CL_MARK})


class Compactor:
    """Pure per-FID coalescing of a contiguous run of records.

    ``compact(batch)`` returns a new batch containing the surviving
    records in journal-index order; indices are preserved (the output
    is *sparse* over the covered range).  ``cr_prev`` chains may dangle
    across dropped records — replay consumers rebuild state, they do
    not walk prev pointers.
    """

    def __init__(self):
        self.stats = {"records_in": 0, "records_out": 0, "annihilated": 0,
                      "folded": 0, "thinned": 0}

    def compact(self, batch: R.RecordBatch) -> R.RecordBatch:
        n = len(batch)
        self.stats["records_in"] += n
        if n == 0:
            return batch
        # group rows per target FID with one stable lexsort over the
        # decoded header columns; a change-point scan yields the
        # per-FID segments, and three reduceat sums decide which
        # segments can possibly drop anything — only those run the
        # per-record fold, everything else passes through untouched
        t = batch.types_np()
        seq, oid, ver = batch.tfid_cols()
        order = np.lexsort((np.arange(n), ver, oid, seq))
        sseq, soid, sver = seq[order], oid[order], ver[order]
        starts = np.flatnonzero(np.r_[True, (sseq[1:] != sseq[:-1])
                                      | (soid[1:] != soid[:-1])
                                      | (sver[1:] != sver[:-1])])
        st = t[order]
        destroy = np.isin(st, sorted(DESTROYS)).astype(np.int64)
        rename = (st == R.CL_RENAME).astype(np.int64)
        idem = np.isin(st, sorted(IDEMPOTENT)).astype(np.int64)
        interesting = ((np.add.reduceat(destroy, starts) > 0)
                       | (np.add.reduceat(rename, starts) > 1)
                       | (np.add.reduceat(idem, starts) > 1))
        drop = set()
        replace: Dict[int, bytes] = {}
        if bool(interesting.any()):
            types = t.tolist()
            bounds = np.r_[starts, n]
            for k in np.flatnonzero(interesting).tolist():
                rows = order[bounds[k]:bounds[k + 1]].tolist()
                self._compact_key(batch, types, rows, drop, replace)
        if not drop and not replace:
            self.stats["records_out"] += n
            return batch
        out = [replace.get(i, None) or batch.packed(i)
               for i in range(n) if i not in drop]
        self.stats["records_out"] += len(out)
        return R.RecordBatch.from_packed(out)

    def _compact_key(self, batch: R.RecordBatch, types: List[int],
                     rows: List[int], drop: set,
                     replace: Dict[int, bytes]) -> None:
        # 1) annihilate closed lifetimes: rows from an observed creation
        # to the matching destroy, unless a hardlink shared the object
        cur: List[int] = []
        created = linked = False
        for r in rows:
            t = types[r]
            if t == R.CL_HARDLINK:
                linked = True
            if t in DESTROYS and created and not linked:
                drop.update(cur)
                drop.add(r)
                self.stats["annihilated"] += len(cur) + 1
                cur, created, linked = [], False, False
                continue
            if t in CREATES and not cur:
                created = True
            cur.append(r)
        alive = [r for r in rows if r not in drop]
        # 2) fold rename chains: one rename, original source -> final
        # target, at the last rename's index
        renames = [r for r in alive if types[r] == R.CL_RENAME]
        if len(renames) > 1:
            first = batch.record(renames[0])
            last = batch.record(renames[-1])
            folded = R.ChangelogRecord(
                type=last.type, index=last.index, prev=first.prev,
                time=last.time, tfid=last.tfid, pfid=last.pfid,
                name=last.name, sfid=first.sfid or last.sfid,
                spfid=first.spfid or last.spfid,
                sname=first.sname or last.sname, jobid=last.jobid,
                shard=last.shard, metrics=last.metrics, xattr=last.xattr)
            replace[renames[-1]] = R.pack(folded)
            drop.update(renames[:-1])
            self.stats["folded"] += len(renames) - 1
            alive = [r for r in alive if r not in drop]
        # 3) last-writer-wins for idempotent full-state records
        for t in IDEMPOTENT:
            t_rows = [r for r in alive if types[r] == t]
            if len(t_rows) > 1:
                drop.update(t_rows[:-1])
                self.stats["thinned"] += len(t_rows) - 1


class _HistSegment:
    """Immutable compacted records covering journal range
    [first, last] (inclusive); record indices are sparse within it."""

    __slots__ = ("first", "last", "batch", "indices", "path")

    def __init__(self, first: int, last: int, batch: R.RecordBatch,
                 path: Optional[str] = None):
        self.first = first
        self.last = last
        self.batch = batch
        self.indices = batch.indices()       # ascending journal indices
        self.path = path


class HistoryStore:
    """Archive of trimmed journal segments, compacted per FID.

    ``compactor=None`` disables coalescing (a raw retained history —
    the full-journal-replay baseline the benchmark compares against);
    the default compacts.  Thread-safe: the journal archives under its
    own lock while replay readers fetch concurrently.
    """

    def __init__(self, base_path: Optional[str] = None,
                 compactor: Optional[Compactor] = ...,
                 merge_factor: int = 8):
        self.base_path = base_path
        self.compactor = Compactor() if compactor is ... else compactor
        self.merge_factor = max(2, merge_factor)
        self._segments: List[_HistSegment] = []
        self._lock = threading.Lock()
        self.stats = {"archived_segments": 0, "archived_records": 0,
                      "merges": 0, "torn_dropped": 0, "duplicate_skips": 0,
                      "retention_trims": 0, "retention_dropped": 0}
        if base_path:
            self._load()

    # -- coverage ------------------------------------------------------------
    @property
    def covered_lo(self) -> int:
        """First covered journal index (0 when empty)."""
        with self._lock:
            return self._segments[0].first if self._segments else 0

    @property
    def covered_hi(self) -> int:
        """Last covered journal index (0 when empty)."""
        with self._lock:
            return self._segments[-1].last if self._segments else 0

    @property
    def record_count(self) -> int:
        with self._lock:
            return sum(len(s.batch) for s in self._segments)

    @property
    def segment_count(self) -> int:
        with self._lock:
            return len(self._segments)

    # -- persistence ---------------------------------------------------------
    def _seg_path(self, first: int, last: int) -> str:
        return f"{self.base_path}.{first:016d}.{last:016d}"

    def _parse_file(self, path: str) -> List[bytes]:
        with open(path, "rb") as fh:
            data = fh.read()
        out, off = [], 0
        while off + 4 <= len(data):
            (ln,) = _LEN.unpack_from(data, off)
            if off + 4 + ln > len(data) or ln < R.HDR_SIZE:
                self.stats["torn_dropped"] += 1      # crash mid-write
                break
            out.append(data[off + 4:off + 4 + ln])
            off += 4 + ln
        if 0 < len(data) - off < 4:
            self.stats["torn_dropped"] += 1
        return out

    def _write_file(self, path: str, batch: R.RecordBatch) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            for buf in batch:
                fh.write(_LEN.pack(len(buf)))
                fh.write(buf)
            fh.flush()
        os.replace(tmp, path)

    def _load(self) -> None:
        found: List[Tuple[int, int, str]] = []
        for path in _glob.glob(self.base_path + ".*"):
            if path.endswith(".tmp"):                # crash mid-merge
                os.remove(path)
                continue
            parts = path.rsplit(".", 2)
            try:
                first, last = int(parts[-2]), int(parts[-1])
            except (ValueError, IndexError):
                continue
            found.append((first, last, path))
        # widest-first: a merged segment swallows the sources a crash
        # left behind (delete the covered files, keep the cover)
        found.sort(key=lambda t: (t[0], -(t[1])))
        kept: List[Tuple[int, int, str]] = []
        for first, last, path in found:
            if kept and first >= kept[-1][0] and last <= kept[-1][1]:
                os.remove(path)                      # fully covered
                continue
            kept.append((first, last, path))
        for first, last, path in kept:
            batch = R.RecordBatch.from_packed(self._parse_file(path))
            self._segments.append(_HistSegment(first, last, batch, path))

    # -- archiving (the Llog trim hook) --------------------------------------
    def archive(self, batch: R.RecordBatch, first: int, last: int,
                move_from: Optional[str] = None) -> bool:
        """Take ownership of trimmed journal records covering
        ``[first, last]``.  ``move_from`` is the journal's on-disk
        segment file, adopted with one ``os.replace`` (identical
        framing) so the trim path never rewrites payload bytes.
        Idempotent: a range already covered (a crash between archive
        and the journal's unlink) is skipped.  Returns True when the
        records were adopted (the caller must then *not* unlink
        ``move_from``)."""
        with self._lock:
            hi = self._segments[-1].last if self._segments else 0
            if last <= hi:
                self.stats["duplicate_skips"] += 1
                return False
            # freeze a private copy: the caller's buffer may be the
            # journal's live bytearray
            batch = R.RecordBatch.from_packed(list(batch))
            path = None
            if self.base_path:
                path = self._seg_path(first, last)
                if move_from and os.path.exists(move_from):
                    os.replace(move_from, path)
                else:
                    self._write_file(path, batch)
            self._segments.append(_HistSegment(first, last, batch, path))
            self.stats["archived_segments"] += 1
            self.stats["archived_records"] += len(batch)
            if len(self._segments) >= self.merge_factor:
                self._merge_locked()
            return True

    # -- compaction ----------------------------------------------------------
    def _merge_locked(self) -> None:
        segs = self._segments
        if len(segs) < 2 and self.compactor is None:
            return
        union = R.RecordBatch.concat([s.batch for s in segs]) \
            if segs else R.RecordBatch.empty()
        merged = self.compactor.compact(union) if self.compactor else union
        first = segs[0].first if segs else 0
        last = segs[-1].last if segs else 0
        path = None
        if self.base_path:
            path = self._seg_path(first, last)
            self._write_file(path, merged)
            for s in segs:
                if s.path and s.path != path and os.path.exists(s.path):
                    os.remove(s.path)
        self._segments = [_HistSegment(first, last, merged, path)]
        self.stats["merges"] += 1

    def compact_now(self) -> None:
        """Force-compact the whole store into one segment (benchmarks,
        tests, and operators draining before a snapshot)."""
        with self._lock:
            if self._segments:
                self._merge_locked()

    # -- retention -----------------------------------------------------------
    def trim(self, horizon: int) -> int:
        """Retention trim: drop archived records with journal index
        strictly below ``horizon``.  Safe whenever no live cursor can
        replay below ``horizon`` (the stream-janitor's contract): a
        bootstrap from any index >= horizon reads only surviving
        records, so reconstructed state is unchanged.  Segments wholly
        below the horizon are unlinked; the boundary segment is
        rewritten per record (write-to-tmp + atomic rename under a new
        range filename, crash-safe like a merge).  Returns the number
        of records dropped."""
        with self._lock:
            if not self._segments or horizon <= self._segments[0].first:
                return 0
            dropped = 0
            kept: List[_HistSegment] = []
            for seg in self._segments:
                if seg.last < horizon:
                    dropped += len(seg.batch)
                    if seg.path and os.path.exists(seg.path):
                        os.remove(seg.path)
                    continue
                if seg.first >= horizon:
                    kept.append(seg)
                    continue
                lo = bisect.bisect_left(seg.indices, horizon)
                if lo == 0:
                    # the range label dips below the horizon but every
                    # record survives (annihilated gap): keep as is
                    kept.append(seg)
                    continue
                batch = R.RecordBatch.from_packed(list(seg.batch[lo:]))
                path = None
                if self.base_path:
                    path = self._seg_path(horizon, seg.last)
                    self._write_file(path, batch)
                    if seg.path and seg.path != path \
                            and os.path.exists(seg.path):
                        os.remove(seg.path)
                kept.append(_HistSegment(horizon, seg.last, batch, path))
                dropped += lo
            self._segments = kept
            if dropped:
                self.stats["retention_trims"] += 1
                self.stats["retention_dropped"] += dropped
            return dropped

    # -- reading -------------------------------------------------------------
    def read(self, start: int, max_records: int = 1024,
             ) -> Tuple[R.RecordBatch, int]:
        """Records with journal index >= ``start``, at most
        ``max_records``; returns ``(batch, next_start)`` where
        ``next_start`` is the first index this read did *not* cover —
        annihilated gaps advance it without producing records."""
        with self._lock:
            views: List[R.RecordBatch] = []
            next_start = start
            want = max_records
            for seg in self._segments:
                if seg.last < start:
                    continue
                if want <= 0:
                    break
                lo = bisect.bisect_left(seg.indices, start)
                take = min(want, len(seg.indices) - lo)
                if take > 0:
                    views.append(seg.batch[lo:lo + take])
                    want -= take
                    next_start = seg.indices[lo + take - 1] + 1
                if lo + take == len(seg.indices) and want > 0:
                    # whole tail consumed: the trailing annihilated gap
                    # (if any) is covered too
                    next_start = max(next_start, seg.last + 1)
            if not views:
                return R.RecordBatch.empty(), max(next_start, start)
            if len(views) == 1:
                return views[0], next_start
            return R.RecordBatch.concat(views), next_start

    def close(self) -> None:
        pass                                   # all writes are atomic


class JournalReplayReader:
    """Replay source over one journal: compacted history first, then
    the journal's physically retained records (``read_raw`` — records
    logically trimmed but not yet archived stay readable, so the union
    is gapless).  ``read`` returns ``(batch, next_start)``."""

    def __init__(self, log):
        self.log = log

    @property
    def floor_is_retention(self) -> bool:
        """True when a raised ``available_lo`` reflects a retention
        trim of an attached history tier (``StreamJanitor``) — a
        policy decision ``replay=True`` should clamp to — rather than
        a journal with no history at all, where a trimmed head means
        the records are simply gone and replay must be refused."""
        return getattr(self.log, "history", None) is not None

    def available_lo(self) -> int:
        hist = getattr(self.log, "history", None)
        if hist is not None and hist.segment_count:
            return hist.covered_lo
        return self.log.first_index

    def read(self, start: int, max_records: int = 1024,
             ) -> Tuple[R.RecordBatch, int]:
        hist = getattr(self.log, "history", None)
        if hist is not None and start <= hist.covered_hi:
            return hist.read(start, max_records)
        batch = self.log.read_raw(start, max_records)
        # a concurrent trim may have archived past ``start`` between
        # the coverage check and the raw read; archive-before-drop
        # makes the store authoritative the moment coverage reaches it
        if hist is not None and start <= hist.covered_hi:
            return hist.read(start, max_records)
        if not batch:
            return batch, max(start, self.log.last_index + 1)
        return batch, batch.packed_index(len(batch) - 1) + 1


class StreamJanitor:
    """Retention-SLO sweeper: bound how much history the tier keeps.

    Archiving is append-only — without a janitor the history store
    grows forever.  Each :meth:`sweep` asks its target (an
    ``LcapProxy`` or ``LcapCluster`` — anything with
    ``retention_horizons()``) for the **oldest still-live cursor** per
    journal: the collective ack frontier across consumer groups, the
    rewind point of any unfinished replay bootstrap (active consumers
    *and* parked durables), and an in-flight migration's handoff
    watermark.  Nothing below that cursor can ever be read again, so
    the janitor trims each journal's ``HistoryStore`` behind it —
    except for the last ``floor`` journal indices, the configurable
    retention SLO that keeps a bootstrap window available for
    late-arriving replay subscribers (``replay=True`` clamps to the
    trimmed ``available_lo``).
    """

    def __init__(self, target, floor: int = 4096):
        self.target = target
        self.floor = max(0, int(floor))
        self.stats = {"sweeps": 0, "records_dropped": 0}

    def _journals(self) -> Dict[str, object]:
        journals = getattr(self.target, "journals", None)
        if journals is not None:
            return dict(journals)
        return {pid: src
                for pid, src in getattr(self.target, "producers", {}).items()
                if getattr(src, "history", None) is not None}

    def sweep(self) -> Dict[str, Dict[str, int]]:
        """One retention pass; returns per journal the horizon applied
        and the records dropped."""
        horizons = self.target.retention_horizons()
        report: Dict[str, Dict[str, int]] = {}
        for pid, log in self._journals().items():
            hist = getattr(log, "history", None)
            if hist is None:
                continue
            horizon = min(horizons.get(pid, 0),
                          log.last_index - self.floor + 1)
            dropped = hist.trim(horizon) if horizon > 0 else 0
            self.stats["records_dropped"] += dropped
            report[pid] = {"horizon": horizon, "dropped": dropped}
        self.stats["sweeps"] += 1
        return report
