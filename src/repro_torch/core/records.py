"""Extensible changelog record format (paper §IV-A, LU-1996).

Faithful reimplementation of the Lustre 2.7 ``struct changelog_rec`` layout:

    fixed header (64 B):
        cr_namelen  u16     length of trailing name (bytes, no NUL)
        cr_flags    u16     extension mask (CLF_*) | high bits reserved
        cr_type     u16     operation code (CL_*)
        <2 B pad>
        cr_index    u64     record index within its producer's llog
        cr_prev     u64     index of the previous record touching cr_tfid
        cr_time     u64     nanoseconds since epoch
        cr_tfid     fid     target object (seq u64, oid u32, ver u32)
        cr_pfid     fid     parent object
    optional, flag-gated, in canonical order:
        CLF_RENAME  -> cr_sfid (16 B) + cr_spfid (16 B)
        CLF_JOBID   -> cr_jobid (32 B, NUL padded)
        CLF_SHARD   -> pod u16, host u16, mesh_row u16, mesh_col u16
        CLF_METRICS -> count u16 + count * f64
        CLF_XATTR   -> len u32 + msgpack blob (msgpack_subset.py)
    variable tail:
        name  (cr_namelen B)
        CLF_RENAME -> NUL + sname (to end of record)

Field access is by *inline offset computation from the flags mask*
(``_offset_after``), exactly as the paper describes — a record never
stores empty space for fields it does not carry.

``remap()`` converts a packed record between flag sets: adding fields
fills them with zeros (the "recent client, older server" direction, done
*locally* at the client); removing fields strips them (the "older client,
newer server" direction, done *remotely* at the proxy to save
bandwidth).  Both directions preserve every field present in both masks.
"""

from __future__ import annotations

import struct
import time as _time
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from .msgpack_subset import packb, unpackb

# ---------------------------------------------------------------------------
# Operation types.  CL_* codes 0..13 mirror Lustre; >=32 are the training
# event extensions this framework layers on top (same record machinery).
# ---------------------------------------------------------------------------
CL_MARK = 0
CL_CREATE = 1
CL_MKDIR = 2
CL_HARDLINK = 3
CL_SOFTLINK = 4
CL_MKNOD = 5
CL_UNLINK = 6
CL_RMDIR = 7
CL_RENAME = 8
CL_EXT = 9          # rename target (legacy two-record form, pre LU-1331)
CL_OPEN = 10
CL_CLOSE = 11
CL_SETATTR = 13

# Training-event extension types (the framework's "metadata operations").
CL_STEP_COMMIT = 32      # a training step committed on a host
CL_CKPT_WRITE = 33       # one checkpoint shard persisted
CL_CKPT_COMMIT = 34      # full checkpoint committed (all shards seen)
CL_DATA_CONSUME = 35     # a data shard/batch range consumed
CL_HEARTBEAT = 36        # liveness + step-duration sample
CL_ELASTIC_JOIN = 37     # host/pod joined the mesh
CL_ELASTIC_LEAVE = 38    # host/pod left (failure or scale-down)
CL_STRAGGLER = 39        # straggler verdict for a host
CL_EVICT = 40            # cache invalidation notice (Ganesha analogue)

# Policy-action lifecycle types (the HSM hsm/actions analogue): a policy
# engine emits these *into* the changelog fabric, so actions are
# themselves a stream any consumer can subscribe to with pushdown.
# tfid is the TARGET object's fid (not an action id), so one action's
# whole NEW -> UPDATE -> COMPLETED -> PURGED chain shares the target's
# cr_prev chain and — under FID-hash cluster routing — one shard.
CL_ACTION_NEW = 41       # a policy rule matched: action enqueued
CL_ACTION_UPDATE = 42    # action state advanced (e.g. started)
CL_ACTION_COMPLETED = 43  # action finished (status: succeeded/failed)
CL_ACTION_PURGED = 44    # janitor trimmed the completed action chain

CL_LAST = 45

#: the action-lifecycle subset (subscription masks, reconciler replay)
CL_ACTION_TYPES = frozenset({CL_ACTION_NEW, CL_ACTION_UPDATE,
                             CL_ACTION_COMPLETED, CL_ACTION_PURGED})

TYPE_NAMES = {
    CL_MARK: "MARK", CL_CREATE: "CREAT", CL_MKDIR: "MKDIR",
    CL_HARDLINK: "HLINK", CL_SOFTLINK: "SLINK", CL_MKNOD: "MKNOD",
    CL_UNLINK: "UNLNK", CL_RMDIR: "RMDIR", CL_RENAME: "RENME",
    CL_EXT: "EXT", CL_OPEN: "OPEN", CL_CLOSE: "CLOSE", CL_SETATTR: "SATTR",
    CL_STEP_COMMIT: "STEP", CL_CKPT_WRITE: "CKPTW", CL_CKPT_COMMIT: "CKPTC",
    CL_DATA_CONSUME: "DATA", CL_HEARTBEAT: "HBEAT", CL_ELASTIC_JOIN: "EJOIN",
    CL_ELASTIC_LEAVE: "ELEAV", CL_STRAGGLER: "STRAG", CL_EVICT: "EVICT",
    CL_ACTION_NEW: "ACTNW", CL_ACTION_UPDATE: "ACTUP",
    CL_ACTION_COMPLETED: "ACTOK", CL_ACTION_PURGED: "ACTPG",
}

# ---------------------------------------------------------------------------
# Extension flags (canonical order == wire order).
# ---------------------------------------------------------------------------
CLF_RENAME = 0x0001
CLF_JOBID = 0x0002
CLF_SHARD = 0x0004
CLF_METRICS = 0x0008
CLF_XATTR = 0x0010

CLF_SUPPORTED = CLF_RENAME | CLF_JOBID | CLF_SHARD | CLF_METRICS | CLF_XATTR
# Flag masks of the historical formats (fig. 3)
CLF_V20 = 0x0000                 # struct changelog_rec (v2.0)
CLF_EXT_REC = CLF_RENAME         # struct changelog_ext_rec
CLF_V27 = CLF_RENAME | CLF_JOBID  # struct changelog_rec (v2.7)

_HDR = struct.Struct("<HHHxxQQQ")          # namelen, flags, type, index, prev, time
_FID = struct.Struct("<QII")               # seq, oid, ver
HDR_SIZE = _HDR.size + 2 * _FID.size       # 64
assert HDR_SIZE == 64

_JOBID_LEN = 32
_SHARD = struct.Struct("<HHHH")


@dataclass(frozen=True)
class Fid:
    """Object identifier: (sequence, object id, version).

    In the framework: seq = run id, oid = object id (host, shard, tensor,
    batch-range...), ver = version/step.
    """
    seq: int = 0
    oid: int = 0
    ver: int = 0

    def pack(self) -> bytes:
        return _FID.pack(self.seq, self.oid, self.ver)

    @staticmethod
    def unpack(buf: bytes, off: int = 0) -> "Fid":
        return Fid(*_FID.unpack_from(buf, off))


NULL_FID = Fid()


@dataclass
class ChangelogRecord:
    type: int = CL_MARK
    index: int = 0
    prev: int = 0
    time: int = 0
    tfid: Fid = NULL_FID
    pfid: Fid = NULL_FID
    name: bytes = b""
    # flag-gated extensions
    sfid: Optional[Fid] = None           # CLF_RENAME
    spfid: Optional[Fid] = None
    sname: bytes = b""                   # rename source name (tail)
    jobid: Optional[bytes] = None        # CLF_JOBID (<=32 B)
    shard: Optional[Tuple[int, int, int, int]] = None  # CLF_SHARD
    metrics: Optional[Tuple[float, ...]] = None        # CLF_METRICS
    xattr: Optional[Dict[str, Any]] = None             # CLF_XATTR

    @property
    def flags(self) -> int:
        f = 0
        if self.sfid is not None:
            f |= CLF_RENAME
        if self.jobid is not None:
            f |= CLF_JOBID
        if self.shard is not None:
            f |= CLF_SHARD
        if self.metrics is not None:
            f |= CLF_METRICS
        if self.xattr is not None:
            f |= CLF_XATTR
        return f

    @property
    def type_name(self) -> str:
        return TYPE_NAMES.get(self.type, f"?{self.type}")

    def key(self) -> Tuple[int, int, int]:
        """Identity of the target object (used by compaction modules)."""
        return (self.tfid.seq, self.tfid.oid, self.tfid.ver)

    def __str__(self) -> str:  # lfs changelog-like rendering
        return (f"{self.index} {self.type:02d}{self.type_name} "
                f"t=[{self.tfid.seq:#x}:{self.tfid.oid:#x}:{self.tfid.ver:#x}] "
                f"p=[{self.pfid.seq:#x}:{self.pfid.oid:#x}:{self.pfid.ver:#x}] "
                f"{self.name.decode(errors='replace')}")


def now_ns() -> int:
    return _time.time_ns()


# ---------------------------------------------------------------------------
# Offset computation (the LU-1996 inline functions).
# ---------------------------------------------------------------------------
def _ext_sizes(flags: int, buf: Optional[bytes] = None, base: int = 0):
    """Yield (flag, size) for each extension present in ``flags``.

    CLF_METRICS / CLF_XATTR are variable: when ``buf`` is given, sizes are
    read from the wire; otherwise they cannot be computed (callers that
    only add/strip fixed fields never need them without a buffer).
    """
    off = base
    if flags & CLF_RENAME:
        yield CLF_RENAME, 2 * _FID.size
        off += 2 * _FID.size
    if flags & CLF_JOBID:
        yield CLF_JOBID, _JOBID_LEN
        off += _JOBID_LEN
    if flags & CLF_SHARD:
        yield CLF_SHARD, _SHARD.size
        off += _SHARD.size
    if flags & CLF_METRICS:
        if buf is None:
            raise ValueError("CLF_METRICS size needs the buffer")
        (cnt,) = struct.unpack_from("<H", buf, off)
        sz = 2 + 8 * cnt
        yield CLF_METRICS, sz
        off += sz
    if flags & CLF_XATTR:
        if buf is None:
            raise ValueError("CLF_XATTR size needs the buffer")
        (ln,) = struct.unpack_from("<I", buf, off)
        yield CLF_XATTR, 4 + ln


def rec_offset(flags: int, upto: int, buf: Optional[bytes] = None) -> int:
    """Offset of extension ``upto`` (or of the name tail if upto==0)
    within a record carrying ``flags`` — the paper's inline offset
    computation."""
    off = HDR_SIZE
    for flag, size in _ext_sizes(flags, buf, HDR_SIZE):
        if flag == upto:
            return off
        off += size
    if upto:
        raise KeyError(f"flag {upto:#x} not in mask {flags:#x}")
    return off


def pack(rec: ChangelogRecord) -> bytes:
    """Serialize to the wire format described in the module docstring."""
    flags = rec.flags
    parts = [
        _HDR.pack(len(rec.name), flags, rec.type, rec.index, rec.prev,
                  rec.time),
        rec.tfid.pack(), rec.pfid.pack(),
    ]
    if flags & CLF_RENAME:
        parts.append(rec.sfid.pack())
        parts.append((rec.spfid or NULL_FID).pack())
    if flags & CLF_JOBID:
        jb = (rec.jobid or b"")[:_JOBID_LEN]
        parts.append(jb.ljust(_JOBID_LEN, b"\0"))
    if flags & CLF_SHARD:
        parts.append(_SHARD.pack(*rec.shard))
    if flags & CLF_METRICS:
        vals = rec.metrics or ()
        parts.append(struct.pack(f"<H{len(vals)}d", len(vals), *vals))
    if flags & CLF_XATTR:
        blob = packb(rec.xattr or {})
        parts.append(struct.pack("<I", len(blob)) + blob)
    parts.append(rec.name)
    if flags & CLF_RENAME:
        parts.append(b"\0" + rec.sname)
    return b"".join(parts)


def unpack(buf: bytes) -> ChangelogRecord:
    namelen, flags, rtype, index, prev, tns = _HDR.unpack_from(buf, 0)
    tfid = Fid.unpack(buf, _HDR.size)
    pfid = Fid.unpack(buf, _HDR.size + _FID.size)
    rec = ChangelogRecord(type=rtype, index=index, prev=prev, time=tns,
                          tfid=tfid, pfid=pfid)
    off = HDR_SIZE
    if flags & CLF_RENAME:
        rec.sfid = Fid.unpack(buf, off)
        rec.spfid = Fid.unpack(buf, off + _FID.size)
        off += 2 * _FID.size
    if flags & CLF_JOBID:
        rec.jobid = buf[off:off + _JOBID_LEN].rstrip(b"\0")
        off += _JOBID_LEN
    if flags & CLF_SHARD:
        rec.shard = _SHARD.unpack_from(buf, off)
        off += _SHARD.size
    if flags & CLF_METRICS:
        (cnt,) = struct.unpack_from("<H", buf, off)
        rec.metrics = struct.unpack_from(f"<{cnt}d", buf, off + 2)
        off += 2 + 8 * cnt
    if flags & CLF_XATTR:
        (ln,) = struct.unpack_from("<I", buf, off)
        rec.xattr = unpackb(buf[off + 4:off + 4 + ln])
        off += 4 + ln
    rec.name = buf[off:off + namelen]
    off += namelen
    if flags & CLF_RENAME and off < len(buf):
        rec.sname = buf[off + 1:]  # skip NUL separator
    return rec


def packed_flags(buf: bytes) -> int:
    return struct.unpack_from("<H", buf, 2)[0]


def packed_type(buf: bytes) -> int:
    return struct.unpack_from("<H", buf, 4)[0]


def packed_jobid(buf: bytes) -> bytes:
    """The CLF_JOBID extension of a packed record, NUL-trimmed
    (``b""`` when the flag is absent) — the scalar twin of
    ``RecordBatch.jobid_col`` for the per-record dispatch path."""
    flags = struct.unpack_from("<H", buf, 2)[0]
    if not flags & CLF_JOBID:
        return b""
    off = HDR_SIZE + (2 * _FID.size if flags & CLF_RENAME else 0)
    return bytes(buf[off:off + _JOBID_LEN]).rstrip(b"\0")


def normalize_flags(flags: Optional[int]) -> int:
    """The single place subscription flag masks are normalized: ``None``
    means "everything supported", unknown bits are masked off (a newer
    client talking to this proxy gets the intersection, per §IV-A)."""
    if flags is None:
        return CLF_SUPPORTED
    return flags & CLF_SUPPORTED


def remap(buf: bytes, target_flags: int) -> bytes:
    """Remap a *packed* record to ``target_flags`` (paper §IV-A).

    Fields present in both masks are copied; fields only in the target are
    zero-filled (local remap at a newer client); fields only in the source
    are stripped (remote remap at the proxy for an older client).  Works
    directly on the byte representation using offset arithmetic — no
    oversized intermediate with empty fields is ever stored.
    """
    target_flags &= CLF_SUPPORTED
    src_flags = packed_flags(buf)
    if src_flags == target_flags:
        return buf
    namelen = struct.unpack_from("<H", buf, 0)[0]

    # slice source extensions
    src_ext: Dict[int, bytes] = {}
    off = HDR_SIZE
    for flag, size in _ext_sizes(src_flags, buf, HDR_SIZE):
        src_ext[flag] = buf[off:off + size]
        off += size
    name_and_tail = buf[off:]

    head = bytearray(buf[:HDR_SIZE])
    struct.pack_into("<H", head, 2, target_flags)
    parts = [bytes(head)]
    zero_default = {
        CLF_RENAME: b"\0" * (2 * _FID.size),
        CLF_JOBID: b"\0" * _JOBID_LEN,
        CLF_SHARD: b"\0" * _SHARD.size,
        CLF_METRICS: struct.pack("<H", 0),
        CLF_XATTR: struct.pack("<I", 1) + packb({}),
    }
    for flag in (CLF_RENAME, CLF_JOBID, CLF_SHARD, CLF_METRICS, CLF_XATTR):
        if target_flags & flag:
            parts.append(src_ext.get(flag, zero_default[flag]))
    # tail: name, and sname only if the target still carries CLF_RENAME
    if src_flags & CLF_RENAME and not target_flags & CLF_RENAME:
        # strip the sname tail, keep only name
        parts.append(name_and_tail[:namelen])
    elif target_flags & CLF_RENAME and not src_flags & CLF_RENAME:
        parts.append(name_and_tail[:namelen] + b"\0")
    else:
        parts.append(name_and_tail)
    return b"".join(parts)


# ---------------------------------------------------------------------------
# Cached remap plans.
#
# ``remap`` rebuilds its slicing decisions from the flag masks on every
# call.  The proxy remaps every dispatched record against every
# consumer's mask, but the number of distinct (src_flags, target_flags)
# pairs is tiny (<= 32 x 32); a compiled per-pair plan amortizes all of
# the mask branching.  Pairs whose fields are all fixed-size get a fully
# static slicing closure; pairs involving CLF_METRICS/CLF_XATTR fall
# back to the generic path (their sizes live in the record itself).
# ---------------------------------------------------------------------------
CLF_VARIABLE = CLF_METRICS | CLF_XATTR
_FIXED_SIZES = {CLF_RENAME: 2 * _FID.size, CLF_JOBID: _JOBID_LEN,
                CLF_SHARD: _SHARD.size}
_FLAG_ORDER = (CLF_RENAME, CLF_JOBID, CLF_SHARD, CLF_METRICS, CLF_XATTR)

_REMAP_PLANS: Dict[Tuple[int, int], Callable[[bytes], bytes]] = {}


def _compile_remap(src: int, dst: int) -> Callable[[bytes], bytes]:
    if (src | dst) & CLF_VARIABLE:
        return lambda buf: remap(buf, dst)
    src_off: Dict[int, int] = {}
    off = HDR_SIZE
    for f in _FLAG_ORDER:
        if src & f:
            src_off[f] = off
            off += _FIXED_SIZES[f]
    name_off = off
    # ('copy', lo, hi) slices from the source; ('zero', blob) fills
    segs: List[Tuple[str, Any, Any]] = []
    for f in _FLAG_ORDER:
        if dst & f:
            if src & f:
                lo = src_off[f]
                if segs and segs[-1][0] == "copy" and segs[-1][2] == lo:
                    segs[-1] = ("copy", segs[-1][1], lo + _FIXED_SIZES[f])
                else:
                    segs.append(("copy", lo, lo + _FIXED_SIZES[f]))
            else:
                zero = b"\0" * _FIXED_SIZES[f]
                segs.append(("zero", zero, None))
    flags_patch = struct.pack("<H", dst)
    add_rename = bool(dst & CLF_RENAME) and not (src & CLF_RENAME)
    strip_rename = bool(src & CLF_RENAME) and not (dst & CLF_RENAME)

    def plan(buf: bytes) -> bytes:
        parts = [buf[:2], flags_patch, buf[4:HDR_SIZE]]
        for kind, a, b in segs:
            parts.append(buf[a:b] if kind == "copy" else a)
        if strip_rename:
            namelen = buf[0] | (buf[1] << 8)
            parts.append(buf[name_off:name_off + namelen])
        elif add_rename:
            parts.append(buf[name_off:])
            parts.append(b"\0")
        else:
            parts.append(buf[name_off:])
        return b"".join(parts)

    return plan


def remap_cached(buf: bytes, target_flags: int) -> bytes:
    """Plan-cached equivalent of ``remap`` (identical output)."""
    dst = target_flags & CLF_SUPPORTED
    src = packed_flags(buf)
    if src == dst:
        return buf
    try:
        plan = _REMAP_PLANS[(src, dst)]
    except KeyError:
        plan = _REMAP_PLANS[(src, dst)] = _compile_remap(src, dst)
    return plan(buf)


# ---------------------------------------------------------------------------
# RecordBatch — the batch-native, *columnar* unit of flow.
#
# A batch is a packed buffer plus an offsets/lengths table (numpy int64
# columns, built lazily from whatever sequence the caller hands in).
# The 64-byte fixed header of every record is decoded **once per
# batch** — a single byte gather viewed as a structured dtype — into
# contiguous per-field columns (index, type, flags, time, tfid/pfid
# triples).  Hot paths (dispatch masks, slot hashing, compaction folds)
# read those arrays; the packed buffer is retained only for payload
# passthrough, and full decode (``record(i)``) stays lazy and
# per-record.  ``select``/``permute``/slicing produce views sharing the
# payload buffer *and* the decoded columns, so stream modules that drop
# or reorder records copy neither payload bytes nor header columns.
# ---------------------------------------------------------------------------
_U16 = struct.Struct("<H")
_U64 = struct.Struct("<Q")
_TFID_AT = struct.Struct("<QII")

#: structured view of the 64-byte fixed header (wire layout, LE)
HDR_DTYPE = np.dtype([
    ("namelen", "<u2"), ("flags", "<u2"), ("type", "<u2"), ("pad", "<u2"),
    ("index", "<u8"), ("prev", "<u8"), ("time", "<u8"),
    ("tseq", "<u8"), ("toid", "<u4"), ("tver", "<u4"),
    ("pseq", "<u8"), ("poid", "<u4"), ("pver", "<u4")])
assert HDR_DTYPE.itemsize == HDR_SIZE

_HDR_RANGE = np.arange(HDR_SIZE, dtype=np.int64)
_I64 = np.int64

Buffer = Union[bytes, bytearray, memoryview]

#: wire frame versions (see ``RecordBatch.to_wire``)
WIRE_V1 = 1
WIRE_V2 = 2
#: first word of a v2 frame; a v1 frame starts with the record count,
#: which stays far below this in any real batch
WIRE2_MAGIC = 0xC015FEED

#: first word of the optional origin trailer a v2 frame may carry
#: *after* its payload.  ``from_wire`` computes every record offset
#: from the lens table and never validates total blob length, so a
#: receiver that predates the trailer simply never looks at it —
#: batch-level origin tagging is backward compatible by construction.
WIRE2_ORIGIN_MAGIC = 0xFEDE0716

#: capability keys exchanged on the cluster control plane (the ``caps``
#: verb, subscribe negotiation) and piggybacked on data-path replies:
#: record-frame generation, deep-batched offer support, and the
#: epoch-versioned routing plane (a peer advertising CAP_EPOCH stamps
#: the current routing epoch on its subscribe/fetch/commit replies and
#: answers the ``topology`` verb, so consumers re-resolve the shard
#: fan-in when the epoch bumps instead of assuming a fixed shard set)
CAP_WIRE = "wire"
CAP_DEEP = "deep"
CAP_EPOCH = "epoch"


def _as_i64(seq) -> np.ndarray:
    if type(seq) is np.ndarray and seq.dtype == np.int64:
        return seq
    return np.asarray(seq, dtype=np.int64)


def _is_frozen(buf) -> bool:
    """True for buffers that can never be resized or mutated under a
    numpy view: bytes, or a read-only memoryview (wire receive path)."""
    return type(buf) is bytes or (type(buf) is memoryview and buf.readonly)


# Shared zero-fill source for the vectorized rebuild: 32 zero bytes
# cover every fixed default (rename 32, jobid 32, shard 8, the metrics
# count prefix 2, and the rename-tail NUL); the empty-xattr default
# (u32 len=1 + msgpack ``{}``) follows at _ZX_OFF.
_ZX_OFF = 32
_ZFILL = np.frombuffer(b"\0" * _ZX_OFF + struct.pack("<I", 1)
                       + packb({}), dtype=np.uint8)
_ZFILL_LEN = {CLF_RENAME: 2 * _FID.size, CLF_JOBID: _JOBID_LEN,
              CLF_SHARD: _SHARD.size, CLF_METRICS: 2,
              CLF_XATTR: 4 + len(packb({}))}


class RecordBatch:
    __slots__ = ("buf", "_off", "_len", "_recs", "_hdr", "_ext", "_pb",
                 "origin")

    def __init__(self, buf: Buffer, offsets: Sequence[int],
                 lengths: Sequence[int]):
        self.buf = buf
        # kept as handed in (list for append-path callers, ndarray for
        # views); normalized to int64 columns on first columnar use
        self._off = offsets if isinstance(offsets, (list, np.ndarray)) \
            else list(offsets)
        self._len = lengths if isinstance(lengths, (list, np.ndarray)) \
            else list(lengths)
        self._recs: Dict[int, ChangelogRecord] = {}
        self._hdr: Optional[np.ndarray] = None   # decoded header columns
        self._ext = None                         # cached extension layout
        self._pb = None                          # cached payload-base view
        #: which filesystem/cluster the batch came from — a *batch*-level
        #: federation tag (one string per frame, never per-record bytes);
        #: rides the v2 wire as a trailer old receivers ignore
        self.origin: Optional[str] = None

    # -- construction -------------------------------------------------------
    @classmethod
    def empty(cls) -> "RecordBatch":
        return cls(b"", np.empty(0, _I64), np.empty(0, _I64))

    @classmethod
    def from_packed(cls, bufs: Iterable[bytes]) -> "RecordBatch":
        chunks = list(bufs)
        n = len(chunks)
        lengths = np.fromiter(map(len, chunks), dtype=_I64, count=n)
        offsets = np.zeros(n, _I64)
        if n > 1:
            np.cumsum(lengths[:-1], out=offsets[1:])
        return cls(b"".join(chunks), offsets, lengths)

    @classmethod
    def from_records(cls, recs: Iterable[ChangelogRecord]) -> "RecordBatch":
        return cls.from_packed(pack(r) for r in recs)

    # -- sizing / iteration (list-of-packed-bytes compatible) ---------------
    def __len__(self) -> int:
        return len(self._off)

    def __bool__(self) -> bool:
        return len(self._off) > 0

    def __iter__(self):
        for i in range(len(self._off)):
            yield self.packed(i)

    def __getitem__(self, i):
        if isinstance(i, slice):
            sub = RecordBatch(self.buf, self._off[i], self._len[i])
            if self._hdr is not None:
                sub._hdr = self._hdr[i]
            sub.origin = self.origin
            return sub
        return self.packed(i)

    def __eq__(self, other) -> bool:
        if isinstance(other, RecordBatch):
            return list(self) == list(other)
        if isinstance(other, (list, tuple)):
            return list(self) == list(other)
        return NotImplemented

    def __repr__(self) -> str:
        return f"RecordBatch({len(self)} records, {self.nbytes}B)"

    @property
    def nbytes(self) -> int:
        return int(self._len_col().sum())

    # -- columnar core ------------------------------------------------------
    def _off_col(self) -> np.ndarray:
        off = self._off
        if type(off) is not np.ndarray:
            off = self._off = _as_i64(off)
        return off

    def _len_col(self) -> np.ndarray:
        ln = self._len
        if type(ln) is not np.ndarray:
            ln = self._len = _as_i64(ln)
        return ln

    def header(self) -> np.ndarray:
        """The decoded fixed-header table: one structured row per
        record (``HDR_DTYPE`` fields), gathered from the packed buffer
        in a single vectorized pass and cached.  A mutable (bytearray)
        buffer is region-copied first — holding a numpy view of a live
        journal segment would lock it against append resizing."""
        h = self._hdr
        if h is None:
            n = len(self._off)
            if n == 0:
                h = np.empty(0, HDR_DTYPE)
            else:
                base, off = self._payload_base()
                gathered = base[off[:, None] + _HDR_RANGE]
                h = gathered.view(HDR_DTYPE).reshape(n)
            self._hdr = h
        return h

    def header_rows(self) -> np.ndarray:
        """The fixed-header table as a ``uint8 [N, 64]`` matrix, one
        ``HDR_DTYPE`` row per record: the layout the routing kernel
        reads (``kernels/stream_ops.py``).  A view of ``header()`` when
        that table is contiguous, so it may be read-only (a sealed
        segment, a received frame) — copy before handing it to a
        writer."""
        h = np.ascontiguousarray(self.header())
        return h.view(np.uint8).reshape(len(h), HDR_SIZE)

    # numpy column accessors (the hot-path surface)
    def indices_np(self) -> np.ndarray:          # u64 cr_index
        return self.header()["index"]

    def types_np(self) -> np.ndarray:            # u16 cr_type
        return self.header()["type"]

    def flags_np(self) -> np.ndarray:            # u16 cr_flags
        return self.header()["flags"]

    def times_np(self) -> np.ndarray:            # u64 cr_time
        return self.header()["time"]

    def tfid_cols(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        h = self.header()
        return h["tseq"], h["toid"], h["tver"]

    def pfid_cols(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        h = self.header()
        return h["pseq"], h["poid"], h["pver"]

    # -- payload-extension columns ------------------------------------------
    # Extensions live at flag-computable offsets (wire order: RENAME,
    # JOBID, SHARD, METRICS, XATTR — rec_offset()), so the fixed-size
    # ones gather vectorized: per-row offset arithmetic on the flags
    # column, one fancy index into the packed buffer, no per-record
    # decode.  The aggregation tier folds whole batches through these.
    def _payload_base(self) -> Tuple[np.ndarray, np.ndarray]:
        """(uint8 view of the packed buffer, per-record offsets into
        it), cached — records are immutable once written, so the
        snapshot a mutable (live-journal) buffer forces is taken once
        per batch, not once per columnar gather."""
        pb = self._pb
        if pb is None:
            off = self._off_col()
            buf = self.buf
            if not _is_frozen(buf):
                lo = int(off.min())
                hi = int((off + self._len_col()).max())
                pb = (np.frombuffer(bytes(buf[lo:hi]), dtype=np.uint8),
                      off - lo)
            else:
                pb = (np.frombuffer(buf, dtype=np.uint8), off)
            self._pb = pb
        return pb

    def _ext_off(self, flags: np.ndarray, upto: int) -> np.ndarray:
        """Per-row offset of fixed-position extension ``upto`` relative
        to each record's start (valid where the flag is present)."""
        off = np.full(len(flags), HDR_SIZE, dtype=np.int64)
        if upto == CLF_RENAME:
            return off
        off += (flags & CLF_RENAME).astype(np.int64) * (2 * _FID.size)
        if upto == CLF_JOBID:
            return off
        off += ((flags & CLF_JOBID) >> 1).astype(np.int64) * _JOBID_LEN
        if upto == CLF_SHARD:
            return off
        off += ((flags & CLF_SHARD) >> 2).astype(np.int64) * _SHARD.size
        if upto == CLF_METRICS:
            return off
        raise KeyError(f"flag {upto:#x} has no fixed offset")

    def jobid_col(self, width: int = _JOBID_LEN) -> np.ndarray:
        """The CLF_JOBID extension as an ``(n, width)`` uint8 matrix;
        rows without the flag are all-zero (the empty jobid).

        ``width`` trims the gather to the leading bytes a caller will
        actually compare (jobids are NUL-padded, so a prefix or
        NUL-terminated-exact match never needs the full field) — the
        tenant-scope pushdown asks only for its widest scope entry."""
        n = len(self)
        width = max(1, min(int(width), _JOBID_LEN))
        out = np.zeros((n, width), dtype=np.uint8)
        if not n:
            return out
        flags = self.flags_np()
        has = (flags & CLF_JOBID) != 0
        rows = np.flatnonzero(has)
        if rows.size:
            # JOBID sits at a flag-computable offset (only RENAME
            # precedes it), so the full extension walk ``_layout``
            # performs is skipped on this per-dispatch path
            base, off = self._payload_base()
            jo = off + self._ext_off(flags, CLF_JOBID)
            if width == 8 and base.size >= 8:
                # the tenant-pushdown shape: one windowed gather, no
                # index-matrix build or scatter.  Flagless rows gather
                # whatever follows their header (clamped in-bounds)
                # and are zeroed after; jobid-bearing rows always have
                # the full 32-byte field behind ``jo``.
                jo = np.minimum(jo, base.size - 8)
                out = np.lib.stride_tricks.sliding_window_view(
                    base, 8)[jo]
                if rows.size != n:
                    out[~has] = 0
                return out
            jo = jo[rows]
            out[rows] = base[jo[:, None] + np.arange(width)]
        return out

    def jobid_word(self) -> np.ndarray:
        """The leading 8 bytes of each record's CLF_JOBID field as one
        native-endian uint64 per row (0 where the flag is absent) —
        the word-at-a-time form of ``jobid_col`` the tenant pushdown
        compares against ``TenantPrincipal`` masked-word tests.  One
        1-D gather through an unaligned sliding uint64 view: no index
        matrix, no ``(n, 8)`` intermediate."""
        n = len(self)
        out = np.zeros(n, dtype=np.uint64)
        if not n:
            return out
        # densify the strided header field once: three flag tests over
        # a contiguous copy beat one over the structured view
        flags = np.ascontiguousarray(self.flags_np())
        has = (flags & CLF_JOBID) != 0
        all_flagged = bool(has.all())
        if not all_flagged and not has.any():
            return out
        base, off = self._payload_base()
        if base.size < 8:
            col = self.jobid_col(8)
            return np.ascontiguousarray(col).view(np.uint64).ravel()
        if (flags & CLF_RENAME).any():
            jo = off + self._ext_off(flags, CLF_JOBID)
        else:                       # JOBID right past the fixed header
            jo = off + np.int64(HDR_SIZE)
        np.minimum(jo, base.size - 8, out=jo)
        words = np.lib.stride_tricks.as_strided(
            base[:(base.size // 8) * 8].view(np.uint64),
            shape=(base.size - 7,), strides=(1,))
        out = words[jo]
        if not all_flagged:         # clamped garbage where no jobid
            out[~has] = 0
        return out

    def shard_cols(self) -> Tuple[np.ndarray, np.ndarray]:
        """The CLF_SHARD (pod, host) u16 pair as int64 columns; rows
        without the flag read (0, 0)."""
        n = len(self)
        pod = np.zeros(n, dtype=np.int64)
        host = np.zeros(n, dtype=np.int64)
        if not n:
            return pod, host
        flags = self.flags_np()
        rows = np.flatnonzero((flags & CLF_SHARD) != 0)
        if rows.size:
            base, _off, starts, _sizes, _name = self._layout()
            so = starts[CLF_SHARD][rows]
            raw = base[so[:, None] + np.arange(4)].astype(np.int64)
            pod[rows] = raw[:, 0] | (raw[:, 1] << 8)
            host[rows] = raw[:, 2] | (raw[:, 3] << 8)
        return pod, host

    def metric0_col(self) -> np.ndarray:
        """The first CLF_METRICS value per record as float64 (0.0 where
        the extension is absent or empty) — the stream's primary gauge
        (loss / bytes / step time, by op type)."""
        n = len(self)
        out = np.zeros(n, dtype=np.float64)
        if not n:
            return out
        flags = self.flags_np()
        rows = np.flatnonzero((flags & CLF_METRICS) != 0)
        if rows.size:
            base, _off, starts, _sizes, _name = self._layout()
            mo = starts[CLF_METRICS][rows]
            cnt = (base[mo].astype(np.int64)
                   | (base[mo + 1].astype(np.int64) << 8))
            have = np.flatnonzero(cnt > 0)
            if have.size:
                vo = mo[have] + 2
                raw = base[vo[:, None] + np.arange(8)]
                out[rows[have]] = raw.view("<f8").ravel()
        return out

    def _ext_layout(self, base: np.ndarray, off: np.ndarray):
        """Per-row absolute ``(starts, sizes)`` of every canonical
        extension (size 0 where the flag is absent) plus the name
        offset — one vectorized walk of the flag-gated payload, shared
        by the variable-size gathers and the whole-batch rebuild."""
        src = self.flags_np().astype(np.int64)
        n = len(src)
        cur = off + np.int64(HDR_SIZE)
        starts: Dict[int, np.ndarray] = {}
        sizes: Dict[int, np.ndarray] = {}
        for flag in _FLAG_ORDER:
            has = (src & flag) != 0
            if flag in _FIXED_SIZES:
                size = np.where(has, np.int64(_FIXED_SIZES[flag]), 0)
            else:
                size = np.zeros(n, dtype=np.int64)
                rows = np.flatnonzero(has)
                if rows.size:
                    o = cur[rows]
                    if flag == CLF_METRICS:       # u16 value count
                        cnt = (base[o].astype(np.int64)
                               | (base[o + 1].astype(np.int64) << 8))
                        size[rows] = 2 + 8 * cnt
                    else:                         # CLF_XATTR: u32 blob len
                        bl = (base[o].astype(np.int64)
                              | (base[o + 1].astype(np.int64) << 8)
                              | (base[o + 2].astype(np.int64) << 16)
                              | (base[o + 3].astype(np.int64) << 24))
                        size[rows] = 4 + bl
            starts[flag] = cur
            sizes[flag] = size
            cur = cur + size
        return starts, sizes, cur

    def _layout(self):
        """``(base, off, starts, sizes, name_off)`` — the payload view
        plus the extension layout, computed once per batch and cached:
        every columnar gather on the same batch (the consumer hot path
        touches several per delivery) shares one canonical walk.
        Mutable buffers get the same snapshot semantics as
        ``header()`` — records are immutable once written."""
        lay = self._ext
        if lay is None:
            base, off = self._payload_base()
            starts, sizes, name_off = self._ext_layout(base, off)
            lay = self._ext = (base, off, starts, sizes, name_off)
        return lay

    def _names_packed(self) -> Tuple[bytes, np.ndarray, np.ndarray]:
        """All names pulled in one ragged gather: ``(packed, lo, hi)``
        with record i's name at ``packed[lo[i]:hi[i]]``."""
        base, _off, _starts, _sizes, name_off = self._layout()
        namelen = self.header()["namelen"].astype(np.int64)
        n = len(self)
        out = np.zeros(n, dtype=np.int64)
        np.cumsum(namelen[:-1], out=out[1:])
        total = int(out[-1] + namelen[-1])
        src = np.arange(total, dtype=np.int64) \
            + np.repeat(name_off - out, namelen)
        return base[src].tobytes(), out, out + namelen

    def name_col(self) -> List[bytes]:
        """Per-record name bytes sliced straight out of the packed
        buffer past the flag-gated extensions — no record decode.  All
        names are pulled in one ragged gather, then sliced off the
        small contiguous result (cheaper than per-row buffer views)."""
        if not len(self):
            return []
        packed, lo, hi = self._names_packed()
        return [packed[s:e] for s, e in zip(lo.tolist(), hi.tolist())]

    def name_col_str(self, errors: str = "replace") -> List[str]:
        """``name_col`` decoded to ``str``: one bulk decode plus string
        slicing when the packed names are pure ASCII (byte offsets ==
        char offsets, and the overwhelmingly common case), per-record
        decode otherwise."""
        if not len(self):
            return []
        packed, lo, hi = self._names_packed()
        if packed.isascii():
            s = packed.decode("ascii")
            return [s[a:b] for a, b in zip(lo.tolist(), hi.tolist())]
        return [packed[a:b].decode(errors=errors)
                for a, b in zip(lo.tolist(), hi.tolist())]

    def metrics_cols(self, k: int = 3) -> Tuple[np.ndarray, np.ndarray]:
        """The first ``k`` CLF_METRICS values as an ``(n, k)`` float64
        matrix plus the per-row value count (0 where the extension is
        absent); unfilled cells read 0.0."""
        n = len(self)
        out = np.zeros((n, k), dtype=np.float64)
        cnt = np.zeros(n, dtype=np.int64)
        if not n:
            return out, cnt
        flags = self.flags_np()
        rows = np.flatnonzero((flags & CLF_METRICS) != 0)
        if rows.size:
            base, _off, starts, _sizes, _name = self._layout()
            mo = starts[CLF_METRICS][rows]
            c = (base[mo].astype(np.int64)
                 | (base[mo + 1].astype(np.int64) << 8))
            cnt[rows] = c
            kk = min(k, int(c.max()))
            if kk > 0:
                # one gather of the first kk values per row (offsets
                # clipped to the buffer for rows with fewer values),
                # then mask the unfilled tail in place
                src = np.minimum(mo[:, None] + 2 + np.arange(8 * kk),
                                 np.int64(len(base) - 1))
                vals = base[src].view("<f8")
                vals[np.arange(kk) >= c[:, None]] = 0.0
                out[rows, :kk] = vals
        return out, cnt

    def xattrs_col(self) -> List[Optional[Dict[str, Any]]]:
        """Per-row CLF_XATTR dicts (None where absent).  Only the
        msgpack blob itself is decoded — the fixed header and the other
        extensions are never re-parsed."""
        n = len(self)
        out: List[Optional[Dict[str, Any]]] = [None] * n
        if not n:
            return out
        flags = self.flags_np()
        if not bool((flags & CLF_XATTR).any()):
            return out
        base, _off, starts, sizes, _name = self._layout()
        xo, xs = starts[CLF_XATTR], sizes[CLF_XATTR]
        mem = memoryview(base)
        for i in np.flatnonzero(xs).tolist():
            s = int(xo[i])
            out[i] = unpackb(mem[s + 4:s + int(xs[i])])
        return out

    # -- zero-copy header accessors (per record) ----------------------------
    def packed(self, i: int) -> bytes:
        o = self._off[i]
        buf = self.buf
        if type(buf) is bytes:
            return buf[o:o + self._len[i]]       # one copy
        return bytes(buf[o:o + self._len[i]])    # bytearray: slice + freeze

    def packed_namelen(self, i: int) -> int:
        h = self._hdr
        if h is not None:
            return int(h["namelen"][i])
        return _U16.unpack_from(self.buf, self._off[i])[0]

    def packed_flags(self, i: int) -> int:
        h = self._hdr
        if h is not None:
            return int(h["flags"][i])
        return _U16.unpack_from(self.buf, self._off[i] + 2)[0]

    def packed_type(self, i: int) -> int:
        h = self._hdr
        if h is not None:
            return int(h["type"][i])
        return _U16.unpack_from(self.buf, self._off[i] + 4)[0]

    def packed_index(self, i: int) -> int:
        h = self._hdr
        if h is not None:
            return int(h["index"][i])
        return _U64.unpack_from(self.buf, self._off[i] + 8)[0]

    def packed_time(self, i: int) -> int:
        h = self._hdr
        if h is not None:
            return int(h["time"][i])
        return _U64.unpack_from(self.buf, self._off[i] + 24)[0]

    def packed_tfid(self, i: int) -> Tuple[int, int, int]:
        h = self._hdr
        if h is not None:
            return (int(h["tseq"][i]), int(h["toid"][i]), int(h["tver"][i]))
        return _TFID_AT.unpack_from(self.buf, self._off[i] + 32)

    packed_key = packed_tfid   # target identity == tfid triple

    # -- whole columns, list-typed (module/test compatibility) --------------
    def types(self) -> List[int]:
        return self.types_np().tolist()

    def indices(self) -> List[int]:
        return self.indices_np().tolist()

    def flags_column(self) -> List[int]:
        return self.flags_np().tolist()

    def keys(self) -> List[Tuple[int, int, int]]:
        seq, oid, ver = self.tfid_cols()
        return list(zip(seq.tolist(), oid.tolist(), ver.tolist()))

    # -- lazy decode ---------------------------------------------------------
    def record(self, i: int) -> ChangelogRecord:
        rec = self._recs.get(i)
        if rec is None:
            rec = self._recs[i] = unpack(self.packed(i))
        return rec

    def to_records(self) -> List[ChangelogRecord]:
        return [self.record(i) for i in range(len(self))]

    # -- zero-copy restructuring --------------------------------------------
    def freeze(self) -> "RecordBatch":
        """A frozen-buffer twin of this batch (``self`` when the buffer
        is already frozen): one compacting copy up front so every later
        gather / ``select`` / ``to_wire`` on it — and on views derived
        from it — sees a zero-copy ``frombuffer`` base instead of
        re-snapshotting a mutable journal segment per call."""
        if _is_frozen(self.buf):
            return self
        blob, off, ln = self._compact()
        out = RecordBatch(blob, off, ln)
        if self._hdr is not None:
            out._hdr = self._hdr
        return out

    def select(self, keep) -> "RecordBatch":
        """View containing rows ``keep`` (an index sequence or int
        array, in the given order), sharing the payload buffer and any
        already-decoded header columns."""
        keep = _as_i64(keep)
        sub = RecordBatch(self.buf, self._off_col()[keep],
                          self._len_col()[keep])
        sub.origin = self.origin
        if self._hdr is not None:
            sub._hdr = self._hdr[keep]
        lay = self._ext
        if lay is not None:
            # the extension layout is per-row over a shared base:
            # subset it instead of re-walking the payload per view
            base, off, starts, sizes, name_off = lay
            sub._ext = (base, off[keep],
                        {f: s[keep] for f, s in starts.items()},
                        {f: s[keep] for f, s in sizes.items()},
                        name_off[keep])
        return sub

    permute = select

    def _compact(self) -> Tuple[bytes, np.ndarray, np.ndarray]:
        """``(blob, offsets, lengths)`` with the records contiguous in
        ``blob`` and offsets rebased to 0 — one range copy when the
        rows already sit back to back (journal segment views), a
        per-record gather otherwise (selected/permuted views)."""
        n = len(self._off)
        if n == 0:
            return b"", np.empty(0, _I64), np.empty(0, _I64)
        off, ln = self._off_col(), self._len_col()
        if n == 1 or bool(np.all(off[1:] == off[:-1] + ln[:-1])):
            lo, hi = int(off[0]), int(off[-1] + ln[-1])
            buf = self.buf
            if type(buf) is bytes and lo == 0 and hi == len(buf):
                return buf, off, ln
            return bytes(buf[lo:hi]), off - lo, ln
        out = np.zeros(n, _I64)
        np.cumsum(ln[:-1], out=out[1:])
        total = int(out[-1] + ln[-1])
        base, poff = self._payload_base()
        # one ragged-range gather instead of a per-record slice+join
        src = np.arange(total, dtype=_I64) + np.repeat(poff - out, ln)
        return base[src].tobytes(), out, ln

    @staticmethod
    def concat(batches: Sequence["RecordBatch"]) -> "RecordBatch":
        batches = [b for b in batches if len(b)]
        if not batches:
            return RecordBatch.empty()
        if len(batches) == 1:
            return batches[0]
        blobs, offs, lens = [], [], []
        base = 0
        for b in batches:
            blob, off, ln = b._compact()
            blobs.append(blob)
            offs.append(off + base if base else off)
            lens.append(ln)
            base += len(blob)
        out = RecordBatch(b"".join(blobs), np.concatenate(offs),
                          np.concatenate(lens))
        origins = {b.origin for b in batches}
        if len(origins) == 1:            # mixed-origin concat drops the tag
            out.origin = origins.pop()
        if all(b._hdr is not None for b in batches):
            out._hdr = np.concatenate([b._hdr for b in batches])
        return out

    # -- per-batch remap (vectorized) ---------------------------------------
    def _rebuild(self, want: np.ndarray) -> "RecordBatch":
        """Whole-batch remap to a per-row target mask, vectorized: one
        canonical-order layout pass, then a single ragged byte gather
        assembles every output record (header | kept / zero-filled
        extensions | name | rename tail).  Bit-identical to mapping
        ``remap_cached`` over the rows, and the rebuilt batch keeps its
        header columns (flags patched in place) with zero re-gather."""
        n = len(self)
        hdr = self.header()
        src = hdr["flags"].astype(np.int64)
        want = want.astype(np.int64) & CLF_SUPPORTED
        base, off, starts, sizes, name_off = self._layout()
        ln = self._len_col()
        zbase = np.int64(len(base))

        # 8 output segments per row: header, the 5 canonical
        # extensions, name, rename tail.  Zero-filled extensions point
        # into the shared _ZFILL block appended past the payload.
        seg_start = np.empty((n, 8), dtype=np.int64)
        seg_len = np.zeros((n, 8), dtype=np.int64)
        seg_start[:, 0] = off
        seg_len[:, 0] = HDR_SIZE
        for col, flag in enumerate(_FLAG_ORDER, start=1):
            has = (src & flag) != 0
            keep = (want & flag) != 0
            zoff = zbase + (_ZX_OFF if flag == CLF_XATTR else 0)
            seg_start[:, col] = np.where(has, starts[flag], zoff)
            fill = np.where(has, sizes[flag], np.int64(_ZFILL_LEN[flag]))
            seg_len[:, col] = np.where(keep, fill, 0)
        namelen = hdr["namelen"].astype(np.int64)
        seg_start[:, 6] = name_off
        seg_len[:, 6] = namelen
        # rename tail: copy "\0" + sname when kept, a single NUL when
        # zero-filled, nothing when stripped or absent
        has_r = (src & CLF_RENAME) != 0
        keep_r = (want & CLF_RENAME) != 0
        tail = np.where(has_r, off + ln - (name_off + namelen),
                        np.int64(1))
        seg_start[:, 7] = np.where(has_r, name_off + namelen, zbase)
        seg_len[:, 7] = np.where(keep_r, tail, 0)

        out_len = seg_len.sum(axis=1)
        out_off = np.zeros(n, _I64)
        if n > 1:
            np.cumsum(out_len[:-1], out=out_off[1:])
        flat_start = seg_start.ravel()
        flat_len = seg_len.ravel()
        ends = np.cumsum(flat_len)
        total = int(ends[-1]) if ends.size else 0
        idx = (np.arange(total, dtype=np.int64)
               - np.repeat(ends - flat_len, flat_len)
               + np.repeat(flat_start, flat_len))
        big = np.concatenate([base, _ZFILL]) if bool(
            ((flat_start >= zbase) & (flat_len > 0)).any()) else base
        out = big[idx]
        fpos = out_off + 2                 # patch cr_flags (LE u16)
        out[fpos] = (want & 0xFF).astype(np.uint8)
        out[fpos + 1] = ((want >> 8) & 0xFF).astype(np.uint8)
        res = RecordBatch(out.tobytes(), out_off, out_len)
        res.origin = self.origin
        new_hdr = hdr.copy()
        new_hdr["flags"] = want
        res._hdr = new_hdr
        return res

    def remap(self, target_flags: int) -> "RecordBatch":
        dst = target_flags & CLF_SUPPORTED
        fl = self.flags_np()
        if not bool((fl != dst).any()):
            return self
        return self._rebuild(np.full(len(self), dst, dtype=np.int64))

    def project(self, target_flags: int) -> "RecordBatch":
        """Strip-only remap: every record keeps ``src & target_flags``
        (the proxy's §IV-A remote remap — fields the consumer did not
        ask for are stripped, absent fields are never zero-filled).
        Identity — no copy at all — when nothing needs stripping, which
        is the steady state of a consumer asking for everything the
        producers write."""
        strip = CLF_SUPPORTED & ~target_flags
        fl = self.flags_np()
        if not strip or not bool((fl & strip).any()):
            return self
        return self._rebuild(fl.astype(np.int64) & target_flags)

    # -- wire framing --------------------------------------------------------
    # v1: u32 count | count * u32 record length | concatenated payload
    # v2: u32 WIRE2_MAGIC | u32 count | count * u32 record length
    #     | count * 64 B header rows (HDR_DTYPE, LE) | payload
    # A v1 count can never collide with the magic (batches are bounded
    # far below 2^31), so ``from_wire`` sniffs the first word and
    # accepts both frames; version negotiation only controls what a
    # sender *emits*, so a v1-only peer never receives a v2 frame.
    def to_wire(self, version: int = WIRE_V1) -> bytes:
        if version >= WIRE_V2:
            return self.to_wire2()
        blob, _off, ln = self._compact()
        return struct.pack("<I", len(self)) + \
            ln.astype("<u4").tobytes() + blob

    def to_wire2(self) -> bytes:
        """v2 frame: the decoded header table rides alongside the
        payload, so the receiver attaches the columns as a zero-copy
        view instead of re-gathering 64 bytes per record.  A batch with
        an ``origin`` tag appends it as a trailer past the payload —
        one string per frame (never per-record bytes), invisible to
        receivers that predate federation."""
        blob, _off, ln = self._compact()
        hdr = self.header()
        frame = (struct.pack("<II", WIRE2_MAGIC, len(self))
                 + ln.astype("<u4").tobytes()
                 + (hdr.tobytes() if hdr.size else b"") + blob)
        if self.origin is not None:
            tag = self.origin.encode("utf-8")
            frame += struct.pack("<IH", WIRE2_ORIGIN_MAGIC, len(tag)) + tag
        return frame

    @staticmethod
    def from_wire(blob: Buffer) -> "RecordBatch":
        if type(blob) is not bytes:
            mv = blob if type(blob) is memoryview else memoryview(blob)
            blob = mv if mv.readonly else bytes(mv)   # zero-copy receive
        (first,) = struct.unpack_from("<I", blob, 0)
        if first != WIRE2_MAGIC:
            n = first
            lengths = np.frombuffer(blob, dtype="<u4", count=n,
                                    offset=4).astype(_I64)
            offsets = np.full(n, 4 + 4 * n, _I64)
            if n > 1:
                offsets[1:] += np.cumsum(lengths[:-1])
            return RecordBatch(blob, offsets, lengths)
        (n,) = struct.unpack_from("<I", blob, 4)
        lengths = np.frombuffer(blob, dtype="<u4", count=n,
                                offset=8).astype(_I64)
        head = 8 + 4 * n
        offsets = np.full(n, head + HDR_SIZE * n, _I64)
        if n > 1:
            offsets[1:] += np.cumsum(lengths[:-1])
        out = RecordBatch(blob, offsets, lengths)
        out._hdr = np.frombuffer(blob, dtype=HDR_DTYPE, count=n,
                                 offset=head)
        # origin trailer past the payload (absent on pre-federation
        # senders; record offsets never reach it either way)
        end = head + HDR_SIZE * n + int(lengths.sum())
        if len(blob) >= end + 6:
            magic, tlen = struct.unpack_from("<IH", blob, end)
            if magic == WIRE2_ORIGIN_MAGIC and len(blob) >= end + 6 + tlen:
                out.origin = bytes(blob[end + 6:end + 6 + tlen]) \
                    .decode("utf-8")
        return out
