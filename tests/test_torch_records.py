"""Port parity, records layer: ``repro_torch.core.records`` against the
reference ``repro.core.records`` on the same seeded inputs.

Exact equality throughout — packed bytes, header columns, restructured
batches, payload gathers and wire frames (both generations, with the
origin trailer) are byte-for-byte the reference's, in both directions.
The port's own msgpack subset is held against ``msgpack`` itself.
"""

import struct

import msgpack
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import records as R                      # noqa: E402
from repro_torch.core import msgpack_subset as M          # noqa: E402
from repro_torch.core import records as T                 # noqa: E402

ALL_TYPES = sorted(R.TYPE_NAMES)


def rand_fields(rng: np.random.Generator, index: int) -> dict:
    """Seeded random record fields; extensions per a random mask."""
    flags = int(rng.integers(0, R.CLF_SUPPORTED + 1))
    f = dict(type=int(rng.choice(ALL_TYPES)), index=index,
             prev=max(0, index - int(rng.integers(0, 4))),
             time=int(rng.integers(0, 1 << 62)),
             tfid=(int(rng.integers(0, 1 << 63)) * 2 + int(rng.integers(0, 2)),
                   int(rng.integers(0, 1 << 32)),
                   int(rng.integers(0, 1 << 32))),
             pfid=(int(rng.integers(0, 1 << 63)),
                   int(rng.integers(0, 1 << 32)),
                   int(rng.integers(0, 1 << 32))),
             name=bytes(rng.integers(97, 123, int(rng.integers(0, 12)))
                        .astype(np.uint8)))
    if flags & R.CLF_RENAME:
        f["rename"] = ((1, 2, 3), (4, 5, index & 0xFFFF), b"old%d" % index)
    if flags & R.CLF_JOBID:
        f["jobid"] = b"job-%d.%d" % (index % 7, index)
    if flags & R.CLF_SHARD:
        f["shard"] = (1, 2, 3, index & 0xFFFF)
    if flags & R.CLF_METRICS:
        f["metrics"] = tuple(float(x) for x in
                             rng.normal(size=int(rng.integers(0, 4))))
    if flags & R.CLF_XATTR:
        f["xattr"] = {"i": index, "s": "v%d" % index, "l": [1, -2.5, None]}
    return f


def build(mod, f: dict):
    """A ``ChangelogRecord`` of package ``mod`` from ``rand_fields``."""
    rec = mod.ChangelogRecord(type=f["type"], index=f["index"], prev=f["prev"],
                              time=f["time"], tfid=mod.Fid(*f["tfid"]),
                              pfid=mod.Fid(*f["pfid"]), name=f["name"])
    if "rename" in f:
        s, sp, sname = f["rename"]
        rec.sfid, rec.spfid, rec.sname = mod.Fid(*s), mod.Fid(*sp), sname
    for key in ("jobid", "shard", "metrics", "xattr"):
        if key in f:
            setattr(rec, key, f[key])
    return rec


def twin_batches(seed: int, n: int = 200):
    rng = np.random.default_rng(seed)
    fields = [rand_fields(rng, i + 1) for i in range(n)]
    return (R.RecordBatch.from_records([build(R, f) for f in fields]),
            T.RecordBatch.from_records([build(T, f) for f in fields]))


def assert_same_batch(a, b):
    assert len(a) == len(b)
    assert list(a) == list(b)
    assert a.header().tobytes() == b.header().tobytes()
    assert a.origin == b.origin


# ------------------------------------------------------------------ records
@pytest.mark.parametrize("seed", range(4))
def test_pack_unpack_bytes_equal(seed):
    rng = np.random.default_rng(seed)
    for i in range(150):
        f = rand_fields(rng, i + 1)
        buf = R.pack(build(R, f))
        assert T.pack(build(T, f)) == buf
        ref, port = R.unpack(buf), T.unpack(buf)
        assert str(ref) == str(port)
        for key in ("flags", "jobid", "shard", "metrics", "xattr", "name",
                    "sname", "prev", "time"):
            assert getattr(ref, key) == getattr(port, key), key


def test_remap_every_mask_pair_bytes_equal():
    rng = np.random.default_rng(7)
    for src in range(R.CLF_SUPPORTED + 1):
        f = rand_fields(rng, src + 1)
        for k in ("rename", "jobid", "shard", "metrics", "xattr"):
            f.pop(k, None)
        if src & R.CLF_RENAME:
            f["rename"] = ((1, 1, 1), (2, 2, 2), b"s")
        if src & R.CLF_JOBID:
            f["jobid"] = b"JOB"
        if src & R.CLF_SHARD:
            f["shard"] = (1, 2, 3, 4)
        if src & R.CLF_METRICS:
            f["metrics"] = (1.5, -2.0)
        if src & R.CLF_XATTR:
            f["xattr"] = {"a": 1}
        buf = R.pack(build(R, f))
        for dst in range(R.CLF_SUPPORTED + 1):
            want = R.remap(buf, dst)
            assert T.remap(buf, dst) == want, (src, dst)
            assert T.remap_cached(buf, dst) == want, (src, dst)
        assert T.packed_jobid(buf) == R.packed_jobid(buf)


# ------------------------------------------------------------ RecordBatch
@pytest.mark.parametrize("seed", range(3))
def test_header_columns_equal(seed):
    ref, port = twin_batches(seed)
    assert port.buf == ref.buf
    assert port.header().dtype == ref.header().dtype
    assert port.header().tobytes() == ref.header().tobytes()
    assert port.header_rows().tobytes() == ref.header().tobytes()
    assert port.header_rows().shape == (len(ref), 64)
    for col in ("indices_np", "types_np", "flags_np", "times_np"):
        assert np.array_equal(getattr(port, col)(), getattr(ref, col)())
    for a, b in zip(port.tfid_cols() + port.pfid_cols(),
                    ref.tfid_cols() + ref.pfid_cols()):
        assert np.array_equal(a, b)
    assert port.keys() == ref.keys()


def test_select_concat_freeze_project_equal():
    ref, port = twin_batches(11)
    rows = [5, 3, 3, 60, 0, 199]
    assert_same_batch(port.select(rows), ref.select(rows))
    assert_same_batch(port[10:40], ref[10:40])
    assert_same_batch(T.RecordBatch.concat([port.select(rows), port[7:9]]),
                      R.RecordBatch.concat([ref.select(rows), ref[7:9]]))
    assert_same_batch(port.freeze(), ref.freeze())
    for want in range(R.CLF_SUPPORTED + 1):
        assert_same_batch(port.project(want), ref.project(want))
        assert_same_batch(port.remap(want), ref.remap(want))
    # a live-journal (bytearray) buffer takes the snapshot paths
    mutable_r = R.RecordBatch(bytearray(ref.buf), ref._off_col(),
                              ref._len_col())
    mutable_p = T.RecordBatch(bytearray(port.buf), port._off_col(),
                              port._len_col())
    assert_same_batch(mutable_p.freeze(), mutable_r.freeze())
    assert_same_batch(mutable_p.select(rows).project(R.CLF_JOBID),
                      mutable_r.select(rows).project(R.CLF_JOBID))


@pytest.mark.parametrize("seed", range(3))
def test_payload_gathers_equal(seed):
    ref, port = twin_batches(seed + 20)
    for view_r, view_p in ((ref, port), (ref.select([9, 1, 4]),
                                         port.select([9, 1, 4]))):
        for width in (1, 8, 32):
            assert np.array_equal(view_p.jobid_col(width),
                                  view_r.jobid_col(width))
        assert np.array_equal(view_p.jobid_word(), view_r.jobid_word())
        for a, b in zip(view_p.shard_cols(), view_r.shard_cols()):
            assert np.array_equal(a, b)
        assert np.array_equal(view_p.metric0_col(), view_r.metric0_col())
        for a, b in zip(view_p.metrics_cols(3), view_r.metrics_cols(3)):
            assert np.array_equal(a, b)
        assert view_p.name_col() == view_r.name_col()
        assert view_p.name_col_str() == view_r.name_col_str()
        assert view_p.xattrs_col() == view_r.xattrs_col()


# ------------------------------------------------------------ wire frames
@pytest.mark.parametrize("origin", [None, "fs-a", "fédé"])
@pytest.mark.parametrize("version", [R.WIRE_V1, R.WIRE_V2])
def test_wire_frames_byte_equal_both_ways(version, origin):
    ref, port = twin_batches(31, n=64)
    ref.origin = port.origin = origin
    for sub_r, sub_p in ((ref, port), (ref.select([3, 1, 2]),
                                       port.select([3, 1, 2])),
                         (R.RecordBatch.empty(), T.RecordBatch.empty())):
        frame = sub_r.to_wire(version)
        assert sub_p.to_wire(version) == frame
        # each package decodes the other's frame to the same batch
        from_ref = T.RecordBatch.from_wire(frame)
        from_port = R.RecordBatch.from_wire(sub_p.to_wire(version))
        assert list(from_ref) == list(sub_r)
        assert list(from_port) == list(sub_r)
        assert from_ref.to_wire(version) == frame
        assert from_port.to_wire(version) == frame
        if version == R.WIRE_V2:
            assert from_ref.origin == sub_r.origin
            assert from_ref.header().tobytes() == sub_r.header().tobytes()


def test_wire_v2_u64_edge_fids():
    fields = [dict(type=R.CL_MARK, index=2**64 - 1, prev=0, time=2**64 - 1,
                   tfid=(2**64 - 1, 2**32 - 1, 2**32 - 1), pfid=(0, 0, 0),
                   name=b"")]
    fields.append(dict(fields[0], tfid=(2**63, 1, 2**31), index=3))
    ref = R.RecordBatch.from_records([build(R, f) for f in fields])
    port = T.RecordBatch.from_records([build(T, f) for f in fields])
    assert port.to_wire(T.WIRE_V2) == ref.to_wire(R.WIRE_V2)
    out = T.RecordBatch.from_wire(ref.to_wire(R.WIRE_V2))
    assert out.tfid_cols()[0].tolist() == [2**64 - 1, 2**63]


# ------------------------------------------------------------ msgpack
_EDGE_INTS = [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
              2**63 - 1, 2**64 - 1, -1, -32, -33, -128, -129, -32768,
              -32769, -2**31, -2**31 - 1, -2**63]


def _rand_obj(rng: np.random.Generator, depth: int = 0):
    kind = int(rng.integers(0, 10 if depth < 3 else 7))
    if kind == 0:
        return None
    if kind == 1:
        return bool(rng.integers(0, 2))
    if kind == 2:       # every integer width, both signs
        bits = int(rng.integers(0, 64))
        v = int(rng.integers(0, 1 << 62)) >> (62 - min(bits, 62))
        return -v - 1 if rng.integers(0, 2) else v
    if kind == 3:
        return float(rng.normal() * 10 ** int(rng.integers(-5, 5)))
    if kind == 4:
        n = int(rng.choice([0, 5, 31, 32, 255, 256, 70000]))
        return "é" * (n // 2) + "x" * (n - n // 2)
    if kind == 5:
        n = int(rng.choice([0, 1, 255, 256, 65536]))
        return bytes(rng.integers(0, 256, n).astype(np.uint8))
    if kind == 6:
        return _EDGE_INTS[int(rng.integers(0, len(_EDGE_INTS)))]
    if kind == 7:
        n = int(rng.choice([0, 3, 15, 16, 17]))
        return [_rand_obj(rng, depth + 1) for _ in range(n)]
    if kind == 8:
        return tuple(_rand_obj(rng, depth + 1)
                     for _ in range(int(rng.integers(0, 4))))
    n = int(rng.choice([0, 2, 15, 16, 20]))
    return {("k%d" % i if i % 3 else b"b%d" % i): _rand_obj(rng, depth + 1)
            for i in range(n)}


@pytest.mark.parametrize("seed", range(4))
def test_msgpack_subset_matches_msgpack(seed):
    rng = np.random.default_rng(seed)
    for _ in range(300):
        obj = _rand_obj(rng)
        blob = msgpack.packb(obj)
        assert M.packb(obj) == blob
        assert M.unpackb(blob) == msgpack.unpackb(blob)
        assert M.unpackb(memoryview(blob)) == msgpack.unpackb(blob)


def test_msgpack_subset_refuses_what_msgpack_refuses():
    for obj in (2**64, -2**63 - 1):
        with pytest.raises(OverflowError):
            msgpack.packb(obj)
        with pytest.raises(OverflowError):
            M.packb(obj)
    with pytest.raises(TypeError):
        M.packb({1, 2})
    bad_key = msgpack.packb({1: 2}, strict_types=False)
    with pytest.raises(ValueError):
        msgpack.unpackb(bad_key)
    with pytest.raises(ValueError):
        M.unpackb(bad_key)
    with pytest.raises(ValueError):
        M.unpackb(b"\x92\x01")               # truncated array
    with pytest.raises(ValueError):
        M.unpackb(b"\x01\x02")               # trailing data
    # single-precision floats decode like msgpack's
    f32 = b"\xca" + struct.pack(">f", 1.25)
    assert M.unpackb(f32) == msgpack.unpackb(f32)
