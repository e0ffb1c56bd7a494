"""Port parity, journal and ack layers: ``repro_torch.core.llog`` /
``ack`` / ``history`` against the reference on the same seeded inputs.

Segment files, reader sidecars and history files written by either
package load in the other and are byte-identical; ``from_packed`` hands
a reference journal to the port with its indices intact; the
``AckTracker`` bulk paths and the ``Compactor`` fold give the same
results on the same calls.
"""

import os
import random
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import records as R                      # noqa: E402
from repro.core.ack import AckTracker as RefTracker       # noqa: E402
from repro.core.history import Compactor as RefCompactor  # noqa: E402
from repro.core.llog import Llog as RefLlog               # noqa: E402
from repro_torch.core import records as T                 # noqa: E402
from repro_torch.core.ack import AckTracker               # noqa: E402
from repro_torch.core.history import Compactor            # noqa: E402
from repro_torch.core.llog import Llog, from_packed       # noqa: E402

TYPES = [R.CL_CREATE, R.CL_SETATTR, R.CL_CLOSE, R.CL_UNLINK, R.CL_MKDIR,
         R.CL_RMDIR, R.CL_RENAME, R.CL_HARDLINK]


def recs(mod, n: int, seed: int, t0: int = 1_000_000):
    """``n`` seeded records of package ``mod`` with fixed times (so two
    packages log identical bytes) and reused targets (cr_prev chains)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rtype = TYPES[int(rng.integers(0, len(TYPES)))]
        rec = mod.ChangelogRecord(
            type=rtype, time=t0 + i, tfid=mod.Fid(0x200000400, int(
                rng.integers(1, 40)), 0), pfid=mod.Fid(0x200000400, 1, 0),
            name=b"f%d" % i, jobid=b"cp.%d" % int(rng.integers(0, 5)))
        if rtype == R.CL_RENAME:
            rec.sfid, rec.spfid, rec.sname = (mod.Fid(1, i, 0),
                                              mod.Fid(1, 1, 0), b"old")
        if i % 11 == 0:
            rec.xattr = {"mode": 420 + i, "user": "u%d" % (i % 3)}
        out.append(rec)
    return out


def feed(log, mod, n, seed, reader="feeder"):
    log.register_reader(reader)
    log.log_batch(recs(mod, n, seed))


def files(path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(Path(path).iterdir())}


def read_all(log):
    return list(log.read(log.first_index, 1 << 30))


# --------------------------------------------------------------- segments
@pytest.mark.parametrize("segment_records", [1, 7, 64])
def test_segment_files_byte_identical(tmp_path, segment_records):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = RefLlog("mdt0", path=str(tmp_path / "ref" / "mdt0"),
                  segment_records=segment_records)
    port = Llog("mdt0", path=str(tmp_path / "port" / "mdt0"),
                segment_records=segment_records)
    feed(ref, R, 150, seed=1)
    feed(port, T, 150, seed=1)
    ref.ack("feeder", 40)
    port.ack("feeder", 40)
    ref.close()
    port.close()
    assert files(tmp_path / "ref") == files(tmp_path / "port")
    assert read_all(ref) == read_all(port)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_segment_files_load_in_the_other_package(tmp_path, writer):
    path = str(tmp_path / "mdt0")
    make, mod = (RefLlog, R) if writer == "ref" else (Llog, T)
    load = Llog if writer == "ref" else RefLlog
    w = make("mdt0", path=path, segment_records=16)
    feed(w, mod, 100, seed=2)
    w.ack("feeder", 30)
    want = read_all(w)
    w.close()
    r = load("mdt0", path=path, segment_records=16)
    assert (r.first_index, r.last_index) == (31, 100)
    assert read_all(r) == want
    assert r.reader_position("feeder") == 30
    # appends after the reload keep both packages' framing identical
    r.log_batch(recs(T if writer == "ref" else R, 5, seed=3))
    r.close()
    again = make("mdt0", path=path, segment_records=16)
    assert again.last_index == 105
    assert read_all(again) == read_all(r)


def test_torn_tail_is_dropped_like_the_reference(tmp_path):
    for make, mod, sub in ((RefLlog, R, "ref"), (Llog, T, "port")):
        d = tmp_path / sub
        d.mkdir()
        log = make("mdt0", path=str(d / "mdt0"), segment_records=1000)
        feed(log, mod, 20, seed=4)
        log.close()
        seg = [p for p in os.listdir(d) if ".seg." in p][0]
        with open(d / seg, "ab") as fh:
            fh.write(b"\x40\x00\x00\x00" + b"\x01" * 10)
    ref = RefLlog("mdt0", path=str(tmp_path / "ref" / "mdt0"))
    port = Llog("mdt0", path=str(tmp_path / "port" / "mdt0"))
    assert port.stats == ref.stats
    assert read_all(port) == read_all(ref)
    assert files(tmp_path / "ref") == files(tmp_path / "port")


def test_history_files_byte_identical(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = RefLlog("mdt0", path=str(tmp_path / "ref" / "mdt0"),
                  segment_records=10, history=True)
    port = Llog("mdt0", path=str(tmp_path / "port" / "mdt0"),
                segment_records=10, history=True)
    feed(ref, R, 95, seed=5)
    feed(port, T, 95, seed=5)
    for hi in (25, 60, 95):
        ref.ack("feeder", hi)
        port.ack("feeder", hi)
    assert port.history.record_count == ref.history.record_count
    ref.close()
    port.close()
    assert files(tmp_path / "ref") == files(tmp_path / "port")
    assert list(port.history.read(1, 1000)[0]) == \
        list(ref.history.read(1, 1000)[0])


# ------------------------------------------------------------ from_packed
@pytest.mark.parametrize("first_index", [1, 500])
def test_from_packed_keeps_indices(tmp_path, first_index):
    ref = RefLlog("mdt0", segment_records=32)
    ref._first = ref._next = first_index       # a journal trimmed earlier
    feed(ref, R, 300, seed=6)
    blob, off, ln = ref.read(first_index, 1 << 20)._compact()
    port = from_packed("mdt0", blob, off, ln, first_index=first_index,
                       segment_records=32)
    assert (port.first_index, port.last_index) == \
        (ref.first_index, ref.last_index)
    assert port.segment_count == ref.segment_count
    assert port.stats == ref.stats
    assert read_all(port) == read_all(ref)
    # the cr_prev chain carries on identically
    port.register_reader("feeder")
    ref_more, port_more = recs(R, 20, seed=7), recs(T, 20, seed=7)
    assert port.log_batch(port_more) == ref.log_batch(ref_more)
    assert [r.prev for r in port_more] == [r.prev for r in ref_more]
    assert read_all(port) == read_all(ref)
    # on disk: the same segment files a reference journal writes
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    disk_ref = RefLlog("mdt0", path=str(tmp_path / "a" / "mdt0"),
                       segment_records=32)
    disk_ref._first = disk_ref._next = first_index
    feed(disk_ref, R, 300, seed=6)
    disk_ref.deregister_reader("feeder")
    disk_ref.close()
    disk_port = from_packed("mdt0", blob, off, ln, first_index=first_index,
                            path=str(tmp_path / "b" / "mdt0"),
                            segment_records=32)
    disk_port.close()
    seg_files = {k: v for k, v in files(tmp_path / "a").items()
                 if ".seg." in k}
    assert files(tmp_path / "b") == seg_files
    assert read_all(RefLlog("mdt0", path=str(tmp_path / "b" / "mdt0"))) == \
        read_all(ref)[:300]


def test_from_packed_refuses_wrong_indices():
    ref = RefLlog("mdt0")
    feed(ref, R, 10, seed=8)
    blob, off, ln = ref.read(1, 100)._compact()
    with pytest.raises(ValueError):
        from_packed("mdt0", blob, off, ln, first_index=2)
    with pytest.raises(ValueError):
        from_packed("mdt0", blob, off[::-1], ln[::-1], first_index=1)


# ------------------------------------------------------------------- acks
def _drive(rounds: int, rng: random.Random):
    """The same deliver/ack call sequence on both trackers, bulk and
    scalar paths mixed; every return value and watermark must agree."""
    ref, port = RefTracker(), AckTracker()
    live, nxt = [], 1
    for _ in range(rounds):
        burst = list(range(nxt, nxt + rng.randrange(1, 40)))
        nxt = burst[-1] + 1
        rng.shuffle(burst)
        if rng.random() < 0.3:
            for i in burst:
                ref.deliver(i)
                port.deliver(i)
        else:
            assert port.deliver_many(burst + burst[:3]) == \
                ref.deliver_many(burst + burst[:3])
        live.extend(burst)
        k = rng.randrange(0, len(live) + 1)
        rng.shuffle(live)
        acks, live = live[:k], live[k:]
        if rng.random() < 0.3:
            for i in acks:
                assert port.ack(i) == ref.ack(i)
        else:
            arr = np.asarray(sorted(acks), dtype=np.int64)
            assert port.ack_many(arr) == ref.ack_many(arr)
        if rng.random() < 0.2 and live:
            thr = rng.choice(live)
            assert port.ack_through(thr) == ref.ack_through(thr)
            live = [i for i in live if i > thr]
        assert (port.watermark, port.in_flight, port.acked_total) == \
            (ref.watermark, ref.in_flight, ref.acked_total)
    assert port.ack_many(live) == ref.ack_many(live)
    assert port.watermark == ref.watermark == nxt - 1


@pytest.mark.parametrize("seed", [16, 17, 18, 19])
def test_ack_tracker_paths_match_reference(seed):
    _drive(60, random.Random(seed))


@pytest.mark.parametrize("seed", [0, 1])
def test_compactor_fold_matches_reference(seed):
    ref, port = RefLlog("mdt0"), Llog("mdt0")
    feed(ref, R, 400, seed)
    feed(port, T, 400, seed)
    ref_c, port_c = RefCompactor(), Compactor()
    ref_out = ref_c.compact(ref.read(1, 1 << 20))
    port_out = port_c.compact(port.read(1, 1 << 20))
    assert list(port_out) == list(ref_out)
    assert port_c.stats == ref_c.stats
