"""Port parity, routing kernel: ``repro_torch.kernels.stream_ops`` (the
CUDA kernel's wrapper and its plain PyTorch version) against the
reference's numpy ``fid_slots`` and its Pallas kernel in interpret mode.

Slots are integers: equality is exact.  Here the wrapper takes the
plain version (its input lies on the CPU); the kernel itself is held
against the plain version on the card by tests/test_torch_card.py and
chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import math                                               # noqa: E402

from repro.core import cluster as ref_cluster             # noqa: E402
from repro.core import records as R                       # noqa: E402
from repro_torch.core import cluster as port_cluster      # noqa: E402
from repro_torch.core import records as T                 # noqa: E402
from repro_torch.core.llog import Llog                    # noqa: E402
from repro_torch.kernels import stream_ops                # noqa: E402

#: chip_smoke.SLOTS_SWEEP: 3 makes the kernel's reciprocal modulus
#: correct its quotient most often, 2^31 - 1 is the largest divisor
N_SLOTS = (1, 3, 64, 65535, 65536, 1000003, (1 << 31) - 1)
EDGE_FIDS = [(0, 0, 0), (1, 0, 0), ((1 << 64) - 1, (1 << 32) - 1,
                                    (1 << 32) - 1), (1 << 63, 1, 2)]


def fid_columns(n: int, seed: int):
    """``n`` seeded FIDs plus the four 2^64-edge FIDs, as the numpy
    columns the reference hashes."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    oid = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    ver = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    edge = np.array(EDGE_FIDS, dtype=object)
    return (np.concatenate([seq, edge[:, 0].astype(np.uint64)]),
            np.concatenate([oid, edge[:, 1].astype(np.uint32)]),
            np.concatenate([ver, edge[:, 2].astype(np.uint32)]))


def header_rows(seq, oid, ver) -> torch.Tensor:
    """The ``uint8 [N, 64]`` header table carrying those FIDs."""
    hdr = np.zeros(len(seq), dtype=T.HDR_DTYPE)
    hdr["tseq"], hdr["toid"], hdr["tver"] = seq, oid, ver
    hdr["index"] = np.arange(1, len(seq) + 1)
    return torch.from_numpy(hdr.view(np.uint8).reshape(len(seq), 64).copy())


@pytest.mark.parametrize("n_slots", N_SLOTS)
def test_plain_version_matches_numpy_fid_slots(n_slots):
    seq, oid, ver = fid_columns(1 << 14, seed=n_slots)
    want = ref_cluster.fid_slots(seq, oid, ver, n_slots)
    rows = header_rows(seq, oid, ver)
    got = stream_ops.fid_slots_rows_reference(rows, n_slots)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    # the wrapper takes the plain version for a CPU tensor
    assert np.array_equal(stream_ops.fid_slots_rows(rows, n_slots).numpy(),
                          want)
    # the port's own numpy and scalar versions agree with the reference's
    assert np.array_equal(port_cluster.fid_slots(seq, oid, ver, n_slots),
                          want)
    assert got[-4:].tolist() == [ref_cluster.fid_slot(k, n_slots)
                                 for k in EDGE_FIDS]
    assert [port_cluster.fid_slot(k, n_slots) for k in EDGE_FIDS] == \
        got[-4:].tolist()


@pytest.mark.parametrize("n_slots", [n for n in N_SLOTS if n < (1 << 16)])
def test_plain_version_matches_pallas_interpret(n_slots):
    stream_ops_ref = pytest.importorskip("repro.kernels.stream_ops")
    seq, oid, ver = fid_columns(512, seed=100 + n_slots)
    want = stream_ops_ref.fid_slots_pallas(seq, oid, ver, n_slots,
                                           interpret=True)
    got = stream_ops.fid_slots_rows_reference(header_rows(seq, oid, ver),
                                              n_slots)
    assert np.array_equal(got.numpy(), want)


def test_empty_batch():
    rows = torch.empty((0, 64), dtype=torch.uint8)
    before = stream_ops.launches
    for fn in (stream_ops.fid_slots_rows,
               stream_ops.fid_slots_rows_reference):
        out = fn(rows, 64)
        assert out.dtype == torch.int64 and out.shape == (0,)
    assert stream_ops.launches == before
    empty = T.RecordBatch.empty()
    assert port_cluster.batch_slots(empty, 64, "cpu").tolist() == []


def test_wrapper_rejects_what_the_kernel_does_not_take():
    rows = torch.zeros((4, 64), dtype=torch.uint8)
    with pytest.raises(TypeError):
        stream_ops.fid_slots_rows(rows.to(torch.int16), 64)
    with pytest.raises(ValueError):
        stream_ops.fid_slots_rows(torch.zeros((4, 32), dtype=torch.uint8), 64)
    with pytest.raises(ValueError):
        stream_ops.fid_slots_rows(torch.zeros(64, dtype=torch.uint8), 64)
    with pytest.raises(ValueError):
        stream_ops.fid_slots_rows(torch.zeros((64, 4), dtype=torch.uint8).t(),
                                  64)
    for bad in (0, -1, 1 << 31):
        with pytest.raises(ValueError):
            stream_ops.fid_slots_rows(rows, bad)
    with pytest.raises(ValueError):
        stream_ops.fid_slots_rows(rows.to("meta"), 64)
    assert stream_ops.fid_slots_rows(rows, (1 << 31) - 1).tolist() == \
        [ref_cluster.fid_slot((0, 0, 0), (1 << 31) - 1)] * 4


def _batch(mod, keys):
    return mod.RecordBatch.from_records(
        [mod.ChangelogRecord(type=R.CL_CREATE, index=i + 1,
                             tfid=mod.Fid(*k), name=b"f%d" % i)
         for i, k in enumerate(keys)])


@pytest.mark.parametrize("n_slots", N_SLOTS)
def test_batch_slots_matches_reference(n_slots):
    rng = np.random.default_rng(7)
    keys = [(int(rng.integers(0, 1 << 63)) * 2 + 1,
             int(rng.integers(0, 1 << 32)), int(rng.integers(0, 1 << 32)))
            for _ in range(300)] + EDGE_FIDS
    ref, port = _batch(R, keys), _batch(T, keys)
    want = ref_cluster.fid_slots(*ref.tfid_cols(), n_slots)
    assert np.array_equal(port_cluster.batch_slots(port, n_slots, "cpu"), want)
    # a received v2 frame's header is a read-only view; slices share it
    frame = T.RecordBatch.from_wire(port.to_wire(T.WIRE_V2))
    assert not frame.header().flags.writeable
    assert np.array_equal(port_cluster.batch_slots(frame, n_slots, "cpu"),
                          want)
    assert np.array_equal(port_cluster.batch_slots(frame[5:50], n_slots,
                                                   "cpu"), want[5:50])
    assert np.array_equal(
        port_cluster.batch_slots(frame.select([9, 2, 2]), n_slots, "cpu"),
        want[[9, 2, 2]])


def test_cluster_defaults_to_the_card():
    logs = {"mdt0": Llog("mdt0")}
    if torch.cuda.is_available():
        cluster = port_cluster.LcapCluster(logs, n_shards=2)
        assert cluster.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cluster.LcapCluster(logs, n_shards=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cluster.LcapCluster(logs, n_shards=2, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cluster.batch_slots(T.RecordBatch.empty(), 64)
    cluster = port_cluster.LcapCluster(logs, n_shards=2, device="cpu")
    assert cluster.device.type == "cpu"
    with pytest.raises(ValueError):
        port_cluster.LcapCluster({}, n_shards=2, device="meta")


def test_wrapper_writes_into_out():
    seq, oid, ver = fid_columns(100, seed=5)
    rows = header_rows(seq, oid, ver)
    want = ref_cluster.fid_slots(seq, oid, ver, 64)
    out = torch.full((len(seq),), -1, dtype=torch.int64)
    assert stream_ops.fid_slots_rows(rows, 64, out=out) is out
    assert np.array_equal(out.numpy(), want)
    for bad in (torch.empty(len(seq), dtype=torch.int32),
                torch.empty(len(seq) + 1, dtype=torch.int64),
                torch.empty((len(seq), 2), dtype=torch.int64)[:, 0],
                torch.empty(len(seq), dtype=torch.int64, device="meta")):
        with pytest.raises(ValueError):
            stream_ops.fid_slots_rows(rows, 64, out=bad)
    with pytest.raises(TypeError):
        stream_ops.fid_slots_rows(rows, 64, out=out.numpy())


#: uneven batch lengths for ``slots_many``, one of them empty; with the
#: chunk cap patched to 300 rows, chunks split batches
LENGTHS = (1, 0, 299, 300, 301, 600, 7)


@pytest.mark.parametrize("n_slots", N_SLOTS)
def test_slots_many_matches_slots_and_the_reference(n_slots, monkeypatch):
    cap = 300
    monkeypatch.setattr(port_cluster, "CHUNK_ROWS", cap)
    rng = np.random.default_rng(n_slots)
    total = sum(LENGTHS)
    keys = [(int(rng.integers(0, 1 << 63)) * 2 + 1,
             int(rng.integers(0, 1 << 32)), int(rng.integers(0, 1 << 32)))
            for _ in range(total - len(EDGE_FIDS))] + EDGE_FIDS
    ref = _batch(R, keys)
    want = ref_cluster.fid_slots(*ref.tfid_cols(), n_slots)
    # slices of a received frame: read-only views of one header table
    frame = T.RecordBatch.from_wire(_batch(T, keys).to_wire(T.WIRE_V2))
    bounds = np.cumsum((0,) + LENGTHS)
    batches = [frame[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    router = port_cluster.SlotRouter("cpu")
    got = router.slots_many(batches, n_slots)
    assert router.chunks == math.ceil(total / cap)
    assert [len(g) for g in got] == list(LENGTHS)
    for batch, g, a, b in zip(batches, got, bounds[:-1], bounds[1:]):
        assert g.dtype == np.int64
        assert np.array_equal(g, want[a:b])
        assert np.array_equal(router.slots(batch, n_slots), want[a:b])
    assert router.slots_many([], n_slots) == []
    assert router.slots_many([T.RecordBatch.empty()] * 2,
                             n_slots)[1].tolist() == []


def kernel_mod(z: int, n: int) -> tuple:
    """``z % n`` as ``csrc/fid_slots.cu::slot_of`` takes it, in Python
    integers: the reciprocal ``m = floor((2^64 - 1) / n)`` the launch
    computes, ``q = umulhi(z, m)``, ``r = z - q*n`` on 64 bits and one
    conditional subtraction.  Returns (slot, whether the subtraction
    fired, whether r was below 2n so that one subtraction was enough)."""
    mask = (1 << 64) - 1
    m = mask // n
    q = (z * m) >> 64
    r = (z - q * n) & mask
    fired = r >= n
    return (r - n if fired else r), fired, r < 2 * n


def numerators(n: int, rng) -> list:
    """The 64-bit edges, the neighbours of n and of the largest multiple
    of n, the edge FIDs' hashes before the modulus, and seeded values."""
    top = ((1 << 64) - 1) // n * n
    return ([0, 1, n - 1, n, n + 1, top - 1, top, (1 << 64) - 1, 1 << 63]
            + [port_cluster.fid_slot(k, 1 << 64) for k in EDGE_FIDS]
            + [int(z) for z in rng.integers(0, 1 << 64, 2000,
                                            dtype=np.uint64)])


@pytest.mark.parametrize("n_slots", N_SLOTS)
def test_reciprocal_modulus_equals_the_remainder(n_slots):
    rng = np.random.default_rng(n_slots)
    for z in numerators(n_slots, rng):
        slot, _fired, one_is_enough = kernel_mod(z, n_slots)
        assert one_is_enough and slot == z % n_slots, (z, n_slots)


def test_reciprocal_modulus_over_seeded_random_pairs():
    rng = np.random.default_rng(22)
    fired = 0
    for n in rng.integers(1, 1 << 31, 300).tolist():
        for z in numerators(n, rng)[:40]:
            slot, f, one_is_enough = kernel_mod(z, n)
            assert one_is_enough and slot == z % n, (z, n)
            fired += f
    assert fired > 0            # the correction step is exercised
