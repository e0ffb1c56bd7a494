"""Phase 7b of ``chip_smoke.py`` on the CPU, at a small size: the whole
LCAP proxy on the cluster through the port and through the reference.

The four stream modules of the reference's own test
(tests/test_columnar.py) agree between the packages on both of their
paths.  The module chain with tenant-scoped groups and a quota that
parks and lifts (part (a): a shard added and slots migrated to it while
the quota holds) delivers the same bytes through both packages; the
replay bootstrap hashed on the shard services' threads while the
distributor routes (part (b)) passes the phase's checks in each.  The
phase's delivery checks reject a record outside a tenant's scope, a
duplicate replayed row and a lost record.  The repair the phase called
for is held here too: a tenant quota set before ``add_shard`` reaches
the new shard.
"""

import importlib.util
import random
from pathlib import Path
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import repro.core.cluster as ref_cluster                   # noqa: E402
import repro.core.federation as ref_federation             # noqa: E402
import repro.core.llog as ref_llog                         # noqa: E402
import repro.core.modules as ref_modules                   # noqa: E402
import repro.core.session as ref_session                   # noqa: E402
import repro.core.tenancy as ref_tenancy                   # noqa: E402
from repro.core import records as R                       # noqa: E402
import repro_torch.core.modules as port_modules            # noqa: E402
from repro_torch.core import records as T                 # noqa: E402
from repro_torch.core.cluster import LcapCluster          # noqa: E402
from repro_torch.core.llog import Llog                    # noqa: E402
from repro_torch.core.session import Subscription, connect  # noqa: E402
from repro_torch.core.tenancy import TenantPrincipal      # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

REF = SimpleNamespace(R=R, cluster=ref_cluster, llog=ref_llog,
                      session=ref_session, federation=ref_federation,
                      modules=ref_modules, tenancy=ref_tenancy, kw={})
PORT = smoke.port_modules()
PORT.kw = {"device": "cpu"}

#: records per MDT journal and per training host
N, M = 2048, 512


# ---------------------------------------------------------------- repair
def quota_cluster(n_slots: int = 8):
    """A one-shard cluster on the CPU over journal ``mdt0``, tenant acme
    under a quota of 1 record a second with a burst of 5, on a clock
    that never moves (the buckets never refill)."""
    log = Llog("mdt0")
    cluster = LcapCluster({"mdt0": log}, n_shards=1, n_slots=n_slots,
                          device="cpu")
    cluster.set_tenant_quota("acme", records_per_s=1, burst_records=5)
    return log, cluster


def acme_records(lo: int, hi: int) -> list:
    return [T.ChangelogRecord(type=T.CL_CREATE, tfid=T.Fid(0x200000400, i, 0),
                              pfid=T.Fid(0x200000400, 1, 0),
                              name=b"f%d" % i, jobid=b"acme.1", time=i)
            for i in range(lo, hi)]


def test_quota_set_before_add_shard_reaches_the_new_shard():
    """A quota set before ``add_shard`` is installed on the shard added
    after it; once the new shard owns every slot, a tenant over quota
    parks there: the records of a second round wait in the shard's
    buffer (its one group is blocked, so dispatch stalls), and its
    dispatch rounds count as parked."""
    log, cluster = quota_cluster()
    new = cluster.add_shard()
    proxy = cluster.shards[new].proxy
    proxy._now = lambda: 0.0
    acct = proxy.tenants.get("acme")
    assert acct is not None and acct.record_bucket is not None
    assert (acct.record_bucket.rate, acct.record_bucket.burst) == (1.0, 5.0)
    cluster.migrate_slots(range(8), new)
    for _ in range(5):
        cluster.pump()
    assert cluster._migration is None and cluster.slot_owner == [new] * 8
    stream = connect(cluster).subscribe(Subscription(
        group="acme", tenant=TenantPrincipal("acme", prefixes=(b"acme.",)),
        auto_commit=False))
    got = []
    for lo in (0, 20):
        log.log_batch(acme_records(lo, lo + 20))
        for _ in range(3):
            cluster.pump()
            for _pid, batch in stream.fetch(1000):
                got += batch.indices_np().tolist()
            stream.commit()
    assert got == list(range(1, 21))
    assert proxy.tenants["acme"].quota_blocked_pumps > 0
    assert proxy.buffered == 20


def test_quota_cleared_without_rates_on_every_shard_the_new_one_too():
    """``set_tenant_quota(name)`` with no rates clears the buckets on
    every shard, on one added before the call, and leaves none for a
    shard added after it."""
    _log, cluster = quota_cluster()
    cluster.add_shard()
    cluster.set_tenant_quota("acme")
    cluster.add_shard()
    for shard in cluster.shards:
        acct = shard.proxy.tenants.get("acme")
        assert acct is None or (acct.record_bucket is None
                                and acct.byte_bucket is None)
    cluster.set_tenant_quota("acme", bytes_per_s=100)
    cluster.add_shard()
    assert all(s.proxy.tenants["acme"].byte_bucket is not None
               for s in cluster.shards)


# --------------------------------------------------------------- modules
def module_stream(seed: int, n: int = 160) -> list:
    """A reference record stream that exercises every module: heartbeats
    of a few hosts, create/unlink and mkdir/rmdir on a few targets,
    checkpoint writes of a few shards, CL_CLOSE and other operations,
    each with a jobid and some with extension fields."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        roll = rng.random()
        if roll < 0.25:
            rtype, fid = R.CL_HEARTBEAT, R.Fid(7, rng.randrange(4), 0)
        elif roll < 0.5:
            rtype = rng.choice([R.CL_CREATE, R.CL_UNLINK, R.CL_MKDIR,
                                R.CL_RMDIR, R.CL_HARDLINK])
            fid = R.Fid(0x200000400, rng.randrange(6), 0)
        elif roll < 0.65:
            rtype = R.CL_CKPT_WRITE
            fid = R.Fid(7, rng.randrange(3), rng.randrange(2))
        else:
            rtype = rng.choice([R.CL_CLOSE, R.CL_SETATTR, R.CL_OPEN,
                                R.CL_RENAME, R.CL_MARK])
            fid = R.Fid(0x200000400, rng.randrange(50), 0)
        ext = {}
        if rng.random() < 0.3:
            ext["metrics"] = (rng.random(), float(i))
        if rtype == R.CL_RENAME:
            ext.update(sfid=R.Fid(1, 2, 3), spfid=R.Fid(4, 5, 6),
                       sname=b"old%d" % i)
        out.append(R.ChangelogRecord(
            type=rtype, index=i + 1, prev=0, time=1000 + i, tfid=fid,
            pfid=R.Fid(0x200000400, 1, 0), name=b"n%d" % i,
            jobid=rng.choice([b"dd.1", b"cp.2", b"train.7"]), **ext))
    return out


def chain(mod, R_):
    return [mod.TypeFilter(set(R_.TYPE_NAMES) - {R_.CL_CLOSE}),
            mod.CoalesceHeartbeats(), mod.CancelCompensating(),
            mod.ReorderByTarget()]


def packed(batch, R_) -> list:
    if isinstance(batch, R_.RecordBatch):
        return [batch.packed(i) for i in range(len(batch))]
    return [R_.pack(r) for r in batch]


@pytest.mark.parametrize("path", ["columnar", "list"])
@pytest.mark.parametrize("seed", [7, 8, 9])
def test_module_chain_matches_the_reference(seed, path):
    """Each of the four modules, and the four chained in the order the
    phase uses, give the same records in the same order in both
    packages, on ``RecordBatch`` (columnar) and on record lists."""
    ref_recs = module_stream(seed)
    port_recs = [T.unpack(R.pack(r)) for r in ref_recs]

    def inputs():
        if path == "columnar":
            return (R.RecordBatch.from_records(ref_recs),
                    T.RecordBatch.from_records(port_recs))
        return list(ref_recs), list(port_recs)

    ref_mods, port_mods = chain(ref_modules, R), chain(port_modules, T)
    for ref_mod, port_mod in zip(ref_mods, port_mods):
        ref_in, port_in = inputs()
        assert packed(port_mod(port_in), T) == packed(ref_mod(ref_in), R)
    ref_out, port_out = inputs()
    for ref_mod, port_mod in zip(ref_mods, port_mods):
        ref_out, port_out = ref_mod(ref_out), port_mod(port_out)
    assert packed(port_out, T) == packed(ref_out, R)
    assert len(port_out) < len(port_recs)


# -------------------------------------------------------- phase 7b (a)
@pytest.fixture(scope="module")
def journals():
    return smoke.proxy_journals(N, M, 3)


def records(pkg, journals):
    return {pid: smoke.journal_records(pkg.R, a, 0, len(a[1]))
            for pid, a in journals.items()}


@pytest.fixture(scope="module")
def columns(journals):
    return smoke.journal_columns(records(PORT, journals))


@pytest.fixture(scope="module")
def chains(journals):
    """Both packages with the shard added before the quota (the
    reference has no repair), and the port as the phase runs it: the
    shard added after the quota is set, at halfway."""
    return {"ref": smoke.run_proxy_chain(REF, records(REF, journals),
                                         add_after_quota=False),
            "port": smoke.run_proxy_chain(PORT, records(PORT, journals),
                                          add_after_quota=False),
            "port_added_after": smoke.run_proxy_chain(
                PORT, records(PORT, journals))}


@pytest.mark.parametrize("key", ["trace", "routing", "journal_acked",
                                 "facts", "stats"])
def test_proxy_chain_matches_the_reference(chains, key):
    """Every delivery of every group (wire-v2 bytes, shard by shard), the
    epoch and owners, the journal acks and the scenario's facts (rows
    each module removed, by shard too; dd's parked rounds by shard; the
    migration and the lift) are equal, and so is every stat but the
    count of journal ack calls: a port shard keeps its watermark below
    records still buffered for dispatch where the reference's runs
    ahead (a deliberate difference of the port, ROADMAP), so the port
    acks the journals in as many steps or more, to the same final
    acks."""
    ref, port = chains["ref"][key], chains["port"][key]
    if key == "stats":
        assert port["journal_acks"] >= ref["journal_acks"] > 0
        ref, port = (dict(s, journal_acks=None) for s in (ref, port))
    assert port == ref


@pytest.mark.parametrize("run", ["ref", "port", "port_added_after"])
def test_proxy_chain_passes_the_phase_checks(chains, columns, run):
    """Each run passes phase 7b (a)'s checks: every module acted (three
    removed rows, the reorder permuted batches), every shard lost rows
    to the chain, robinhood got each record once or a module removed it,
    audit and the tenant groups got robinhood's records of their types
    and scopes, and dd parked, on the added shard too."""
    facts = smoke.verify_proxy_chain(chains[run], columns)
    assert sum(facts["tenant_records"].values()) > 0
    assert chains[run]["facts"]["parked_rounds"][
        chains[run]["facts"]["added"]] > 0


def test_proxy_chain_counts_launch_sites(chains):
    port = chains["port_added_after"]
    chunks = port["sites"]["chunks"]
    assert chunks["round"] > 0 and chunks["migration"] > 0
    assert port["routing_launches"] == sum(chunks.values())


def test_trace_digest_tells_traces_apart(chains):
    """Phase 7b (a) holds the card's trace against the CPU process's by
    ``trace_digest``: one bit flipped, two batches swapped or a field's
    bytes moved to the next field change it; the same entries do not."""
    trace = chains["port"]["trace"]
    digest = smoke.trace_digest(trace)
    assert smoke.trace_digest([tuple(e) for e in trace]) == digest
    group, member, shard, pid, wire = trace[0]
    flipped = (group, member, shard, pid, wire[:-1] + bytes([wire[-1] ^ 1]))
    assert smoke.trace_digest([flipped] + trace[1:]) != digest
    k = next(i for i, e in enumerate(trace) if e != trace[0])
    swapped = [trace[k]] + trace[1:k] + [trace[0]] + trace[k + 1:]
    assert smoke.trace_digest(swapped) != digest
    assert smoke.trace_digest([("ab", "c")]) != smoke.trace_digest(
        [("a", "bc")])


# -------------------------------------------------------- phase 7b (b)
@pytest.fixture(scope="module")
def replays(journals):
    return {name: smoke.run_replay(pkg, records(pkg, journals))
            for name, pkg in (("ref", REF), ("port", PORT))}


@pytest.mark.parametrize("name", ["ref", "port"])
def test_threaded_replay_passes_the_phase_checks(replays, columns, name):
    """A replay bootstrap of tenant cp over the wire, read on the shard
    services' threads while the distributor routes the second half:
    no (journal, index) twice, live every record in scope above each
    shard's handoff watermark, every replayed row on a slot of the shard
    that served it, no read on the distributor's thread."""
    run = replays[name]
    facts = smoke.verify_replay(run, columns)
    assert facts["replayed"] > 0 and facts["live"] > 0
    assert run["distributor"] not in run["read_threads"]


def test_threaded_replay_hashes_on_the_service_threads(replays):
    """The port's replay chunks were hashed on threads other than the
    distributor's, which hashed every routing round."""
    run = replays["port"]
    assert run["sites"]["chunks"]["replay"] > 0
    assert run["threads"]["round"] == [run["distributor"]]
    assert run["distributor"] not in run["threads"]["replay"]
    assert run["routing_launches"] == sum(run["sites"]["chunks"].values())


# ------------------------------------------------------ planted faults
def plant_out_of_scope(run: dict) -> dict:
    """Relabel one batch tenant cp got as tenant dd's."""
    trace = list(run["trace"])
    k = next(i for i, e in enumerate(trace) if e[0] == "tenant-cp")
    trace[k] = ("tenant-dd",) + trace[k][1:]
    return dict(run, trace=trace)


def plant_lost(run: dict) -> dict:
    """Take one robinhood batch out of the trace."""
    trace = list(run["trace"])
    del trace[next(i for i, e in enumerate(trace) if e[0] == "robinhood")]
    return dict(run, trace=trace)


def plant_duplicate_replay(run: dict) -> dict:
    """Deliver one batch of replayed rows of the replay group twice."""
    batches = list(run["groups"]["tenant-cp"])
    k = next(i for i, (shard, pid, idx, *_rest) in enumerate(batches)
             if (idx <= run["hw"][shard].get(pid, 0)).any())
    batches.append(batches[k])
    return dict(run, groups=dict(run["groups"], **{"tenant-cp": batches}))


@pytest.mark.parametrize("plant,what", [
    (plant_out_of_scope, "outside its scope"),
    (plant_lost, "robinhood got"),
])
def test_chain_checks_fail_a_planted_fault(chains, columns, plant, what):
    with pytest.raises(smoke.SmokeError, match=what):
        smoke.verify_proxy_chain(plant(chains["port"]), columns)


def test_replay_checks_fail_a_duplicate_replayed_row(replays, columns):
    with pytest.raises(smoke.SmokeError, match="twice"):
        smoke.verify_replay(plant_duplicate_replay(replays["port"]),
                            columns)
