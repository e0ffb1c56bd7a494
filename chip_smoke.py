"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failed check exits nonzero and prints no result:

1. device   the card's name and power limit (no CUDA card: exit 2);
2. build    the CUDA kernels of ``src/repro_torch`` compiled from the
            checkout with nvcc, one process per source, all at once
            (into ``src/repro_torch/kernels/build``);
3. kernels  each kernel against its plain PyTorch version on the same
            inputs, with its time, the plain version's time and its
            bound: ``fid_slots`` bit-exact (integer outputs: tolerance
            0); ``flash_attention`` at every case of the reference's
            tests/test_kernels.py and at the serving path's shape,
            within 2e-5 (float32) / 2e-2 (bfloat16), beside
            ``scaled_dot_product_attention`` on the same tensors as a
            yardstick (the port never calls it);
4. main     the sharded changelog pipeline end to end: 4 MDT journals x
            262,144 records routed by ``LcapCluster(device="cuda")`` to
            4 shards, two consumer groups and an ephemeral reader
            draining it; exactly-once per group, every record on its
            slot's owner, all journals trimmed, one kernel launch per
            routing read; and a small run that must deliver exactly
            what the same cluster delivers routing on the CPU;
5. serve    granite-8b at full width (36 layers, 8.25 B parameters in
            bf16, seeded random weights on the card) through the port's
            serving launcher: 4 prompts of 2048 tokens prefilled through
            the attention kernel (one launch per layer), 16 tokens
            generated, the LCAP invalidation loop over 2 replicas; then
            flash-vs-naive and prefill/decode consistency of the logits.

Then a JSON line of serve numbers, one of kernels, the card's
``nvidia-smi`` line, and the result line ``{"ok": true, "device":
{...}}`` last.  Imports nothing of JAX, of the reference package or of
msgpack.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: the card's peaks used for bounds (NVIDIA H100 SXM data sheet): HBM
#: bytes/s, and INT32 instructions/s.  The sheet's 67 TFLOP/s float32 is
#: 132 SMs x 128 FP32 lanes x 2 (an FMA counts twice) x 1.98 GHz; an SM
#: has half as many INT32 lanes, one instruction each: 67e12 / 4.
HBM_BYTES_PER_S = 3.35e12
INT32_INSTR_PER_S = 67e12 / 4
#: dense bf16 tensor-core peak (NVIDIA H100 SXM data sheet)
BF16_FLOP_PER_S = 989e12
#: float32 peak outside the tensor cores (the same sheet)
FP32_FLOP_PER_S = 67e12

N_MDTS = 4
RECORDS_PER_MDT = 262_144
N_SHARDS = 4
N_SLOTS = 64
BATCH = 1024
SLOTS_SWEEP = (1, 64, 65535, 65536, 1000003)
EDGE_FIDS = [(0, 0, 0), (1, 0, 0), ((1 << 64) - 1, (1 << 32) - 1,
                                    (1 << 32) - 1), (1 << 63, 1, 2)]
#: operation mix of the main path (percent)
MIX = (("CL_CREATE", 30), ("CL_SETATTR", 25), ("CL_CLOSE", 15),
       ("CL_UNLINK", 15), ("CL_MKDIR", 5), ("CL_RMDIR", 5), ("CL_RENAME", 5))
AUDIT = ("CL_CREATE", "CL_UNLINK", "CL_RENAME", "CL_RMDIR")
#: bytes fid_slots must move per row: the one 32-byte sector of the row
#: that holds tseq/toid/tver (bytes 32..47), and the int64 slot written
FID_SLOT_BYTES = 32 + 8
#: INT32 instructions of one fid_slot, counted low (so the bound stays a
#: bound): the three 64 x 64-bit multiplies 3 multiply-adds each and the
#: two 32 x 64-bit ones 2 each (13), the seed's xors one 3-input LOP3
#: per 32-bit half (2), each of the 3 shift+xor steps two funnel shifts
#: and two xors (12), and the 64-bit modulus at least 4
FID_SLOT_INT32_INSTRS = 31


#: tests/test_kernels.py's cases for the attention kernel: (B, Sq, Sk, H,
#: KV, D), dtype, causal, window, cap; the last two add gemma2-9b's
#: head_dim with its softcap, and rows with nothing visible (q >= 20)
FLASH_SHAPES = [(1, 128, 128, 4, 4, 64), (2, 256, 256, 8, 2, 64),
                (1, 100, 100, 4, 2, 80), (2, 64, 192, 4, 1, 32),
                (1, 512, 512, 2, 2, 128)]
FLASH_CASES = (
    [(shape, dtype, True, 0, 0.0) for shape in FLASH_SHAPES
     for dtype in ("float32", "bfloat16")]
    + [((2, 128, 128, 4, 2, 64), "float32", True, window, 0.0)
       for window in (8, 64)]
    + [((1, 128, 128, 4, 4, 64), "float32", True, 0, 20.0),
       ((1, 64, 128, 4, 4, 64), "float32", False, 0, 0.0),
       ((1, 32, 32, 2, 2, 32), "float32", True, 1, 0.0),
       ((1, 96, 96, 4, 2, 224), "bfloat16", True, 0, 50.0),
       ((1, 64, 16, 2, 1, 32), "float32", True, 4, 0.0)])
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: the serving path: granite-8b, B prompts of P tokens, G generated
SERVE_ARCH = "granite-8b"
SERVE_B, SERVE_P, SERVE_G, SERVE_REPLICAS = 4, 2048, 16, 2
#: the attention kernel's shape on that path (bf16, causal)
FLASH_MAIN = ((SERVE_B, SERVE_P, SERVE_P, 32, 8, 128), "bfloat16", True, 0,
              0.0)
#: bound on |logits| differences in the serve checks: the reference's own
#: prefill/decode tolerance (tests/test_models.py: 0.12), held as a plain
#: absolute bound
LOGIT_ATOL = 0.12
#: decode steps profiled on their own after the checks
DECODE_PROFILE_STEPS = 5
DEVICE = torch.device("cuda")


class SmokeError(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_median_ms(fn, runs: int = 50) -> float:
    """Median device time of ``fn()`` over ``runs`` launches, each
    between two CUDA events (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_busy_ms(prof, name: str = "") -> float:
    """Device time of every kernel and copy a CUDA-only profile saw (of
    those whose name contains ``name``)."""
    total_us = 0.0
    for evt in prof.key_averages():
        if name in evt.key:
            total_us += getattr(evt, "self_device_time_total",
                                getattr(evt, "self_cuda_time_total", 0.0))
    return total_us / 1e3


# --------------------------------------------------------------- phase 3
def fid_rows(n: int, seed: int) -> torch.Tensor:
    """``uint8 [n + 4, 64]`` header rows: ``n`` seeded target FIDs plus
    the four 2^64-edge FIDs."""
    from repro_torch.core import records as T
    rng = np.random.default_rng(seed)
    hdr = np.zeros(n + len(EDGE_FIDS), dtype=T.HDR_DTYPE)
    hdr["tseq"][:n] = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    hdr["toid"][:n] = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    hdr["tver"][:n] = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    for j, (s, o, v) in enumerate(EDGE_FIDS):
        hdr[n + j]["tseq"], hdr[n + j]["toid"], hdr[n + j]["tver"] = s, o, v
    return torch.from_numpy(hdr.view(np.uint8).reshape(len(hdr), 64).copy())


def fid_slots_bound_ms(n: int) -> tuple:
    """Least time for ``n`` rows on the card: FID_SLOT_BYTES per row at
    HBM's rate, against FID_SLOT_INT32_INSTRS per row at the INT32
    rate; the larger, and which of the two it is."""
    by_bytes = n * FID_SLOT_BYTES / HBM_BYTES_PER_S * 1e3
    by_ops = n * FID_SLOT_INT32_INSTRS / INT32_INSTR_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def kernel_phase(seed: int) -> dict:
    from repro_torch.kernels import stream_ops
    dev = torch.device("cuda")
    worst = 0
    big = fid_rows(1 << 20, seed)
    cases = [(big, "2^20 + edge FIDs"), (big[:1024], "N = 1024"),
             (big[:0], "N = 0")]
    for rows, label in cases:
        on_card = rows.to(dev)
        for n_slots in SLOTS_SWEEP:
            before = stream_ops.launches
            got = stream_ops.fid_slots_rows(on_card, n_slots)
            torch.cuda.synchronize()
            want = stream_ops.fid_slots_rows_reference(rows, n_slots)
            check(stream_ops.launches == before + (1 if len(rows) else 0),
                  f"fid_slots launch count wrong at {label}")
            check(got.dtype == torch.int64 and got.shape == want.shape,
                  f"fid_slots shape/dtype wrong at {label}")
            diff = (got.cpu() - want).abs()
            err = int(diff.max()) if diff.numel() else 0
            worst = max(worst, err)
            check(err == 0, f"fid_slots differs from its plain version at "
                  f"{label}, n_slots={n_slots}: max |err| {err}")
        log(f"kernels: fid_slots bit-exact vs plain version ({label}, "
            f"n_slots in {SLOTS_SWEEP})")
    # the floor under any launch: one tiny PyTorch kernel
    one = torch.zeros(1, device=dev)
    launch_ms = cuda_median_ms(lambda: one.add_(1))
    log(f"kernels: one-element PyTorch kernel {launch_ms:.6f} ms "
        "(launch floor)")
    sizes = {}
    for n in (1024, 1 << 20):
        rows = big[:n].to(dev)
        ms = cuda_median_ms(lambda: stream_ops.fid_slots_rows(rows, N_SLOTS))
        plain_ms = cuda_median_ms(
            lambda: stream_ops.fid_slots_rows_reference(rows, N_SLOTS),
            runs=20)
        bound_ms, bound_by = fid_slots_bound_ms(n)
        # a launch cannot take less than the floor under any launch
        floor_ms, floor_by = ((launch_ms, "launch") if launch_ms > bound_ms
                              else (bound_ms, bound_by))
        # the kernel's own device time, without the launch around it
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                stream_ops.fid_slots_rows(rows, N_SLOTS)
            torch.cuda.synchronize()
        device_ms = device_busy_ms(prof) / 20
        sizes[n] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "bound_with_launch_ms": floor_ms,
                    "bound_with_launch_by": floor_by, "device_ms": device_ms}
        log(f"kernels: fid_slots N={n} n_slots={N_SLOTS}: kernel {ms:.6f} ms "
            f"(median of 50, CUDA events around each launch; "
            f"{device_ms:.6f} ms device time by torch.profiler), plain "
            f"version {plain_ms:.6f} ms; bound {floor_ms:.6f} ms "
            f"({floor_by}): bytes and INT32 work alone "
            f"{bound_ms:.6f} ms ({bound_by}, {n * FID_SLOT_BYTES} B), "
            f"launch floor {launch_ms:.6f} ms")
    return {"max_abs_err": worst, "sizes": sizes, "launch_ms": launch_ms}


# --------------------------------------------------------------- phase 4
def make_journal_arrays(m: int, n: int, seed: int):
    """MDT ``m``'s journal as packed records (buffer, offsets, lengths,
    types), built in bulk: the operation mix, a ``procname.uid`` jobid
    from 64 jobs on every record, target FIDs on sequence
    ``0x200000400 + m`` with dense oids in 1..65536 (reused, so targets
    have cr_prev chains), and a source FID pair + name for renames."""
    from repro_torch.core import records as T
    rng = np.random.default_rng([seed, m])
    codes = np.array([getattr(T, name) for name, _ in MIX], dtype=np.uint16)
    weights = np.array([w for _, w in MIX], dtype=np.float64)
    types = codes[rng.choice(len(codes), n, p=weights / weights.sum())]
    index = np.arange(1, n + 1, dtype=np.uint64)
    oid = rng.integers(1, 65537, n).astype(np.uint32)
    job = rng.integers(0, 64, n)
    rename = types == T.CL_RENAME
    # cr_prev: the previous record with the same target (0 if none)
    order = np.argsort(oid, kind="stable")
    prev = np.zeros(n, dtype=np.uint64)
    same = oid[order[1:]] == oid[order[:-1]]
    prev[order[1:][same]] = index[order[:-1][same]]

    hdr = np.zeros(n, dtype=T.HDR_DTYPE)
    hdr["namelen"] = 8
    hdr["flags"] = np.where(rename, T.CLF_RENAME | T.CLF_JOBID, T.CLF_JOBID)
    hdr["type"] = types
    hdr["index"] = index
    hdr["prev"] = prev
    hdr["time"] = np.uint64(1_700_000_000 * 10**9) + index * np.uint64(997)
    hdr["tseq"] = 0x200000400 + m
    hdr["toid"] = oid
    hdr["pseq"] = 0x200000400 + m
    hdr["poid"] = 1
    # lengths: header | rename fids (32) | jobid (32) | name (8)
    #          | rename tail NUL + sname (9)
    lengths = (64 + 32 + 8 + rename * (32 + 9)).astype(np.int64)
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    buf = np.zeros(int(lengths.sum()), dtype=np.uint8)

    def put(starts, mat):
        buf[starts[:, None] + np.arange(mat.shape[1])] = mat

    put(offsets, hdr.view(np.uint8).reshape(n, 64))
    r = np.flatnonzero(rename)
    fids = np.zeros(len(r), dtype=[("sseq", "<u8"), ("soid", "<u4"),
                                   ("sver", "<u4"), ("spseq", "<u8"),
                                   ("spoid", "<u4"), ("spver", "<u4")])
    fids["sseq"] = fids["spseq"] = 0x200000400 + m
    fids["soid"] = rng.integers(1, 65537, len(r))
    fids["spoid"] = 1
    put(offsets[r] + 64, fids.view(np.uint8).reshape(len(r), 32))
    jobids = np.zeros((64, 32), dtype=np.uint8)
    for j in range(64):
        text = b"%s.%d" % ((b"dd", b"cp", b"rsync", b"tar")[j % 4], 500 + j)
        jobids[j, :len(text)] = np.frombuffer(text, dtype=np.uint8)
    jo = offsets + 64 + rename * 32
    put(jo, jobids[job])

    def digits(values, lead):
        d = np.empty((len(values), 8), dtype=np.uint8)
        d[:, 0] = ord(lead)
        v = values.astype(np.int64) % 10**7
        for k in range(7, 0, -1):
            d[:, k] = 48 + v % 10
            v //= 10
        return d

    put(jo + 32, digits(index, "f"))
    put(jo[r] + 32 + 8 + 1, digits(index[r], "s"))   # NUL stays zero
    return buf.tobytes(), offsets, lengths, types


def check_generator(buf, offsets, lengths, m: int) -> None:
    """The bulk-built records are byte-identical to ``records.pack`` of
    the same fields (the first 2000 of the journal)."""
    from repro_torch.core import records as T
    for i in range(2000):
        raw = buf[offsets[i]:offsets[i] + lengths[i]]
        rec = T.unpack(raw)
        check(T.pack(rec) == raw, f"mdt{m} record {i + 1} does not repack")
        check(rec.index == i + 1 and rec.jobid and len(rec.name) == 8,
              f"mdt{m} record {i + 1} malformed")


def shard_of(stream, batch) -> int:
    """The shard whose child stream delivered ``batch`` (FanInStream
    remembers it for commits and requeues)."""
    child = stream._sources[id(batch)]
    return next(i for i, s in stream._children if s is child)


def run_pipeline(journals: dict, device: str, n_slots: int = N_SLOTS,
                 batch_size: int = BATCH):
    """Drive the port's main path: cluster, subscriptions (all before
    the first pump), pump + fetch + commit until the journals drain.
    Returns (cluster, logs, deliveries, seconds, routing_seconds);
    deliveries are (group, member, shard, pid, batch), routing_seconds
    the host time spent in the cluster's routing calls (header rows to
    the card, kernel, slots back)."""
    from repro_torch.core import records as T
    from repro_torch.core.cluster import LcapCluster
    from repro_torch.core.llog import from_packed
    from repro_torch.core.proxy import EPHEMERAL
    from repro_torch.core.session import Subscription, connect

    logs = {pid: from_packed(pid, buf, off, ln, first_index=1)
            for pid, (buf, off, ln, _types) in journals.items()}
    t0 = time.perf_counter()
    cluster = LcapCluster(logs, n_shards=N_SHARDS, n_slots=n_slots,
                          batch_size=batch_size, device=device)
    routing = [0.0]
    route = cluster.batch_slots

    def timed_route(batch):
        t = time.perf_counter()
        out = route(batch)
        routing[0] += time.perf_counter() - t
        return out

    cluster.batch_slots = timed_route
    session = connect(cluster)
    audit = frozenset(getattr(T, name) for name in AUDIT)
    streams = []
    for k in range(2):
        streams.append(("robinhood", k, session.subscribe(
            Subscription(group="robinhood", auto_commit=False))))
    for k in range(2):
        streams.append(("audit", k, session.subscribe(
            Subscription(group="audit", types=audit, flags=T.CLF_JOBID,
                         auto_commit=False))))
    streams.append(("reader", 0, session.subscribe(
        Subscription(mode=EPHEMERAL, auto_commit=False))))
    deliveries = []
    for _ in range(100_000):
        moved = cluster.pump()
        for group, k, stream in streams:
            for pid, batch in stream.fetch(1 << 16):
                deliveries.append((group, k, shard_of(stream, batch), pid,
                                   batch))
                moved += len(batch)
            stream.commit()
        if not moved and all(log.first_index == log.last_index + 1
                             for log in logs.values()):
            break
    if device != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return cluster, logs, deliveries, seconds, routing[0]


def verify_pipeline(cluster, logs, deliveries, journals, n_slots) -> dict:
    from repro_torch.core import records as T
    from repro_torch.kernels import stream_ops
    audit = np.array([getattr(T, name) for name in AUDIT])
    seen = {(g, pid): np.zeros(len(j[1]) + 1, dtype=np.int64)
            for g in ("robinhood", "audit", "reader") for pid, j in
            journals.items()}
    owner = cluster.routing.owner_array()
    for group, _k, shard, pid, batch in deliveries:
        idx = batch.indices_np().astype(np.int64)
        np.add.at(seen[(group, pid)], idx, 1)
        rows = torch.from_numpy(batch.header_rows().copy())
        slots = stream_ops.fid_slots_rows_reference(rows, n_slots).numpy()
        check(bool((owner[slots] == shard).all()),
              f"shard {shard} delivered records of slots it does not own")
    drops = sum(s.proxy.stats["ephemeral_drops"] for s in cluster.shards)
    got_reader = 0
    for pid, (_buf, _off, _ln, types) in journals.items():
        counts = {g: seen[(g, pid)][1:] for g in ("robinhood", "audit",
                                                  "reader")}
        check(bool((counts["robinhood"] == 1).all()),
              f"robinhood did not see every {pid} record exactly once")
        want_audit = np.isin(types, audit).astype(np.int64)
        check(np.array_equal(counts["audit"], want_audit),
              f"audit did not see every {pid} record of its types "
              "exactly once")
        check(bool((counts["reader"] <= 1).all()),
              f"the ephemeral reader saw a {pid} record twice")
        got_reader += int(counts["reader"].sum())
    total = sum(len(j[1]) for j in journals.values())
    check(got_reader + drops == total,
          f"ephemeral reader: {got_reader} delivered + {drops} dropped "
          f"!= {total}")
    for pid, log in logs.items():
        check(log.first_index == log.last_index + 1,
              f"{pid} not trimmed: first {log.first_index}, last "
              f"{log.last_index}")
    return {"reader": got_reader, "reader_drops": drops}


def main_path_phase(seed: int) -> dict:
    from repro_torch.kernels import stream_ops
    t0 = time.perf_counter()
    journals = {}
    for m in range(N_MDTS):
        arrays = make_journal_arrays(m, RECORDS_PER_MDT, seed)
        check_generator(*arrays[:3], m)
        journals[f"mdt{m}"] = arrays
    gen_s = time.perf_counter() - t0
    total = N_MDTS * RECORDS_PER_MDT
    log(f"main: generated {total} records in {N_MDTS} journals "
        f"({gen_s:.3f} s, not timed below)")
    from torch.profiler import ProfilerActivity, profile
    stream_ops.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cluster, logs, deliveries, seconds, routing_s = run_pipeline(
            journals, "cuda")
    launches = stream_ops.launches
    reads = cluster.routing_reads
    facts = verify_pipeline(cluster, logs, deliveries, journals, N_SLOTS)
    check(launches > 0, "the main path launched no fid_slots kernel")
    check(launches == reads, f"fid_slots launches {launches} != non-empty "
          f"routing reads {reads}")
    rate = total / seconds
    log(f"main: {total} records, 4 shards, robinhood x2 + audit x2 + "
        f"ephemeral reader: {seconds:.3f} s end to end, {rate:.1f} records/s")
    log(f"main: routing reads {reads}, fid_slots launches {launches}, "
        f"ephemeral reader got {facts['reader']} "
        f"(dropped {facts['reader_drops']} on full outboxes)")
    busy_ms = device_busy_ms(prof)
    log(f"main: routing calls took {routing_s:.3f} s of the host's "
        f"{seconds:.3f} s ({100 * routing_s / seconds:.3f} %); device busy "
        f"{busy_ms:.3f} ms by torch.profiler (kernels and copies), idle "
        f"{100 * (1 - busy_ms / 1e3 / seconds):.3f} %")
    log("main: exactly once per group, every record on its slot's owner, "
        "all journals trimmed")
    # small run: the card's routing delivers exactly what the CPU's does
    small = {f"mdt{m}": make_journal_arrays(m, 4096, seed + 1)
             for m in range(N_MDTS)}
    traces = []
    for device in ("cuda", "cpu"):
        c, lg, dl, _s, _r = run_pipeline(small, device, batch_size=256)
        verify_pipeline(c, lg, dl, small, N_SLOTS)
        traces.append([(g, k, sh, pid, b.to_wire(2))
                       for g, k, sh, pid, b in dl])
    check(traces[0] == traces[1], "routing on the card delivered other "
          "records than routing on the CPU")
    log(f"main: small run (4 x 4096 records) delivers identically with "
        f"routing on the card and on the CPU ({len(traces[0])} batches)")
    return {"launches": launches, "reads": reads, "seconds": seconds,
            "records_per_s": rate, "routing_s": routing_s,
            "device_busy_ms": busy_ms}


# ------------------------------------------------- phase 3: flash attention
def flash_qkv(shape, dtype, seed: int, dev):
    B, Sq, Sk, H, KV, D = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    return tuple(torch.randn(s, generator=gen, device=dev).to(dt)
                 for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D)))


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(q, k) pairs the mask leaves visible, per batch and head."""
    q = np.arange(Sq)
    hi = np.minimum(q, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(Sq, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_bound_ms(case) -> tuple:
    """Least time for one attention call on the card: 4*D FLOPs per
    visible pair at the bf16 tensor-core peak (float32 inputs: the
    float32 peak), against q, k, v and o moved once at HBM's rate."""
    (B, Sq, Sk, H, KV, D), dtype, causal, window, _cap = case
    flops = 4 * D * B * H * visible_pairs(Sq, Sk, causal, window)
    size = 2 if dtype == "bfloat16" else 4
    nbytes = size * D * (2 * B * Sq * H + 2 * B * Sk * KV)
    peak = BF16_FLOP_PER_S if dtype == "bfloat16" else FP32_FLOP_PER_S
    by_ops = flops / peak * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return ((by_ops, "operations") if by_ops >= by_bytes
            else (by_bytes, "bytes")), flops, nbytes


def flash_check(case, seed: int, dev) -> float:
    """The kernel against its plain version on one case; returns the
    max |difference|."""
    from repro_torch.kernels import flash_attention as fa
    shape, dtype, causal, window, cap = case
    q, k, v = flash_qkv(shape, dtype, seed, dev)
    before = fa.launches
    got = fa.flash_attention_bshd(q, k, v, causal=causal, window=window,
                                  cap=cap)
    torch.cuda.synchronize()
    check(fa.launches == before + 1, f"flash_attention launch count wrong "
          f"at {case}")
    check(got.shape == q.shape and got.dtype == q.dtype,
          f"flash_attention shape/dtype wrong at {case}")
    want = fa.flash_attention_reference(q, k, v, causal=causal,
                                        window=window, cap=cap)
    tol = FLASH_TOL[dtype]
    err = (got.float() - want.float()).abs()
    worst = float(err.max())
    bad = int((err > tol + tol * want.float().abs()).sum())
    check(bad == 0 and bool(torch.isfinite(got).all()),
          f"flash_attention differs from its plain version at {case}: "
          f"{bad} elements beyond rtol=atol={tol}, max |err| {worst}")
    if shape == (1, 64, 16, 2, 1, 32):
        check(bool((got[:, 20:] == 0).all()),
              "flash_attention: fully masked rows are not 0")
    return worst


def flash_phase(seed: int) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_attention as fa
    dev = DEVICE
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for i, case in enumerate(FLASH_CASES):
        worst[case[1]] = max(worst[case[1]], flash_check(case, seed + i, dev))
    log(f"kernels: flash_attention within tolerance of its plain version at "
        f"{len(FLASH_CASES)} cases (max |err| float32 {worst['float32']:.3g} "
        f"<= 2e-5 rtol+atol, bfloat16 {worst['bfloat16']:.3g} <= 2e-2)")
    main_err = flash_check(FLASH_MAIN, seed, dev)
    (B, S, _, H, KV, D), *_ = FLASH_MAIN
    q, k, v = flash_qkv(FLASH_MAIN[0], "bfloat16", seed, dev)
    ms = cuda_median_ms(lambda: fa.flash_attention_bshd(q, k, v, causal=True),
                        runs=20)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fa.flash_attention_bshd(q, k, v, causal=True)
        torch.cuda.synchronize()
    device_ms = device_busy_ms(prof) / 10
    plain_ms = cuda_median_ms(
        lambda: fa.flash_attention_reference(q, k, v, causal=True), runs=5)
    # the yardstick: one PyTorch call computing the same function
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)

    lib_err = float((library().transpose(1, 2).float()
                     - fa.flash_attention_reference(q, k, v, causal=True)
                     .float()).abs().max())
    library_ms = cuda_median_ms(library, runs=20)
    (bound_ms, bound_by), flops, nbytes = flash_bound_ms(FLASH_MAIN)
    log(f"kernels: flash_attention bf16 B={B} S={S} H={H} KV={KV} D={D} "
        f"causal: kernel {ms:.6f} ms (median of 20, CUDA events; "
        f"{device_ms:.6f} ms device time by torch.profiler), plain version "
        f"{plain_ms:.6f} ms, scaled_dot_product_attention {library_ms:.6f} ms "
        f"(max |diff| to the plain version {lib_err:.3g}); bound "
        f"{bound_ms:.6f} ms ({bound_by}: {flops / 1e9:.3f} GFLOP, "
        f"{nbytes / 1e6:.3f} MB); max |err| {main_err:.3g}")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "flops": flops, "bytes": nbytes,
            "max_abs_err": main_err, "max_abs_err_float32": worst["float32"],
            "max_abs_err_bfloat16": worst["bfloat16"]}


# ------------------------------------------------------------ phase 5: serve
def serve_phase(seed: int) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs as C
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as S
    from repro_torch.models import transformer as T
    dev = DEVICE
    cfg = C.get_config(SERVE_ARCH)
    n_params = T.count_params(cfg)
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in _tensors(params))
    log(f"serve: {SERVE_ARCH} at full width ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
        f"{n_params} parameters): {weight_bytes / 1e9:.3f} GB of weights on "
        f"the card in {init_s:.3f} s")
    tokens = S.make_tokens(cfg, SERVE_B, SERVE_P, seed=seed, device=dev)
    torch.cuda.reset_peak_memory_stats()

    fa.launches = 0
    out = S.serve(cfg, params, tokens, gen_len=SERVE_G,
                  replicas=SERVE_REPLICAS)
    launches = fa.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches == cfg.n_layers, f"the prefill launched flash_attention "
          f"{launches} times, not once per layer ({cfg.n_layers})")
    logits, gen = out["prefill_logits"], out["generated"]
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    check(tuple(gen.shape) == (SERVE_B, SERVE_G) and
          bool(((gen >= 0) & (gen < cfg.vocab_size)).all()),
          f"generated tokens malformed: {tuple(gen.shape)}")
    check(out["evicted_per_replica"] == [1] * SERVE_REPLICAS,
          f"evicted_per_replica {out['evicted_per_replica']}")
    check(out["remaining_pages"] == [SERVE_B - 1] * SERVE_REPLICAS,
          f"remaining_pages {out['remaining_pages']}")
    prefill_ms = out["prefill_s"] * 1e3
    steps = out["decode_steps"]
    decode_ms = out["decode_s"] * 1e3 / steps
    decode_tok_s = SERVE_B * steps / out["decode_s"]
    total_tok_s = SERVE_B * SERVE_G / (out["prefill_s"] + out["decode_s"])
    log(f"serve: prefill {SERVE_B} x {SERVE_P} tokens {prefill_ms:.3f} ms "
        f"({SERVE_B * SERVE_P / out['prefill_s']:.1f} prompt tokens/s), "
        f"decode {decode_ms:.3f} ms per step over {steps} steps "
        f"({decode_tok_s:.1f} generated tokens/s), {SERVE_B} x {SERVE_G} "
        f"tokens generated in all at {total_tok_s:.1f} tokens/s; "
        f"flash_attention launches {launches}; peak memory {peak_gb:.3f} GB")
    log(f"serve: invalidation over {SERVE_REPLICAS} replicas: evicted "
        f"{out['evicted_per_replica']}, remaining pages "
        f"{out['remaining_pages']}")

    # the same run again under the profiler: where the card's time went
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        again = S.serve(cfg, params, tokens, gen_len=SERVE_G,
                        replicas=SERVE_REPLICAS)
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = device_busy_ms(prof)
    kernel_ms = device_busy_ms(prof, "flash_fwd_kernel")
    prof_prefill_ms = again["prefill_s"] * 1e3
    log(f"serve (profiled run): {wall_ms:.3f} ms wall, device busy "
        f"{busy_ms:.3f} ms (idle {100 * (1 - busy_ms / wall_ms):.3f} %); "
        f"prefill {prof_prefill_ms:.3f} ms, of which the attention kernel "
        f"{kernel_ms:.3f} ms ({100 * kernel_ms / prof_prefill_ms:.3f} %)")

    with torch.inference_mode():
        naive, _ = T.prefill(params, cfg, tokens, max_seq=SERVE_P,
                             impl="naive")
        flash_vs_naive = float((logits - naive).abs().max())
        del naive
        torch.cuda.empty_cache()
        check(flash_vs_naive <= LOGIT_ATOL, f"prefill logits with flash and "
              f"naive attention differ by {flash_vs_naive} > {LOGIT_ATOL}")
        # one decode step at position P after a prefill of P tokens, against
        # the last logits of a prefill of P + 1 tokens
        ext = S.make_tokens(cfg, SERVE_B, SERVE_P + 1, seed=seed + 1,
                            device=dev)
        full, _ = T.prefill(params, cfg, ext, impl="flash")
        _, cache = T.prefill(params, cfg, ext[:, :SERVE_P],
                             max_seq=SERVE_P + 1 + DECODE_PROFILE_STEPS,
                             impl="flash")
        pos = torch.full((SERVE_B,), SERVE_P, dtype=torch.int32, device=dev)
        step, cache = T.decode_step(params, cfg, ext[:, SERVE_P:], cache, pos)
        decode_vs_prefill = float((step[:, 0] - full).abs().max())
        # decode alone under the profiler: the card's share of a step
        token = torch.argmax(step[:, 0], -1)[:, None]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(1, DECODE_PROFILE_STEPS + 1):
                step, cache = T.decode_step(params, cfg, token, cache,
                                            pos + i)
                token = torch.argmax(step[:, 0], -1)[:, None]
            torch.cuda.synchronize()
            step_wall_ms = (time.perf_counter() - t0) * 1e3 / \
                DECODE_PROFILE_STEPS
        step_busy_ms = device_busy_ms(prof) / DECODE_PROFILE_STEPS
        del cache
    check(decode_vs_prefill <= LOGIT_ATOL, f"decode at position {SERVE_P} "
          f"differs from a {SERVE_P + 1}-token prefill by {decode_vs_prefill}"
          f" > {LOGIT_ATOL}")
    log(f"serve: decode alone (profiled, {DECODE_PROFILE_STEPS} steps): "
        f"{step_wall_ms:.3f} ms wall per step, device busy {step_busy_ms:.3f}"
        f" ms per step (idle {100 * (1 - step_busy_ms / step_wall_ms):.3f} "
        f"%); reading the weights once takes at least "
        f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms")
    phase_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"serve: peak device memory over the whole phase, checks included: "
        f"{phase_peak_gb:.3f} GB")
    log(f"serve: last-position logits, flash vs naive attention: max |diff| "
        f"{flash_vs_naive:.6f} (bound {LOGIT_ATOL}); decode step at "
        f"position {SERVE_P} vs a {SERVE_P + 1}-token prefill: max |diff| "
        f"{decode_vs_prefill:.6f} (bound {LOGIT_ATOL}); |logits| up to "
        f"{float(logits.abs().max()):.3f}")
    del params
    torch.cuda.empty_cache()
    return {"arch": SERVE_ARCH, "params": n_params,
            "weight_bytes": weight_bytes, "batch": SERVE_B,
            "prompt_len": SERVE_P, "gen_len": SERVE_G,
            "decode_steps": steps, "prefill_ms": prefill_ms,
            "decode_ms_per_step": decode_ms,
            "decode_tokens_per_s": decode_tok_s,
            "generated_tokens_per_s": total_tok_s,
            "flash_launches": launches, "peak_memory_gb": peak_gb,
            "phase_peak_memory_gb": phase_peak_gb,
            "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "profiled_prefill_ms": prof_prefill_ms,
            "kernel_ms_in_prefill": kernel_ms,
            "kernel_share_of_prefill": kernel_ms / prof_prefill_ms,
            "decode_profiled_wall_ms_per_step": step_wall_ms,
            "decode_device_busy_ms_per_step": step_busy_ms,
            "flash_vs_naive_max_abs": flash_vs_naive,
            "decode_vs_prefill_max_abs": decode_vs_prefill,
            "logit_bound": LOGIT_ATOL,
            "evicted_per_replica": out["evicted_per_replica"],
            "remaining_pages": out["remaining_pages"]}


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {kind} x {torch.cuda.device_count()}")

    # float32 matrix products in full float32: the plain versions' fp32
    # tolerance (2e-5) does not survive TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build, flash_attention, stream_ops
    t0 = time.perf_counter()
    built = _build.build(stream_ops.SOURCE, flash_attention.SOURCE,
                         verbose=True)
    for lib, seconds in built:
        log(f"build: {lib.name} in {seconds:.3f} s")
    log(f"build: both kernels in {time.perf_counter() - t0:.3f} s "
        "(one nvcc each, in parallel)")

    k = kernel_phase(args.seed)
    fl = flash_phase(args.seed)
    main = main_path_phase(args.seed)
    sv = serve_phase(args.seed)
    at = k["sizes"][BATCH]
    kernels = {"kernels": [{
        "name": "fid_slots",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fid_slots.cu",
        "replaces": "src/repro/kernels/stream_ops.py:119",
        "matched": k["max_abs_err"] == 0,
        "launches": main["launches"],
        "max_abs_err": k["max_abs_err"],
        "ms": at["ms"], "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
        "library_ms": None,
        "shape": f"[{BATCH}, 64] uint8 -> [{BATCH}] int64",
        # bound_ms counts bytes and operations only; bound_with_launch_*
        # is the larger of it and the measured launch floor
        "launch_floor_ms": k["launch_ms"],
        "bound_with_launch_ms": at["bound_with_launch_ms"],
        "bound_with_launch_by": at["bound_with_launch_by"],
        "at_2p20": k["sizes"][1 << 20],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:32",
        "launches": sv["flash_launches"],
        "max_abs_err": fl["max_abs_err"],
        "ms": fl["ms"], "plain_ms": fl["plain_ms"],
        "bound_ms": fl["bound_ms"], "bound_by": fl["bound_by"],
        "library_ms": fl["library_ms"],
        "shape": "q (4, 2048, 32, 128), k/v (4, 2048, 8, 128) bf16, causal",
        "device_ms": fl["device_ms"], "flops": fl["flops"],
        "bytes": fl["bytes"],
        "max_abs_err_float32": fl["max_abs_err_float32"],
        "max_abs_err_bfloat16": fl["max_abs_err_bfloat16"],
    }], "main_path": {"records": N_MDTS * RECORDS_PER_MDT,
                      "seconds": main["seconds"],
                      "records_per_s": main["records_per_s"],
                      "routing_reads": main["reads"],
                      "routing_s": main["routing_s"],
                      "device_busy_ms": main["device_busy_ms"]}}
    print(json.dumps({"serve": sv}), flush=True)
    print(json.dumps(kernels), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
