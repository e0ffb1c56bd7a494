"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failed check exits nonzero and prints no result:

1. device   the card's name and power limit (no CUDA card: exit 2; no
            ``src/repro_torch`` beside the script: exit 3);
2. build    the CUDA kernels of ``src/repro_torch`` compiled from the
            checkout with nvcc, one process per source, all at once
            (into ``src/repro_torch/kernels/build``);
3. kernels  each kernel against its plain PyTorch version on the same
            inputs, with its time, the plain version's time and its
            bound: ``fid_slots`` bit-exact (integer outputs: tolerance
            0) at N = 0, 1024 and 2^16 (with the edge FIDs) and 2^20 for
            every n_slots of ``SLOTS_SWEEP``, called alone and into a
            given ``out``, timed at 1024, 2^16 (one routing chunk) and
            2^20, its SASS instructions counted (``cuobjdump``), and one
            routing round of 64 journal reads of 1024 records hashed
            through one ``SlotRouter.slots_many`` against 64
            ``SlotRouter.slots`` calls, in turns (host ns a row), and
            beside it PyTorch copies of one word of each row and of
            whole rows; each of the two attention kernels
            (``flash_fwd_sm90_kernel``, wgmma and TMA, bf16 with
            D % 16 == 0; ``flash_fwd_kernel``, CUDA cores, every case)
            at every case of the reference's
            tests/test_kernels.py it takes, at the serving path's shape
            and at extra bf16 cases (a 2049-token prefill, gemma2's
            head_dim with window and softcap, rows with nothing visible,
            phase 9's head_dim 64 with GQA 32:4, phase 11's head_dim 160
            (an instance of the wgmma kernel's own), phase 12's non-causal
            encoder over 1500 frames and its decoder prefill, small
            non-causal cases with Sq != Sk and Sk not a multiple of 64,
            and the prefills of phases 12a and 12b: gemma2-9b's 2 x 8192
            tokens at head_dim 224 with its softcap, on a local layer
            (window 4096) and a global one, and qwen2.5-14b's GQA 40:8),
            within 2e-5 (float32) / 2e-2 (bfloat16), where a case with a
            softcap has q scaled so that the cap matters, and each
            kernel launched without the case's softcap or window must
            fail the same check; both timed at the shapes of phases 5,
            9, 11, 12 (encoder and decoder), 12a (both layers, and the
            global one without its softcap) and 12b,
            in turns with ``scaled_dot_product_attention`` on the same
            tensors as a yardstick (the port never calls it; with
            gemma2's softcap, ``flex_attention`` compiled with the cap
            as its score_mod, and SDPA without the cap beside it); the
            wgmma kernel also checked at its tile edges
            (``FLASH_SM90_EDGE``: every instance, head_dims 16 to 256,
            lengths 1 to 1000, Sq != Sk, GQA 8:1, windows ending inside a
            kv tile, the softcap, rows with nothing visible), each
            instance's registers, stack and spills (``cuobjdump
            --dump-resource-usage``) and its SASS spills and wgmmas
            logged; the CUDA-core kernel also checked at its tile edges in
            float32 and bf16 (``FLASH_SIMT_EDGE``: head_dims 1 to 256,
            lengths 1 to 1000, Sq != Sk, GQA 8:1, windows ending inside a
            kv tile, the softcap, rows with nothing visible), in bf16 at
            head_dim 72 through the wrapper (``kernel_for``'s CUDA-core
            branch, launches counted by the wrapper and on the card), its SASS
            counted by opcode, and checked and timed in float32 at the
            shapes of phases 5, 9 and 11 (head_dims 128, 64 and 160),
            against SDPA in float32 and its bound at the card's float32
            CUDA-core rate; the decode kernel (``decode_attn_kernel``,
            with ``decode_attn_merge_kernel`` where it splits) through
            ``decode_attention_bshd`` at granite-8b's benchmark cell (32
            sequences over 4224 slots) and at the decode shape of every
            served family (``DECODE_FAMILIES``: gemma2-9b's ring after it
            wrapped and its global layer, both with the softcap), at
            per-sequence positions, at its own split count and at one
            split, within the card tests' tolerance of its plain version
            (launched without gemma2's softcap it must fail that check),
            launches counted by the wrapper and on the card; each shape
            timed by CUDA events in turns with
            ``scaled_dot_product_attention`` (``enable_gqa``, the same
            boolean mask; without gemma2's softcap), with the plain
            version's time, the model's former path's
            (``attention_core_naive``), the profiler's device time of
            both kernels and the bound by bytes (the cache read once);
            and the split counts 1 to 12 timed at the cell's traffic for
            granite-8b (4 heads a block) and qwen3-moe (8);
4. main     the sharded changelog pipeline end to end: 4 MDT journals x
            262,144 records routed by ``LcapCluster(device="cuda")`` to
            4 shards, two consumer groups and an ephemeral reader
            draining it; exactly-once per group, every record on its
            slot's owner, all journals trimmed, one kernel launch per
            routing chunk (a round's reads hashed together, up to
            ``CHUNK_ROWS`` rows a launch: fewer launches than reads);
            and a small run that must deliver exactly what the same
            cluster delivers routing on the CPU;
5. serve    granite-8b at full width (36 layers, 8.25 B parameters in
            bf16, seeded random weights on the card) through the port's
            serving launcher: 4 prompts of 2048 tokens prefilled through
            the wgmma attention kernel (one launch per layer, and none of
            the CUDA-core kernel, by the wrapper's counters and by the
            kernels' own counts on the card; the profiler's kernel names,
            which can lose a record, at most as many; no ``fid_slots``
            launch), 16 tokens
            generated (one decode-kernel launch per layer a step, by the
            wrapper's count and the kernel's own, as in every serving
            phase), the LCAP invalidation loop over 2 replicas; then
            5 warm calls of the launcher, whose medians are the phase's
            prefill and decode times (as in every serving phase);
            flash-vs-naive and prefill/decode consistency of the logits;
6. wire     the main path over the wire, on 4 MDT journals x 65,536
            records from phase 4's generator: (a) ``LcapClusterService``
            routing on the card (its distributor thread), the main path's
            consumers in this process on the four shard ports over
            127.0.0.1 TCP with v2 frames, with phase 4's checks, one
            kernel launch per routing chunk, and a small run that must
            deliver per group what the in-process run delivers; (b) four
            spawned ``run_shard_daemon`` processes, each draining a
            co-located robinhood group, fed deep-batched v2 offers by a
            coordinator here that routes on the card, and an audit group
            over the wire; records/s, routing seconds, wire bytes and
            messages (``transport.instrument``) and the seconds in
            ``msgpack_subset``;
7. activity the paper's consumers over the card-routed cluster, on 4 MDT
            journals x 65,536 records from phase 4's generator: a
            namespace mirror, a policy engine whose action journal is a
            fifth producer (archive and purge rules on stream time, an
            executor failing every fifth action; both rules must fire,
            and each archive target must have been last set by a job and
            idle at its action's emission, by the engine's view and by a
            replay of the journals), a windowed aggregator,
            an audit trail and a SQLite metrics database, all held
            against a plain reckoning from the generator's arrays; the
            action stream reconciled; the merged registry's counters,
            one Prometheus scrape over 127.0.0.1, a Ganglia push and the
            ``top`` frame; one kernel launch per routing chunk; and a
            small run whose consumers must end in the same state routing
            on the card and on the CPU;
7a. elastic the paper's elastic operations with routing on the card, on
            phase 4's generator (cluster of 64 slots, batches of 1024),
            each part's ``fid_slots`` launches counted from 0 and equal to
            its routers' chunks, call site by call site
            (``RoutingSites``): (a) ``benchmarks/bench_elastic.py``'s
            churn storm at 4 journals x 65,536 records a window: an
            ``LcapClusterService`` of 4 shard ports, one durable member
            over ``connect(addresses)`` never restarted, a steady window
            streamed 256 records a journal at a time, then a churn
            window under seeded ``migrate_slots``, one
            ``service.add_shard()`` and a split through the service, the
            window's first migration taken with the consumer held and
            records still to come, so that the stream parks records for
            it whatever the host's speed; both windows exactly once,
            journals trimmed, an epoch bump seen per migration and per
            shard added, records parked;
            records/s of each window and their ratio beside the
            reference's gate of 0.5 (not held); (b) phase 6b's four shard
            daemons with a wire ``mirror`` group, one daemon SIGKILLed
            after half of 4 x 65,536 records are routed: nothing lost,
            duplicates counted, the stream's ``lost`` names it; (c) the
            elastic scenario pumped here (``run_elastic``: migrations
            under backpressure, a split, a migration cancelled by its
            source's death, a replay bootstrap from the history tier) at
            4 x 65,536 records, routing on the card and on the CPU, equal
            byte for byte in every delivery, stats, epoch, owners and
            journal acks; (d) two filesystems of 2 journals x 65,536
            under ``Federation``, a durable member detached and resumed,
            one member migrating (exactly once), the other killing a
            shard (at least once), the merged cursor at every journal's
            last index;
7b. proxy   the whole LCAP proxy on the card-routed cluster, on phase 4's
            generator with scratch files (about a fifth of the CREATEs
            unlinked within 32 records) and two training hosts' journals
            from the port's ``ActivityTracker``, every journal with a
            history tier, each part's ``fid_slots`` launches counted from 0
            and equal to its router's chunks, call site by call site: (a)
            ``run_proxy_chain`` over 4 x 65,536 MDT and 2 x 16,384
            training records, fed 1/16 a round: 4 shards whose proxies
            chain ``TypeFilter`` (every type but CL_CLOSE),
            ``CoalesceHeartbeats``, ``CancelCompensating`` and
            ``ReorderByTarget``; robinhood x2, audit, a group per tenant
            (jobid prefixes dd., cp., rsync., tar.) and an ephemeral
            reader; tenant dd under a quota on a step clock, a shard added
            at halfway and 8 slots migrated to it while the quota holds,
            the quota lifted once dd parked there; on the card and, in a
            spawned process at the same time, on the CPU, equal byte for
            byte (the trace by its SHA-256); robinhood's deliveries and each
            module's removed rows = every record once, audit and each
            tenant group = robinhood's records of its types or scope, dd
            parked (on the added shard too) and then served in full,
            records/s beside phase 4's; (b) ``run_replay`` over 4 x 16,384
            MDT records: an ``LcapClusterService`` with the same chain, a
            ``Feeder`` thread, a durable robinhood member and the dd and
            rsync groups over ``connect(addresses)``, and, once half is
            routed and acknowledged, a ``replay=True`` group of tenant cp
            draining its bootstrap, hashed on the shard services' threads,
            while the second half is routed: no (journal, index) twice,
            live exactly its scope above each shard's handoff watermark,
            every replayed row on its serving shard's slots by the plain
            hash, no replay chunk on the distributor's thread;
8. train    starcoder2-3b at full width and depth (30 layers, 4.31 B
            parameters) trained on the card by the port's ``Trainer``
            with fp32 master weights and AdamW (69 GB of state), 2 hosts'
            activity feeding MetricsDB, the checkpoint committer and the
            straggler detector: one warm-up step, 5 timed, one under the
            profiler; finite losses and grad norms, a first loss below
            2 ln(vocab) + 1, the host schedule's lr, MetricsDB rows =
            steps x hosts per type, journals trimmed; then at 2 layers a
            restart probe (checkpoint at step 3, a new trainer resumes
            there with an equal step 4 loss) and one training step on
            the card against the CPU (loss and grad norm within 2e-2);
            neither kernel is launched;
8a-8c.      phase 8's recipe, checks and numbers for the other families
            that fit one card with fp32 AdamW state, at full width and
            depth: 8a ``moe-train`` granite-moe-1b-a400m (24 layers, 32
            experts top-8, 1.33 B parameters; the share of (token, k)
            slots the profiled step drops at its capacity), 8b
            ``ssm-train`` mamba2-780m (48 layers; its card-vs-CPU step
            at 2 x 512 tokens, where the scan crosses a full 256-token
            chunk), 8c ``audio-train`` whisper-small (12 + 12 layers, 8
            clips of 1500 float32 N(0, 1) frames and 448 decoder tokens
            a step; the reference's Trainer feeds no frames, so its
            steps go through ``build_train_step`` directly, with no
            MetricsDB and no restart probe, and its card-vs-CPU step
            takes the frames; its model-FLOP share also with the
            encoder's frames); no kernel launched, by each kernel's
            count;
9. moe      qwen3-moe-30b-a3b at full width and depth (48 layers, 128
            experts top-8, 30.08 B parameters in bf16, seeded random
            weights) through phase 5's serving path: 48 wgmma launches
            per prefill and none of the CUDA-core kernel (counted as in
            phase 5), phase 5's invalidation counts, the share of
            (token, k) slots the prefill drops at the default capacity
            (decode drops none); flash-vs-naive and decode-vs-prefill
            logits (the latter at a capacity where nothing drops) within
            0.12 with one run replaying the other's routes, and free-running
            unless router choices differ between the two runs (counted by
            layer and printed with the free-running difference); one MoE
            layer in float32 on the card against the CPU (routing equal,
            output within 1e-5); no ``fid_slots`` launch;
10. ssm     mamba2-780m at full width and depth (48 layers, 780 M
            parameters) on the same path: no attention launch (0 and 0)
            and no ``fid_slots`` launch;
            decode at P against a P + 1 token prefill within 0.12; one SSD
            layer in float32 on the card against the CPU (output, cache
            and two decode steps within 1e-4);
10a. hybrid jamba-v0.1-52b cut to one period of its layer pattern (8 of
            32 layers: one stage of a four-stage pipeline, one period a
            card; 13,267,656,416 parameters, 26.54 GB of bf16 weights, both
            checked), every width as published: SSD layers at 0-3 and
            5-7, attention (no RoPE) at 4, MoE (16 experts, top-2,
            capacity 320 a row) at the odd layers; phase 9's path, checks
            and numbers with the counts from the layer pattern: 1 wgmma
            launch a prefill (wrapper, and the kernel's own count on the
            card) and none of the CUDA-core kernel, 4 routed layers a
            pass, none dropped at decode, no ``fid_slots`` launch; the
            logits checks held with the routes replayed, and by the
            float32 computation (as phase 11's) where bf16 noise exceeds
            0.12; the first MoE layer (1) and the first SSD layer (0) in
            float32 on the card against the CPU;
11. vlm     pixtral-12b at full width and depth (40 layers, 12.77 B
            parameters in bf16, seeded random weights) through phase 5's
            serving path, the first 256 positions of each prompt being
            float32 normal image-patch embeddings: 40 wgmma launches per
            prefill at head_dim 160 and none of the CUDA-core kernel
            (counted as in phase 5), no ``fid_slots`` launch;
            flash-vs-naive and decode-vs-prefill logits within 0.12, or
            no farther from the float32 logits than the other path (its
            mean |diff| plus 5 %);
12. audio   whisper-small at full width and depth (12 encoder and 12
            decoder layers) serving 4 clips of 1500 float32 normal frame
            embeddings with a 224-token decoder prompt: 24 wgmma launches
            per prefill, 12 of them without a causal mask (by the
            wrapper's arguments), none of the CUDA-core kernel, no
            ``fid_slots`` launch; flash-vs-naive and decode-vs-prefill
            logits within 0.12; one encoder layer and one decoder layer
            with its cross attention in float32 on the card against the
            CPU, within 1e-4;
12a. gemma gemma2-9b at full width and depth (42 layers, 9.01 B
            parameters in bf16; head_dim 224, an instance of the wgmma
            kernel's own; a window of 4096 on its 21 local layers; attention
            and logit softcaps; tied, scaled embeddings over 256,000
            rows) serving 2 prompts of 8192 tokens: 42 wgmma launches per
            prefill, 21 of them with window 4096 (by the wrapper's
            arguments), none of the CUDA-core kernel (counted as in
            phase 5), no ``fid_slots`` launch; flash-vs-naive logits,
            and a decode step at position 8192, which lands in slot 0 of
            each local layer's wrapped 4096-slot ring, against an
            8193-token prefill, within 0.12 or as phase 11 holds them;
12b. qwen   qwen2.5-14b at full width and depth (48 layers, 14.77 B
            parameters in bf16; QKV bias, GQA 40:8) on phase 5's traffic:
            48 wgmma launches per prefill and none of the CUDA-core
            kernel, no ``fid_slots`` launch; the logits checks of 12a;
13. mesh    the sharded path on a one-rank NCCL process group (a
            ``FileStore`` in a temporary directory) and
            ``make_elastic_mesh(1)``'s (1, 1) ``DeviceMesh``: (a) phase 5's
            granite-8b weights placed by ``specs.prefill_cell``'s
            placements, phase 5's serving run under ``use_rules`` (36
            wgmma launches a prefill through ``local_map``, by the
            wrapper's counters and the kernel's own count on the card, none
            of the CUDA-core kernel), prefill logits within 1e-3 of phase
            5's, prefill and decode times beside phase 5's; (b) phase 8's
            starcoder2-3b ``Trainer`` on the mesh (parameters and moments
            placed by their logical axes, each step under the rules): a
            warm-up step and 3 timed, losses within 1e-4 of phase 8's
            first four, step ms, idle share (one more step profiled) and
            peak memory beside phase 8's; (c) ``compressed_psum`` over the
            one rank on the gradients of one more step, leaf by leaf:
            every mean within half a quantization step of the gradient,
            the error buffer exactly what was lost; the payload's bytes;
14. roofline the cost models (no kernel launched): (a) the port's dry
            run (``launch.dryrun.run_cell``) on a fake 16x16 mesh of 256
            ranks on this host, meta tensors only: granite-8b's
            decode_32k and prefill_32k traced whole at full width and
            depth, with their probes, whose FLOP prediction must hold
            within 1 % of the whole trace, and train_4k by its probes
            alone (its 16 microbatches of 36 layers take minutes to
            trace whole); then the prefill_32k of qwen3-moe-30b-a3b,
            mamba2-780m, pixtral-12b and whisper-small, and the
            decode_32k of mamba2-780m and jamba-v0.1-52b (the SSD
            decode step on heads sharded 16 ways); a prefill traced
            whole in the probes' coarse attention grid (the same FLOPs
            and collectives, fewer bytes), a decode in the step's own;
            the cells traced by ``DRYRUN_WORKERS`` processes at once;
            every cell traced and ``ok``; per-device FLOPs, bytes,
            collective bytes, the rank's peak memory beside the card's
            and the dominant roofline term; (b) the one-card bound of
            every measured prefill and decode step of phases 5, 9-12,
            10a, 12a and 12b (the medians of their warm calls, each at
            the depth it was served) and of phases
            8-8c's training steps: model FLOPs (6 N_active a
            token to train, 2 N_active to serve) and
            ``estimate_hbm_bytes(n_dev=1)`` at the phase's own shape
            over the data sheet's 989 TFLOP/s and 3.35 TB/s, which must
            not exceed the measured time, and the model-FLOP share of
            each; (c) the card's own rates: a bf16 8192^3 product and a
            4 GiB copy timed with CUDA events, neither above 105 % of
            the data sheet.

Then a JSON line of serve numbers, one of wire numbers, one of activity
numbers, one of elastic numbers, one of proxy numbers, one of training
numbers, one of MoE
serving numbers, one of SSD serving numbers, one of hybrid serving
numbers, one of VLM serving
numbers, one of audio serving numbers, one of gemma2 and one of qwen2.5
serving numbers, one of mesh numbers, one of roofline numbers, one of phases 8a-8c's training numbers
(``train_families``), one of kernels,
the card's ``nvidia-smi`` line, and the result line ``{"ok": true,
"device": {...}}`` last.  Imports nothing of
JAX, of the reference package or of msgpack.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import statistics
import subprocess
import sys
import threading
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
#: divisors the routing kernel is held at: 3 makes its reciprocal
#: modulus correct the quotient most often, 2^31 - 1 is the largest
SLOTS_SWEEP = (1, 3, 64, 65535, 65536, 1000003, (1 << 31) - 1)
#: sizes the routing kernel is timed at: a journal read, one routing
#: chunk (``cluster.CHUNK_ROWS``), and 2^20 rows
SLOT_SIZES = (1024, 1 << 16, 1 << 20)
#: phase 3's routing round: journal reads of BATCH records hashed two ways
ROUND_READS = 64
#: the int64 word of a header row that holds tseq (bytes 32..39)
TFID_WORD = 4
#: phase 6: records per MDT journal over the wire, and its time limits
WIRE_RECORDS_PER_MDT = 65_536
WIRE_DEADLINE_S = 300.0
DAEMON_START_S = 120.0
#: phase 7: records per MDT journal through the consumers (the mirror's
#: reduction is a per-record Python loop, as the reference's), its time
#: limit, and the aggregator's pane
ACTIVITY_RECORDS_PER_MDT = 65_536
ACTIVITY_DEADLINE_S = 400.0
ACTIVITY_WINDOW_NS = 1_000_000
#: phase 7a: records per MDT journal in each part (a window of (a)),
#: records appended to a journal at a time by (a)'s feeder, the share of
#: (a)'s churn window fed before its first migration (an eighth), the
#: parking bound of (c), its time limit, and the reference's own churn
#: gate (``benchmarks/bench_elastic.py``), printed beside the ratio, not
#: held
ELASTIC_RECORDS_PER_MDT = 65_536
ELASTIC_FEED_CHUNK = 256
ELASTIC_FIRST_MIGRATION_AT = 8
ELASTIC_PARK_CAP = 16_384
ELASTIC_DEADLINE_S = 300.0
CHURN_GATE = 0.5
# phase 7b: the whole proxy (stream modules, tenants, a threaded replay)
PROXY_RECORDS_PER_MDT = 65_536
PROXY_TRAIN_HOSTS = 2
PROXY_TRAIN_RECORDS = 16_384
PROXY_TRAIN_RUN = 7
SCRATCH_SHARE = 0.2
SCRATCH_WINDOW = 32
CKPT_EVERY = 64
CKPT_SHARDS = 8
CKPT_REWRITES = 2
TENANTS = ("dd", "cp", "rsync", "tar")
# dd's quota, per shard: records a clock second (one round) and burst,
# the records per MDT journal over this: about 2/3 of dd's share of a
# round on a shard, so dd parks and the added shard's first share parks
# it there
QUOTA_DIVISOR = 112
PROXY_FEED_ROUNDS = 16
PROXY_MOVED_SLOTS = 8
PROXY_LIFT_WAIT = 8
PROXY_MAX_ROUNDS = 10_000
PROXY_DEADLINE_S = 120.0
# (b) streams the first records of each MDT journal: the threaded wire
# path (three consumers and a replay on one interpreter) runs far slower
# than the threadless one, and the phase must stay within 45 s
PROXY_REPLAY_RECORDS_PER_MDT = 16_384
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
#: the attention kernel's shape on phase 9's path: qwen3-moe-30b-a3b,
#: head_dim 64, GQA 32:4 (bf16, causal)
FLASH_MOE = ((4, 2048, 2048, 32, 4, 64), "bfloat16", True, 0, 0.0)
#: bf16 cases beyond the reference's: the decode check's 2049-token
#: prefill, gemma2-9b's head_dim with its window and softcap, rows with
#: nothing visible (q >= 20), and phase 9's shape
FLASH_EXTRA = [((4, 2049, 2049, 32, 8, 128), "bfloat16", True, 0, 0.0),
               ((1, 96, 96, 4, 2, 224), "bfloat16", True, 16, 50.0),
               ((1, 64, 16, 2, 1, 32), "bfloat16", True, 4, 0.0),
               FLASH_MOE]
#: the attention kernel's shapes on phases 11 and 12: pixtral-12b's
#: prefill (head_dim 160, GQA 32:8, causal), whisper-small's encoder (no
#: causal mask, 1500 frames: 23 whole kv tiles of 64 and one of 28) and
#: its decoder's 224-token prefill; and small non-causal cases with
#: Sq != Sk and Sk not a multiple of 64
FLASH_VLM = ((4, 2048, 2048, 32, 8, 160), "bfloat16", True, 0, 0.0)
FLASH_ENC = ((4, 1500, 1500, 12, 12, 64), "bfloat16", False, 0, 0.0)
FLASH_DEC = ((4, 224, 224, 12, 12, 64), "bfloat16", True, 0, 0.0)
FLASH_ENCDEC = [FLASH_VLM, FLASH_ENC, FLASH_DEC,
                ((2, 100, 1500, 4, 4, 64), "bfloat16", False, 0, 0.0),
                ((1, 64, 130, 4, 2, 160), "bfloat16", False, 0, 0.0)]
#: the attention kernel's shapes on phases 12a and 12b: gemma2-9b's
#: prefill at head_dim 224 (an instance of the wgmma kernel), GQA 16:8,
#: its softcap of 50 on every layer, on its local layers (window 4096) and
#: its global ones; qwen2.5-14b's (GQA 40:8, head_dim 128)
FLASH_GEMMA = ((2, 8192, 8192, 16, 8, 224), "bfloat16", True, 4096, 50.0)
FLASH_GEMMA_GLOBAL = ((2, 8192, 8192, 16, 8, 224), "bfloat16", True, 0,
                      50.0)
#: gemma2-9b's global layer without its softcap: timed beside the capped
#: call in phase 3, so the cap's cost in the wgmma kernel is a measured
#: number
FLASH_GEMMA_NOCAP = ((2, 8192, 8192, 16, 8, 224), "bfloat16", True, 0, 0.0)
FLASH_QWEN = ((4, 2048, 2048, 40, 8, 128), "bfloat16", True, 0, 0.0)
FLASH_DENSE = [FLASH_GEMMA, FLASH_GEMMA_GLOBAL, FLASH_QWEN]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: the CUDA-core kernel's tile edges, in float32 and bf16: head_dims 1,
#: 4, 36, 100, 200 and 256 (every instance, both staging routes), lengths
#: 1, 63, 65, 129 and 1000 (under, at and past its 64-row kv and 64- or
#: 128-row q tiles), Sq != Sk causal and not, GQA 8:1, windows of 100 and
#: 200 that end inside a kv tile, the softcap (q times CAP_Q_SCALE), and
#: rows with nothing visible (window 5 over 65 keys: q >= 69)
FLASH_SIMT_GEOMETRY = [
    ((1, 1, 1, 2, 1, 1), True, 0, 0.0),
    ((2, 63, 65, 8, 1, 4), True, 0, 0.0),
    ((1, 65, 63, 4, 2, 36), False, 0, 0.0),
    ((1, 129, 1000, 8, 1, 100), False, 0, 0.0),
    ((1, 1000, 129, 4, 1, 200), True, 0, 0.0),
    ((1, 1000, 1000, 2, 1, 256), True, 100, 0.0),
    ((1, 129, 129, 4, 4, 100), True, 0, 30.0),
    ((1, 129, 65, 4, 1, 36), True, 5, 0.0),
    ((1, 1000, 1000, 8, 1, 64), True, 200, 50.0),
    ((2, 65, 1000, 4, 2, 1), False, 0, 0.0)]
FLASH_SIMT_EDGE = [(shape, dtype, causal, window, cap)
                   for shape, causal, window, cap in FLASH_SIMT_GEOMETRY
                   for dtype in ("float32", "bfloat16")]
#: the wgmma kernel's tile edges, in bf16 (it takes nothing else): head
#: dims 16, 48, 64, 96, 128, 144, 160, 192, 208, 224 and 256 (every
#: instance, at its own width and padded up to it), lengths 1, 63, 65,
#: 127, 129, 191, 193, 257 and 1000 (under, at and past its 128- and
#: 192-row q tiles and its 64- to 128-row kv tiles), Sq != Sk causal and
#: not, GQA 8:1, windows of
#: 100, 200 and 300 that end inside a kv tile, the softcap (q times
#: CAP_Q_SCALE), and rows with nothing visible (window 5 over 65 keys:
#: q >= 69; their blocks have no kv tile at all)
FLASH_SM90_GEOMETRY = [
    ((1, 1, 1, 2, 1, 16), True, 0, 0.0),
    ((2, 63, 65, 8, 1, 48), True, 0, 0.0),
    ((1, 65, 63, 4, 2, 64), False, 0, 0.0),
    ((1, 127, 129, 4, 1, 96), False, 0, 0.0),
    ((1, 129, 1000, 8, 1, 128), False, 0, 0.0),
    ((1, 1000, 129, 4, 1, 144), True, 0, 0.0),
    ((1, 193, 191, 4, 2, 128), True, 0, 0.0),
    ((1, 257, 257, 4, 2, 160), True, 100, 0.0),
    ((1, 1000, 1000, 2, 1, 192), True, 200, 50.0),
    ((1, 129, 65, 4, 1, 208), True, 5, 0.0),
    ((1, 1000, 1000, 2, 1, 224), True, 300, 50.0),
    ((2, 257, 1000, 4, 2, 256), False, 0, 30.0)]
FLASH_SM90_EDGE = [(shape, "bfloat16", causal, window, cap)
                   for shape, causal, window, cap in FLASH_SM90_GEOMETRY]
#: bf16 at a head_dim that is not a multiple of 16: through the wrapper,
#: kernel_for sends it to the CUDA-core kernel
FLASH_BF16_ODD = ((2, 129, 129, 4, 2, 72), "bfloat16", True, 0, 0.0)
#: q's scale in the cases with a softcap: scores of N(0, 1) inputs stay
#: near 1, where a cap of 20 or 50 moves them by under 1e-2, and a
#: kernel without the cap would pass; at 24 they reach tens, the cap
#: changes them and the softmax is peaked (outputs O(1))
CAP_Q_SCALE = 24.0
#: the serving path: granite-8b, B prompts of P tokens, G generated
SERVE_ARCH = "granite-8b"
SERVE_B, SERVE_P, SERVE_G, SERVE_REPLICAS = 4, 2048, 16, 2
#: the attention kernel's shape on that path (bf16, causal)
FLASH_MAIN = ((SERVE_B, SERVE_P, SERVE_P, 32, 8, 128), "bfloat16", True, 0,
              0.0)
#: the same shape in float32: the CUDA-core kernel's own regime (the
#: wgmma kernel takes bf16 only), checked and timed in phase 3
FLASH_MAIN_F32 = (FLASH_MAIN[0], "float32", True, 0, 0.0)
#: the CUDA-core kernel's other instances in float32: qwen3-moe's shape
#: (head_dim 64) and pixtral-12b's (head_dim 160, the 256-wide instance)
FLASH_MOE_F32 = (FLASH_MOE[0], "float32", True, 0, 0.0)
FLASH_VLM_F32 = (FLASH_VLM[0], "float32", True, 0, 0.0)
FLASH_F32_TIMED = {"simt_float32": FLASH_MAIN_F32,
                   "simt_float32_moe": FLASH_MOE_F32,
                   "simt_float32_vlm": FLASH_VLM_F32}
#: calls of the launcher timed after each serving phase's first: the
#: phase's prefill ms and decode ms a step are their medians (phase 14's
#: one-card shares read them), the first call's numbers kept beside them
WARM_CALLS = 5
#: bound on |logits| differences in the serve checks: the reference's own
#: prefill/decode tolerance (tests/test_models.py: 0.12), held as a plain
#: absolute bound
LOGIT_ATOL = 0.12
#: decode steps profiled on their own after the checks
DECODE_PROFILE_STEPS = 5
#: phase 8: starcoder2-3b trained at full width and depth with fp32
#: master weights and AdamW; the restart probe and the card-vs-CPU step
#: at full width and TRAIN_PROBE_LAYERS layers
TRAIN_ARCH = "starcoder2-3b"
TRAIN_HOSTS, TRAIN_BATCH, TRAIN_SEQ = 2, 8, 512
TRAIN_HP = dict(n_micro=2, remat=True, remat_policy="none",
                attn_impl="naive")
TRAIN_WARMUP_STEPS, TRAIN_TIMED_STEPS = 1, 5
TRAIN_PROBE_LAYERS = 2
#: the card-vs-CPU step's batch: the CPU takes its full-width step in
#: seconds at 2 x 128 tokens (minutes at the phase's 8 x 512)
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 2, 128
TRAIN_TOL = 2e-2
#: fp32 parameters, gradients, m and v
TRAIN_STATE_BYTES_PER_PARAM = 16
#: phases 8a-8c: the MoE, SSD and encoder-decoder families that fit one
#: card with that state, trained on phase 8's recipe at full width and
#: depth: (tag, arch, keywords of ``train_run``).  whisper-small takes
#: TRAIN_BATCH clips of AUDIO_TRAIN_SEQ decoder tokens (its decoder's
#: context) and its encoder's n_frames frames; mamba2-780m's card-vs-CPU
#: step runs at TRAIN_SEQ tokens, where its scan crosses a full chunk of
#: 256 (at TRAIN_CPU_SEQ the chunk would be 128)
AUDIO_TRAIN_SEQ = 448
TRAIN_FAMILIES = (
    ("moe-train", "granite-moe-1b-a400m", {}),
    ("ssm-train", "mamba2-780m", {"cpu_batch": 2, "cpu_seq": TRAIN_SEQ}),
    ("audio-train", "whisper-small", {"seq": AUDIO_TRAIN_SEQ}))
#: the training phases' tags, whose steps phase 14 bounds
TRAIN_TAGS = ("train",) + tuple(tag for tag, _a, _kw in TRAIN_FAMILIES)
#: phases 9 and 10: the MoE and SSD families served at full width and
#: depth on phase 5's path (SERVE_B prompts of SERVE_P tokens, SERVE_G
#: generated, SERVE_REPLICAS replicas)
MOE_ARCH = "qwen3-moe-30b-a3b"
SSM_ARCH = "mamba2-780m"
#: one layer of each on the card against the CPU in float32: its input's
#: batch and tokens, and the bounds (rtol = atol)
LAYER_CHECK_B, LAYER_CHECK_S = 2, 256
MOE_LAYER_TOL = 1e-5
SSD_LAYER_TOL = 1e-4
#: phases 11 and 12: the VLM on phase 5's traffic, and the
#: encoder-decoder: SERVE_B clips of n_frames frames with an AUDIO_P-token
#: decoder prompt (whisper's decoder sees 448 positions, the first half
#: of them the previous window's text), SERVE_G generated; one encoder
#: and one decoder layer of it on the card against the CPU in float32
VLM_ARCH = "pixtral-12b"
AUDIO_ARCH = "whisper-small"
AUDIO_P = 224
ENCDEC_LAYER_TOL = 1e-4
#: phases 12a and 12b: the two dense models not served before, at full
#: width and depth.  gemma2-9b takes GEMMA_B prompts of GEMMA_P tokens:
#: 8192 is its global attention span (arXiv:2408.00118, Table 1), so the
#: window of 4096 on its local layers masks half the keys of the last
#: queries, and decode reads their 4096-slot rings after they wrapped;
#: qwen2.5-14b takes phase 5's traffic
GEMMA_ARCH, GEMMA_B, GEMMA_P = "gemma2-9b", 2, 8192
QWEN_ARCH = "qwen2.5-14b"
#: phase 10a: the hybrid family on phase 9's path.  jamba-v0.1-52b's
#: 32 layers (102.9 GB in bf16) fit no card; the deployment served is a
#: four-stage pipeline of four cards, one period of 8 layers a card, and
#: this card is one stage: n_layers 32 -> 8 (hybrid_period), every width
#: as published, so one attention layer, seven SSD layers and four MoE
#: layers (16 experts, top-2, capacity factor 1.25) in the published
#: ratio.  It holds the first stage's embedding and the last stage's
#: unembedding too, and all 16 experts of each MoE layer.
HYBRID_ARCH = "jamba-v0.1-52b"
HYBRID_CUT = "one period; four-stage pipeline"
HYBRID_PARAMS = 13_267_656_416
HYBRID_WEIGHT_BYTES = 26_535_687_296
#: phase 3: the decode kernel at each served family's decode shape:
#: (tag, arch, sequences, prompt tokens, generated tokens, layer).  The
#: cache holds prompt + generated slots (a ring of the window on a local
#: layer), timed at the last position it holds and checked at per-sequence
#: positions up to 127 below it.  First granite-8b's benchmark cell (32
#: sessions of a 4096-token prompt and 128 generated), then the serving
#: phases' traffic (the jamba stage's one attention layer has granite-8b's
#: shape), and starcoder2-3b's grouping of 12 (two blocks of 6)
DECODE_FAMILIES = (
    ("cell", SERVE_ARCH, 32, 4096, 128, "global"),
    ("serve", SERVE_ARCH, SERVE_B, SERVE_P, SERVE_G, "global"),
    ("moe", MOE_ARCH, SERVE_B, SERVE_P, SERVE_G, "global"),
    ("vlm", VLM_ARCH, SERVE_B, SERVE_P, SERVE_G, "global"),
    ("audio", AUDIO_ARCH, SERVE_B, AUDIO_P, SERVE_G, "global"),
    ("gemma_local", GEMMA_ARCH, GEMMA_B, GEMMA_P, SERVE_G, "local"),
    ("gemma_global", GEMMA_ARCH, GEMMA_B, GEMMA_P, SERVE_G, "global"),
    ("qwen", QWEN_ARCH, SERVE_B, SERVE_P, SERVE_G, "global"),
    ("starcoder2", TRAIN_ARCH, SERVE_B, SERVE_P, SERVE_G, "global"))
#: the split counts timed at the cell's traffic, and the families timed
#: there (granite-8b's 4 heads a block, qwen3-moe's 8)
DECODE_SPLITS = (1, 2, 3, 4, 5, 6, 8, 12)
DECODE_SWEEP = (("cell", SERVE_ARCH), ("moe_cell", MOE_ARCH))
#: the card tests' tolerances of the decode kernel against its plain
#: version: the same float32 sums in another order; in bf16 both round
#: the same float32 result once
DECODE_TOL = {"float32": dict(rtol=5e-5, atol=5e-5),
              "bfloat16": dict(rtol=2 ** -7, atol=1e-5)}
#: the serving phases' tags, whose records phase 14 bounds
SERVE_TAGS = ("serve", "moe", "ssm", "hybrid", "vlm", "audio", "gemma",
              "qwen")
#: phases 11 and 12: where two bf16 paths' logits differ by more than
#: LOGIT_ATOL, how much farther from the float32 computation than the
#: other path the path under test may be, in mean |diff| (relative)
NOISE_MARGIN = 0.05
#: phase 13: the sharded path on one rank runs phase 5's and phase 8's
#: operations, so its logits and losses must equal theirs to these bounds
MESH_LOGIT_TOL = 1e-3
MESH_LOSS_TOL = 1e-4
MESH_TIMED_STEPS = 3
#: half a quantization step, and float32 rounding room
COMPRESS_HALF_STEP = 0.5 + 2 ** -15
#: phase 14 (a): the dry-run cells on the fake 16x16 mesh, every one
#: traced: (arch, shape, traced whole, with probes, whole in the probes'
#: coarse attention grid).  A prefill is traced whole in the coarse grid
#: (8 x 8 blocks a layer; the step's own 64 x 32 would take granite-8b's
#: some 4 minutes of host): the same FLOPs and collectives, fewer
#: bytes.  granite-8b's train_4k by its probes alone (16 microbatches of
#: 36 layers take some 9 minutes to trace whole).  The decode cells are
#: traced whole in the step's grid; mamba2's and jamba's run the SSD
#: decode on heads sharded 16 ways.
DRYRUN_CELLS = (("granite-8b", "decode_32k", True, True, False),
                ("granite-8b", "prefill_32k", True, True, True),
                ("granite-8b", "train_4k", False, True, True),
                (MOE_ARCH, "prefill_32k", True, False, True),
                (SSM_ARCH, "prefill_32k", True, False, True),
                (VLM_ARCH, "prefill_32k", True, False, True),
                (AUDIO_ARCH, "prefill_32k", True, False, True),
                (SSM_ARCH, "decode_32k", True, False, False),
                ("jamba-v0.1-52b", "decode_32k", True, False, False))
#: processes tracing (a)'s cells at once, in the order above (a trace is
#: one host thread on meta tensors; the card's host has 8 cores; of the
#: some 140 s the cells take one after another, mamba2-780m's prefill
#: takes 53)
DRYRUN_WORKERS = 4
#: the probe model's FLOPs against the whole trace (relative)
DRYRUN_PROBE_TOL = 0.01
#: (c): the bf16 product's side, the copy's bytes, and how far above the
#: data sheet a measured rate may read
RATE_MATMUL_N = 8192
RATE_COPY_BYTES = 4 << 30
RATE_CEILING = 1.05
DEVICE = torch.device("cuda")
#: what phases 5 and 8 keep for phase 13 to compare with
HELD: dict = {}


class SmokeError(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def spawn_pool(workers: int):
    """A pool of ``workers`` fresh processes, spawned (this process holds
    CUDA, which a forked child cannot use); its ``with`` block waits for
    them and stops them."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    return ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_median_ms(fn, runs: int = 50) -> float:
    """Median device time of ``fn()`` over ``runs`` launches, each
    between two CUDA events (after one warm-up call)."""
    return statistics.median(cuda_times_ms(fn, runs))


def cuda_times_ms(fn, runs: int) -> list:
    """Device time of ``fn()`` at each of ``runs`` launches, between two
    CUDA events (after one warm-up call)."""
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
    return times


def back_to_back_ms(fn, runs: int) -> float:
    """Mean device time of ``fn()`` over ``runs`` launches enqueued back
    to back between two CUDA events (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def kernel_count(prof, name: str) -> int:
    """Launches a CUDA-only profile saw of kernels whose name contains
    ``name``."""
    return sum(evt.count for evt in prof.key_averages() if name in evt.key)


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


#: opcodes ``sass_counts`` counts one by one
SASS_OPS = ("FFMA", "LDS", "STS", "SHFL", "MUFU", "LDGSTS", "STL", "LDL",
            "HGMMA")


def sass_counts(lib) -> dict:
    """SASS instructions of each function in a built library, by
    ``cuobjdump -sass`` (NOPs left out): {function: {"instructions",
    "loads" (LDG), "calls" (CALL), and by opcode "ffma", "lds" (shared
    loads), "sts", "shfl", "mufu", "ldgsts" (cp.async), "stl" and "ldl"
    (spills to and from local memory), "hgmma" (wgmma)}}."""
    import re
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()}")
    counts, name = {}, None
    for line in out.stdout.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            counts[name] = {"instructions": 0, "loads": 0, "calls": 0,
                            "registers_named": 0,
                            **{op.lower(): 0 for op in SASS_OPS}}
            continue
        ins = re.match(
            r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)", line)
        if name is None or not ins or ins.group(1).startswith("NOP"):
            continue
        op = ins.group(1)
        counts[name]["instructions"] += 1
        counts[name]["loads"] += op.startswith("LDG")
        counts[name]["calls"] += op.startswith("CALL")
        base = op.split(".")[0]
        if base in SASS_OPS:
            counts[name][base.lower()] += 1
        # the instruction's text: between its address and its encoding
        text = line.split("*/", 1)[1].split("/*", 1)[0]
        for reg in re.findall(r"\bR(\d+)\b", text):
            counts[name]["registers_named"] = max(
                counts[name]["registers_named"], int(reg) + 1)
    return counts


def resource_usage(lib) -> dict:
    """Each function's resources in a built library, by ``cuobjdump
    --dump-resource-usage``: {function: {"registers" (a thread's at
    launch), "stack_bytes" (its stack frame: spills land there),
    "local_bytes"}}."""
    import re
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "--dump-resource-usage", str(lib)],
                         capture_output=True, text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()}")
    usage, name = {}, None
    for line in out.stdout.splitlines():
        head = re.match(r"\s*Function (\S+):", line)
        if head:
            name = head.group(1)
            continue
        regs = re.search(r"REG:(\d+) STACK:(\d+).*LOCAL:(\d+)", line)
        if name is not None and regs:
            usage[name] = {"registers": int(regs.group(1)),
                           "stack_bytes": int(regs.group(2)),
                           "local_bytes": int(regs.group(3))}
            name = None
    return usage


def by_instance(counts: dict) -> dict:
    """``counts`` keyed by each attention instance's width (the template
    argument in its mangled name: ``...kernelILi160E...`` -> "160")."""
    import re
    out = {}
    for name, c in counts.items():
        width = re.search(r"kernelI\w*?Li(\d+)E", name)
        out[width.group(1) if width else name] = c
    return out


def round_trip(seed: int) -> dict:
    """One routing round on the card, hashed two ways on the same
    ``SlotRouter``: ROUND_READS journal reads of BATCH records through
    one ``slots_many`` (one chunk, one launch), and through ROUND_READS
    ``slots`` calls (one launch each, the migration path).  Both must
    equal the plain version; host seconds of each way, 21 times in
    turns, as ns a row (medians)."""
    from repro_torch.core.cluster import SlotRouter
    from repro_torch.core.llog import from_packed
    from repro_torch.kernels import stream_ops
    buf, off, ln, _types = make_journal_arrays(0, ROUND_READS * BATCH, seed)
    log = from_packed("mdt0", buf, off, ln, first_index=1)
    batches = [log.read(1 + k * BATCH, BATCH) for k in range(ROUND_READS)]
    want = [stream_ops.fid_slots_rows_reference(
        torch.from_numpy(b.header_rows().copy()), N_SLOTS).numpy()
        for b in batches]
    router = SlotRouter("cuda")
    ways = {"slots_many": lambda: router.slots_many(batches, N_SLOTS),
            "slots": lambda: [router.slots(b, N_SLOTS) for b in batches]}
    for way, fn in ways.items():
        chunks, launches = router.chunks, stream_ops.launches
        got = fn()
        check(all(np.array_equal(g, w) for g, w in zip(got, want)),
              f"routing round through {way} differs from the plain version")
        expect = 1 if way == "slots_many" else ROUND_READS
        check(router.chunks - chunks == stream_ops.launches - launches
              == expect, f"routing round through {way}: "
              f"{stream_ops.launches - launches} launches, not {expect}")
    seconds = {way: [] for way in ways}
    for rep in range(21):
        order = list(ways) if rep % 2 == 0 else list(ways)[::-1]
        for way in order:
            t = time.perf_counter()
            ways[way]()
            seconds[way].append(time.perf_counter() - t)
    rows = ROUND_READS * BATCH
    return {f"{way}_ns_per_row": statistics.median(v) / rows * 1e9
            for way, v in seconds.items()}


def kernel_phase(seed: int) -> dict:
    from repro_torch.kernels import _build, stream_ops
    dev = torch.device("cuda")
    worst = 0
    big = fid_rows(1 << 20, seed)
    # the last rows of the table hold the four edge FIDs
    cases = [(big, "2^20 + edge FIDs"),
             (big[-BATCH:], f"N = {BATCH} with the edge FIDs"),
             (big[-(1 << 16):], "N = 2^16 with the edge FIDs"),
             (big[:0], "N = 0")]
    for rows, label in cases:
        on_card = rows.to(dev)
        for n_slots in SLOTS_SWEEP:
            before = stream_ops.launches
            got = stream_ops.fid_slots_rows(on_card, n_slots)
            into = torch.full((len(rows),), -1, dtype=torch.int64,
                              device=dev)
            check(stream_ops.fid_slots_rows(on_card, n_slots, out=into)
                  is into, f"fid_slots did not return its out at {label}")
            torch.cuda.synchronize()
            want = stream_ops.fid_slots_rows_reference(rows, n_slots)
            check(stream_ops.launches
                  == before + (2 if len(rows) else 0),
                  f"fid_slots launch count wrong at {label}")
            check(got.dtype == torch.int64 and got.shape == want.shape,
                  f"fid_slots shape/dtype wrong at {label}")
            for what in (got, into):
                diff = (what.cpu() - want).abs()
                err = int(diff.max()) if diff.numel() else 0
                worst = max(worst, err)
                check(err == 0, f"fid_slots differs from its plain version "
                      f"at {label}, n_slots={n_slots}: max |err| {err}")
        log(f"kernels: fid_slots bit-exact vs plain version ({label}, "
            f"n_slots in {SLOTS_SWEEP}, alone and into out)")
    lib = _build.library_path(stream_ops.SOURCE)
    sass = sass_counts(lib)
    log(f"kernels: fid_slots SASS instructions by cuobjdump of {lib.name} "
        f"(NOPs left out): {json.dumps(sass)}")
    # the floor under any launch: one tiny PyTorch kernel
    one = torch.zeros(1, device=dev)
    launch_ms = cuda_median_ms(lambda: one.add_(1))
    log(f"kernels: one-element PyTorch kernel {launch_ms:.6f} ms "
        "(launch floor)")
    sizes = {}
    for n in SLOT_SIZES:
        rows = big[:n].to(dev)
        into = torch.empty(n, dtype=torch.int64, device=dev)
        ms = cuda_median_ms(lambda: stream_ops.fid_slots_rows(rows, N_SLOTS))
        out_ms = cuda_median_ms(
            lambda: stream_ops.fid_slots_rows(rows, N_SLOTS, out=into))
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
                stream_ops.fid_slots_rows(rows, N_SLOTS, out=into)
            torch.cuda.synchronize()
        device_ms = device_busy_ms(prof) / 20
        # what the rows' layout lets the card do: the kernel launched back
        # to back, against PyTorch copies of one 8-byte word of each
        # 64-byte row (less than the kernel must read) and of whole rows
        words = rows.view(torch.int64)[:, TFID_WORD]
        word_out = torch.empty(n, dtype=torch.int64, device=dev)
        whole = torch.empty_like(rows)
        access = {
            "kernel_ms": back_to_back_ms(
                lambda: stream_ops.fid_slots_rows(rows, N_SLOTS, out=into),
                200),
            "copy_word_of_row_ms": back_to_back_ms(
                lambda: word_out.copy_(words), 200),
            "copy_whole_row_ms": back_to_back_ms(
                lambda: whole.copy_(rows), 200)}
        sizes[n] = {"ms": ms, "out_ms": out_ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "bound_with_launch_ms": floor_ms,
                    "bound_with_launch_by": floor_by, "device_ms": device_ms,
                    "back_to_back": access}
        log(f"kernels: fid_slots N={n} n_slots={N_SLOTS}: kernel {ms:.6f} ms "
            f"(median of 50, CUDA events around each wrapper call; "
            f"{out_ms:.6f} ms into a given out; {device_ms:.6f} ms device "
            f"time by torch.profiler), plain version {plain_ms:.6f} ms; "
            f"bound {floor_ms:.6f} ms ({floor_by}): bytes and INT32 work "
            f"alone {bound_ms:.6f} ms ({bound_by}, {n * FID_SLOT_BYTES} B), "
            f"launch floor {launch_ms:.6f} ms; device time at "
            f"{100 * bound_ms / device_ms:.1f} % of the bound")
        log(f"kernels: fid_slots N={n}, 200 launches back to back: kernel "
            f"{access['kernel_ms']:.6f} ms, a PyTorch copy of one 8-byte "
            f"word of each row {access['copy_word_of_row_ms']:.6f} ms, of "
            f"whole rows {access['copy_whole_row_ms']:.6f} ms (mean of 200 "
            "between CUDA events)")
    trip = round_trip(seed)
    log(f"kernels: a routing round of {ROUND_READS} reads x {BATCH} rows on "
        f"the card: one slots_many (1 launch) "
        f"{trip['slots_many_ns_per_row']:.3f} ns a row, {ROUND_READS} slots "
        f"calls ({ROUND_READS} launches) {trip['slots_ns_per_row']:.3f} ns "
        f"a row (host clock, medians of 21 in turns)")
    return {"max_abs_err": worst, "sizes": sizes, "launch_ms": launch_ms,
            "sass": sass, "round_trip": trip}


# --------------------------------------------------------------- phase 4
def make_journal_arrays(m: int, n: int, seed: int, scratch: bool = False):
    """MDT ``m``'s journal as packed records (buffer, offsets, lengths,
    types), built in bulk: the operation mix, a ``procname.uid`` jobid
    from 64 jobs on every record, target FIDs on sequence
    ``0x200000400 + m`` with dense oids in 1..65536 (reused, so targets
    have cr_prev chains), and a source FID pair + name for renames.
    With ``scratch``, temporary files: about ``SCRATCH_SHARE`` of the
    CREATEs get an UNLINK of the same target within the next
    ``SCRATCH_WINDOW`` records (the paper's creat/unlink case), each in
    place of a record that is no rename and no such CREATE, drawn from a
    generator of their own (the other draws are those without it)."""
    from repro_torch.core import records as T
    rng = np.random.default_rng([seed, m])
    codes = np.array([getattr(T, name) for name, _ in MIX], dtype=np.uint16)
    weights = np.array([w for _, w in MIX], dtype=np.float64)
    types = codes[rng.choice(len(codes), n, p=weights / weights.sum())]
    index = np.arange(1, n + 1, dtype=np.uint64)
    oid = rng.integers(1, 65537, n).astype(np.uint32)
    job = rng.integers(0, 64, n)
    rename = types == T.CL_RENAME
    if scratch:
        srng = np.random.default_rng([seed, m, 1])
        made = np.flatnonzero(types == T.CL_CREATE)
        made = made[srng.random(len(made)) < SCRATCH_SHARE]
        gone = made + srng.integers(1, SCRATCH_WINDOW + 1, len(made))
        keep = gone < n
        made, gone = made[keep], gone[keep]
        keep = ~rename[gone] & ~np.isin(gone, made)
        gone, first = np.unique(gone[keep], return_index=True)
        made = made[keep][first]
        types[gone] = T.CL_UNLINK
        oid[gone] = oid[made]
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


def subscribe_main_path(session) -> list:
    """The main path's consumers on ``session`` (in process or over the
    wire): robinhood x2, audit x2 (its types, the jobid projection) and
    an ephemeral reader, as (group, member, stream)."""
    from repro_torch.core import records as T
    from repro_torch.core.proxy import EPHEMERAL
    from repro_torch.core.session import Subscription
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
    return streams


def timed_routing(cluster) -> list:
    """Make ``cluster`` add the host seconds of its routing calls (header
    rows to the card, kernel, slots back), of one read or of a round's
    reads, to the returned one-element list."""
    routing = [0.0]

    def timed(route):
        def call(batches):
            t = time.perf_counter()
            out = route(batches)
            routing[0] += time.perf_counter() - t
            return out
        return call

    cluster.batch_slots = timed(cluster.batch_slots)
    cluster.batch_slots_many = timed(cluster.batch_slots_many)
    return routing


def run_pipeline(journals: dict, device: str, n_slots: int = N_SLOTS,
                 batch_size: int = BATCH):
    """Drive the port's main path: cluster, subscriptions (all before
    the first pump), pump + fetch + commit until the journals drain.
    Returns (cluster, logs, deliveries, seconds, routing_seconds);
    deliveries are (group, member, shard, pid, batch), routing_seconds
    the host time spent in the cluster's routing calls (header rows to
    the card, kernel, slots back)."""
    from repro_torch.core.cluster import LcapCluster
    from repro_torch.core.llog import from_packed
    from repro_torch.core.session import connect

    logs = {pid: from_packed(pid, buf, off, ln, first_index=1)
            for pid, (buf, off, ln, _types) in journals.items()}
    t0 = time.perf_counter()
    cluster = LcapCluster(logs, n_shards=N_SHARDS, n_slots=n_slots,
                          batch_size=batch_size, device=device)
    routing = timed_routing(cluster)
    streams = subscribe_main_path(connect(cluster))
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
    reads, chunks = cluster.routing_reads, cluster.routing_launches
    facts = verify_pipeline(cluster, logs, deliveries, journals, N_SLOTS)
    check_routing_launches("main", launches, chunks, reads)
    rate = total / seconds
    log(f"main: {total} records, 4 shards, robinhood x2 + audit x2 + "
        f"ephemeral reader: {seconds:.3f} s end to end, {rate:.1f} records/s")
    log(f"main: routing reads {reads}, routing chunks {chunks}, fid_slots "
        f"launches {launches}, ephemeral reader got {facts['reader']} "
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
            "routing_share": routing_s / seconds, "device_busy_ms": busy_ms}


def check_routing_launches(label: str, launches: int, chunks: int,
                           reads: int) -> None:
    """A cluster run on the card: one kernel launch per routing chunk,
    and fewer chunks than reads (a round's reads hashed together)."""
    check(launches > 0, f"{label}: no fid_slots kernel launched")
    check(launches == chunks, f"{label}: fid_slots launches {launches} != "
          f"routing chunks {chunks}")
    check(chunks < reads, f"{label}: {chunks} routing chunks for {reads} "
          "routing reads")


# ------------------------------------------------------------ phase 6: wire
class WireMeter:
    """What the wire moves in this process: frames and bytes by
    direction, through ``transport.instrument`` (this object has the
    registry surface it uses), and host seconds inside the framing's
    ``msgpack_subset.packb``/``unpackb``."""

    def __init__(self):
        self._lock = threading.Lock()
        self.values = {}
        self.pack_s = self.unpack_s = 0.0
        self.packs = self.unpacks = 0

    def counter(self, name, help_text, labels=()):
        meter = self

        class Family:
            def labels(self, direction):
                key = f"{name.split('_')[2]}_{direction}"
                meter.values.setdefault(key, 0)

                class Child:
                    def inc(self, n=1):
                        with meter._lock:
                            meter.values[key] += n
                return Child()
        return Family()

    def install(self) -> None:
        from repro_torch.core import transport
        transport.instrument(self)
        packb, unpackb = transport.packb, transport.unpackb

        def timed_packb(obj):
            t = time.perf_counter()
            out = packb(obj)
            dt = time.perf_counter() - t
            with self._lock:
                self.pack_s += dt
                self.packs += 1
            return out

        def timed_unpackb(blob):
            t = time.perf_counter()
            out = unpackb(blob)
            dt = time.perf_counter() - t
            with self._lock:
                self.unpack_s += dt
                self.unpacks += 1
            return out

        transport.packb, transport.unpackb = timed_packb, timed_unpackb

    def take(self) -> dict:
        """The counts since the last ``take``, and zero them."""
        with self._lock:
            out = dict(self.values, pack_s=self.pack_s,
                       unpack_s=self.unpack_s, packs=self.packs,
                       unpacks=self.unpacks)
            self.values = {k: 0 for k in self.values}
            self.pack_s = self.unpack_s = 0.0
            self.packs = self.unpacks = 0
        return out


def trimmed(logs) -> bool:
    return all(log.first_index == log.last_index + 1 for log in logs.values())


def idle(cluster) -> bool:
    """An in-process cluster is through its stream: no migration in
    flight, every journal trimmed and nothing in a live shard's ingest
    buffer.  A trimmed journal alone is not enough: the collective ack
    can pass records a migration hands its target (or a failover its
    survivors) before the shard dispatches them."""
    return cluster._migration is None and trimmed(cluster.journals) and all(
        shard.proxy.buffered == 0 for i, shard in enumerate(cluster.shards)
        if cluster.alive[i])


def run_wire_service(journals: dict, device: str, n_slots: int = N_SLOTS,
                     batch_size: int = BATCH):
    """The main path served over the wire (phase 6a): the cluster's four
    shards each behind its own ``LcapService`` port, routing by
    ``LcapClusterService``'s distributor thread; the main path's
    consumers in this process reach the shard ports over 127.0.0.1 TCP
    through ``connect(service)``, v2 frames negotiated.  Every consumer
    subscribes before the journals join the cluster (so before anything
    is routed).  Returns (cluster, logs, deliveries, seconds,
    routing_seconds) like ``run_pipeline``."""
    from repro_torch.core import records as T
    from repro_torch.core.cluster import LcapCluster, LcapClusterService
    from repro_torch.core.llog import from_packed
    from repro_torch.core.session import connect

    logs = {pid: from_packed(pid, buf, off, ln, first_index=1)
            for pid, (buf, off, ln, _types) in journals.items()}
    cluster = LcapCluster({}, n_shards=N_SHARDS, n_slots=n_slots,
                          batch_size=batch_size, device=device)
    routing = timed_routing(cluster)
    svc = LcapClusterService(cluster).start()
    session = None
    try:
        session = connect(svc)
        streams = subscribe_main_path(session)
        for _group, _k, stream in streams:
            for _i, child in stream._children:
                check(child.session._backend.wire == T.WIRE_V2,
                      "a wire consumer did not negotiate v2 frames")
        t0 = time.perf_counter()
        for pid, log in logs.items():
            cluster.add_producer(pid, log)
        deliveries = []
        deadline = t0 + WIRE_DEADLINE_S
        while True:
            check(svc.failure is None,
                  f"the distributor thread failed: {svc.failure!r}")
            moved = 0
            for group, k, stream in streams:
                for pid, batch in stream.fetch(1 << 16):
                    deliveries.append((group, k, shard_of(stream, batch),
                                       pid, batch))
                    moved += len(batch)
                stream.commit()
            if not moved and trimmed(logs):
                break
            check(time.perf_counter() < deadline, "the wire run did not "
                  f"drain within {WIRE_DEADLINE_S} s")
            if not moved:
                time.sleep(0.001)
        seconds = time.perf_counter() - t0
        check(all(cluster.alive) and cluster.stats["shards_failed"] == 0,
              "a shard failed over during the wire run")
    finally:
        if session is not None:
            session.close()
        svc.stop()
    return cluster, logs, deliveries, seconds, routing[0]


def run_wire_daemons(journals: dict, device: str, n_slots: int = N_SLOTS,
                     batch_size: int = BATCH) -> dict:
    """The main path over shard daemons (phase 6b): four
    ``run_shard_daemon`` processes, each draining a co-located robinhood
    group of two members; a coordinator in this process routes on
    ``device`` and feeds them deep-batched v2 offers over
    ``RemoteShard``s; an audit group consumes over the wire through
    ``connect(addresses)``, subscribed before the first pump."""
    import multiprocessing as mp
    from repro_torch.core import records as T
    from repro_torch.core.cluster import (LcapCluster, RemoteShard,
                                          run_shard_daemon)
    from repro_torch.core.llog import from_packed
    from repro_torch.core.session import Subscription, connect

    ctx = mp.get_context("spawn")
    procs, conns = [], []
    try:
        t_spawn = time.perf_counter()
        for i in range(N_SHARDS):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=run_shard_daemon,
                            args=(child, i, N_SHARDS),
                            kwargs={"local_groups": [("robinhood", 2)]},
                            daemon=True)
            p.start()
            procs.append(p)
            conns.append(parent)
        addrs = []
        for conn in conns:
            check(conn.poll(DAEMON_START_S), "a shard daemon did not report "
                  f"its address within {DAEMON_START_S} s")
            addrs.append(tuple(conn.recv()))
        spawn_s = time.perf_counter() - t_spawn
        logs = {pid: from_packed(pid, buf, off, ln, first_index=1)
                for pid, (buf, off, ln, _types) in journals.items()}
        session = connect(addrs)
        audit = session.subscribe(Subscription(
            group="audit", types=frozenset(getattr(T, n) for n in AUDIT),
            flags=T.CLF_JOBID, auto_commit=False))
        shards = [RemoteShard(a, index=i) for i, a in enumerate(addrs)]
        cluster = LcapCluster(logs, shards=shards, n_slots=n_slots,
                              batch_size=batch_size, device=device)
        routing = timed_routing(cluster)
        deliveries = []
        t0 = time.perf_counter()
        deadline = t0 + WIRE_DEADLINE_S
        try:
            while True:
                moved = cluster.pump(pump_shards=False)
                if not moved:
                    cluster.collect_watermarks()
                got = 0
                for pid, batch in audit.fetch(1 << 16):
                    deliveries.append(("audit", 0, shard_of(audit, batch),
                                       pid, batch))
                    got += len(batch)
                audit.commit()
                if not moved and not got and trimmed(logs):
                    break
                check(time.perf_counter() < deadline, "the daemon run did "
                      f"not drain within {WIRE_DEADLINE_S} s")
                if not moved and not got:
                    time.sleep(0.001)
            seconds = time.perf_counter() - t0
            caps = [shard.caps() for shard in shards]
            check(all(cluster.alive) and cluster.stats["shards_failed"] == 0,
                  "a shard daemon failed over during the run")
        finally:
            session.close()
            cluster.close()
        drained = []
        for conn in conns:
            conn.send("stop")
            check(conn.poll(DAEMON_START_S), "a shard daemon did not report "
                  "its drained count")
            drained.append(conn.recv())
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join(30)
    return {"cluster": cluster, "logs": logs, "deliveries": deliveries,
            "seconds": seconds, "routing_s": routing[0], "caps": caps,
            "drained": drained, "spawn_s": spawn_s}


def verify_daemons(run: dict, journals: dict, n_slots: int) -> None:
    """Phase 6b's checks: the daemons drained every record once between
    them, audit saw every record of its types exactly once, each from
    its slot's owner, every peer deep v2, every journal trimmed."""
    from repro_torch.core import records as T
    from repro_torch.kernels import stream_ops
    total = sum(len(j[1]) for j in journals.values())
    check(sum(run["drained"]) == total, f"the daemons drained "
          f"{run['drained']} records, not {total} between them")
    check(all(c == {"wire": T.WIRE_V2, "deep": True} for c in run["caps"]),
          f"shard daemon caps {run['caps']}")
    audit = np.array([getattr(T, name) for name in AUDIT])
    seen = {pid: np.zeros(len(j[1]) + 1, dtype=np.int64)
            for pid, j in journals.items()}
    owner = run["cluster"].routing.owner_array()
    for _g, _k, shard, pid, batch in run["deliveries"]:
        np.add.at(seen[pid], batch.indices_np().astype(np.int64), 1)
        rows = torch.from_numpy(batch.header_rows().copy())
        slots = stream_ops.fid_slots_rows_reference(rows, n_slots).numpy()
        check(bool((owner[slots] == shard).all()),
              f"shard {shard} delivered records of slots it does not own")
    for pid, (_buf, _off, _ln, types) in journals.items():
        check(np.array_equal(seen[pid][1:],
                             np.isin(types, audit).astype(np.int64)),
              f"audit over the wire did not see every {pid} record of its "
              "types exactly once")
    for pid, log in run["logs"].items():
        check(log.first_index == log.last_index + 1, f"{pid} not trimmed")


def group_records(deliveries) -> dict:
    """group -> {(pid, index): packed record bytes}, checking that no
    group got a record twice."""
    out = {}
    for group, _k, _shard, pid, batch in deliveries:
        per = out.setdefault(group, {})
        for i, rec in zip(batch.indices(), batch):
            check((pid, i) not in per, f"{group} got {pid} {i} twice")
            per[(pid, i)] = bytes(rec)
    return out


def wire_phase(seed: int, smi: str) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import stream_ops
    meter = WireMeter()
    meter.install()
    journals = {f"mdt{m}": make_journal_arrays(m, WIRE_RECORDS_PER_MDT, seed)
                for m in range(N_MDTS)}
    total = N_MDTS * WIRE_RECORDS_PER_MDT
    out = {"records": total}
    # (a) the cluster service
    meter.take()
    stream_ops.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cluster, logs, deliveries, seconds, routing_s = run_wire_service(
            journals, "cuda")
    launches, reads = stream_ops.launches, cluster.routing_reads
    wire = meter.take()
    facts = verify_pipeline(cluster, logs, deliveries, journals, N_SLOTS)
    check_routing_launches("wire service", launches,
                           cluster.routing_launches, reads)
    busy_ms = device_busy_ms(prof)
    out["service"] = {"seconds": seconds, "records_per_s": total / seconds,
                      "routing_s": routing_s, "launches": launches,
                      "routing_reads": reads, "device_busy_ms": busy_ms,
                      "idle_share": 1 - busy_ms / 1e3 / seconds,
                      "wire": wire, **facts}
    log_wire("wire (a) cluster service", out["service"], total, smi)
    log("wire (a): exactly once per group over TCP, every record on its "
        "slot's owner, ephemeral delivered + dropped = total, all journals "
        "trimmed")
    # (a) small run: over the wire as in process, per group
    small = {f"mdt{m}": make_journal_arrays(m, 4096, seed + 1)
             for m in range(N_MDTS)}
    c, lg, dl, _s, _r = run_pipeline(small, "cuda", batch_size=256)
    verify_pipeline(c, lg, dl, small, N_SLOTS)
    wc, wlg, wdl, _s, _r = run_wire_service(small, "cuda", batch_size=256)
    verify_pipeline(wc, wlg, wdl, small, N_SLOTS)
    in_process, over_wire = group_records(dl), group_records(wdl)
    check(over_wire == in_process, "the wire run delivered other records "
          "than the in-process run on the same journals")
    log(f"wire (a): small run (4 x 4096 records) delivers per group the same "
        f"(pid, index) -> packed bytes over the wire as in process "
        f"({sum(len(v) for v in over_wire.values())} deliveries)")
    # (b) shard daemons
    meter.take()
    stream_ops.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run = run_wire_daemons(journals, "cuda")
    launches, reads = stream_ops.launches, run["cluster"].routing_reads
    wire = meter.take()
    verify_daemons(run, journals, N_SLOTS)
    check_routing_launches("daemons", launches,
                           run["cluster"].routing_launches, reads)
    busy_ms = device_busy_ms(prof)
    seconds = run["seconds"]
    out["daemons"] = {"seconds": seconds, "records_per_s": total / seconds,
                      "routing_s": run["routing_s"], "launches": launches,
                      "routing_reads": reads, "device_busy_ms": busy_ms,
                      "idle_share": 1 - busy_ms / 1e3 / seconds,
                      "drained": run["drained"], "spawn_s": run["spawn_s"],
                      "wire": wire}
    log_wire("wire (b) shard daemons", out["daemons"], total, smi)
    log(f"wire (b): daemons drained {run['drained']} (sum {total}), audit "
        f"exactly once over TCP from each slot's owner, caps "
        f"{run['caps'][0]} on all {N_SHARDS}, all journals trimmed; "
        f"daemons up in {run['spawn_s']:.3f} s (spawn, not timed above)")
    return out


def log_wire(label: str, r: dict, total: int, smi: str) -> None:
    w = r["wire"]
    log(f"{label}: {total} records in {r['seconds']:.3f} s end to end, "
        f"{r['records_per_s']:.1f} records/s [{smi}]")
    log(f"{label}: routing calls {r['routing_s']:.3f} s of the host's "
        f"{r['seconds']:.3f} s ({100 * r['routing_s'] / r['seconds']:.3f} %), "
        f"routing reads {r['routing_reads']}, fid_slots launches "
        f"{r['launches']}; device busy {r['device_busy_ms']:.3f} ms by "
        f"torch.profiler, idle {100 * r['idle_share']:.3f} % [{smi}]")
    log(f"{label}: this process sent {w.get('messages_sent', 0)} messages / "
        f"{w.get('bytes_sent', 0)} bytes and received "
        f"{w.get('messages_received', 0)} / {w.get('bytes_received', 0)} "
        f"bytes (transport.instrument); msgpack_subset packb "
        f"{w['pack_s']:.3f} s over {w['packs']} calls, unpackb "
        f"{w['unpack_s']:.3f} s over {w['unpacks']} calls "
        f"({100 * (w['pack_s'] + w['unpack_s']) / r['seconds']:.3f} % of "
        f"the run's host seconds, summed over threads) [{smi}]")


# ------------------------------------------------------ phase 7: activity
class ConsumerClock:
    """Host seconds and counts (records, actions or calls) of each
    consumer's calls in one run."""

    def __init__(self):
        self.seconds = {}
        self.counts = {}

    def _add(self, name: str, since: float, n: int) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + \
            time.perf_counter() - since
        self.counts[name] = self.counts.get(name, 0) + n

    def poll(self, name: str, fn, *args) -> int:
        """Call ``fn``; count what it returns (a number, or a list's
        length)."""
        t = time.perf_counter()
        got = fn(*args)
        n = len(got) if isinstance(got, list) else got
        self._add(name, t, n)
        return n

    def timed(self, name: str, fn):
        """``fn`` adding its host seconds and calls under ``name``."""
        def call(*args):
            t = time.perf_counter()
            out = fn(*args)
            self._add(name, t, 1)
            return out
        return call


def activity_rules(scale: float = 1.0):
    """The phase's two rules on stream time.  Records step by 997 ns, so
    one MDT of ``ACTIVITY_RECORDS_PER_MDT`` spans about 65 ms; a shorter
    run passes ``scale`` = its records over that, so its rules fire at
    the same points of its stream.  ``archive`` takes entries last set
    by a job (CL_SETATTR, which is also the only op that records the
    writer's jobid in the mirror: CL_CREATE starts an entry with none)
    and idle since; ``purge`` old entries last set."""
    from repro_torch.core import records as T
    from repro_torch.policy import PolicyRule
    return [PolicyRule("archive", action="archive",
                       types={T.CL_SETATTR}, flags_all=T.CLF_JOBID,
                       min_idle_s=0.01 * scale),
            PolicyRule("purge", action="purge", types={T.CL_SETATTR},
                       min_age_s=0.02 * scale)]


class Copytool:
    """The phase's executor, an HSM copytool stand-in: every fifth
    cookie fails."""

    def __init__(self):
        self.done = self.failed = 0

    def __call__(self, act) -> bool:
        ok = act.cookie % 5 != 0
        self.done += ok
        self.failed += not ok
        return ok


def run_activity(journals: dict, device: str, db_path: str,
                 n_slots: int = N_SLOTS, batch_size: int = BATCH,
                 time_reap: bool = False) -> dict:
    """The paper's consumers over the card-routed cluster (phase 7): a
    ``NamespaceMirror``, a ``PolicyEngine`` whose action journal is a
    fifth producer routed like the MDTs, an ``ActivityAggregator`` with
    1 ms panes, an ``AuditTrail`` over ``AUDIT``'s types and a
    ``MetricsDB`` on a new SQLite file ``db_path``, all subscribed
    before the engine's journal joins and before the first pump; a port
    ``MetricsRegistry`` attached to the cluster.  Pumps until every
    journal, the actions included, is trimmed, then reconciles the
    action stream.  ``time_reap`` also times the engine's zombie reaping
    inside ``evaluate`` (the phase's timed run)."""
    from repro_torch.core import records as T
    from repro_torch.core.cluster import LcapCluster
    from repro_torch.core.llog import from_packed
    from repro_torch.obs import ActivityAggregator, MetricsRegistry
    from repro_torch.policy import NamespaceMirror, PolicyEngine, reconcile
    from repro_torch.track import AuditTrail, MetricsDB

    # a compacted history tier behind every journal: the reconciler
    # replays the action stream with replay=True, which every producer
    # must be able to serve once trimmed
    logs = {pid: from_packed(pid, buf, off, ln, first_index=1, history=True)
            for pid, (buf, off, ln, _types) in journals.items()}
    cluster = LcapCluster(logs, n_shards=N_SHARDS, n_slots=n_slots,
                          batch_size=batch_size, device=device)
    cluster.attach_registry(MetricsRegistry())
    routing = timed_routing(cluster)
    mirror = NamespaceMirror(cluster, replay=None)
    agg = ActivityAggregator(cluster, window_ns=ACTIVITY_WINDOW_NS)
    audit = AuditTrail(cluster, types=frozenset(getattr(T, n)
                                                for n in AUDIT))
    mdb = MetricsDB(cluster, db_path)
    per_mdt = max(len(j[1]) for j in journals.values())
    engine = PolicyEngine(mirror, activity_rules(
        per_mdt / ACTIVITY_RECORDS_PER_MDT), target=cluster)
    clock = ConsumerClock()
    if time_reap:
        # inside evaluate(): the engine's scan of its live actions and
        # waiters for each dirtied target that is not (or no longer) in
        # the mirror
        engine._reap_target = clock.timed("engine_evaluate_reap",
                                          engine._reap_target)
    # the mirror's view of each archive target as the engine emits its
    # NEW action: (target, stream clock, last op, jobid held, idle ns)
    archived = []
    emit = engine._emit

    def watch(rtype, act, status):
        if rtype == T.CL_ACTION_NEW and act.rule == "archive":
            e = mirror.entries[act.key]
            archived.append((act.key, mirror.clock, e.last_type,
                             bool(e.attr_jobid), mirror.clock - e.mtime))
        return emit(rtype, act, status)

    engine._emit = watch
    copytool = Copytool()
    everything = dict(logs, actions=engine.log)
    t0 = time.perf_counter()
    deadline = t0 + ACTIVITY_DEADLINE_S
    rounds = 0
    while True:
        rounds += 1
        moved = cluster.pump()
        moved += clock.poll("mirror", mirror.poll, 1 << 16)
        moved += clock.poll("aggregator", agg.run_once, 1 << 16)
        moved += clock.poll("audit", audit.poll, 1 << 16)
        moved += clock.poll("metricsdb", mdb.poll, 1 << 16)
        moved += clock.poll("engine_evaluate", engine.evaluate)
        moved += clock.poll("engine_run", engine.run_pending, copytool)
        if not moved and trimmed(everything):
            break
        check(time.perf_counter() < deadline, "the activity run did not "
              f"drain within {ACTIVITY_DEADLINE_S} s")
    if device != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    t = time.perf_counter()
    report = reconcile(engine, cluster)
    reconcile_s = time.perf_counter() - t
    check(all(cluster.alive) and cluster.stats["shards_failed"] == 0,
          "a shard failed over during the activity run")
    return {"cluster": cluster, "logs": logs, "mirror": mirror,
            "engine": engine, "agg": agg, "audit": audit, "mdb": mdb,
            "report": report, "seconds": seconds, "routing_s": routing[0],
            "consumer_s": clock.seconds, "consumer_counts": clock.counts,
            "reconcile_s": reconcile_s, "rounds": rounds,
            "copytool": copytool, "archived": archived}


def activity_counters(snap: dict, render=None) -> tuple:
    """A merged registry snapshot as the Prometheus text of its counters
    (by ``render``, the port's ``render_prometheus`` unless given), the
    help and label sets of its gauges and histograms, and its
    histograms' bucket bounds: gauge values, pump latencies and their
    sums can hold wall time."""
    if render is None:
        from repro_torch.obs import render_prometheus as render
    counters = {n: e for n, e in snap.items() if e["type"] == "counter"}
    shape = {n: (e["type"], e["help"],
                 sorted(sorted(lb.items()) for lb, _v in e["samples"]))
             for n, e in snap.items() if e["type"] != "counter"}
    bounds = {n: sorted((sorted(lb.items()), [le for le, _c in v["buckets"]])
                        for lb, v in e["samples"])
              for n, e in snap.items() if e["type"] == "histogram"}
    return render(counters), shape, bounds


def consumer_state(run: dict) -> dict:
    """Every consumer's state after an activity run, comparable across
    runs: mirror snapshot, windows, audit report, live actions and the
    reconcile report, SQLite rows and merged counters."""
    agg, r = run["agg"], run["report"]
    return {
        "mirror": run["mirror"].snapshot(),
        "windows": {w: agg.counters(w) for w in agg.window_ids()},
        "agg_stats": dict(agg.stats),
        "audit": run["audit"].report(),
        "actions": run["engine"].live_state(),
        "engine_stats": dict(run["engine"].stats),
        "reconcile": (r.ok, r.missing, r.extra, r.mismatched, r.truth_live,
                      r.stream_live),
        "sqlite": run["mdb"].query(
            "SELECT * FROM events ORDER BY producer, idx"),
        "metrics": activity_counters(run["cluster"].metrics()),
    }


def journal_jobids(buf, offsets, types) -> np.ndarray:
    """The 32-byte jobid of every record, read from the generator's own
    buffer where it put them (after the header, and after the source
    FID pair of a rename)."""
    from repro_torch.core import records as T
    raw = np.frombuffer(buf, dtype=np.uint8)
    at = offsets + 64 + (types == T.CL_RENAME) * 32
    mat = raw[at[:, None] + np.arange(32)]
    return np.array([bytes(row).rstrip(b"\0").decode() for row in mat])


def live_targets(journals: dict) -> set:
    """The namespace a mirror must hold: each MDT's (type, oid) sequence
    replayed in index order, CL_CREATE/CL_MKDIR adding the target and
    CL_UNLINK/CL_RMDIR removing it (the generator makes no hard links,
    so the last of these four on a target decides)."""
    from repro_torch.core import records as T
    out = set()
    for buf, offsets, _ln, types in journals.values():
        hdr = np.frombuffer(buf, dtype=np.uint8)[
            offsets[:, None] + np.arange(64)].copy().view(T.HDR_DTYPE)[:, 0]
        oid = hdr["toid"].astype(np.int64)
        seq = int(hdr["tseq"][0])
        keep = np.isin(types, [T.CL_CREATE, T.CL_MKDIR, T.CL_UNLINK,
                               T.CL_RMDIR])
        o, tp = oid[keep][::-1], types[keep][::-1]
        _u, last = np.unique(o, return_index=True)
        alive = np.isin(tp[last], [T.CL_CREATE, T.CL_MKDIR])
        out.update((seq, int(x), 0) for x in o[last][alive])
    return out


def archive_reckoning(journals: dict, idle_ns: int) -> tuple:
    """The archive rule's plain reckoning: each MDT's mirror-applied
    records replayed in index order through a target's lifecycle
    (CL_CREATE/CL_MKDIR start it with no jobid, CL_UNLINK/CL_RMDIR end
    it, CL_RENAME and CL_SETATTR touch a live one, CL_SETATTR recording
    the writer's jobid).  Returns ``(qualifying, eligible)``: target ->
    stream times at which it became an archive candidate (last op
    CL_SETATTR carrying a jobid), and the targets that are candidates at
    the end and idle ``idle_ns`` by the last time the mirror sees."""
    from repro_torch.core import records as T
    from repro_torch.policy import MIRROR_TYPES
    qualifying, final, clock = {}, {}, 0
    for buf, offsets, _ln, types in journals.values():
        keep = np.isin(types, list(MIRROR_TYPES))
        hdr = np.frombuffer(buf, dtype=np.uint8)[
            offsets[keep][:, None] + np.arange(64)].copy().view(
                T.HDR_DTYPE)[:, 0]
        clock = max(clock, int(hdr["time"].max()))
        seq = int(hdr["tseq"][0])
        for oid, t, when, flags in zip(hdr["toid"].tolist(),
                                       types[keep].tolist(),
                                       hdr["time"].tolist(),
                                       hdr["flags"].tolist()):
            key = (seq, oid, 0)
            alive = final.get(key)
            if t in (T.CL_CREATE, T.CL_MKDIR):
                final[key] = (False, when)
            elif alive is None:
                continue
            elif t in (T.CL_UNLINK, T.CL_RMDIR):
                del final[key]
            elif t == T.CL_SETATTR:
                ok = bool(flags & T.CLF_JOBID)
                final[key] = (ok, when)
                if ok:
                    qualifying.setdefault(key, []).append(when)
            elif t == T.CL_RENAME:
                final[key] = (False, when)
    eligible = {k for k, (ok, when) in final.items()
                if ok and when + idle_ns <= clock}
    return qualifying, eligible


def verify_activity(run: dict, journals: dict) -> dict:
    """Phase 7's checks against a plain reckoning from the generator's
    arrays, and against the engine's own ground truth for the action
    stream; returns the numbers the phase prints."""
    from repro_torch.core import records as T
    from repro_torch.obs import (GangliaPusher, PrometheusExporter,
                                 render_prometheus)
    from repro_torch.policy import FAILED, MIRROR_TYPES, SUCCEED
    import urllib.request
    mirror, engine, agg = run["mirror"], run["engine"], run["agg"]
    audit, mdb, cluster = run["audit"], run["mdb"], run["cluster"]
    audit_types = np.array([getattr(T, n) for n in AUDIT])
    types = {pid: j[3] for pid, j in journals.items()}
    jobs = {pid: journal_jobids(j[0], j[1], j[3])
            for pid, j in journals.items()}
    total = sum(len(t) for t in types.values())
    all_types = np.concatenate(list(types.values()))
    all_jobs = np.concatenate(list(jobs.values()))

    # the mirror
    check(set(mirror.entries) == live_targets(journals),
          "the mirror's live namespace is not the journals' replay")
    check(mirror.stats["deduped"] == 0, "the mirror saw a redelivery")

    # the action stream
    n_actions = engine.log.last_index
    done, failed = run["copytool"].done, run["copytool"].failed
    statuses = [s for _k, _r, s in engine.live_state().values()]
    report = run["report"]
    check(report.ok and report.truth_live == report.stream_live,
          f"reconcile: {report}")
    check(done > 0 and failed > 0, f"actions completed {done}, failed "
          f"{failed}: both must occur")
    check(done + failed == engine.stats["completed"] and
          statuses.count(SUCCEED) + statuses.count(FAILED)
          + engine.stats["purged"] == done + failed,
          "the engine's completions differ from the copytool's")
    # run_pending starts (UPDATE) and completes every action it takes
    emitted = {T.CL_ACTION_NEW: engine.stats["emitted"],
               T.CL_ACTION_UPDATE: engine.stats["completed"],
               T.CL_ACTION_COMPLETED: engine.stats["completed"],
               T.CL_ACTION_PURGED: engine.stats["purged"]}
    emitted = {t: n for t, n in emitted.items() if n}
    check(sum(emitted.values()) == n_actions,
          f"action journal holds {n_actions} records, the engine emitted "
          f"{sum(emitted.values())}")

    # the aggregator
    check(agg.stats["late_dropped"] == 0 and
          agg.stats["windows_evicted"] == 0,
          f"aggregator dropped or evicted: {agg.stats}")
    folded = {}
    for w in agg.window_ids():
        for (op, job, pid, _host), (c, _v) in agg.counters(w).items():
            key = (pid, op, job)
            folded[key] = folded.get(key, 0) + c
    want = {}
    for pid in journals:
        pairs = np.char.add(types[pid].astype(str),
                            np.char.add("|", jobs[pid]))
        u, c = np.unique(pairs, return_counts=True)
        for pair, n in zip(u.tolist(), c.tolist()):
            op, job = pair.split("|", 1)
            want[(pid, int(op), job)] = n
    for t, n in emitted.items():
        want[(engine.producer, t, "")] = n
    check(folded == want, "the aggregator's (type, jobid) counts differ "
          "from the journals'")

    # the audit trail
    sel = np.isin(all_types, audit_types)
    u, c = np.unique(all_jobs[sel], return_counts=True)
    want_jobs = dict(zip(u.tolist(), c.tolist()))
    got_jobs = {j: t.records for j, t in audit.trails.items()}
    check(got_jobs == want_jobs, "audit counts per jobid differ")
    users = {}
    for j, n in want_jobs.items():
        uid = j.rpartition(".")[2]           # procname.uid
        users[uid] = users.get(uid, 0) + n
    check(audit.users() == users, "audit counts per user differ")
    check(audit.unattributed == 0, "audit saw records without a jobid")

    # the metrics database
    u, c = np.unique(all_types, return_counts=True)
    want_types = dict(zip(u.tolist(), c.tolist()))
    got_types = dict(mdb.query("SELECT type, count(*) FROM events WHERE "
                               "producer != ? GROUP BY type",
                               (engine.producer,)))
    check(got_types == want_types, "MetricsDB's type counts differ")
    got_actions = dict(mdb.query("SELECT type, count(*) FROM events WHERE "
                                 "producer = ? GROUP BY type",
                                 (engine.producer,)))
    check(got_actions == emitted, "MetricsDB's action counts differ")
    # both rules fire.  Each archive target, as its NEW action was
    # emitted, was last set by a job (CL_SETATTR with a jobid) and idle;
    # against the plain reckoning: it had become a candidate by then,
    # and every target that is a candidate and idle at the end has one
    archived = run["archived"]
    kinds = dict(mdb.query("SELECT name, count(*) FROM events WHERE "
                           "producer = ? AND type = ? GROUP BY name",
                           (engine.producer, T.CL_ACTION_NEW)))
    check(kinds.get("archive", 0) == len(archived) > 0 and
          kinds.get("purge", 0) > 0 and
          sum(kinds.values()) == engine.stats["emitted"],
          f"NEW actions by kind {kinds}: both rules must fire")
    rule = next(r for r in engine.rules if r.name == "archive")
    idle_ns = int(rule.min_idle_s * 1e9)
    check(all(last == T.CL_SETATTR and jobid and idle >= idle_ns
              for _k, _c, last, jobid, idle in archived),
          "an archive action's target was not last set by a job and idle")
    qualifying, eligible = archive_reckoning(journals, idle_ns)
    late = [k for k, clock, *_ in archived
            if not any(w + idle_ns <= clock for w in qualifying.get(k, ()))]
    check(not late, f"{len(late)} archive targets were no candidates at "
          f"their emission by the journals' replay, e.g. {late[:3]}")
    missed = eligible - {k for k, *_ in archived}
    check(not missed, f"{len(missed)} idle candidates at the end got no "
          f"archive action, e.g. {sorted(missed)[:3]}")

    # the merged metrics: routed, offered to each group, delivered
    snap = cluster.metrics()

    def fam_sum(name, **match):
        return sum(v for lb, v in snap.get(name, {}).get("samples", [])
                   if all(lb.get(k) == x for k, x in match.items()))

    routed = total + n_actions
    check(fam_sum("lcap_cluster_routed_total") == routed and
          fam_sum("lcap_proxy_ingested_total") == routed,
          "routed or ingested counters != journal + action records")
    n_mirror = int(np.isin(all_types, list(MIRROR_TYPES)).sum())
    want = {"mirror": n_mirror, "obs": routed, "audit": int(sel.sum()),
            "metrics": routed}
    got = {"mirror": run["consumer_counts"]["mirror"],
           "obs": run["consumer_counts"]["aggregator"],
           "audit": run["consumer_counts"]["audit"],
           "metrics": run["consumer_counts"]["metricsdb"]}
    check(got == want, f"consumers received {got}, the journals hold "
          f"{want}")
    # the ack layer counts every record each group was offered (records
    # a pushdown filtered out are acknowledged in place)
    offered = {g: fam_sum("lcap_ack_delivered_records_total", group=g)
               for g in want}
    check(offered == dict.fromkeys(want, routed), f"ack-layer delivered "
          f"counters {offered}, not {routed} for every group")
    check(fam_sum("lcap_proxy_dispatched_total") == sum(want.values()) and
          fam_sum("lcap_proxy_filtered_out_total")
          == sum(routed - n for n in want.values()),
          "dispatched / filtered counters differ from the deliveries")

    # the export edges
    exporter = PrometheusExporter(snapshot_fn=cluster.metrics,
                                  host="127.0.0.1").start()
    try:
        with urllib.request.urlopen(exporter.url, timeout=30) as resp:
            check(resp.status == 200, f"scrape status {resp.status}")
            body = resp.read().decode()
    finally:
        exporter.stop()
    scraped = counter_lines(body)
    check(scraped and scraped == counter_lines(
        render_prometheus(cluster.metrics())),
        "the scrape's counters differ from render_prometheus")
    pusher = GangliaPusher(snapshot_fn=cluster.metrics)
    pushed = pusher.push()
    sent = {m["name"].split(".")[1] for m in pusher.sent}
    mapped = {short for name, (short, _u) in pusher.name_map.items()
              if name in snap}
    check(pushed == len(pusher.sent) > 0 and mapped and mapped <= sent,
          f"Ganglia push sent {sorted(sent)}, not every mapped name "
          f"{sorted(mapped)}")
    return {"records": total, "actions_emitted": engine.stats["emitted"],
            "action_records": n_actions, "actions_completed": done,
            "actions_failed": failed,
            "actions_by_rule": kinds,
            "archive_candidates_at_end": len(eligible),
            "live_actions_by_rule": {r.name: sum(
                1 for _k, rule, _s in engine.live_state().values()
                if rule == r.name) for r in engine.rules},
            "zombies_reaped": engine.stats["zombies_reaped"],
            "mirror_entries": len(mirror.entries),
            "windows": len(agg.window_ids()),
            "audit_jobids": len(audit.trails),
            "scraped_counter_lines": len(scraped),
            "ganglia_metrics": pushed}


def counter_lines(text: str) -> list:
    """The sample lines of every counter family in exposition text."""
    counters, out = set(), []
    for line in text.splitlines():
        if line.startswith("# TYPE ") and line.endswith(" counter"):
            counters.add(line.split()[2])
        elif line and not line.startswith("#") and \
                line.split("{")[0].split(" ")[0] in counters:
            out.append(line)
    return sorted(out)


def activity_phase(seed: int, smi: str) -> dict:
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.session import connect
    from repro_torch.kernels import stream_ops
    from repro_torch.obs import ActivityTop
    journals = {f"mdt{m}": make_journal_arrays(m, ACTIVITY_RECORDS_PER_MDT,
                                               seed)
                for m in range(N_MDTS)}
    with tempfile.TemporaryDirectory() as workdir:
        stream_ops.launches = 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run = run_activity(journals, "cuda",
                               str(Path(workdir) / "activity.db"),
                               time_reap=True)
        launches, reads = stream_ops.launches, run["cluster"].routing_reads
        facts = verify_activity(run, journals)
        check_routing_launches("activity", launches,
                               run["cluster"].routing_launches, reads)
        session = connect(run["cluster"])
        frame = ActivityTop(run["agg"], session=session,
                            cluster=run["cluster"], k=5).render()
        session.close()
        check(frame.strip() != "", "ActivityTop rendered an empty frame")
        agg = run["agg"]
        wins = agg.window_ids()
        top = agg.top("jobid", k=5, sliding=wins[-1] - wins[0] + 1)
        busy_ms = device_busy_ms(prof)
        seconds = run["seconds"]
        run["mdb"].close()
        # small run: every consumer's state the same routing on the CPU
        small = {f"mdt{m}": make_journal_arrays(m, 4096, seed + 1)
                 for m in range(N_MDTS)}
        states = []
        for device in ("cuda", "cpu"):
            r = run_activity(small, device,
                             str(Path(workdir) / f"small-{device}.db"),
                             batch_size=256)
            verify_activity(r, small)
            states.append(consumer_state(r))
            r["mdb"].close()
        check(states[0] == states[1], "the consumers' state differs "
              "between routing on the card and on the CPU")
    out = {"records": facts["records"], "seconds": seconds,
           "records_per_s": facts["records"] / seconds,
           "records_and_actions_per_s":
               (facts["records"] + facts["action_records"]) / seconds,
           "routing_s": run["routing_s"], "launches": launches,
           "routing_reads": reads, "rounds": run["rounds"],
           "consumer_s": run["consumer_s"],
           "reap_calls": run["consumer_counts"].get(
               "engine_evaluate_reap", 0),
           "reconcile_s": run["reconcile_s"], "device_busy_ms": busy_ms,
           "idle_share": 1 - busy_ms / 1e3 / seconds,
           "top_jobids": [(r["label"], r["count"]) for r in top],
           "small_run_records": N_MDTS * 4096, **facts}
    log(f"activity: {facts['records']} journal records + "
        f"{facts['action_records']} action records through mirror, policy "
        f"engine, aggregator, audit and MetricsDB in {seconds:.3f} s, "
        f"{out['records_per_s']:.1f} journal records/s [{smi}]")
    log(f"activity: routing calls {run['routing_s']:.3f} s of the host's "
        f"{seconds:.3f} s ({100 * run['routing_s'] / seconds:.3f} %), routing "
        f"reads {reads}, fid_slots launches {launches}; device busy "
        f"{busy_ms:.3f} ms by torch.profiler, idle "
        f"{100 * out['idle_share']:.3f} % [{smi}]")
    log("activity: host seconds in each consumer's polls: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(run["consumer_s"].items(),
                                          key=lambda kv: -kv[1]))
        + f" (engine_evaluate_reap is part of engine_evaluate: "
        f"{run['consumer_counts'].get('engine_evaluate_reap', 0)} calls); "
        f"reconcile {run['reconcile_s']:.3f} [{smi}]")
    log(f"activity: mirror {facts['mirror_entries']} entries, actions "
        f"emitted {facts['actions_emitted']} (live by rule "
        f"{facts['live_actions_by_rule']}, zombies reaped "
        f"{facts['zombies_reaped']}), completed {facts['actions_completed']}"
        f", failed {facts['actions_failed']}, {facts['windows']} windows, "
        f"top jobids {out['top_jobids']}")
    log("activity: mirror = replay of the journals, aggregator and audit "
        "counts = the journals', MetricsDB type counts = the journals', "
        "reconcile ok, routed and delivered counters = deliveries, "
        "Prometheus scrape = render_prometheus, Ganglia names sent, "
        "ActivityTop rendered; small run (4 x 4096) identical on card and "
        "CPU")
    return out


# ------------------------------------------------------ phase 7a: elastic
def journal_records(R, arrays, lo: int, hi: int) -> list:
    """Records ``lo + 1 .. hi`` of a journal from ``make_journal_arrays``
    as ``ChangelogRecord``s of records module ``R`` (the port's; the
    reference's in the CPU tests), for ``Llog.log_batch``, which gives
    them the same indices and ``cr_prev`` chains when they are appended
    in order to a journal holding records 1 .. lo."""
    buf, off, ln, _types = arrays
    return [R.unpack(buf[o:o + n])
            for o, n in zip(off[lo:hi].tolist(), ln[lo:hi].tolist())]


def port_modules():
    """The port's modules as ``run_elastic`` and ``run_federation``
    take a package (the CPU tests pass the reference's the same way)."""
    from types import SimpleNamespace
    from repro_torch.core import (cluster, federation, llog, modules,
                                  session, tenancy)
    from repro_torch.core import records as R
    return SimpleNamespace(R=R, cluster=cluster, llog=llog, session=session,
                           federation=federation, modules=modules,
                           tenancy=tenancy, kw={"device": "cuda"})


class RoutingSites:
    """Where the routing chunks of ``clusters`` are hashed, by call site:
    ``round`` (a routing round with no migration in flight: its reads
    hashed together), ``migration`` (the round while a migration is in
    flight: each read hashed as it is read), ``redeliver`` (a forced
    migration's journal re-read), ``reoffer`` (a cancelled migration's
    parked records) and ``replay`` (``ClusterReplayReader.read``, the
    shard filter of a replay bootstrap).  Counts each cluster's router
    chunks (on either device), the ``stream_ops.launches`` made in them
    (the card's) and the threads that hashed them.  Wraps the call sites
    for the life of the context, without changing what they do; the
    counting runs inside the router's lock."""

    SITES = ("round", "migration", "redeliver", "reoffer", "replay", "other")

    def __init__(self, *clusters):
        self.clusters = clusters
        self.chunks = [dict.fromkeys(self.SITES, 0) for _ in clusters]
        self.launches = [dict.fromkeys(self.SITES, 0) for _ in clusters]
        #: the threads that hashed each site's chunks, and every chunk's
        #: site in the order the router hashed them
        self.threads = [{site: set() for site in self.SITES}
                        for _ in clusters]
        self.order = [[] for _ in clusters]
        self._local = threading.local()

    def _in(self, site: str, fn, *args):
        stack = self._local.__dict__.setdefault("stack", [])
        stack.append(site)
        try:
            return fn(*args)
        finally:
            stack.pop()

    def __enter__(self) -> "RoutingSites":
        from repro_torch.core import cluster as CL
        from repro_torch.kernels import stream_ops
        for k, c in enumerate(self.clusters):
            def hashed(n, n_slots, dst, k=k, hash_=c._router._hash):
                before = stream_ops.launches
                hash_(n, n_slots, dst)
                stack = getattr(self._local, "stack", None)
                site = stack[-1] if stack else "other"
                self.chunks[k][site] += 1
                self.launches[k][site] += stream_ops.launches - before
                self.threads[k][site].add(threading.current_thread().name)
                self.order[k].append(site)

            def route(c=c, route_=c._route):
                return self._in("round" if c._migration is None
                                else "migration", route_)
            c._router._hash = hashed
            c._route = route
            for name, site in (("_redeliver_locked", "redeliver"),
                               ("_reoffer_parked_locked", "reoffer")):
                setattr(c, name, lambda *a, site=site, fn=getattr(c, name):
                        self._in(site, fn, *a))
        self._read = CL.ClusterReplayReader.read
        ours = {id(c) for c in self.clusters}

        def read(reader, start, max_records=1024, read_=self._read):
            if id(reader.cluster) not in ours:
                return read_(reader, start, max_records)
            return self._in("replay", read_, reader, start, max_records)
        CL.ClusterReplayReader.read = read
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.core import cluster as CL
        CL.ClusterReplayReader.read = self._read
        for c in self.clusters:
            for name in ("_route", "_redeliver_locked",
                         "_reoffer_parked_locked"):
                c.__dict__.pop(name, None)
            c._router.__dict__.pop("_hash", None)

    def total(self, what: str = "chunks") -> dict:
        """Chunks (or launches) by site, summed over the clusters."""
        rows = getattr(self, what)
        return {s: sum(r[s] for r in rows) for s in self.SITES}


def delivery_counts(deliveries, sizes: dict) -> dict:
    """key -> int64 array (index 0 unused): how often each journal index
    was delivered, from ``(key, indices)`` pairs; ``sizes`` holds each
    key's last index."""
    counts = {key: np.zeros(n + 1, dtype=np.int64)
              for key, n in sizes.items()}
    for key, idx in deliveries:
        np.add.at(counts[key], np.asarray(idx, dtype=np.int64), 1)
    return counts


def check_delivered(label: str, counts: dict, exactly_once: bool,
                    want: dict = None) -> int:
    """Every index of every journal delivered at least once (of those
    ``want`` marks, where given), and exactly once on a graceful path.
    Returns the duplicates."""
    dups = 0
    for key, c in counts.items():
        got = c[1:]
        need = np.ones(len(got), dtype=bool) if want is None else want[key]
        lost = int((need & (got == 0)).sum())
        check(lost == 0, f"{label}: {lost} records of {key} never delivered")
        check(bool((got[~need] == 0).all()),
              f"{label}: records of {key} delivered outside the group's "
              "types")
        extra = int(np.maximum(got - 1, 0).sum())
        check(not (exactly_once and extra),
              f"{label}: {extra} records of {key} delivered more than once "
              "on a graceful path")
        dups += extra
    return dups


def run_elastic(pkg, records: dict, park_cap: int,
                batch_size: int = BATCH) -> dict:
    """Phase 7a (c): the elastic operations with no thread, the cluster
    pumped here round by round as tests/test_torch_cluster.py's
    ``run_elastic`` does.  ``pkg`` holds a package's ``R``, ``cluster``,
    ``session`` and ``llog`` modules and the keywords its
    ``LcapCluster`` takes (``kw``: the port's routing device);
    ``records`` maps each journal to its records (``journal_records``).

    Journals with a history tier take 1/16 of their records a round,
    up to 15/16 (the rest comes with the last migration);
    robinhood (two members) fetches up to n/8 records a member a round,
    audit (its types, one member) up to n/128, so its backlog holds the
    shard watermarks, and with them each migration's handoff, back over
    many rounds, and the parked records reach ``park_cap``
    (backpressure).  Topology changes, each at the first round at or
    after its own with no migration in flight: round 1 and round 4, 8
    slots of shard 0 to shard 1; round 8, ``split_shard()``; round 12,
    half of shard 2's slots to shard 3, the journals' remaining records
    appended at once, and shard 2 killed the round after, while that
    migration parks (so the cancel hands its parked records back).  Once
    every journal has trimmed, a late group subscribes with
    ``replay=True`` and bootstraps from the history tier.  Returns the
    trace (group, member, shard, journal, v2 bytes) and the state the
    card's run and the CPU's must share."""
    R, S = pkg.R, pkg.session.Subscription
    n = len(next(iter(records.values())))
    feed = -(-n // 16)
    logs = {pid: pkg.llog.Llog(pid, history=True) for pid in records}
    cluster = pkg.cluster.LcapCluster(logs, n_shards=N_SHARDS,
                                      n_slots=N_SLOTS, batch_size=batch_size,
                                      park_cap=park_cap, **pkg.kw)
    sites = (RoutingSites(cluster) if hasattr(cluster, "_router")
             else contextlib.nullcontext())
    session = pkg.session.connect(cluster)
    audit = frozenset(getattr(R, name) for name in AUDIT)
    streams = [("robinhood", k, session.subscribe(S(
        group="robinhood", auto_commit=False))) for k in range(2)]
    streams.append(("audit", 0, session.subscribe(S(
        group="audit", types=audit, flags=R.CLF_JOBID, auto_commit=False))))
    take = {"robinhood": max(1, n // 8), "audit": max(1, n // 128)}
    fed = 0
    trace, facts = [], {"max_parked": 0, "parked_at_kill": 0}

    def append(hi: int) -> None:
        nonlocal fed
        for pid, log in logs.items():
            log.log_batch(records[pid][fed:hi])
        fed = hi

    def move_half_of_2(c) -> None:
        half = c.routing.slots_of(2)
        c.migrate_slots(half[:len(half) // 2], 3)
        append(n)

    def kill_2(c) -> None:
        check(c._migration is not None, "the migration off shard 2 "
              "committed before its source could be killed")
        facts["parked_at_kill"] = c._parked_count
        c.kill_shard(2, reason="killed while its slots drain")

    steps = [(1, lambda c: c.migrate_slots(c.routing.slots_of(0)[:8], 1)),
             (4, lambda c: c.migrate_slots(c.routing.slots_of(0)[:8], 1)),
             (8, lambda c: c.split_shard()),
             (12, move_half_of_2), (0, kill_2)]

    def consume(group_streams) -> int:
        moved = 0
        for group, k, stream in group_streams:
            for pid, batch in stream.fetch(take.get(group, n // 8)):
                trace.append((group, k, shard_of(stream, batch), pid,
                              batch.to_wire(R.WIRE_V2)))
                moved += len(batch)
            stream.commit()
        return moved

    def settled() -> bool:
        return idle(cluster)

    with sites:
        rounds = 0
        for rounds in range(1, 100_000):
            rnd = rounds - 1
            if rnd < 15:
                append(min(n - feed, fed + feed))
            if steps and rnd >= steps[0][0] and (
                    cluster._migration is None or steps[0][1] is kill_2):
                steps.pop(0)[1](cluster)
                if steps and steps[0][1] is kill_2:
                    steps[0] = (rnd + 1, kill_2)
            moved = cluster.pump()
            facts["max_parked"] = max(facts["max_parked"],
                                      cluster._parked_count)
            moved += consume(streams)
            if not steps and fed == n and not moved and settled():
                break
        check(not steps and settled(), "the elastic run did not settle")
        # a late group bootstraps from the history tier, shard by shard
        late = session.subscribe(S(group="late", replay=True,
                                   auto_commit=False))
        late_streams = [("late", 0, late)]
        for _ in range(100_000):
            moved = cluster.pump() + consume(late_streams)
            if not moved and not late.replaying and settled():
                break
        check(not late.replaying, "the late group's replay did not end")
    facts.update(rounds=rounds, replayed=late.replayed,
                 backpressure=facts["max_parked"] >= park_cap)
    session.close()
    out = {"trace": trace, "stats": dict(cluster.stats),
           "routing": (cluster.routing.epoch, cluster.slot_owner),
           "journal_acked": dict(cluster.journal_acked),
           "alive": list(cluster.alive), "facts": facts}
    if hasattr(cluster, "_router"):
        out["sites"] = {"chunks": sites.total("chunks"),
                        "launches": sites.total("launches")}
        out["routing_launches"] = cluster.routing_launches
        out["routing_reads"] = cluster.routing_reads
    return out


def verify_elastic(run: dict, journals: dict, park_cap: int) -> dict:
    """Phase 7a (c)'s checks on one run: robinhood got every record and
    audit every record of its types (at least once: a shard was
    killed), the late group replayed, every operation of the scenario
    happened, backpressure engaged, and each elastic call site hashed
    (port runs)."""
    from repro_torch.core import records as T
    sizes = {pid: len(j[1]) for pid, j in journals.items()}
    audit = np.array([getattr(T, name) for name in AUDIT])
    by_group = {g: [] for g in ("robinhood", "audit", "late")}
    for group, _k, _shard, pid, wire in run["trace"]:
        by_group[group].append(
            (pid, T.RecordBatch.from_wire(wire).indices_np()))
    dups = {g: check_delivered(f"elastic (c) {g}",
                               delivery_counts(by_group[g], sizes),
                               exactly_once=False, want=want)
            for g, want in (("robinhood", None),
                            ("audit", {pid: np.isin(j[3], audit)
                                       for pid, j in journals.items()}))}
    st, facts = run["stats"], run["facts"]
    check(st["migrations_completed"] == 3 and
          st["migrations_cancelled"] == 1 and st["shards_added"] == 1 and
          st["shards_failed"] == 1, f"elastic (c): stats {st}")
    check(st["failover_redelivered"] > 0, "elastic (c): the kill "
          "redelivered nothing")
    check(facts["backpressure"], f"elastic (c): at most "
          f"{facts['max_parked']} records parked, under {park_cap}: no "
          "backpressure")
    check(facts["parked_at_kill"] > 0, "elastic (c): nothing parked when "
          "the migration's source was killed")
    check(facts["replayed"] > 0 and by_group["late"],
          "elastic (c): the late group replayed nothing")
    if "sites" in run:
        chunks = run["sites"]["chunks"]
        for site in ("migration", "redeliver", "reoffer", "replay"):
            check(chunks[site] > 0, f"elastic (c): no routing chunk hashed "
                  f"by the {site} call site")
    return {"duplicates": dups, "late_records": sum(
        len(i) for _p, i in by_group["late"])}


def run_federation(pkg, records: dict) -> dict:
    """Phase 7a (d): two filesystems, ``fs0`` (journals mdt0, mdt1) and
    ``fs1`` (mdt2, mdt3), each an ``LcapCluster`` of 3 shards routing on
    ``pkg.kw``'s device, joined by ``Federation``.  Both clusters' journals
    are written before the first pump; one durable member of group
    ``fed`` fetches up to 1/16 of the records a round until it has half
    of them, commits, detaches and ``resume``s; then ``fs0`` migrates
    half its slots (graceful) and ``fs1`` kills the shard with the most
    records routed to it and not yet acknowledged (forced) while the
    resumed member consumes the rest.  Returns the deliveries
    ((origin, journal), indices), the two streams' cursors merged, each
    journal's last index, and each member's stats and routing."""
    S = pkg.session.Subscription
    members = {"fs0": ("mdt0", "mdt1"), "fs1": ("mdt2", "mdt3")}
    logs = {o: {pid: pkg.llog.Llog(pid) for pid in pids}
            for o, pids in members.items()}
    clusters = {o: pkg.cluster.LcapCluster(logs[o], n_shards=3,
                                           n_slots=N_SLOTS,
                                           batch_size=BATCH, **pkg.kw)
                for o in members}
    for o, pids in members.items():
        for pid in pids:
            logs[o][pid].log_batch(records[pid])
    total = sum(len(records[pid]) for pids in members.values()
                for pid in pids)
    take = max(1, total // 16)
    fed = pkg.federation.Federation(clusters)
    stream = fed.subscribe(S(group="fed", name="auditor", auto_commit=False))
    deliveries, cursor = [], pkg.federation.GlobalCursor()

    def consume() -> int:
        got = 0
        for origin, pid, batch in stream.fetch(take):
            check(batch.origin == origin and pid in members[origin],
                  f"federation: a {pid} batch stamped {batch.origin!r} "
                  f"came from {origin!r}")
            deliveries.append(((origin, pid), batch.indices_np()))
            got += len(batch)
        stream.commit()
        return got

    def settled() -> bool:
        return all(idle(c) for c in clusters.values())

    sites = (RoutingSites(*clusters.values())
             if hasattr(clusters["fs0"], "_router")
             else contextlib.nullcontext())
    with sites:
        got = 0
        for _ in range(100_000):
            if got >= total // 2:
                break
            fed.pump()
            got += consume()
        check(got >= total // 2, "federation: half the records never came")
        cursor.merge(stream.cursor)
        stream.detach()
        stream = fed.resume("fed", "auditor", auto_commit=False)
        check(stream.resumed, "federation: the durable member did not resume")
        victim = []

        def kill_busiest() -> None:
            lag = clusters["fs1"].autoscale_signals()
            victim.append(max(sorted(lag), key=lambda i: lag[i][
                "dispatch_lag"]))
            clusters["fs1"].kill_shard(int(victim[0]), reason="killed")

        events = [lambda: clusters["fs0"].migrate_slots(range(N_SLOTS // 2),
                                                        1), kill_busiest]
        for _ in range(100_000):
            if events:
                events.pop(0)()
            moved = fed.pump() + consume()
            if not events and not moved and settled():
                break
        check(settled(), "federation: the members did not settle")
        cursor.merge(stream.cursor)
    out = {"deliveries": deliveries, "cursor": cursor.snapshot(),
           "last": {o: {pid: log.last_index for pid, log in per.items()}
                    for o, per in logs.items()},
           "stats": {o: dict(c.stats) for o, c in clusters.items()},
           "routing": {o: (c.routing.epoch, c.slot_owner)
                       for o, c in clusters.items()},
           "lost": {o: list(child.lost) for o, child in stream._children},
           "victim": int(victim[0])}
    if hasattr(clusters["fs0"], "_router"):
        out["sites"] = {"chunks": sites.total("chunks"),
                        "launches": sites.total("launches")}
        out["routing_launches"] = sum(c.routing_launches
                                      for c in clusters.values())
        out["routing_reads"] = sum(c.routing_reads
                                   for c in clusters.values())
    stream.close()
    fed.close()
    for c in clusters.values():
        c.close()
    return out


def verify_federation(run: dict) -> dict:
    """Phase 7a (d)'s checks: every record of both origins delivered,
    ``fs0``'s exactly once (its migration is graceful), ``fs1``'s at
    least once (a shard was killed); the merged cursor at every
    journal's last index; ``fs0`` migrated and ``fs1`` failed over."""
    sizes = {(o, pid): last for o, per in run["last"].items()
             for pid, last in per.items()}
    counts = delivery_counts(run["deliveries"], sizes)
    dups = {o: check_delivered(
        f"federation {o}", {k: c for k, c in counts.items() if k[0] == o},
        exactly_once=(o == "fs0")) for o in run["last"]}
    check(run["cursor"] == run["last"], f"federation: cursor "
          f"{run['cursor']} is not the journals' last indices {run['last']}")
    st = run["stats"]
    check(st["fs0"]["migrations_completed"] == 1, "federation: fs0's "
          "migration did not complete")
    check(st["fs1"]["shards_failed"] == 1 and
          st["fs1"]["failover_redelivered"] > 0,
          "federation: fs1's kill redelivered nothing")
    check(run["lost"]["fs1"] == [run["victim"]] and
          run["lost"]["fs0"] == [],
          f"federation: lost shards {run['lost']}")
    return {"duplicates": dups, "records": sum(sizes.values())}


class WireConsumer(threading.Thread):
    """A durable member of a group over the wire, never restarted,
    fetching and committing in a loop (phase 7a (a)'s, as
    ``bench_elastic.py``'s, and phase 7b (b)'s).  With ``sizes``
    (journal -> records) it counts each (journal, index) it gets; with
    ``keep`` it keeps each batch's shard, journal and indices, and with
    ``rows`` the batch's target FIDs and jobids' first 8 bytes too.  It
    keeps every routing epoch its stream moved to, and follows the
    stream's ``replaying`` until the bootstrap ends.  ``hold`` stops its
    fetching (and so its acks) until ``release``."""

    def __init__(self, stream, sizes: dict | None = None,
                 keep: bool = False, rows: bool = False):
        super().__init__(daemon=True)
        self.stream, self.keep, self.rows = stream, keep or rows, rows
        self.counts = None if sizes is None else {
            pid: np.zeros(n + 1, dtype=np.int64) for pid, n in sizes.items()}
        self.unique = self.records = 0
        self.batches = []
        self.epochs = [stream.epoch]
        self.replaying = stream.replaying
        self.error = None
        self._halt = threading.Event()
        self._go = threading.Event()
        self._go.set()

    @property
    def epoch(self) -> int:
        return self.epochs[-1]

    def _take(self, pid, batch) -> int:
        idx = batch.indices_np().astype(np.int64)
        if self.counts is not None:
            c = self.counts[pid]
            self.unique += int((c[idx] == 0).sum())
            c[idx] += 1
        if self.keep:
            entry = (shard_of(self.stream, batch), pid, idx)
            if self.rows:
                entry += (tuple(np.asarray(c).copy()
                                for c in batch.tfid_cols()),
                          np.asarray(batch.jobid_col(8)).copy())
            self.batches.append(entry)
        return len(idx)

    def hold(self) -> None:
        self._go.clear()

    def release(self) -> None:
        self._go.set()

    def run(self) -> None:
        try:
            while not self._halt.is_set():
                if not self._go.wait(0.01):
                    continue
                got = sum(self._take(pid, batch)
                          for pid, batch in self.stream.fetch(1 << 16))
                self.stream.commit()
                self.records += got
                if self.stream.epoch != self.epochs[-1]:
                    self.epochs.append(self.stream.epoch)
                self.replaying = self.stream.replaying
                if not got:
                    time.sleep(0.001)
        except BaseException as exc:         # held by the phase
            self.error = exc

    def stop(self) -> None:
        self._halt.set()
        self.join(30)


class Feeder(threading.Thread):
    """Appends records ``lo + 1 .. hi`` to every journal,
    ``ELASTIC_FEED_CHUNK`` a journal at a time, yielding between chunks
    (a stream, not a pre-filled backlog).  With ``gate_at`` it stops
    once it has fed that many records a journal, until ``gate`` is
    set."""

    def __init__(self, logs: dict, records: dict, lo: int, hi: int,
                 gate_at: int | None = None):
        super().__init__(daemon=True)
        self.logs, self.records, self.lo, self.hi = logs, records, lo, hi
        self.gate_at, self.gate = gate_at, threading.Event()
        self.fed = 0
        self.error = None

    def run(self) -> None:
        try:
            for a in range(self.lo, self.hi, ELASTIC_FEED_CHUNK):
                if self.gate_at is not None and \
                        a - self.lo >= self.gate_at:
                    if not self.gate.wait(ELASTIC_DEADLINE_S):
                        raise RuntimeError("the feeder's gate stayed shut "
                                           f"for {ELASTIC_DEADLINE_S} s")
                b = min(self.hi, a + ELASTIC_FEED_CHUNK)
                for pid, log in self.logs.items():
                    log.log_batch(self.records[pid][a:b])
                self.fed = b - self.lo
                time.sleep(0)
        except BaseException as exc:
            self.error = exc


class ChurnStorm(threading.Thread):
    """Phase 7a (a)'s storm, as ``bench_elastic.py``'s: ``migrate_slots``
    of half a random live shard's slots to another, each once the
    previous topology change has committed and the consumer has seen its
    epoch; at half the window (after one such migration at least) one
    ``service.add_shard()`` and a migration onto the new shard; at three
    quarters a split through the service: ``service.add_shard()``, then
    half of the most-loaded shard's slots onto it.

    The first migration is taken so that records must park for it
    (``_park_first``): the caller holds the consumer and starts the
    feeder with a gate.  Left to the threads' timing, a feeder that ran
    ahead of the storm's first change let the routing loop read the
    whole window before any migration began, and nothing parked."""

    def __init__(self, svc, consumer, feeder, rng, window: int):
        super().__init__(daemon=True)
        self.svc, self.consumer, self.feeder = svc, consumer, feeder
        self.rng, self.window = rng, window
        self.migrations = self.added = 0
        self.split = None
        self.hold_s = None
        self.error = None
        self._halt = threading.Event()

    def _wait(self, what: str, cond) -> bool:
        """Poll ``cond``; False if the storm is stopped first."""
        deadline = time.perf_counter() + ELASTIC_DEADLINE_S
        while not cond():
            if self._halt.is_set():
                return False
            if time.perf_counter() >= deadline:
                raise RuntimeError(f"the storm waited {ELASTIC_DEADLINE_S} "
                                   f"s for {what}")
            time.sleep(0.002)
        return True

    def _park_first(self) -> bool:
        """The window's first migration, with records parked for it.
        The feeder waits at its gate and the consumer is held: once the
        routing loop has read all that was fed, half of a random shard's
        slots start to drain, and the migration cannot commit while that
        shard's share stays unacknowledged.  Then the feeder goes on, and
        the consumer is released once the routing loop has parked records
        of the draining slots.  False if the storm is stopped first."""
        c, f = self.svc.cluster, self.feeder
        t0 = time.perf_counter()
        try:
            if not self._wait("the feeder's gate", lambda: (
                    f.fed >= f.gate_at and
                    all(c.cursors[pid] > log.last_index
                        for pid, log in f.logs.items()))):
                return False
            self._migrate(None, None)
            if c._migration is None:
                raise RuntimeError("the first migration committed at once "
                                   "although the consumer was held")
            f.gate.set()
            return self._wait("records to park",
                              lambda: c.stats["parked_records"] > 0)
        finally:
            f.gate.set()
            self.consumer.release()
            self.hold_s = time.perf_counter() - t0

    def _migrate(self, dst, src) -> None:
        """Half of ``src``'s slots (a random owner, or ``"most
        loaded"``) onto ``dst`` (a random other live shard if None)."""
        c = self.svc.cluster
        live = [i for i in range(len(c.shards)) if c.alive[i]]
        counts = c.routing.counts(len(c.shards))
        owners = [i for i in live if counts[i] > 0 and i != dst]
        if src == "most loaded":
            src = max(owners, key=lambda i: counts[i])
            self.split = (src, dst)
        else:
            src = self.rng.choice(owners)
        if dst is None:
            dst = self.rng.choice([i for i in live if i != src])
        slots = c.routing.slots_of(src)
        c.migrate_slots(slots[:max(1, len(slots) // 2)], dst)
        self.migrations += 1

    def _settled(self) -> bool:
        """Wait for the last change to commit and reach the consumer."""
        c = self.svc.cluster
        while not self._halt.is_set():
            if c._migration is None and self.consumer.epoch >= c.epoch:
                return True
            time.sleep(0.002)
        return False

    def _add(self) -> int:
        new = self.svc.add_shard()
        self.added += 1
        return new

    def run(self) -> None:
        try:
            if not self._park_first():
                return
            while self._settled():
                fed = self.feeder.fed
                if not self.added and self.migrations and \
                        fed >= self.window // 2:
                    dst, src = self._add(), None
                elif self.added == 1 and fed >= 3 * self.window // 4:
                    dst, src = self._add(), "most loaded"
                else:
                    dst = src = None
                if dst is not None and not self._settled():
                    break
                self._migrate(dst, src)
                time.sleep(0.005)
        except BaseException as exc:
            self.error = exc

    def stop(self) -> None:
        self._halt.set()
        self.join(30)


def wait_for(what: str, cond, threads=(), svc=None, progress=None,
             limit_s: float = ELASTIC_DEADLINE_S) -> None:
    """Poll ``cond`` until it holds; fail on a thread's error, the
    distributor's failure or ``limit_s``, with the last samples of
    ``progress`` (a ``Progress``) when the run stalled."""
    deadline = time.perf_counter() + limit_s
    while not cond():
        for th in threads:
            check(th.error is None, f"{what}: {type(th).__name__} failed: "
                  f"{th.error!r}")
        failure = getattr(svc, "failure", None)
        check(failure is None,
              f"{what}: the distributor thread failed: {failure!r}")
        if time.perf_counter() >= deadline:
            tail = "" if progress is None else \
                f"; last samples {progress.samples[-5:]}"
            check(False, f"{what}: not within {limit_s} s{tail}")
        time.sleep(0.002)


def run_churn(records: dict, device, seed: int) -> dict:
    """Phase 7a (a): ``bench_elastic.py``'s design on the port.  An
    ``LcapClusterService`` over 4 in-process shards, each behind its own
    port, routing on ``device`` in its distributor thread; one durable
    member of group ``elastic`` over ``connect(service.addresses)`` (a
    wire ``FanInStream`` that finds new shards by the epoch its replies
    carry and the ``topology`` verb), never restarted.  A steady window
    streams records 1 .. n of every journal, a churn window n + 1 .. 2n
    while ``ChurnStorm`` runs (seeded): the consumer is held and the
    feeder stops at an eighth of the window until the storm's first
    migration is in flight (``ChurnStorm._park_first``).  Each window
    lasts until the consumer holds all its records and the storm has
    split a shard."""
    import random
    from repro_torch.core.cluster import LcapCluster, LcapClusterService
    from repro_torch.core.llog import Llog
    from repro_torch.core.session import Subscription, connect
    from repro_torch.kernels import stream_ops
    n = len(next(iter(records.values()))) // 2
    logs = {pid: Llog(pid) for pid in records}
    cluster = LcapCluster(logs, n_shards=N_SHARDS, n_slots=N_SLOTS,
                          batch_size=BATCH, device=device)
    svc = LcapClusterService(cluster)
    rng = random.Random(seed)
    session = consumer = None
    out = {"windows": {}}
    with RoutingSites(cluster) as sites:
        stream_ops.launches = 0
        svc.start()
        try:
            session = connect(list(svc.addresses))
            stream = session.subscribe(Subscription(
                group="elastic", name="storm", auto_commit=False))
            epoch0 = stream.epoch
            consumer = WireConsumer(stream, {pid: 2 * n for pid in logs})
            consumer.start()
            for name, lo in (("steady", 0), ("churn", n)):
                want = consumer.unique + n * len(logs)
                churn = name == "churn"
                feeder = Feeder(logs, records, lo, lo + n, gate_at=(
                    n // ELASTIC_FIRST_MIGRATION_AT if churn else None))
                storm = ChurnStorm(svc, consumer, feeder, rng, n) \
                    if churn else None
                if storm:
                    consumer.hold()
                threads = [t for t in (feeder, storm, consumer) if t]
                t0 = time.perf_counter()
                feeder.start()
                if storm:
                    storm.start()
                # the window also waits for the storm's split, so that a
                # short window still takes every kind of change
                wait_for(f"elastic (a) {name} window",
                         lambda: consumer.unique >= want and (
                             storm is None or storm.split is not None),
                         threads, svc)
                seconds = time.perf_counter() - t0
                feeder.join()
                if storm:
                    storm.stop()
                    check(storm.error is None, f"elastic (a): the storm "
                          f"failed: {storm.error!r}")
                    out.update(storm_migrations=storm.migrations,
                               storm_added=storm.added, split=storm.split,
                               hold_s=storm.hold_s)
                out["windows"][name] = {
                    "records": n * len(logs), "seconds": seconds,
                    "records_per_s": n * len(logs) / seconds}
            wait_for("elastic (a) settle", lambda: (
                cluster._migration is None
                and consumer.epoch >= cluster.epoch
                and trimmed(logs)), [consumer], svc)
            consumer.stop()
            check(consumer.error is None,
                  f"elastic (a): the consumer failed: {consumer.error!r}")
            out.update(counts=consumer.counts, epochs=consumer.epochs,
                       epoch0=epoch0, shards_seen=sorted(stream.shards),
                       lost=list(stream.lost))
        finally:
            if consumer is not None:
                consumer.stop()
            if session is not None:
                session.close()
            svc.stop()
        out.update(launches=stream_ops.launches,
                   sites={"chunks": sites.total("chunks"),
                          "launches": sites.total("launches")})
    out.update(failure=svc.failure, stats=dict(cluster.stats),
               epoch=cluster.epoch, trimmed=trimmed(logs),
               routing_launches=cluster.routing_launches,
               routing_reads=cluster.routing_reads,
               shards=len(cluster.shards))
    return out


def verify_churn(run: dict) -> dict:
    """Phase 7a (a)'s checks: both windows exactly once, every journal
    trimmed, no distributor failure, the consumer at the final epoch
    having seen a bump for each migration and each shard added, records
    parked, and the storm's operations all in the cluster's stats."""
    dups = check_delivered("elastic (a)", run["counts"], exactly_once=True)
    st = run["stats"]
    check(run["failure"] is None, f"elastic (a): the distributor failed: "
          f"{run['failure']!r}")
    check(run["trimmed"], "elastic (a): a journal did not trim")
    check(run["lost"] == [], f"elastic (a): shards lost {run['lost']}")
    check(st["shards_added"] == 2 and run["storm_added"] == 2 and
          run["split"] is not None and run["shards"] == N_SHARDS + 2,
          f"elastic (a): {st['shards_added']} shards added, split "
          f"{run['split']}")
    check(st["migrations_started"] == st["migrations_completed"]
          == run["storm_migrations"] >= 3,
          f"elastic (a): migrations {st['migrations_started']} started, "
          f"{st['migrations_completed']} completed, storm "
          f"{run['storm_migrations']}")
    seen = len(run["epochs"]) - 1
    check(run["epochs"][-1] == run["epoch"],
          f"elastic (a): the consumer ended at epoch {run['epochs'][-1]}, "
          f"the cluster at {run['epoch']}")
    check(seen >= st["migrations_started"] + st["shards_added"],
          f"elastic (a): the consumer saw {seen} epoch bumps for "
          f"{st['migrations_started']} migrations and "
          f"{st['shards_added']} shards added")
    check(sorted(run["shards_seen"]) == list(range(run["shards"])),
          f"elastic (a): the consumer reads shards {run['shards_seen']}")
    check(st["parked_records"] > 0, "elastic (a): no record was parked")
    return {"duplicates": dups, "epoch_bumps_seen": seen}


def run_failover(journals: dict, records: dict, device, seed: int) -> dict:
    """Phase 7a (b): phase 6b's deployment (four ``run_shard_daemon``
    processes, each draining a co-located robinhood group of two) with a
    ``mirror`` group over the wire (``connect(addresses)``) in this
    process.  The journals hold their first halves (``from_packed``); the
    first routing round offers them all, then one daemon (seeded) is
    SIGKILLed with its share in flight, and the coordinator's next offer
    or watermark call fails it over (``kill_shard``: the dead shard's
    slots to the survivors, the journals re-read above its last
    watermark and hashed on ``device``).  The second halves arrive 4096
    records a journal a round."""
    import multiprocessing as mp
    import random
    from repro_torch.core.cluster import (LcapCluster, RemoteShard,
                                          run_shard_daemon)
    from repro_torch.core.llog import from_packed
    from repro_torch.core.session import Subscription, connect
    from repro_torch.kernels import stream_ops
    n = len(next(iter(records.values())))
    half = n // 2
    victim = random.Random(seed).randrange(N_SHARDS)
    ctx = mp.get_context("spawn")
    procs, conns = [], []
    try:
        t_spawn = time.perf_counter()
        for i in range(N_SHARDS):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=run_shard_daemon,
                            args=(child, i, N_SHARDS),
                            kwargs={"local_groups": [("robinhood", 2)]},
                            daemon=True)
            p.start()
            procs.append(p)
            conns.append(parent)
        addrs = []
        for conn in conns:
            check(conn.poll(DAEMON_START_S), "a shard daemon did not report "
                  f"its address within {DAEMON_START_S} s")
            addrs.append(tuple(conn.recv()))
        spawn_s = time.perf_counter() - t_spawn
        logs = {pid: from_packed(pid, buf[:int(off[half])], off[:half],
                                 ln[:half], first_index=1)
                for pid, (buf, off, ln, _types) in journals.items()}
        session = connect(addrs)
        mirror = session.subscribe(Subscription(group="mirror",
                                                auto_commit=False))
        cluster = LcapCluster(logs, shards=[RemoteShard(a, index=i)
                                            for i, a in enumerate(addrs)],
                              n_slots=N_SLOTS, batch_size=BATCH,
                              device=device)
        deliveries = []
        seen = {pid: np.zeros(n + 1, dtype=bool) for pid in logs}
        unique, quiet = 0, None
        fed, killed_at, kill_s = half, None, None
        with RoutingSites(cluster) as sites:
            stream_ops.launches = 0
            t0 = time.perf_counter()
            deadline = t0 + ELASTIC_DEADLINE_S
            try:
                while True:
                    moved = cluster.pump(pump_shards=False)
                    if killed_at is None:
                        killed_at = cluster.stats["routed"]
                        procs[victim].kill()
                        procs[victim].join(30)
                        kill_s = time.perf_counter() - t0
                    elif fed < n:
                        hi = min(n, fed + 4096)
                        for pid, log in logs.items():
                            log.log_batch(records[pid][fed:hi])
                        fed = hi
                    if not moved:
                        cluster.collect_watermarks()
                    got = 0
                    for pid, batch in mirror.fetch(1 << 16):
                        idx = batch.indices_np().astype(np.int64)
                        deliveries.append((pid, idx))
                        unique += int((~seen[pid][idx]).sum())
                        seen[pid][idx] = True
                        got += len(batch)
                    mirror.commit()
                    # a trimmed journal does not mean the survivors have
                    # dispatched what the failover re-offered them: stop
                    # when the mirror holds every record, or after a
                    # quiet second (the check then finds what is lost)
                    if fed == n and not moved and not got and trimmed(logs):
                        quiet = quiet or time.perf_counter()
                        if unique == N_MDTS * n or \
                                time.perf_counter() - quiet > 1.0:
                            break
                    else:
                        quiet = None
                    check(time.perf_counter() < deadline, "the failover run "
                          f"did not drain within {ELASTIC_DEADLINE_S} s")
                    if not moved and not got:
                        time.sleep(0.001)
                seconds = time.perf_counter() - t0
            finally:
                lost = list(mirror.lost)
                session.close()
                cluster.close()
            launches = stream_ops.launches
        drained = {}
        for i, conn in enumerate(conns):
            if i == victim:
                continue
            conn.send("stop")
            check(conn.poll(DAEMON_START_S), "a shard daemon did not report "
                  "its drained count")
            drained[i] = conn.recv()
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join(30)
    return {"deliveries": deliveries, "lost": lost, "victim": victim,
            "killed_at": killed_at, "kill_s": kill_s, "seconds": seconds,
            "spawn_s": spawn_s, "stats": dict(cluster.stats),
            "alive": list(cluster.alive), "trimmed": trimmed(logs),
            "launches": launches, "routing_launches": cluster.routing_launches,
            "routing_reads": cluster.routing_reads, "drained": drained,
            "sites": {"chunks": sites.total("chunks"),
                      "launches": sites.total("launches")},
            "sizes": {pid: n for pid in logs}}


def verify_failover(run: dict) -> dict:
    """Phase 7a (b)'s checks: the mirror group lost no (journal, index)
    through the SIGKILL (duplicates counted: at-least-once), the kill
    redelivered, the stream dropped the dead shard, every journal
    trimmed, and the redelivery hashed on the routing device."""
    counts = delivery_counts(run["deliveries"], run["sizes"])
    dups = check_delivered("elastic (b) mirror", counts, exactly_once=False)
    st = run["stats"]
    check(st["shards_failed"] == 1 and
          not run["alive"][run["victim"]], f"elastic (b): shard "
          f"{run['victim']} was not failed over ({st['shards_failed']} "
          "failed)")
    check(st["failover_redelivered"] > 0, "elastic (b): the failover "
          "redelivered nothing")
    check(run["lost"] == [run["victim"]], f"elastic (b): the stream lost "
          f"{run['lost']}, not [{run['victim']}]")
    check(run["trimmed"], "elastic (b): a journal did not trim")
    check(run["sites"]["chunks"]["redeliver"] > 0, "elastic (b): the "
          "redelivery hashed nothing")
    return {"duplicates": dups}

def check_launches(label: str, run: dict, launches: int) -> None:
    """Phase 7a: every router chunk of the part was one kernel launch,
    call site by call site."""
    check(launches > 0, f"{label}: no fid_slots kernel launched")
    check(launches == run["routing_launches"], f"{label}: fid_slots "
          f"launches {launches} != routing chunks {run['routing_launches']}")
    check(run["sites"]["launches"] == run["sites"]["chunks"],
          f"{label}: launches by call site {run['sites']['launches']} != "
          f"chunks {run['sites']['chunks']}")


def elastic_phase(seed: int, smi: str) -> dict:
    """Phase 7a: the paper's elastic operations on the card, parts (a)
    to (d) (``run_churn``, ``run_failover``, ``run_elastic`` on the card
    and on the CPU, ``run_federation``), each on phase 4's generator,
    routing with the kernel, its launches counted from 0."""
    from repro_torch.kernels import stream_ops
    pkg = port_modules()
    n = ELASTIC_RECORDS_PER_MDT
    t0 = time.perf_counter()
    arrays = {f"mdt{m}": make_journal_arrays(m, 2 * n, seed)
              for m in range(N_MDTS)}
    records = {pid: journal_records(pkg.R, a, 0, 2 * n)
               for pid, a in arrays.items()}
    # parts (b) to (d) take the first n records of each journal
    journals = {pid: (buf, off[:n], ln[:n], types[:n])
                for pid, (buf, off, ln, types) in arrays.items()}
    first = {pid: recs[:n] for pid, recs in records.items()}
    out = {"records_per_mdt": n, "setup_s": time.perf_counter() - t0}
    log(f"elastic: {N_MDTS} journals x {2 * n} records generated and "
        f"unpacked in {out['setup_s']:.3f} s (not timed below)")

    # (a) a churn storm over the wire
    t = time.perf_counter()
    a = run_churn(records, "cuda", seed)
    fa = verify_churn(a)
    check_launches("elastic (a)", a, a["launches"])
    st, w = a["stats"], a["windows"]
    ratio = w["churn"]["records_per_s"] / w["steady"]["records_per_s"]
    out["churn"] = {
        "steady_records_per_s": w["steady"]["records_per_s"],
        "churn_records_per_s": w["churn"]["records_per_s"],
        "steady_s": w["steady"]["seconds"], "churn_s": w["churn"]["seconds"],
        "churn_ratio": ratio, "reference_gate": CHURN_GATE,
        "migrations_started": st["migrations_started"],
        "migrations_completed": st["migrations_completed"],
        "shards_added": st["shards_added"], "split": list(a["split"]),
        "epoch_bumps": st["epoch_bumps"],
        "epoch_bumps_seen": fa["epoch_bumps_seen"],
        "parked_records": st["parked_records"],
        "first_migration_hold_s": a["hold_s"],
        "launches": a["launches"], "routing_reads": a["routing_reads"],
        "launches_by_site": a["sites"]["launches"],
        "migration_reads": a["sites"]["launches"]["migration"],
        "seconds": time.perf_counter() - t}
    c = out["churn"]
    log(f"elastic (a) churn storm over the wire: steady "
        f"{c['steady_records_per_s']:.1f} records/s, churn "
        f"{c['churn_records_per_s']:.1f} records/s, ratio {ratio:.4f} "
        f"(the reference's gate {CHURN_GATE}, not held) [{smi}]")
    log(f"elastic (a): {c['migrations_started']} migrations started, "
        f"{c['migrations_completed']} completed, {c['shards_added']} shards "
        f"added (split {a['split'][0]} -> {a['split'][1]}), "
        f"{c['epoch_bumps']} epoch bumps, {c['epoch_bumps_seen']} seen by the "
        f"wire consumer, {c['parked_records']} records parked (the "
        f"consumer held {c['first_migration_hold_s']:.3f} s for the first "
        f"migration); fid_slots "
        f"launches {c['launches']} = routing chunks, of them "
        f"{c['migration_reads']} one read a launch in the migration branch "
        f"(routing reads {c['routing_reads']}); exactly once over "
        f"{4 * 2 * n} records, all journals trimmed")

    # (b) a shard daemon SIGKILLed mid-stream
    t = time.perf_counter()
    b = run_failover(journals, first, "cuda", seed)
    fb = verify_failover(b)
    check_launches("elastic (b)", b, b["launches"])
    out["failover"] = {
        "victim": b["victim"], "killed_at_routed": b["killed_at"],
        "duplicates": fb["duplicates"],
        "failover_redelivered": b["stats"]["failover_redelivered"],
        "lost": b["lost"], "run_s": b["seconds"], "spawn_s": b["spawn_s"],
        "records_per_s": N_MDTS * n / b["seconds"],
        "launches": b["launches"], "routing_reads": b["routing_reads"],
        "launches_by_site": b["sites"]["launches"],
        "drained_by_survivors": b["drained"],
        "seconds": time.perf_counter() - t}
    f = out["failover"]
    log(f"elastic (b) shard daemon {f['victim']} SIGKILLed after "
        f"{f['killed_at_routed']} of {N_MDTS * n} records routed: no record "
        f"lost, {f['duplicates']} duplicates, {f['failover_redelivered']} "
        f"redelivered, stream lost {f['lost']}, journals trimmed; "
        f"{f['records_per_s']:.1f} records/s; fid_slots launches "
        f"{f['launches']} = routing chunks ({f['launches_by_site']}) [{smi}]")

    # (c) the elastic run, card against CPU
    t = time.perf_counter()
    stream_ops.launches = 0
    card = run_elastic(pkg, first, ELASTIC_PARK_CAP)
    card_s = time.perf_counter() - t
    launches = stream_ops.launches
    fc = verify_elastic(card, journals, ELASTIC_PARK_CAP)
    check_launches("elastic (c)", card, launches)
    t_cpu = time.perf_counter()
    cpu_pkg = port_modules()
    cpu_pkg.kw = {"device": "cpu"}
    cpu = run_elastic(cpu_pkg, first, ELASTIC_PARK_CAP)
    cpu_s = time.perf_counter() - t_cpu
    verify_elastic(cpu, journals, ELASTIC_PARK_CAP)
    for key in ("trace", "stats", "routing", "journal_acked", "alive",
                "facts"):
        check(card[key] == cpu[key], f"elastic (c): {key} differs between "
              "routing on the card and on the CPU")
    out["card_vs_cpu"] = {
        "batches": len(card["trace"]), "stats": card["stats"],
        "epoch": card["routing"][0], "facts": card["facts"],
        "duplicates": fc["duplicates"], "late_records": fc["late_records"],
        "launches": launches, "routing_reads": card["routing_reads"],
        "launches_by_site": card["sites"]["launches"],
        "card_s": card_s, "cpu_s": cpu_s,
        "seconds": time.perf_counter() - t}
    c = out["card_vs_cpu"]
    log(f"elastic (c) card vs CPU: {c['batches']} batches, stats, epoch "
        f"{c['epoch']}, owners and journal acks equal byte for byte; "
        f"{card['stats']['migrations_completed']} migrations, split, cancel "
        f"by kill ({c['facts']['parked_at_kill']} parked at the kill), "
        f"backpressure at {c['facts']['max_parked']} parked (cap "
        f"{ELASTIC_PARK_CAP}), late replay {c['late_records']} records; "
        f"fid_slots launches {launches} = routing chunks by site "
        f"{c['launches_by_site']}; card run {card_s:.3f} s, CPU run "
        f"{cpu_s:.3f} s [{smi}]")
    del card, cpu

    # (d) two filesystems federated
    t = time.perf_counter()
    stream_ops.launches = 0
    d = run_federation(pkg, first)
    launches = stream_ops.launches
    fd = verify_federation(d)
    check_launches("elastic (d)", d, launches)
    out["federation"] = {
        "records": fd["records"], "duplicates": fd["duplicates"],
        "cursor": d["cursor"], "lost": d["lost"],
        "fs0_migrations": d["stats"]["fs0"]["migrations_completed"],
        "fs1_redelivered": d["stats"]["fs1"]["failover_redelivered"],
        "launches": launches, "routing_reads": d["routing_reads"],
        "launches_by_site": d["sites"]["launches"],
        "seconds": time.perf_counter() - t}
    f = out["federation"]
    log(f"elastic (d) federation of fs0 and fs1: {f['records']} records "
        f"across a detach and resume, fs0 exactly once through a graceful "
        f"migration, fs1 {f['duplicates']['fs1']} duplicates through a "
        f"kill ({f['fs1_redelivered']} redelivered), cursor = the journals' "
        f"last indices; fid_slots launches {launches} = routing chunks "
        f"({f['launches_by_site']}) [{smi}]")
    out["launches"] = {"churn": out["churn"]["launches"],
                       "failover": out["failover"]["launches"],
                       "card_vs_cpu": out["card_vs_cpu"]["launches"],
                       "federation": out["federation"]["launches"]}
    return out

# -------------------------------------------------------- phase 7b: proxy
def tracker_arrays(host: int, n: int, seed: int):
    """Training host ``host``'s journal of ``n`` records, logged by the
    port's ``ActivityTracker`` (run ``PROXY_TRAIN_RUN``), as
    ``make_journal_arrays`` returns a journal: each step a step commit,
    two heartbeats and a data range; every ``CKPT_EVERY`` steps a
    checkpoint of ``CKPT_SHARDS`` shards, ``CKPT_REWRITES`` of them
    written again at the same step (the superseding write has the same
    target FID)."""
    from repro_torch.track.tracker import ActivityTracker
    rng = np.random.default_rng([seed, 100 + host])
    tr = ActivityTracker(PROXY_TRAIN_RUN, host,
                         jobid=f"train.{PROXY_TRAIN_RUN}",
                         shard=(0, host, 0, 0))
    tr.llog.register_reader("dump")
    step = 0
    while tr.llog.last_index < n:
        dt = float(rng.uniform(0.9, 1.1))
        tr.step_commit(step, float(rng.uniform(1.0, 4.0)), dt, 8192)
        tr.heartbeat(step, dt)
        tr.heartbeat(step, dt)
        tr.data_consume(step, host, step * 8, step * 8 + 8)
        step += 1
        if step % CKPT_EVERY == 0:
            again = rng.choice(CKPT_SHARDS, CKPT_REWRITES, replace=False)
            for s in list(range(CKPT_SHARDS)) + sorted(again.tolist()):
                tr.ckpt_write(step, s, 1 << 20, f"ckpt/{step}/{s}",
                              CKPT_SHARDS)
    packed = []
    while len(packed) < n:
        batch = tr.llog.read(len(packed) + 1, n - len(packed))
        packed += [batch.packed(i) for i in range(len(batch))]
    lengths = np.array([len(b) for b in packed], dtype=np.int64)
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    types = np.array([int.from_bytes(b[4:6], "little") for b in packed],
                     dtype=np.uint16)
    return b"".join(packed), offsets, lengths, types


def proxy_journals(n: int, m: int, seed: int) -> dict:
    """Phase 7b's journals: 4 MDTs of ``n`` records with scratch files,
    and ``PROXY_TRAIN_HOSTS`` training hosts of ``m``."""
    out = {f"mdt{k}": make_journal_arrays(k, n, seed, scratch=True)
           for k in range(N_MDTS)}
    out.update({f"host{h}": tracker_arrays(h, m, seed)
                for h in range(PROXY_TRAIN_HOSTS)})
    return out


def plain_slots(seq, oid, ver) -> np.ndarray:
    """The slots of target FIDs given as columns, by the kernel's plain
    version."""
    from repro_torch.core import records as T
    from repro_torch.kernels import stream_ops
    hdr = np.zeros(len(seq), dtype=T.HDR_DTYPE)
    hdr["tseq"], hdr["toid"], hdr["tver"] = seq, oid, ver
    rows = torch.from_numpy(hdr.view(np.uint8).reshape(-1, 64))
    return stream_ops.fid_slots_rows_reference(rows, N_SLOTS).numpy()


def journal_columns(records: dict) -> dict:
    """Each journal's type, tenant (an index into ``TENANTS`` whose
    ``prefix.`` its jobid starts with, else -1) and FID slot, a row per
    record, from its records (``journal_records``)."""
    prefixes = [(k, t.encode() + b".") for k, t in enumerate(TENANTS)]
    return {pid: {
        "types": np.array([r.type for r in recs], dtype=np.int64),
        "tenant": np.array([next((k for k, p in prefixes
                                  if r.jobid.startswith(p)), -1)
                            for r in recs], dtype=np.int64),
        "slot": plain_slots(*(np.array([getattr(r.tfid, f) for r in recs],
                                       dtype=np.uint64)
                              for f in ("seq", "oid", "ver")))}
        for pid, recs in records.items()}


class CountingModule:
    """A stream module that counts the rows it removes and the batches it
    returns reordered (another batch of the same length), and nothing
    else: ``module(batch)`` is the wrapped module's output."""

    def __init__(self, module):
        self.module = module
        self.removed = 0
        self.reordered = 0

    def __call__(self, batch):
        out = self.module(batch)
        self.removed += len(batch) - len(out)
        self.reordered += out is not batch and len(out) == len(batch)
        return out


def proxy_chain(pkg) -> list:
    """The reference test's chain (tests/test_columnar.py), each module
    counted: every type but CL_CLOSE, heartbeats coalesced, compensating
    operations cancelled, rows reordered by target."""
    M, R = pkg.modules, pkg.R
    return [CountingModule(m) for m in (
        M.TypeFilter(set(R.TYPE_NAMES) - {R.CL_CLOSE}),
        M.CoalesceHeartbeats(), M.CancelCompensating(),
        M.ReorderByTarget())]


MODULE_NAMES = ("TypeFilter", "CoalesceHeartbeats", "CancelCompensating",
                "ReorderByTarget")


def tenant_spec(pkg, t: str, **kw):
    """A subscription of group ``tenant-t``, scoped to jobids ``t.*``."""
    P = pkg.tenancy.TenantPrincipal
    return pkg.session.Subscription(
        group=f"tenant-{t}", tenant=P(t, prefixes=(t.encode() + b".",)),
        auto_commit=False, **kw)


def run_proxy_chain(pkg, records: dict, add_after_quota: bool = True) -> dict:
    """Phase 7b (a): the whole proxy on the cluster with no thread.  An
    ``LcapCluster`` of 4 shards, 64 slots and ``proxy_chain``'s modules
    over every journal of ``records`` (each with a history tier),
    routing on ``pkg.kw``'s device; groups robinhood (two members),
    audit (its types), a group for each tenant of ``TENANTS`` scoped to
    its jobid prefix, and an ephemeral reader.  Tenant ``dd`` has a quota
    (per shard: the records per MDT over ``QUOTA_DIVISOR`` a clock
    second, the same burst) on a step clock, one second a round, that
    replaces ``LcapProxy._now`` on each shard's proxy.  Each journal
    takes 1/16 of its records a round.  At round 8 (halfway) a shard is
    added (already there when not ``add_after_quota``: then it joins
    before the quota is set) and ``PROXY_MOVED_SLOTS`` of shard 0's
    slots migrate to it while the quota holds.  The quota is lifted
    once the migration has committed and ``dd`` has parked on the new
    shard, or ``PROXY_LIFT_WAIT`` rounds after the commit.  Returns the
    trace (group, member, shard, journal, v2 bytes), the stats and the
    facts two runs must share."""
    R, S = pkg.R, pkg.session.Subscription
    mdt = next(pid for pid in records if pid.startswith("mdt"))
    n = len(records[mdt])
    logs = {pid: pkg.llog.Llog(pid, history=True) for pid in records}
    chain = proxy_chain(pkg)
    cluster = pkg.cluster.LcapCluster(logs, n_shards=N_SHARDS,
                                      n_slots=N_SLOTS, batch_size=BATCH,
                                      modules=chain, **pkg.kw)
    clock = [0.0]

    def tick(shard: int) -> None:
        cluster.shards[shard].proxy._now = lambda: clock[0]

    for i in range(len(cluster.shards)):
        tick(i)
    added = None
    if not add_after_quota:
        added = cluster.add_shard()
        tick(added)
    sites = (RoutingSites(cluster) if hasattr(cluster, "_router")
             else contextlib.nullcontext())
    session = pkg.session.connect(cluster)
    audit = frozenset(getattr(R, name) for name in AUDIT)
    streams = [("robinhood", k, session.subscribe(S(
        group="robinhood", auto_commit=False))) for k in range(2)]
    streams.append(("audit", 0, session.subscribe(S(
        group="audit", types=audit, flags=R.CLF_JOBID, auto_commit=False))))
    streams += [(f"tenant-{t}", 0, session.subscribe(tenant_spec(pkg, t)))
                for t in TENANTS]
    streams.append(("reader", 0, session.subscribe(S(
        mode=pkg.session.EPHEMERAL, auto_commit=False))))
    quota = max(1, n // QUOTA_DIVISOR)
    cluster.set_tenant_quota("dd", records_per_s=quota, burst_records=quota)
    feed = {pid: -(-len(recs) // PROXY_FEED_ROUNDS)
            for pid, recs in records.items()}
    trace = []
    facts = {"quota": quota, "moved_at": None, "committed_at": None,
             "lifted_at": None}

    def parked_rounds(shard: int) -> int:
        acct = cluster.shards[shard].proxy.tenants.get("dd")
        return 0 if acct is None else acct.quota_blocked_pumps

    with sites:
        t0 = time.perf_counter()
        for rnd in range(PROXY_MAX_ROUNDS):
            clock[0] = float(rnd)
            if rnd < PROXY_FEED_ROUNDS:
                for pid, log in logs.items():
                    log.log_batch(records[pid][rnd * feed[pid]:
                                               (rnd + 1) * feed[pid]])
            if rnd == PROXY_FEED_ROUNDS // 2:
                if added is None:
                    added = cluster.add_shard()
                    tick(added)
                cluster.migrate_slots(
                    cluster.routing.slots_of(0)[:PROXY_MOVED_SLOTS], added)
                facts["moved_at"] = rnd
            if facts["moved_at"] is not None and \
                    facts["committed_at"] is None and \
                    cluster._migration is None:
                facts["committed_at"] = rnd
            if facts["committed_at"] is not None and \
                    facts["lifted_at"] is None and (
                        parked_rounds(added) or
                        rnd >= facts["committed_at"] + PROXY_LIFT_WAIT):
                cluster.set_tenant_quota("dd")
                facts["lifted_at"] = rnd
            moved = cluster.pump()
            for group, k, stream in streams:
                for pid, batch in stream.fetch(1 << 16):
                    trace.append((group, k, shard_of(stream, batch), pid,
                                  batch.to_wire(R.WIRE_V2)))
                    moved += len(batch)
                stream.commit()
            if rnd >= PROXY_FEED_ROUNDS and facts["lifted_at"] is not None \
                    and not moved and idle(cluster):
                break
        seconds = time.perf_counter() - t0
    check(facts["lifted_at"] is not None and idle(cluster),
          f"proxy (a): the run did not settle in {PROXY_MAX_ROUNDS} rounds")
    session.close()
    facts.update(
        rounds=rnd + 1, added=added,
        removed={name: m.removed for name, m in zip(MODULE_NAMES, chain)},
        reordered=chain[-1].reordered,
        removed_by_shard=[s.proxy.stats["dropped_by_modules"]
                          for s in cluster.shards],
        parked_rounds=[parked_rounds(i) for i in range(len(cluster.shards))],
        reader_drops=sum(s.proxy.stats["ephemeral_drops"]
                         for s in cluster.shards))
    out = {"trace": trace, "stats": dict(cluster.stats),
           "routing": (cluster.routing.epoch, cluster.slot_owner),
           "journal_acked": dict(cluster.journal_acked), "facts": facts,
           "seconds": seconds}
    if hasattr(cluster, "_router"):
        out["sites"] = {"chunks": sites.total("chunks"),
                        "launches": sites.total("launches")}
        out["routing_launches"] = cluster.routing_launches
        out["routing_reads"] = cluster.routing_reads
    return out


def removable(cols: dict) -> dict:
    """Which records each module may remove, by type: TypeFilter every
    CL_CLOSE, CoalesceHeartbeats heartbeats, CancelCompensating the
    compensating pairs and superseded checkpoint writes."""
    from repro_torch.core import records as T
    kinds = {"TypeFilter": (T.CL_CLOSE,),
             "CoalesceHeartbeats": (T.CL_HEARTBEAT,),
             "CancelCompensating": (T.CL_CREATE, T.CL_UNLINK, T.CL_MKDIR,
                                    T.CL_RMDIR, T.CL_CKPT_WRITE)}
    return {name: {pid: np.isin(c["types"], kinds[name])
                   for pid, c in cols.items()} for name in kinds}


def check_tenants(label: str, counts: dict, rh: dict, cols: dict,
                  tenants=TENANTS) -> None:
    """Each tenant group of ``counts`` got, exactly once, robinhood's
    records (``rh``: delivered at least once) whose jobid is in its
    scope, and no other record."""
    for t in tenants:
        k = TENANTS.index(t)
        for pid, c in counts[f"tenant-{t}"].items():
            got, scope = c[1:], cols[pid]["tenant"] == k
            check(bool((got[~scope] == 0).all()),
                  f"{label}: tenant {t} got {int((got[~scope] > 0).sum())} "
                  f"records of {pid} outside its scope")
            want = (rh[pid][1:] > 0) & scope
            check(np.array_equal(got, want.astype(np.int64)),
                  f"{label}: tenant {t} got {int((got > 0).sum())} "
                  f"records of {pid}, not once each of robinhood's "
                  f"{int(want.sum())} in its scope")


def verify_proxy_chain(run: dict, cols: dict) -> dict:
    """Phase 7b (a)'s checks on one run: robinhood got each record once
    or a module removed it (module by module: TypeFilter every CL_CLOSE,
    and the rest only records of the types they act on), audit
    robinhood's records of its types, each tenant group robinhood's
    records in its scope and nothing else (no training record), every
    module removed rows on the cluster and every shard lost rows to the
    chain, ``dd`` parked (on the added shard too) and got everything once
    lifted, and the ephemeral reader nothing twice."""
    from repro_torch.core import records as T
    sizes = {pid: len(c["types"]) for pid, c in cols.items()}
    by_group = {}
    for group, _k, _shard, pid, wire in run["trace"]:
        by_group.setdefault(group, []).append(
            (pid, T.RecordBatch.from_wire(wire).indices_np()))
    counts = {g: delivery_counts(d, sizes) for g, d in by_group.items()}
    rh = counts["robinhood"]
    facts = run["facts"]
    removed = facts["removed"]
    total = sum(sizes.values())
    for pid, c in rh.items():
        check(bool((c[1:] <= 1).all()), f"proxy (a): robinhood got "
              f"{int((c[1:] > 1).sum())} records of {pid} twice")
    delivered = sum(int((c[1:] > 0).sum()) for c in rh.values())
    check(delivered + sum(removed.values()) == total,
          f"proxy (a): robinhood got {delivered} records and the modules "
          f"removed {sum(removed.values())}, not the {total} journaled")
    check(sum(removed.values()) == sum(facts["removed_by_shard"]),
          f"proxy (a): the modules counted {removed}, the shards "
          f"{facts['removed_by_shard']}")
    kinds = removable(cols)
    for name, per in kinds.items():
        gone = sum(int(((rh[pid][1:] == 0) & m).sum())
                   for pid, m in per.items())
        check(gone == removed[name], f"proxy (a): {removed[name]} rows "
              f"removed by {name}, {gone} of its types undelivered")
    for pid in sizes:
        acted = np.zeros(sizes[pid], dtype=bool)
        for per in kinds.values():
            acted |= per[pid]
        check(bool((rh[pid][1:][~acted] == 1).all()),
              f"proxy (a): robinhood missed records of {pid} that no "
              "module acts on")
        check(bool((rh[pid][1:][cols[pid]["types"] == T.CL_CLOSE]
                    == 0).all()), f"proxy (a): a CL_CLOSE of {pid} passed "
              "the type filter")
    audit = np.array([getattr(T, name) for name in AUDIT])
    for pid, c in counts["audit"].items():
        want = (rh[pid][1:] > 0) & np.isin(cols[pid]["types"], audit)
        check(np.array_equal(c[1:], want.astype(np.int64)),
              f"proxy (a): audit's {pid} records are not robinhood's of "
              "its types, once each")
    check_tenants("proxy (a)", counts, rh, cols)
    for name in MODULE_NAMES[:3]:
        check(removed[name] > 0, f"proxy (a): {name} removed no row")
    check(facts["reordered"] > 0, "proxy (a): ReorderByTarget reordered no "
          "batch")
    check(all(r > 0 for r in facts["removed_by_shard"]),
          f"proxy (a): a shard lost no row to the modules: "
          f"{facts['removed_by_shard']}")
    check(facts["parked_rounds"][facts["added"]] > 0,
          f"proxy (a): dd never parked on the added shard "
          f"{facts['added']}: parked rounds {facts['parked_rounds']}")
    check(facts["committed_at"] is not None and
          facts["lifted_at"] >= facts["committed_at"],
          f"proxy (a): the migration and the lift out of order: {facts}")
    for pid, c in counts.get("reader", {}).items():
        check(bool((c[1:] <= 1).all()), f"proxy (a): the ephemeral reader "
              f"got a {pid} record twice")
    return {"delivered": delivered, "removed": removed,
            "tenant_records": {t: sum(int(c[1:].sum()) for c in
                                      counts[f"tenant-{t}"].values())
                               for t in TENANTS},
            "reader": sum(int(c[1:].sum())
                          for c in counts.get("reader", {}).values())}


class Progress(threading.Thread):
    """Samples ``sample()`` every half second into ``samples`` (the
    deadline's message shows the last ones when a threaded run
    stalls)."""

    def __init__(self, sample):
        super().__init__(daemon=True)
        self.sample = sample
        self.samples = []
        self.error = None
        self._halt = threading.Event()

    def run(self) -> None:
        t0 = time.perf_counter()
        while not self._halt.wait(0.5):
            try:
                self.samples.append({"s": round(time.perf_counter() - t0,
                                                1), **self.sample()})
            except Exception as exc:     # a sample is a view, never fatal
                self.samples.append({"error": repr(exc)})

    def stop(self) -> None:
        self._halt.set()
        self.join(5)


class ReplayReads:
    """Records the thread of every ``ClusterReplayReader.read`` of the
    cluster module ``cluster_module`` while the context holds: the
    reference's, whose clusters have no router for ``RoutingSites`` to
    wrap."""

    def __init__(self, cluster_module):
        self.module = cluster_module
        self.threads = set()

    def __enter__(self) -> "ReplayReads":
        cls = self.module.ClusterReplayReader
        self._read = read_ = cls.read

        def read(reader, *a, **kw):
            self.threads.add(threading.current_thread().name)
            return read_(reader, *a, **kw)
        cls.read = read
        return self

    def __exit__(self, *exc) -> None:
        self.module.ClusterReplayReader.read = self._read


def run_replay(pkg, records: dict) -> dict:
    """Phase 7b (b): a replay bootstrap from the shard services' threads
    while the distributor routes.  An ``LcapClusterService`` of 4 shards
    with ``proxy_chain``'s modules over the MDT journals of ``records``
    (each with a history tier), routing on ``pkg.kw``'s device in its
    distributor thread; a durable robinhood member and the groups of
    tenants dd and rsync read over ``connect(addresses)`` in threads.
    A ``Feeder`` streams the first half of every journal; once it is
    routed and acknowledged, a ``replay=True`` group scoped to tenant
    cp subscribes over the wire (each shard's handoff watermarks
    recorded) and drains its bootstrap, each history read hashed on the
    thread of the shard service that serves it, while a second
    ``Feeder`` streams the second half and the distributor routes it.
    No topology change."""
    from repro_torch.kernels import stream_ops
    S = pkg.session.Subscription
    mdts = {pid: recs for pid, recs in records.items()
            if pid.startswith("mdt")}
    n = len(next(iter(mdts.values())))
    half = n // 2
    logs = {pid: pkg.llog.Llog(pid, history=True) for pid in mdts}
    cluster = pkg.cluster.LcapCluster(logs, n_shards=N_SHARDS,
                                      n_slots=N_SLOTS, batch_size=BATCH,
                                      modules=proxy_chain(pkg), **pkg.kw)
    svc = pkg.cluster.LcapClusterService(cluster)
    port = hasattr(cluster, "_router")
    # the port's replay reads by the threads that hashed their chunks,
    # the reference's by the threads that called them
    sites = RoutingSites(cluster) if port else ReplayReads(pkg.cluster)
    sessions, consumers, hw = [], [], []
    replay = None
    out = {}

    def subscribe(spec):
        # a session (its sockets) to each consumer thread: one
        # connection carries one request at a time
        sessions.append(pkg.session.connect(list(svc.addresses)))
        return sessions[-1].subscribe(spec)

    def sample() -> dict:
        return {"routed": cluster.stats["routed"],
                "rounds": cluster.stats["routing_rounds"],
                "acked": min(cluster.journal_acked.values()),
                "got": [c.records for c in consumers],
                "replaying": None if replay is None else replay.replaying}

    progress = Progress(sample)
    with sites:
        stream_ops.launches = 0
        svc.start()
        progress.start()
        try:
            consumers.append(WireConsumer(subscribe(S(
                group="robinhood", name="rh", auto_commit=False)), keep=True))
            consumers += [WireConsumer(subscribe(tenant_spec(pkg, t)),
                                       keep=True) for t in ("dd", "rsync")]
            for c in consumers:
                c.start()
            t0 = time.perf_counter()
            first = Feeder(logs, mdts, 0, half)
            first.start()
            wait_for("proxy (b) first half", lambda: (
                first.fed == half and all(
                    cluster.journal_acked[pid] >= half for pid in logs)),
                [first, *consumers], svc, progress, PROXY_DEADLINE_S)
            out["first_half_s"] = time.perf_counter() - t0
            stream = subscribe(tenant_spec(pkg, "cp", replay=True))
            for shard in cluster.shards:
                with shard.proxy._lock:
                    hw.append({pid: w for cons in
                               shard.proxy.consumers.values()
                               if cons.group == "tenant-cp"
                               for pid, w in cons.replay_hw.items()})
            replay = WireConsumer(stream, rows=True)
            second = Feeder(logs, mdts, half, n)
            t1 = time.perf_counter()
            replay.start()
            second.start()
            wait_for("proxy (b) replay and second half", lambda: (
                second.fed == n - half and not replay.replaying
                and trimmed(logs) and all(
                    s.proxy.buffered == 0 for s in cluster.shards)),
                [second, replay, *consumers], svc, progress,
                PROXY_DEADLINE_S)
            out["second_half_s"] = time.perf_counter() - t1
            for c in consumers + [replay]:
                c.stop()
                check(c.error is None, f"proxy (b): a consumer failed: "
                      f"{c.error!r}")
        finally:
            progress.stop()
            for c in consumers + ([replay] if replay else []):
                c.stop()
            for session in sessions:
                session.close()
            svc.stop()
        out["launches"] = stream_ops.launches
    out.update(
        records_per_mdt=n, groups={"robinhood": consumers[0].batches,
                "tenant-dd": consumers[1].batches,
                "tenant-rsync": consumers[2].batches,
                "tenant-cp": replay.batches},
        hw=hw, owner=list(cluster.slot_owner), trimmed=trimmed(logs),
        failure=getattr(svc, "failure", None), stats=dict(cluster.stats),
        removed_by_shard=[s.proxy.stats["dropped_by_modules"]
                          for s in cluster.shards],
        replayed=stream.replayed, distributor=svc._distributor.name,
        read_threads=sorted(sites.threads[0]["replay"] if port
                            else sites.threads),
        samples=progress.samples[-3:])
    if port:
        order = sites.order[0]
        last_round = max((i for i, s in enumerate(order) if s == "round"),
                         default=-1)
        out.update(
            sites={"chunks": sites.total("chunks"),
                   "launches": sites.total("launches")},
            threads={s: sorted(t) for s, t in sites.threads[0].items() if t},
            replay_before_last_round=order[:last_round].count("replay"),
            routing_launches=cluster.routing_launches,
            routing_reads=cluster.routing_reads)
    return out


def verify_replay(run: dict, cols: dict) -> dict:
    """Phase 7b (b)'s checks on one run: robinhood got each record once
    or the modules removed it, the tenant groups robinhood's records in
    their scopes; the replay group no (journal, index) twice, live
    exactly robinhood's records in its scope above each shard's handoff
    watermark, every replayed row in its scope and, hashed again by the
    plain version, on a slot of the shard that served it; replay reads
    on threads other than the distributor's (the port's: the threads
    that hashed its replay chunks, of which there are some, while the
    distributor hashed every routing round); no distributor failure."""
    n = run["records_per_mdt"]
    mdts = {pid: {k: v[:n] for k, v in c.items()}
            for pid, c in cols.items() if pid.startswith("mdt")}
    sizes = {pid: len(c["types"]) for pid, c in mdts.items()}
    counts = {g: delivery_counts([(pid, idx) for _s, pid, idx, *_ in b],
                                 sizes)
              for g, b in run["groups"].items()}
    rh = counts["robinhood"]
    check(run["failure"] is None, f"proxy (b): the distributor failed: "
          f"{run['failure']!r}")
    check(run["trimmed"], "proxy (b): a journal did not trim")
    for pid, c in rh.items():
        check(bool((c[1:] <= 1).all()), f"proxy (b): robinhood got a {pid} "
              "record twice")
    delivered = sum(int((c[1:] > 0).sum()) for c in rh.values())
    removed = sum(run["removed_by_shard"])
    check(delivered + removed == sum(sizes.values()),
          f"proxy (b): robinhood got {delivered} records and the modules "
          f"removed {removed}, not the {sum(sizes.values())} journaled")
    check_tenants("proxy (b)", counts, rh, mdts, ("dd", "rsync"))
    cp = TENANTS.index("cp")
    owner = np.asarray(run["owner"])
    live = {pid: np.zeros(n + 1, dtype=np.int64) for pid, n in sizes.items()}
    replayed = 0
    for shard, pid, idx, fids, jobids in run["groups"]["tenant-cp"]:
        w = run["hw"][shard].get(pid, 0)
        np.add.at(live[pid], idx[idx > w], 1)
        old = idx <= w
        if not old.any():
            continue
        replayed += int(old.sum())
        slots = plain_slots(*(col[old] for col in fids))
        check(bool((owner[slots] == shard).all()),
              f"proxy (b): shard {shard} replayed rows of slots it does not "
              "own")
        check(all(bytes(j[:3]) == b"cp." for j in jobids[old]),
              "proxy (b): the replay group got a replayed row outside its "
              "scope")
    for pid, c in counts["tenant-cp"].items():
        check(bool((c[1:] <= 1).all()), f"proxy (b): the replay group got "
              f"{int((c[1:] > 1).sum())} records of {pid} twice")
        handoff = np.array([w.get(pid, 0) for w in run["hw"]])
        above = np.arange(1, sizes[pid] + 1) > \
            handoff[owner[mdts[pid]["slot"]]]
        want = (rh[pid][1:] > 0) & (mdts[pid]["tenant"] == cp) & above
        check(np.array_equal(live[pid][1:], want.astype(np.int64)),
              f"proxy (b): the replay group got {int(live[pid][1:].sum())} "
              f"live records of {pid}, not once each of the "
              f"{int(want.sum())} in its scope above the handoff")
    check(replayed > 0 and replayed == run["replayed"],
          f"proxy (b): the replay group replayed {replayed} rows, its "
          f"stream counted {run['replayed']}")
    dist = run["distributor"]
    reads = run["read_threads"]
    check(reads and dist not in reads, f"proxy (b): replay reads by "
          f"thread {reads}, the distributor is {dist}")
    if "sites" in run:
        th = run["threads"]
        check(run["sites"]["chunks"]["replay"] > 0, "proxy (b): no replay "
              "chunk was hashed")
        check(th.get("round") == [dist], f"proxy (b): routing rounds hashed "
              f"by {th.get('round')}, not the distributor {dist}")
    return {"delivered": delivered, "removed": removed,
            "replayed": replayed,
            "live": sum(int(c[1:].sum()) for c in live.values())}


def trace_digest(trace) -> str:
    """SHA-256 of a trace (``run_proxy_chain``'s): every field of every
    entry in order, each prefixed by its length."""
    import hashlib
    h = hashlib.sha256()
    for entry in trace:
        for field in entry:
            b = field if isinstance(field, bytes) else str(field).encode()
            h.update(len(b).to_bytes(8, "little"))
            h.update(b)
    return h.hexdigest()


def proxy_chain_on_cpu(arrays: dict) -> dict:
    """``run_proxy_chain`` of the port routing on the CPU over the
    journals ``arrays`` (``proxy_journals``'s: the training hosts' carry
    the clock's time, so they are made once), held to
    ``verify_proxy_chain``: the run phase 7b (a) holds the card's against,
    made in a process of its own meanwhile.  Its trace comes back as
    ``trace_digest``: the batches themselves would take seconds to cross
    to the parent."""
    pkg = port_modules()
    pkg.kw = {"device": "cpu"}
    records = {pid: journal_records(pkg.R, a, 0, len(a[1]))
               for pid, a in arrays.items()}
    run = run_proxy_chain(pkg, records)
    verify_proxy_chain(run, journal_columns(records))
    return dict(run, trace=trace_digest(run["trace"]))


def proxy_phase(seed: int, smi: str, main_rate: float) -> dict:
    """Phase 7b: the whole proxy on the card-routed cluster, (a)
    ``run_proxy_chain`` on the card and, in a spawned process at the
    same time, on the CPU (equal byte for byte) and (b) ``run_replay`` on
    the card, each part's ``fid_slots`` launches counted from 0 and equal
    to its router's chunks, call site by call site."""
    with spawn_pool(1) as pool:
        pool.submit(int)    # the process starts while the journals are made
        return proxy_parts(seed, smi, main_rate, pool)


def proxy_parts(seed: int, smi: str, main_rate: float, pool) -> dict:
    """``proxy_phase``'s parts, (a)'s run on the CPU in ``pool``."""
    from repro_torch.kernels import stream_ops
    pkg = port_modules()
    n, m = PROXY_RECORDS_PER_MDT, PROXY_TRAIN_RECORDS
    t0 = time.perf_counter()
    arrays = proxy_journals(n, m, seed)
    cpu_run = pool.submit(proxy_chain_on_cpu, arrays)
    records = {pid: journal_records(pkg.R, a, 0, len(a[1]))
               for pid, a in arrays.items()}
    cols = journal_columns(records)
    total = sum(len(r) for r in records.values())
    out = {"records_per_mdt": n, "train_records_per_host": m,
           "records": total, "setup_s": time.perf_counter() - t0}
    log(f"proxy: {N_MDTS} MDT journals x {n} records (scratch files) and "
        f"{PROXY_TRAIN_HOSTS} training hosts x {m} generated in "
        f"{out['setup_s']:.3f} s (not timed below)")

    # (a) the module chain and the tenants, card against CPU
    t = time.perf_counter()
    stream_ops.launches = 0
    card = run_proxy_chain(pkg, records)
    launches = stream_ops.launches
    fa = verify_proxy_chain(card, cols)
    check_launches("proxy (a)", card, launches)
    cpu = cpu_run.result()
    ours = dict(card, trace=trace_digest(card["trace"]))
    for key in ("trace", "stats", "routing", "journal_acked", "facts"):
        check(ours[key] == cpu[key], f"proxy (a): {key} differs between "
              "routing on the card and on the CPU")
    facts = card["facts"]
    out["chain"] = {
        "batches": len(card["trace"]), "records_per_s":
        total / card["seconds"], "main_records_per_s": main_rate,
        "card_s": card["seconds"], "cpu_s": cpu["seconds"],
        "removed": facts["removed"],
        "removed_by_shard": facts["removed_by_shard"],
        "delivered": fa["delivered"], "tenant_records": fa["tenant_records"],
        "parked_rounds": facts["parked_rounds"], "added": facts["added"],
        "quota": facts["quota"], "rounds": facts["rounds"],
        "moved_at": facts["moved_at"], "committed_at": facts["committed_at"],
        "lifted_at": facts["lifted_at"], "reader": fa["reader"],
        "reader_drops": facts["reader_drops"], "stats": card["stats"],
        "launches": launches, "routing_reads": card["routing_reads"],
        "launches_by_site": card["sites"]["launches"],
        "seconds": time.perf_counter() - t}
    c = out["chain"]
    log(f"proxy (a) module chain + tenants, card vs CPU: {c['batches']} "
        f"batches (equal SHA-256), stats, epoch, owners and journal acks "
        f"equal; {total} records, {c['records_per_s']:.1f} records/s on the "
        f"card (phase 4: {main_rate:.1f}), card run {c['card_s']:.3f} s, CPU "
        f"run {c['cpu_s']:.3f} s [{smi}]")
    log(f"proxy (a): removed by module {c['removed']}, by shard "
        f"{c['removed_by_shard']}; robinhood {c['delivered']} + removed = "
        f"every record once; tenants {c['tenant_records']}, no record out "
        f"of scope; dd's quota {c['quota']}/s parked rounds by shard "
        f"{c['parked_rounds']} (shard {c['added']} added at round "
        f"{c['moved_at']}, migration committed at {c['committed_at']}, "
        f"quota lifted at {c['lifted_at']}, {c['rounds']} rounds); "
        f"fid_slots launches {launches} = routing chunks by site "
        f"{c['launches_by_site']}")
    del card, cpu

    # (b) replay from the shard services' threads while the distributor
    # routes
    t = time.perf_counter()
    b = run_replay(pkg, {pid: recs[:PROXY_REPLAY_RECORDS_PER_MDT]
                         for pid, recs in records.items()})
    fb = verify_replay(b, cols)
    check_launches("proxy (b)", b, b["launches"])
    check(b["replay_before_last_round"] > 0, "proxy (b): every replay chunk "
          "was hashed after the distributor's last routing chunk: the "
          "bootstrap did not overlap routing")
    out["replay"] = {
        "replayed": fb["replayed"], "live": fb["live"],
        "delivered": fb["delivered"], "removed": fb["removed"],
        "first_half_s": b["first_half_s"],
        "second_half_s": b["second_half_s"],
        "records_per_mdt": PROXY_REPLAY_RECORDS_PER_MDT,
        "records_per_s": N_MDTS * (PROXY_REPLAY_RECORDS_PER_MDT -
                                   PROXY_REPLAY_RECORDS_PER_MDT // 2)
        / b["second_half_s"],
        "replay_threads": b["threads"].get("replay"),
        "distributor": b["distributor"],
        "replay_chunks_before_last_round": b["replay_before_last_round"],
        "launches": b["launches"], "routing_reads": b["routing_reads"],
        "launches_by_site": b["sites"]["launches"],
        "seconds": time.perf_counter() - t}
    r = out["replay"]
    log(f"proxy (b) replay bootstrap of tenant cp over the wire: "
        f"{r['replayed']} rows replayed, hashed on {r['replay_threads']} "
        f"(the distributor is {r['distributor']}), {r['live']} live, no "
        f"(journal, index) twice; {r['replay_chunks_before_last_round']} "
        f"replay chunks hashed before the distributor's last routing chunk; "
        f"second half {r['records_per_s']:.1f} records/s; fid_slots "
        f"launches {r['launches']} = routing chunks by site "
        f"{r['launches_by_site']} [{smi}]")
    out["launches"] = {"chain": out["chain"]["launches"],
                       "replay": out["replay"]["launches"],
                       "replay_by_site": out["replay"]["launches_by_site"]}
    return out

# ------------------------------------------------- phase 3: flash attention
def flash_qkv(case, seed: int, dev):
    """q, k, v of ``case`` from N(0, 1); with a softcap, q times
    ``CAP_Q_SCALE``, so that the scores reach tens and the cap changes
    them (``flash_check`` drops it to prove that)."""
    (B, Sq, Sk, H, KV, D), dtype, _causal, _window, cap = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(s, generator=gen, device=dev)
               for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D)))
    if cap:
        q = q * CAP_Q_SCALE
    return q.to(dt), k.to(dt), v.to(dt)


def visible_span(Sq: int, Sk: int, causal: bool, window: int) -> tuple:
    """The first and last key each query row sees (last < first: none)."""
    q = np.arange(Sq)
    hi = np.minimum(q, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(Sq, int)
    return lo, hi


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(q, k) pairs the mask leaves visible, per batch and head."""
    lo, hi = visible_span(Sq, Sk, causal, window)
    return int(np.maximum(hi - lo + 1, 0).sum())


def masked_rows(Sq: int, Sk: int, causal: bool, window: int) -> np.ndarray:
    """The query rows that see no key at all (their output must be 0)."""
    lo, hi = visible_span(Sq, Sk, causal, window)
    return np.flatnonzero(hi < lo)


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


def takes(kernel: str, case) -> bool:
    """Whether ``kernel`` takes ``case``: the CUDA-core kernel every case,
    the wgmma kernel bf16 with D % 16 == 0."""
    from repro_torch.kernels import flash_attention as fa
    return kernel == fa.SIMT or fa.kernel_for(getattr(torch, case[1]),
                                              case[0][5]) == fa.SM90


def flash_check(kernel: str, case, seed: int, dev) -> float:
    """``kernel`` against the plain version on one case; returns the max
    |difference| and, for each of the case's softcap and window, the
    share of elements beyond the tolerance when the kernel is launched
    without it (a planted fault the check must see: above 0)."""
    from repro_torch.kernels import flash_attention as fa
    shape, dtype, causal, window, cap = case
    q, k, v = flash_qkv(case, seed, dev)
    counter = "launches_sm90" if kernel == fa.SM90 else "launches_simt"
    before = getattr(fa, counter)
    got = fa.launch_kernel(kernel, q, k, v, causal=causal, window=window,
                           cap=cap)
    torch.cuda.synchronize()
    check(getattr(fa, counter) == before + 1,
          f"{kernel} launch count wrong at {case}")
    check(got.shape == q.shape and got.dtype == q.dtype,
          f"{kernel} shape/dtype wrong at {case}")
    want = fa.flash_attention_reference(q, k, v, causal=causal,
                                        window=window, cap=cap)
    tol = FLASH_TOL[dtype]

    def beyond(out):
        return (out.float() - want.float()).abs() > \
            tol + tol * want.float().abs()

    worst = float((got.float() - want.float()).abs().max())
    bad = int(beyond(got).sum())
    check(bad == 0 and bool(torch.isfinite(got).all()),
          f"{kernel} differs from its plain version at {case}: "
          f"{bad} elements beyond rtol=atol={tol}, max |err| {worst}")
    empty = torch.as_tensor(masked_rows(shape[1], shape[2], causal, window),
                            device=dev)
    check(bool((got[:, empty] == 0).all()),
          f"{kernel}: rows with nothing visible are not 0 at {case}")
    caught = {}
    for what, kw in (("cap", {"cap": 0.0}), ("window", {"window": 0})):
        if not (cap if what == "cap" else window):
            continue
        wrong = fa.launch_kernel(kernel, q, k, v, **{
            "causal": causal, "window": window, "cap": cap, **kw})
        caught[what] = float(beyond(wrong).float().mean())
        check(caught[what] > 0,
              f"{kernel} launched without the {what} passes the check at "
              f"{case}: the check cannot see the {what}")
        del wrong
    return worst, caught


def flash_wrapper_check(case, seed: int, dev) -> float:
    """``case`` through ``flash_attention_bshd``: the kernel
    ``kernel_for`` picks, one launch by the wrapper's counters and by
    the kernels' own counts on the card, and the output within the
    tolerance of the plain version; returns the max |difference|."""
    from repro_torch.kernels import flash_attention as fa
    shape, dtype, causal, window, cap = case
    q, k, v = flash_qkv(case, seed, dev)
    kernel = fa.kernel_for(q.dtype, shape[5])
    before = (fa.launches, fa.launches_sm90, fa.launches_simt)
    on_card = {name: fa.device_launches(name) for name in (fa.SM90, fa.SIMT)}
    got = fa.flash_attention_bshd(q, k, v, causal=causal, window=window,
                                  cap=cap)
    sm90 = int(kernel == fa.SM90)
    check((fa.launches, fa.launches_sm90, fa.launches_simt) == (
        before[0] + 1, before[1] + sm90, before[2] + 1 - sm90),
        f"wrapper launch counts wrong at {case}")
    check({name: fa.device_launches(name) - n
           for name, n in on_card.items()} == {fa.SM90: sm90,
                                               fa.SIMT: 1 - sm90},
          f"launches counted on the card wrong at {case}")
    want = fa.flash_attention_reference(q, k, v, causal=causal,
                                        window=window, cap=cap)
    tol = FLASH_TOL[dtype]
    worst = float((got.float() - want.float()).abs().max())
    check(bool(torch.allclose(got.float(), want.float(), rtol=tol,
                              atol=tol)),
          f"{kernel} through the wrapper differs from its plain version at "
          f"{case}: max |err| {worst}")
    log(f"kernels: {list(shape)} {dtype} through flash_attention_bshd: "
        f"kernel_for -> {kernel}, 1 launch by the wrapper and on the card, "
        f"max |err| {worst:.3g}")
    return worst


def attention_binaries(simt_lib, sm90_lib) -> tuple:
    """What ``cuobjdump`` reads in the two attention libraries: the
    CUDA-core one's SASS counts, and the wgmma one's resource usage and
    SASS counts by instance width (a child process's work, beside the
    card's checks and timings)."""
    return (sass_counts(simt_lib), by_instance(resource_usage(sm90_lib)),
            by_instance(sass_counts(sm90_lib)))


def flash_phase(seed: int) -> dict:
    from repro_torch.kernels import _build, flash_attention as fa
    # the libraries' SASS is read in a child process while the card works
    with spawn_pool(1) as pool:
        return flash_checks(seed, pool.submit(
            attention_binaries, _build.library_path(fa.SOURCE),
            _build.library_path(fa.SOURCE_SM90)))


def flash_checks(seed: int, binaries) -> dict:
    """Phase 3's attention half: ``binaries`` is the future of
    ``attention_binaries``."""
    from repro_torch.kernels import flash_attention as fa
    dev = DEVICE
    out = {}
    cases = FLASH_CASES + [FLASH_MAIN, FLASH_MAIN_F32] + FLASH_EXTRA + \
        FLASH_ENCDEC + FLASH_DENSE + [FLASH_GEMMA_NOCAP] + \
        FLASH_SIMT_EDGE + FLASH_SM90_EDGE + [FLASH_MOE_F32, FLASH_VLM_F32]
    #: the shapes timed beside the serving path's, by their key in ``out``
    timed = {"moe_shape": FLASH_MOE, "vlm_shape": FLASH_VLM,
             "enc_shape": FLASH_ENC, "dec_shape": FLASH_DEC,
             "gemma_shape": FLASH_GEMMA,
             "gemma_global_shape": FLASH_GEMMA_GLOBAL,
             "gemma_global_nocap_shape": FLASH_GEMMA_NOCAP,
             "qwen_shape": FLASH_QWEN}
    #: each kernel's own cases: its tile edges, and for the wgmma kernel
    #: gemma2's global layer without the cap (the cap's cost in it)
    own = {fa.SM90: FLASH_SM90_EDGE + [FLASH_GEMMA_NOCAP],
           fa.SIMT: FLASH_SIMT_EDGE}
    errs, caught = {}, {}
    for kernel in (fa.SM90, fa.SIMT):
        worst = {"float32": 0.0, "bfloat16": 0.0}
        other = own[fa.SIMT if kernel == fa.SM90 else fa.SM90]
        taken = [c for c in cases if takes(kernel, c) and c not in other]
        for i, case in enumerate(taken):
            err, caught[kernel, case] = flash_check(kernel, case, seed + i,
                                                    dev)
            worst[case[1]] = max(worst[case[1]], err)
            errs[kernel, case] = err
        main_err = errs[kernel, FLASH_MAIN]
        out[kernel] = {"cases": len(taken), "max_abs_err": main_err,
                       "max_abs_err_float32": worst["float32"],
                       "max_abs_err_bfloat16": worst["bfloat16"]}
        log(f"kernels: {kernel} within tolerance of the plain version at "
            f"{len(taken)} cases (max |err| float32 {worst['float32']:.3g} "
            f"<= 2e-5 rtol+atol, bfloat16 {worst['bfloat16']:.3g} <= 2e-2; "
            f"serving shape {main_err:.3g}; "
            + "; ".join(f"{name} {errs[kernel, case]:.3g}"
                        for name, case in timed.items()
                        if case in taken) + ")")
        log(f"kernels: {kernel} at the non-causal and head_dim 160 cases: "
            + ", ".join(f"{list(c[0])} causal={c[2]} {errs[kernel, c]:.3g}"
                        for c in FLASH_ENCDEC))
        log(f"kernels: {kernel} at gemma2-9b's and qwen2.5-14b's prefill: "
            + ", ".join(f"{list(c[0])} window={c[3]} cap={c[4]:g} "
                        f"{errs[kernel, c]:.3g}" for c in FLASH_DENSE))
        log(f"kernels: {kernel} launched without the softcap or the window "
            f"fails the check (q times {CAP_Q_SCALE:g} where capped; share "
            "of elements beyond the tolerance): "
            + ", ".join(f"{list(c[0])} {c[1]} window={c[3]} cap={c[4]:g} "
                        + " ".join(f"no {w} {f:.4f}"
                                   for w, f in caught[kernel, c].items())
                        for c in taken if caught[kernel, c]))
    for kernel, cases_at in ((fa.SM90, FLASH_SM90_EDGE),
                             (fa.SIMT, FLASH_SIMT_EDGE)):
        log(f"kernels: {kernel} at its tile edges: "
            + ", ".join(f"{list(c[0])} {c[1]} causal={c[2]} window={c[3]} "
                        f"cap={c[4]:g} {errs[kernel, c]:.3g}"
                        for c in cases_at))
    out["bf16_odd_through_wrapper"] = {
        "shape": list(FLASH_BF16_ODD[0]),
        "max_abs_err": flash_wrapper_check(FLASH_BF16_ODD, seed, dev)}
    simt_sass, usage, sass = binaries.result()
    out["sass"] = simt_sass
    log(f"kernels: {fa.SIMT} SASS by cuobjdump, per instance (NOPs left "
        f"out): {json.dumps(simt_sass)}")
    # the wgmma kernel's instances, by width: registers and stack frame
    # (cuobjdump --dump-resource-usage), and spill stores and loads and
    # wgmma instructions in their SASS
    out["instances_sm90"] = {width: {**usage[width], **{
        op: sass[width][op] for op in ("instructions", "registers_named",
                                       "stl", "ldl", "hgmma", "mufu")}}
        for width in sorted(sass, key=int)}
    log(f"kernels: {fa.SM90} instances by width: "
        + "; ".join(f"{w}: {r['registers']} registers at launch, "
                    f"{r['registers_named']} named, stack "
                    f"{r['stack_bytes']} B, {r['stl']} STL / {r['ldl']} LDL, "
                    f"{r['hgmma']} HGMMA, {r['mufu']} MUFU of "
                    f"{r['instructions']} instructions"
                    for w, r in out["instances_sm90"].items()))
    for kernel, t in time_flash(FLASH_MAIN, seed, dev).items():
        out[kernel].update(t)
    for name, case in timed.items():
        kernels = (fa.SM90,) if case in own[fa.SM90] else (fa.SM90, fa.SIMT)
        out[name] = time_flash(case, seed, dev, kernels)
        for kernel in kernels:
            out[name][kernel]["max_abs_err"] = errs[kernel, case]
            out[name][kernel]["planted_faults"] = \
                caught[kernel, case]
    for name, case in FLASH_F32_TIMED.items():
        out[name] = dict(time_simt_float32(case, seed, dev),
                         max_abs_err=errs[fa.SIMT, case])
    return out


def time_simt_float32(case, seed: int, dev) -> dict:
    """The CUDA-core kernel in float32, which only it takes, timed in
    turns with ``scaled_dot_product_attention`` on the same float32
    tensors (TF32 off, as ``main`` sets it), with the plain version's
    time and the bound at the card's float32 CUDA-core rate."""
    from repro_torch.kernels import flash_attention as fa
    (B, S, _Sk, H, KV, D), _dtype, causal, window, cap = case
    q, k, v = flash_qkv(case, seed, dev)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fns = {fa.SIMT: lambda: fa.launch_kernel(fa.SIMT, q, k, v, causal=causal,
                                             window=window, cap=cap),
           "library": lambda: sdpa(qt, kt, vt, is_causal=causal,
                                   enable_gqa=True)}
    want = fa.flash_attention_reference(q, k, v, causal=causal).float()
    lib_err = float((fns["library"]().transpose(1, 2) - want).abs().max())
    del want
    samples = {name: [] for name in fns}
    turns = {name: [] for name in fns}
    for order in (tuple(fns), tuple(fns)[::-1]):
        for name in order:
            times = cuda_times_ms(fns[name], runs=10)
            samples[name] += times
            turns[name].append(statistics.median(times))
    ms = {name: statistics.median(t) for name, t in samples.items()}
    plain_ms = cuda_median_ms(lambda: fa.flash_attention_reference(
        q, k, v, causal=causal), runs=3)
    (bound_ms, bound_by), flops, nbytes = flash_bound_ms(case)
    out = {"ms": ms[fa.SIMT], "turns_ms": turns[fa.SIMT],
           "library_ms": ms["library"], "library_turns_ms": turns["library"],
           "library_call": "scaled_dot_product_attention (float32)",
           "library_max_abs_diff": lib_err, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_rate": FP32_FLOP_PER_S, "flops": flops, "bytes": nbytes,
           "shape": list(case[0]), "dtype": "float32", "causal": causal}
    log(f"kernels: {fa.SIMT} float32 B={B} S={S} H={H} KV={KV} D={D} "
        f"causal={causal}: {ms[fa.SIMT]:.6f} ms (median of 20 launches by "
        f"CUDA events; turn medians {turns[fa.SIMT][0]:.6f} / "
        f"{turns[fa.SIMT][1]:.6f}), {bound_ms / ms[fa.SIMT]:.3f} of its "
        f"bound {bound_ms:.6f} ms ({bound_by} at "
        f"{FP32_FLOP_PER_S / 1e12:g} TFLOP/s float32: {flops / 1e9:.3f} "
        f"GFLOP); scaled_dot_product_attention float32 {ms['library']:.6f} "
        f"ms (max |diff| to the plain version {lib_err:.3g}), plain version "
        f"{plain_ms:.6f} ms")
    del q, k, v, qt, kt, vt, fns
    torch.cuda.empty_cache()
    return out


def time_flash(case, seed: int, dev, kernels=None) -> dict:
    """Both attention kernels (or those in ``kernels``) at one bf16 shape
    (causal or not, windowed and soft-capped as the case says), timed in
    turns with the library
    call that computes the same function on the same tensors (the
    yardstick; the port never calls it), with the plain version's time
    and the bound; one dict per kernel.  The library call is
    ``scaled_dot_product_attention``; with a softcap it is
    ``flex_attention`` (compiled) with the cap as its ``score_mod`` and
    the causal mask and window as its block mask, and SDPA without the
    cap is timed beside it (``sdpa_without_cap_ms``; a window goes to it
    as a dense boolean mask over kv heads repeated to the q heads, which
    takes it off its flash path)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_attention as fa
    (B, S, Sk, H, KV, D), _, causal, window, cap = case
    q, k, v = flash_qkv(case, seed, dev)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window:
        qp = torch.arange(S, device=dev)[:, None]
        kp = torch.arange(Sk, device=dev)[None, :]
        mask = (kp <= qp) & (kp > qp - window)
        kr, vr = (x.repeat_interleave(H // KV, dim=1) for x in (kt, vt))

        def sdpa_call():
            return sdpa(qt, kr, vr, attn_mask=mask)
    else:
        def sdpa_call():
            return sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
    kernels = kernels or (fa.SM90, fa.SIMT)
    fns = {kernel: (lambda kernel=kernel: fa.launch_kernel(
        kernel, q, k, v, causal=causal, window=window, cap=cap))
        for kernel in kernels}
    fns["library"] = flex_call(qt, kt, vt, causal, window, cap) \
        if cap else sdpa_call
    if cap:
        fns["sdpa"] = sdpa_call
    want = fa.flash_attention_reference(q, k, v, causal=causal,
                                        window=window, cap=cap).float()
    lib_err = float((fns["library"]().transpose(1, 2).float() - want)
                    .abs().max())
    del want
    # in turns: wgmma, CUDA cores, library, library, CUDA cores, wgmma;
    # each launch between its own two events, and 20 launches back to back
    # between two events (the host's launch cost then hides behind the card)
    samples = {name: [] for name in fns}
    turns = {name: [] for name in fns}
    b2b = {name: [] for name in fns}
    names = tuple(fns)
    for order in (names, names[::-1]):
        for name in order:
            times = cuda_times_ms(fns[name], runs=20)
            samples[name] += times
            turns[name].append(statistics.median(times))
            b2b[name].append(back_to_back_ms(fns[name], runs=20))
    ms = {name: statistics.median(t) for name, t in samples.items()}
    device_ms = {}
    for kernel in kernels:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fns[kernel]()
            torch.cuda.synchronize()
        device_ms[kernel] = device_busy_ms(prof, kernel) / 10
    plain_ms = cuda_median_ms(
        lambda: fa.flash_attention_reference(q, k, v, causal=causal,
                                             window=window, cap=cap), runs=5)
    (bound_ms, bound_by), flops, nbytes = flash_bound_ms(case)
    yardstick = ("flex_attention (compiled) with the softcap as score_mod"
                 if cap else "scaled_dot_product_attention")
    out = {}
    for kernel in kernels:
        out[kernel] = {
            "ms": ms[kernel], "turns_ms": turns[kernel],
            "back_to_back_ms": b2b[kernel],
            "library_back_to_back_ms": b2b["library"],
            "device_ms": device_ms[kernel], "plain_ms": plain_ms,
            "library_ms": ms["library"],
            "library_call": yardstick,
            "sdpa_without_cap_ms": ms["sdpa"] if cap else None,
            "bound_ms": bound_ms,
            "bound_by": bound_by, "flops": flops, "bytes": nbytes,
            "shape": list(case[0]), "causal": causal, "window": window,
            "cap": cap}
        log(f"kernels: {kernel} bf16 B={B} S={S} H={H} KV={KV} D={D} "
            f"causal={causal} window={window} cap={cap:g}: "
            f"{ms[kernel]:.6f} ms (median of 40 launches by "
            f"CUDA events; turn medians {turns[kernel][0]:.6f} / "
            f"{turns[kernel][1]:.6f} ms; back to back {b2b[kernel][0]:.6f} / "
            f"{b2b[kernel][1]:.6f} ms; {device_ms[kernel]:.6f} ms device "
            f"time by torch.profiler), {bound_ms / ms[kernel]:.3f} of its "
            f"bound, {ms['library'] / ms[kernel]:.3f} x {yardstick}'s "
            f"speed")
    log(f"kernels: attention yardsticks at B={B} S={S} H={H} KV={KV} D={D} "
        f"causal={causal} window={window} cap={cap:g}: "
        f"plain version {plain_ms:.6f} ms, {yardstick} "
        f"{ms['library']:.6f} ms (turn medians {turns['library'][0]:.6f} / "
        f"{turns['library'][1]:.6f}; back to back {b2b['library'][0]:.6f} / "
        f"{b2b['library'][1]:.6f}; max |diff| to the plain version "
        f"{lib_err:.3g}); bound {bound_ms:.6f} ms ({bound_by}: "
        f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB)")
    if cap:
        log(f"kernels: beside it, scaled_dot_product_attention without the "
            f"softcap "
            + ("under a dense boolean mask for the window (off its flash "
               "path) " if window else "(is_causal, on its flash path) ")
            + f"{ms['sdpa']:.6f} ms (turn medians {turns['sdpa'][0]:.6f} / "
            f"{turns['sdpa'][1]:.6f})")
    del q, k, v, qt, kt, vt, sdpa_call, fns
    torch.cuda.empty_cache()
    return out


def flex_call(qt, kt, vt, causal: bool, window: int, cap: float):
    """One compiled ``flex_attention`` call on (B, H, S, D) tensors with
    gemma2's softcap as its ``score_mod`` (after the scale, as the
    kernel's) and the causal mask and window as its block mask: the
    library call that computes the kernel's function where SDPA cannot.
    Returns the call, compiled and warmed up."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    def score_mod(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    def mask_mod(b, h, qi, ki):
        ok = ki <= qi if causal else ki >= 0
        return ok & (ki > qi - window) if window else ok

    block_mask = create_block_mask(mask_mod, None, None, qt.shape[2],
                                   kt.shape[2], device=qt.device)
    flex = torch.compile(flex_attention, dynamic=False)

    def call():
        return flex(qt, kt, vt, score_mod=score_mod, block_mask=block_mask,
                    enable_gqa=True)
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    log(f"kernels: flex_attention compiled and run once in "
        f"{time.perf_counter() - t0:.1f} s")
    return call


# ---------------------------------------------- phase 3: decode attention
def decode_case(tag: str, arch: str, B: int, P: int, G: int,
                layer: str) -> dict:
    """A row of ``DECODE_FAMILIES`` as the decode kernel sees it: the
    shape ``(B, slots, KV, G, D)``, window, ring and softcap of the
    family's config, and the newest position the cache holds."""
    from repro_torch import configs as C
    cfg = C.get_config(arch)
    KV = cfg.n_kv_heads
    window = cfg.sliding_window if layer == "local" else 0
    slots = min(P + G, window) if window else P + G
    return {"tag": tag, "arch": arch, "layer": layer,
            "shape": (B, slots, KV, cfg.n_heads // KV,
                      cfg.resolved_head_dim),
            "window": window, "ring": bool(window) and slots == window,
            "cap": float(cfg.attn_softcap), "last": P + G - 1}


def decode_inputs(case: dict, seed: int, dev, per_sequence: bool):
    """q, the caches (bf16, from N(0, 1); q times ``CAP_Q_SCALE`` with a
    softcap, so that the cap matters) and the positions: every sequence
    at the case's last, or each up to 127 below it."""
    B, S, KV, G, D = case["shape"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(s, generator=gen, device=dev)
               for s in ((B, 1, KV * G, D), (B, S, KV, D), (B, S, KV, D)))
    if case["cap"]:
        q = q * CAP_Q_SCALE
    last = case["last"]
    pos = [max(last - (b * 37) % 128, 0) if per_sequence else last
           for b in range(B)]
    return (q.bfloat16(), k.bfloat16(), v.bfloat16(),
            torch.tensor(pos, dtype=torch.int32, device=dev))


def decode_kw(case: dict) -> dict:
    return dict(window=case["window"], ring=case["ring"], cap=case["cap"])


def decode_splits(case: dict) -> int:
    from repro_torch.kernels import decode_attention as da
    B, S, KV, G, _D = case["shape"]
    return da.splits_for(B, KV, G, S, case["window"])


def decode_check(case: dict, seed: int, dev) -> dict:
    """The kernel at per-sequence positions against its plain version,
    through the wrapper (its own split count) and at one split, within
    ``DECODE_TOL``; with a softcap, launched without it, the share of
    elements beyond that tolerance (must be above 0)."""
    from repro_torch.kernels import decode_attention as da
    q, k, v, pos = decode_inputs(case, seed, dev, per_sequence=True)
    kw, splits = decode_kw(case), decode_splits(case)
    tol = DECODE_TOL["bfloat16"]
    scale = case["shape"][4] ** -0.5
    errs, wants = {}, {}
    for n in (splits, 1):
        got = (da.decode_attention_bshd(q, k, v, pos, **kw) if n == splits
               else da._launch(q, k, v, pos.long(), case["window"],
                               case["ring"], case["cap"], scale, 1))
        wants[n] = da.decode_attention_reference(q, k, v, pos, splits=n,
                                                 **kw).float()
        err = float((got.float() - wants[n]).abs().max())
        check(bool(torch.isclose(got.float(), wants[n], **tol).all()),
              f"decode {case['tag']}: the kernel at {n} splits is "
              f"{err:.3g} from its plain version, beyond {tol}")
        errs[n] = err
    out = {"max_abs_err": errs[splits], "max_abs_err_one_split": errs[1],
           "splits": splits}
    if case["cap"]:
        got = da._launch(q, k, v, pos, case["window"], case["ring"], 0.0,
                         scale, splits).float()
        share = float((~torch.isclose(got, wants[splits], **tol))
                      .float().mean())
        check(share > 0, f"decode {case['tag']}: launched without the "
              "softcap, the kernel still passes the check")
        out["without_cap_share_beyond_tol"] = share
    return out


def time_decode(case: dict, seed: int, dev) -> dict:
    """The wrapper at the case's last position, timed by CUDA events in
    turns with ``scaled_dot_product_attention`` over the same slots (a
    boolean mask, ``enable_gqa``; without the softcap, which it cannot
    take), with the profiler's device time of each kernel, the plain
    version's time, the model's former path's (``attention_core_naive``
    over ``_decode_k_pos``, float32) and the bound: the visible cache,
    q and the output moved once at HBM's rate.  Its ``ms`` is the mean of
    two runs of 50 calls back to back between two events (as a decode
    step enqueues them); ``per_launch_ms``, a call between its own two
    events, adds the host's cost of launching it and the merge."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import layers as L
    q, k, v, pos = decode_inputs(case, seed, dev, per_sequence=False)
    B, S, KV, G, D = case["shape"]
    kw, window, cap = decode_kw(case), case["window"], case["cap"]
    lo, hi = da._visible(pos, S, window, case["ring"])
    slot = torch.arange(S, device=dev)[None, :]
    mask = ((slot >= lo[:, None]) & (slot <= hi[:, None]))[:, None, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fns = {"kernel": lambda: da.decode_attention_bshd(q, k, v, pos, **kw),
           "library": lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                   enable_gqa=True)}
    want = da.decode_attention_reference(q, k, v, pos, splits=1,
                                         **kw).float()
    lib_err = None if cap else float(
        (fns["library"]().transpose(1, 2).float() - want).abs().max())
    samples = {name: [] for name in fns}
    turns = {name: [] for name in fns}
    b2b = {name: [] for name in fns}
    for order in (("kernel", "library"), ("library", "kernel")):
        for name in order:
            times = cuda_times_ms(fns[name], runs=20)
            samples[name] += times
            turns[name].append(statistics.median(times))
            b2b[name].append(back_to_back_ms(fns[name], runs=50))
    per_launch = {name: statistics.median(t) for name, t in samples.items()}
    ms = {name: statistics.mean(t) for name, t in b2b.items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fns["kernel"]()
        torch.cuda.synchronize()
    seen = {"kernel": kernel_count(prof, "decode_attn_kernel"),
            "merge": kernel_count(prof, "decode_attn_merge_kernel")}
    plain_ms = cuda_median_ms(lambda: da.decode_attention_reference(
        q, k, v, pos, splits=decode_splits(case), **kw), runs=5)
    k_pos = L._decode_k_pos(pos, 0, S, S, window)
    former_ms = cuda_median_ms(lambda: L.attention_core_naive(
        q, k, v, pos[:, None], k_pos, causal=True, window=0, cap=cap),
        runs=5)
    visible = int((hi - lo + 1).clamp(min=0).sum())
    nbytes = 2 * D * (2 * KV * visible + 2 * B * KV * G)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {"shape": list(case["shape"]), "dtype": "bfloat16",
           "window": window, "ring": case["ring"], "cap": cap,
           "pos": case["last"], "ms": ms["kernel"],
           "back_to_back_ms": b2b["kernel"],
           "per_launch_ms": per_launch["kernel"],
           "turns_ms": turns["kernel"],
           # a CUDA trace can lose records: each kernel's time over the
           # launches the profiler saw of it (10 calls)
           "device_ms": device_busy_ms(prof, "decode_attn_kernel")
           / max(seen["kernel"], 1),
           "merge_device_ms": device_busy_ms(prof, "decode_attn_merge_kernel")
           / max(seen["merge"], 1),
           "profiled_launches": seen,
           "plain_ms": plain_ms, "former_path_ms": former_ms,
           "library_ms": ms["library"],
           "library_back_to_back_ms": b2b["library"],
           "library_per_launch_ms": per_launch["library"],
           "library_call": "scaled_dot_product_attention (enable_gqa, "
                           "boolean mask" + (", without the softcap)"
                                             if cap else ")"),
           "library_max_abs_diff": lib_err,
           "bound_ms": bound_ms, "bound_by": "bytes", "bytes": nbytes,
           "share_of_bound": bound_ms / ms["kernel"]}
    del q, k, v, qt, kt, vt, mask, want, fns
    torch.cuda.empty_cache()
    return out


def decode_split_sweep(case: dict, seed: int, dev) -> dict:
    """The kernel at each of ``DECODE_SPLITS`` at the case's last
    position, 50 launches back to back between two CUDA events (the merge
    included), beside ``splits_for``'s choice."""
    from repro_torch.kernels import decode_attention as da
    q, k, v, pos = decode_inputs(case, seed, dev, per_sequence=False)
    scale = case["shape"][4] ** -0.5
    ms = {n: back_to_back_ms(
        lambda n=n: da._launch(q, k, v, pos, case["window"], case["ring"],
                               case["cap"], scale, n), runs=50)
        for n in DECODE_SPLITS}
    del q, k, v
    torch.cuda.empty_cache()
    return {"shape": list(case["shape"]), "ms_by_splits": ms,
            "splits_for": decode_splits(case),
            "best": min(ms, key=ms.get)}


def decode_phase(seed: int) -> dict:
    """Phase 3's decode half: ``decode_check`` and ``time_decode`` at
    every row of ``DECODE_FAMILIES``, ``decode_split_sweep`` at the
    cell's traffic for the rows of ``DECODE_SWEEP``, and the phase's
    launches by the wrapper's count against the kernel's own."""
    from repro_torch.kernels import decode_attention as da
    dev = DEVICE
    da.launches = 0
    da.device_launches(reset=True)
    out = {"cases": {}}
    for i, row in enumerate(DECODE_FAMILIES):
        case = decode_case(*row)
        r = dict(decode_check(case, seed + i, dev), arch=case["arch"],
                 layer=case["layer"])
        r.update(time_decode(case, seed + i, dev))
        out["cases"][case["tag"]] = r
        log(f"kernels: decode_attn_kernel at {case['tag']} ({case['arch']}, "
            f"{case['layer']} layer) B={r['shape'][0]} S={r['shape'][1]} "
            f"KV={r['shape'][2]} G={r['shape'][3]} D={r['shape'][4]} "
            f"window={r['window']} ring={r['ring']} cap={r['cap']:g} "
            f"pos={r['pos']}, {r['splits']} splits: {r['ms']:.6f} ms "
            f"(CUDA events, 50 calls back to back, twice: "
            f"{r['back_to_back_ms'][0]:.6f} / {r['back_to_back_ms'][1]:.6f};"
            f" a call between its own events {r['per_launch_ms']:.6f}, turn "
            f"medians {r['turns_ms'][0]:.6f} / {r['turns_ms'][1]:.6f}; "
            f"profiler: kernel {r['device_ms']:.6f}, merge "
            f"{r['merge_device_ms']:.6f}, launches seen of 10 "
            f"{r['profiled_launches']}), bound {r['bound_ms']:.6f} ms by "
            f"bytes ({r['bytes'] / 1e6:.3f} MB), {r['share_of_bound']:.3f} "
            f"of it; plain version {r['plain_ms']:.6f} ms, former path "
            f"{r['former_path_ms']:.6f} ms, {r['library_call']} "
            f"{r['library_ms']:.6f} ms back to back "
            f"({r['library_per_launch_ms']:.6f} a call; max |diff| to the "
            "plain version "
            f"{r['library_max_abs_diff']}); max |err| to the plain version "
            f"{r['max_abs_err']:.3g} ({r['max_abs_err_one_split']:.3g} at "
            f"one split)"
            + (f"; without the softcap {r['without_cap_share_beyond_tol']:.4f}"
               " of elements beyond the tolerance" if r["cap"] else ""))
    out["split_sweep"] = {}
    for tag, arch in DECODE_SWEEP:
        sw = decode_split_sweep(decode_case(tag, arch, 32, 4096, 128,
                                            "global"), seed, dev)
        out["split_sweep"][tag] = sw
        log(f"kernels: decode_attn_kernel by split count at {tag} "
            f"({arch}, {sw['shape']}), ms back to back: "
            + ", ".join(f"{n} {t:.6f}" for n, t in sw["ms_by_splits"].items())
            + f"; splits_for {sw['splits_for']}, best {sw['best']}")
    on_card = da.device_launches()
    check(on_card == da.launches, f"decode phase: {da.launches} launches by "
          f"the wrapper's count, {on_card} by the kernel's own")
    out.update({"launches": da.launches, "device_launches": on_card})
    log(f"kernels: decode_attn_kernel launches in the phase: {da.launches} "
        f"by the wrapper, {on_card} counted on the card")
    return out


# ------------------------------------------------------------ phase 5: serve
def serve_phase(seed: int, smi: str) -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as S
    from repro_torch.models import transformer as T
    cfg, params, res = family_params(SERVE_ARCH, seed, "serve")
    dev, P = DEVICE, SERVE_P
    tokens = S.make_tokens(cfg, SERVE_B, P, seed=seed, device=dev)
    torch.cuda.reset_peak_memory_stats()
    out, launches, slot_launches = serve_family(cfg, params, tokens,
                                                cfg.n_layers, "serve")
    res.update(serve_numbers(out))
    res.update(warm_serve(cfg, params, tokens, res, "serve", smi))
    res.update({"attention_launches": launches,
                "decode_attention_launches":
                    out["decode_attention_launches"],
                "fid_slots_launches": slot_launches,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    log(f"serve: prefill {SERVE_B} x {P} tokens {res['prefill_ms']:.3f} ms "
        f"({res['prompt_tokens_per_s']:.1f} prompt tokens/s), decode "
        f"{res['decode_ms_per_step']:.3f} ms per step over "
        f"{res['decode_steps']} steps ({res['decode_tokens_per_s']:.1f} "
        f"generated tokens/s), {SERVE_B} x {SERVE_G} tokens generated in all "
        f"at {res['generated_tokens_per_s']:.1f} tokens/s; attention "
        f"launches {launches}, fid_slots {slot_launches}; peak memory "
        f"{res['peak_memory_gb']:.3f} GB")
    log(f"serve: invalidation over {SERVE_REPLICAS} replicas: evicted "
        f"{out['evicted_per_replica']}, remaining pages "
        f"{out['remaining_pages']}")
    # the prefill alone, then the same run again, under the profiler
    res.update(profiled_serve(cfg, params, tokens, cfg.n_layers, "serve"))
    res["kernel_share_of_prefill"] = (res["kernel_ms_in_prefill"]
                                      / res["profiled_prefill_ms"])
    log_profiled("serve", res)

    logits = out["prefill_logits"]
    HELD["serve"] = {"logits": logits.float().cpu(),
                     "generated": out["generated"].cpu()}
    with torch.inference_mode():
        naive, _ = T.prefill(params, cfg, tokens, max_seq=P, impl="naive")
        flash_vs_naive = float((logits - naive).abs().max())
        del naive
        torch.cuda.empty_cache()
        check(flash_vs_naive <= LOGIT_ATOL, f"prefill logits with flash and "
              f"naive attention differ by {flash_vs_naive} > {LOGIT_ATOL}")
        # one decode step at position P after a prefill of P tokens, against
        # the last logits of a prefill of P + 1 tokens
        ext = S.make_tokens(cfg, SERVE_B, P + 1, seed=seed + 1, device=dev)
        full, _ = T.prefill(params, cfg, ext, impl="flash")
        _, cache = T.prefill(params, cfg, ext[:, :P],
                             max_seq=P + 1 + DECODE_PROFILE_STEPS,
                             impl="flash")
        pos = torch.full((SERVE_B,), P, dtype=torch.int32, device=dev)
        step, cache = T.decode_step(params, cfg, ext[:, P:], cache, pos)
        decode_vs_prefill = float((step[:, 0] - full).abs().max())
        # decode alone under the profiler: the card's share of a step
        res.update(profiled_decode(cfg, params, step, cache, pos))
        del cache
    check(decode_vs_prefill <= LOGIT_ATOL, f"decode at position {P} "
          f"differs from a {P + 1}-token prefill by {decode_vs_prefill}"
          f" > {LOGIT_ATOL}")
    log(f"serve: decode alone (profiled, {DECODE_PROFILE_STEPS} steps): "
        f"{res['decode_profiled_wall_ms_per_step']:.3f} ms wall per step, "
        f"device busy {res['decode_device_busy_ms_per_step']:.3f} ms per step"
        f" (idle {100 * res['decode_idle_share']:.3f} %); reading the "
        f"weights once takes at least "
        f"{res['weight_bytes'] / HBM_BYTES_PER_S * 1e3:.3f} ms")
    res["phase_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"serve: peak device memory over the whole phase, checks included: "
        f"{res['phase_peak_memory_gb']:.3f} GB")
    log(f"serve: last-position logits, flash vs naive attention: max |diff| "
        f"{flash_vs_naive:.6f} (bound {LOGIT_ATOL}); decode step at "
        f"position {P} vs a {P + 1}-token prefill: max |diff| "
        f"{decode_vs_prefill:.6f} (bound {LOGIT_ATOL}); |logits| up to "
        f"{float(logits.abs().max()):.3f}")
    res.update({"flash_vs_naive_max_abs": flash_vs_naive,
                "decode_vs_prefill_max_abs": decode_vs_prefill,
                "logit_bound": LOGIT_ATOL})
    del params, out, logits
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------ phase 8: train
def train_hp(**kw):
    from repro_torch.runtime.steps import TrainHParams
    return TrainHParams(**dict(TRAIN_HP, **kw))


def drain_trainer(trainer, rounds: int = 50) -> None:
    """Pump the trainer's consumers until every host journal is trimmed
    behind them (checkpoint writes finished first)."""
    trainer.ckpt.wait()
    for _ in range(rounds):
        trainer.pump_consumers()
        if all(t.llog.first_index == t.llog.last_index + 1
               for t in trainer.trackers):
            return
    raise SmokeError("the trainer's journals did not trim behind its "
                     "consumers")


def record_metrics(trainer) -> list:
    """Wrap the trainer's step to keep each step's metrics (read after
    the run, so no extra synchronise)."""
    got, step = [], trainer.train_step

    def wrapped(params, opt, batch):
        out = step(params, opt, batch)
        got.append((opt.step, out[2]))
        return out

    trainer.train_step = wrapped
    return got


def check_train_metrics(hist, got, hp, cfg, tag: str = "train") -> list:
    """Every loss and grad norm finite, the first loss a sensible init's
    (tests/test_models.py: < 2 ln(vocab) + 1), ``lr`` the host
    schedule's; returns the grad norms."""
    from repro_torch.optim.adamw import cosine_lr
    losses = [h["loss"] for h in hist]
    norms = [float(m["grad_norm"]) for _s, m in got]
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"{tag}: losses {losses} or grad norms {norms} not finite")
    check(losses[0] < 2 * np.log(cfg.vocab_size) + 1,
          f"{tag}: first loss {losses[0]} >= 2 ln(vocab) + 1")
    want = [cosine_lr(s, peak=hp.peak_lr, warmup=hp.warmup,
                      total=hp.total_steps) for s, _m in got]
    check([m["lr"] for _s, m in got] == want,
          f"{tag}: lr {[m['lr'] for _s, m in got]} != the schedule's {want}")
    return norms


def train_card_vs_cpu(cfg, batch: int, seq: int, seed: int,
                      extra=None, tag: str = "train") -> dict:
    """One ``build_train_step`` step of ``cfg`` on the card and on the CPU
    from the same fp32 weights (drawn on the CPU) and the same batch
    (the pipeline's tokens and labels, and ``extra``'s keys, host
    tensors): loss and grad norm within ``TRAIN_TOL`` relative, ``lr``
    equal."""
    from repro_torch.data import ShardedTokenPipeline
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import build_train_step
    hp = train_hp()
    data = ShardedTokenPipeline(cfg.vocab_size, seq, batch, 1, 0,
                                seed=seed).batch_at(0)
    data.update(extra or {})
    host = T.init_params(cfg, seed=seed, device="cpu", dtype=torch.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        params = adamw.tree_map(lambda t: t.to(dev, copy=True), host)
        t0 = time.perf_counter()
        _p, _o, m = build_train_step(cfg, hp)(params, adamw.init(params),
                                              data)
        out[dev] = {"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]), "lr": m["lr"],
                    "seconds": time.perf_counter() - t0}
        del params, _p, _o
    card, cpu = out["cuda"], out["cpu"]
    for k in ("loss", "grad_norm"):
        check(abs(card[k] - cpu[k]) <= TRAIN_TOL * abs(cpu[k]),
              f"{tag}: card {k} {card[k]} vs CPU {cpu[k]}: beyond "
              f"{TRAIN_TOL} relative")
    check(card["lr"] == cpu["lr"], f"{tag}: lr {card['lr']} on the card, "
          f"{cpu['lr']} on the CPU")
    return out


def optimizer_ms(trainer, runs: int = 3) -> float:
    """CUDA-event time of one AdamW update (clipping included) over the
    trainer's whole state, on gradients of zeros (the last step freed the
    real ones); it changes the state, so it runs after the checks."""
    from repro_torch.optim import adamw
    grads = adamw.tree_map(torch.zeros_like, trainer.params)
    opt = trainer.opt_state
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _p, opt, _gn = adamw.update(grads, opt, trainer.params, lr=1e-6)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    trainer.opt_state = opt
    return statistics.median(times)


def device_ms_by_class(prof) -> dict:
    """Device time of a CUDA-only profile by kind of kernel: matrix
    products (cuBLAS's ``nvjet``/``gemm``/``cutlass`` kernels),
    elementwise, reductions (softmax, log-sum-exp, norms), the rest."""
    out = {"matmul": 0.0, "elementwise": 0.0, "reduce": 0.0, "other": 0.0}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        name = e.key.lower()
        if any(k in name for k in ("nvjet", "gemm", "cutlass", "xmma")):
            out["matmul"] += us / 1e3
        elif "elementwise" in name:
            out["elementwise"] += us / 1e3
        elif "reduce" in name or "softmax" in name:
            out["reduce"] += us / 1e3
        else:
            out["other"] += us / 1e3
    return out


def top_device_ops(prof, n: int = 8) -> list:
    """The ``n`` operations of a CUDA-only profile with the most device
    time: (name, ms, calls)."""
    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    events = sorted(prof.key_averages(), key=lambda e: -device_us(e))
    return [(e.key, round(device_us(e) / 1e3, 3), e.count)
            for e in events[:n]]


class StepLoop:
    """``build_train_step`` and ``adamw.init`` driven directly, as the
    reference's train cell drives them (``runtime/specs.py::batch_struct``
    adds a family's keys), for a family whose batch the Trainer cannot
    feed: the pipeline's tokens and labels plus ``extras(batch, step)``.
    The attributes ``record_metrics`` and ``optimizer_ms`` read are the
    Trainer's; each step is timed as ``Trainer.run`` times one, to the
    end of its device work, the batches of a ``run`` drawn before its
    first step's clock starts."""

    def __init__(self, cfg, hp, batch: int, seq: int, seed: int, extras):
        from repro_torch.data import ShardedTokenPipeline
        from repro_torch.models import transformer as T
        from repro_torch.optim import adamw
        from repro_torch.runtime.steps import build_train_step
        self.params = T.init_params(cfg, seed=seed, device="cuda",
                                    dtype=torch.float32)
        self.opt_state = adamw.init(self.params)
        self.train_step = build_train_step(cfg, hp)
        self.pipe = ShardedTokenPipeline(cfg.vocab_size, seq, batch, 1, 0,
                                         seed=seed)
        self.batch, self.extras = batch, extras
        self.step = 0
        self.history = []

    def run(self, n_steps: int) -> list:
        batches = [dict(next(self.pipe), **self.extras(self.batch,
                                                       self.step + i))
                   for i in range(n_steps)]
        for batch in batches:
            t0 = time.time()
            self.params, self.opt_state, metrics = self.train_step(
                self.params, self.opt_state, batch)
            torch.cuda.synchronize()
            dt = time.time() - t0
            self.step += 1
            self.history.append({"step": self.step,
                                 "loss": float(metrics["loss"]),
                                 "time": dt})
        return self.history


def frame_extras(cfg, seed: int):
    """An encoder-decoder's frames for ``StepLoop`` and the card-vs-CPU
    step: float32 N(0, 1) embeddings (batch, n_frames, d_model) on the
    host, drawn as the serving launcher draws them (``make_batch``),
    from ``seed + step``."""
    from repro_torch.launch import serve as S

    def extras(batch: int, step: int) -> dict:
        return {"frames": S.make_batch(cfg, batch, 1, seed=seed + step,
                                       device="cpu")["frames"]}
    return extras


def routed_drops(routes, cfg, seq: int) -> dict:
    """The share of (token, k) slots that a training step's routing
    (``RouteLog`` calls) dropped at the capacity of ``seq`` tokens, over
    every routed call: a layer recomputed in the backward pass routes
    its same input again."""
    from repro_torch.models import layers as L
    dropped = [int((~keep).sum()) for _e, keep in routes.calls]
    slots = routes.calls[0][1].numel()
    return {"capacity": L.moe_capacity(cfg, seq),
            "routed_calls": len(dropped),
            "dropped_share": sum(dropped) / (slots * len(dropped)),
            "dropped_share_min_max": [min(dropped) / slots,
                                      max(dropped) / slots]}


def encoder_layer_params(cfg) -> int:
    """Parameters of an encoder-decoder's encoder layers."""
    from repro_torch.models import transformer as M
    sizes = []
    M._walk(M.param_layout(cfg)["enc_layers"],
            lambda _path, leaf: sizes.append(int(np.prod(leaf[0]))))
    return sum(sizes)


def restart_probe(probe, tag: str, seed: int, batch: int, seq: int) -> dict:
    """Phase 8 (b): a Trainer of ``probe`` checkpoints at step 3, and a
    new one resumes there with an equal step 4 loss; checkpoint bytes,
    the host snapshot's, write's and restore's seconds, and the
    operations that have no deterministic version."""
    import tempfile
    import warnings
    from repro_torch.checkpoint import ckpt as ckpt_mod
    from repro_torch.runtime.train_loop import Trainer
    hp = train_hp()
    timing = {"snapshot_s": 0.0, "write_s": 0.0}
    save = ckpt_mod.save_checkpoint

    def timed_save(*a, **kw):
        t = time.perf_counter()
        paths = save(*a, **kw)
        timing["write_s"] += time.perf_counter() - t
        return paths

    torch.use_deterministic_algorithms(True, warn_only=True)
    ckpt_mod.save_checkpoint = timed_save
    try:
        with tempfile.TemporaryDirectory() as wd, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            kw = dict(workdir=wd, hp=hp, global_batch=batch,
                      seq_len=seq, n_hosts=TRAIN_HOSTS, ckpt_every=3,
                      seed=seed, device="cuda")
            first = Trainer(probe, **kw)
            tree = first.checkpoint_tree

            def timed_tree():
                t = time.perf_counter()
                out_tree = tree()
                timing["snapshot_s"] += time.perf_counter() - t
                return out_tree

            first.checkpoint_tree = timed_tree
            h1 = first.run(4)
            drain_trainer(first)
            check(first.committer.latest_committed() == 3,
                  f"{tag}: committed {first.committer.latest_committed()}, "
                  "not 3")
            ck_dir = Path(wd) / "ckpt"
            ckpt_bytes = sum(f.stat().st_size for f in ck_dir.iterdir()
                             if f.name.startswith("step-00000003"))
            first.close()
            del first
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            second = Trainer(probe, **kw)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            check(second.step == 3 and all(p.step == 3
                                           for p in second.pipes),
                  f"{tag}: resumed at step {second.step}, pipes at "
                  f"{[p.step for p in second.pipes]}, not 3")
            check(second.committer.latest_committed() == 3,
                  f"{tag}: the restarted committer does not see step 3")
            h2 = second.run(1)
            drain_trainer(second)
            second.close()
            del second
            nondet = sorted({str(w.message).split(".")[0] for w in caught
                             if "deterministic" in str(w.message)})
    finally:
        ckpt_mod.save_checkpoint = save
        torch.use_deterministic_algorithms(False)
    check(h2[0]["step"] == 4 and h2[0]["loss"] == h1[3]["loss"],
          f"{tag}: the resumed step 4 loss {h2[0]['loss']} != the first "
          f"run's {h1[3]['loss']}")
    log(f"{tag}: restart probe ({TRAIN_PROBE_LAYERS} layers at full width):"
        f" checkpoint at step 3 {ckpt_bytes} bytes, host snapshot "
        f"{timing['snapshot_s']:.3f} s, write {timing['write_s']:.3f} s "
        f"(off the training thread), restart and restore {restore_s:.3f} s;"
        f" resumed at step 3, step 4 loss {h2[0]['loss']!r} = the first "
        f"run's; ops without a deterministic version: {nondet or 'none'}")
    return {"layers": TRAIN_PROBE_LAYERS,
            "losses": [h["loss"] for h in h1],
            "resumed_step4_loss": h2[0]["loss"],
            "checkpoint_bytes": ckpt_bytes,
            "snapshot_s": timing["snapshot_s"],
            "write_s": timing["write_s"], "restore_s": restore_s,
            "nondeterministic_ops": nondet}


def train_phase(seed: int, smi: str) -> dict:
    from repro_torch import configs as C
    return train_run(C.get_config(TRAIN_ARCH), "train", seed, smi)


def train_family_phase(cfg, tag: str, seed: int, smi: str, **kw) -> dict:
    """Phases 8a-8c: ``train_run`` of another family at full width and
    depth (an encoder-decoder with its frames, ``frame_extras``), and
    each attention kernel's and ``fid_slots``'s launches in the phase,
    which must be 0."""
    from repro_torch.kernels import flash_attention as fa, stream_ops
    before = (stream_ops.launches, fa.launches_sm90, fa.launches_simt)
    if cfg.is_encoder_decoder:
        kw["extras"] = frame_extras(cfg, seed)
        log(f"{tag}: {cfg.arch_id}: {cfg.n_encoder_layers} encoder layers "
            f"over {cfg.n_frames} float32 N(0, 1) frames a clip and "
            f"{cfg.n_layers} decoder layers")
    out = train_run(cfg, tag, seed, smi, **kw)
    out["launches_by_kernel"] = dict(zip(
        ("fid_slots", fa.SM90, fa.SIMT),
        (n - b for n, b in zip((stream_ops.launches, fa.launches_sm90,
                                fa.launches_simt), before))))
    log(f"{tag}: kernel launches in the phase {out['launches_by_kernel']}")
    check(not any(out["launches_by_kernel"].values()),
          f"{tag}: kernel launches {out['launches_by_kernel']}")
    name, ms, calls = out["top_device_ops_ms"][0]
    log(f"{tag}: {cfg.arch_id} step {out['step_ms_median']:.3f} ms, "
        f"{out['tokens_per_s']:.1f} tokens/s, model-FLOP share "
        f"{100 * out['model_flop_share_bf16']:.3f} %, idle "
        f"{100 * out['idle_share']:.3f} % of the profiled step, peak "
        f"memory {out['peak_memory_gb']:.3f} GB; top device operation "
        f"{name[:60]!r} {ms} ms in {calls} calls [{smi}]")
    return out


def train_run(cfg, tag: str, seed: int, smi: str, *,
              batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ, extras=None,
              cpu_batch: int = TRAIN_CPU_BATCH,
              cpu_seq: int = TRAIN_CPU_SEQ) -> dict:
    """Phase 8's recipe for ``cfg``, its lines and checks named by
    ``tag``: (a) ``batch`` x ``seq`` tokens a step through the
    ``Trainer`` on the card, 2 hosts' activity feeding MetricsDB, then
    (b) the restart probe and (c) one step on the card against the CPU
    at ``cpu_batch`` x ``cpu_seq``, both at TRAIN_PROBE_LAYERS layers.
    With ``extras`` (a family's batch keys past tokens and labels,
    ``extras(batch, step)``), which the Trainer does not feed, (a) drives
    ``build_train_step`` directly (``StepLoop``), with no MetricsDB
    and no restart probe."""
    import contextlib
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import records as T
    from repro_torch.kernels import flash_attention as fa, stream_ops
    from repro_torch.models import transformer as M
    from repro_torch.runtime.train_loop import Trainer
    n_params = M.count_params(cfg)
    torch.cuda.empty_cache()
    total_b = torch.cuda.get_device_properties(0).total_memory
    state_b = TRAIN_STATE_BYTES_PER_PARAM * n_params
    log(f"{tag}: {cfg.arch_id} at full width and depth ({cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
        f"heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}): {n_params} "
        f"parameters; fp32 parameters, gradients, m and v "
        f"{state_b / 1e9:.3f} GB of the card's {total_b / 1e9:.3f} GB, "
        f"{(total_b - state_b) / 1e9:.3f} GB left for activations and "
        f"workspace; {torch.cuda.memory_allocated() / 1e9:.3f} GB still "
        f"allocated by earlier phases")
    check(state_b < total_b, f"{tag}: the optimizer state does not fit")
    hp = train_hp()
    tokens = batch * seq
    slots0, flash0 = stream_ops.launches, fa.launches
    out = {"arch": cfg.arch_id, "params": n_params, "layers": cfg.n_layers,
           "global_batch": batch, "seq_len": seq,
           "hp": dict(hp._asdict()), "state_gb": state_b / 1e9}
    # a MoE step's routing, kept over the profiled step
    routes = RouteLog() if cfg.n_experts else contextlib.nullcontext()

    # (a) full width and depth, the consumers attached
    with tempfile.TemporaryDirectory() as wd:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if extras is None:
            trainer = Trainer(cfg, workdir=wd, hp=hp, global_batch=batch,
                              seq_len=seq, n_hosts=TRAIN_HOSTS,
                              ckpt_every=10 ** 9, seed=seed, device="cuda")
        else:
            trainer = StepLoop(cfg, hp, batch, seq, seed, extras)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        got = record_metrics(trainer)
        trainer.run(TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS)
        with profile(activities=[ProfilerActivity.CUDA]) as prof, routes:
            hist = trainer.run(1)
        prof_ms = hist[-1]["time"] * 1e3
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        norms = check_train_metrics(hist, got, hp, cfg, tag)
        opt_ms = optimizer_ms(trainer)
        rows = None
        if extras is None:
            drain_trainer(trainer)
            n_steps = len(hist)
            rows = dict(trainer.metrics[0].query(
                "SELECT type, COUNT(*) FROM events GROUP BY type"))
            want = {t: n_steps * TRAIN_HOSTS for t in (
                T.CL_STEP_COMMIT, T.CL_HEARTBEAT, T.CL_DATA_CONSUME)}
            check(rows == want, f"{tag}: MetricsDB rows by type {rows}, "
                  f"the steps x hosts imply {want}")
            trainer.close()
        del trainer
    timed = [h["time"] for h in hist[TRAIN_WARMUP_STEPS:-1]]
    step_s = statistics.median(timed)
    busy_ms = device_busy_ms(prof)
    by_class = device_ms_by_class(prof)
    top = top_device_ops(prof)
    out.update({
        "init_s": init_s, "losses": [h["loss"] for h in hist],
        "grad_norms": norms, "lrs": [m["lr"] for _s, m in got],
        "step_ms": [t * 1e3 for t in timed], "step_ms_median": step_s * 1e3,
        "tokens_per_s": tokens / step_s,
        "model_flop_share_bf16": M.model_flops_per_token(cfg) * tokens
        / step_s / BF16_FLOP_PER_S,
        "profiled_step_ms": prof_ms, "device_busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / prof_ms, "peak_memory_gb": peak_gb,
        "optimizer_ms": opt_ms, "device_ms_by_class": by_class,
        "top_device_ops_ms": top, "metricsdb_rows": rows})
    log(f"{tag}: {batch} x {seq} tokens a step, n_micro "
        f"{hp.n_micro}, remat {hp.remat_policy!r}, {hp.attn_impl} attention;"
        f" step {out['step_ms_median']:.3f} ms (median of "
        f"{TRAIN_TIMED_STEPS} after {TRAIN_WARMUP_STEPS} warm-up: "
        f"{', '.join(f'{t:.3f}' for t in out['step_ms'])}), "
        f"{out['tokens_per_s']:.1f} tokens/s, model FLOPs "
        f"(6 N tokens / step) {100 * out['model_flop_share_bf16']:.3f} % of "
        f"the bf16 dense peak (989 TFLOP/s) [{smi}]")
    log(f"{tag}: profiled step {prof_ms:.3f} ms wall, device busy "
        f"{busy_ms:.3f} ms (idle {100 * out['idle_share']:.3f} %), by kind "
        f"of kernel (ms): {', '.join(f'{k} {v:.3f}' for k, v in by_class.items())}"
        f"; one AdamW update alone {opt_ms:.3f} ms by events; peak memory "
        f"{peak_gb:.3f} GB; init {init_s:.3f} s [{smi}]")
    log(f"{tag}: top device operations (ms, calls): "
        f"{[(name[:60], ms, n) for name, ms, n in top]}")
    if cfg.n_experts:
        out.update(routed_drops(routes, cfg, seq))
        log(f"{tag}: the profiled step's routing at capacity "
            f"{out['capacity']} slots per expert and row dropped "
            f"{100 * out['dropped_share']:.4f} % of its (token, k) slots "
            f"(over {out['routed_calls']} routed calls, recomputes "
            f"included; by call from "
            f"{100 * out['dropped_share_min_max'][0]:.4f} to "
            f"{100 * out['dropped_share_min_max'][1]:.4f} %); the gradient "
            f"flows through kept slots only")
    if cfg.is_encoder_decoder:
        enc = encoder_layer_params(cfg)
        frames = batch * cfg.n_frames
        out.update({"encoder_layer_params": enc, "frames": frames,
                    "model_flop_share_bf16_with_frames":
                    (6.0 * enc * frames + 6.0 * (n_params - enc) * tokens)
                    / step_s / BF16_FLOP_PER_S})
        log(f"{tag}: with the encoder's frames (6 x {enc} encoder-layer "
            f"parameters x {frames} frames + 6 x the other "
            f"{n_params - enc} x {tokens} tokens) the model FLOPs are "
            f"{100 * out['model_flop_share_bf16_with_frames']:.3f} % of the "
            f"bf16 dense peak [{smi}]")
    if extras is None:
        log(f"{tag}: losses {out['losses']}, grad norms {norms}; MetricsDB "
            f"rows {rows}; journals trimmed behind the consumers")
    else:
        log(f"{tag}: losses {out['losses']}, grad norms {norms}; no "
            "MetricsDB rows and no restart probe: the reference's Trainer "
            "feeds only the pipeline's tokens and labels "
            "(src/repro/runtime/train_loop.py:113-116), so these steps "
            "went through build_train_step directly")

    # (b) restart probe: full width, TRAIN_PROBE_LAYERS layers
    probe = cfg.replace(n_layers=TRAIN_PROBE_LAYERS, n_encoder_layers=min(
        cfg.n_encoder_layers, TRAIN_PROBE_LAYERS))
    out["restart"] = None if extras else restart_probe(probe, tag, seed,
                                                       batch, seq)

    # (c) the same step on the card and on the CPU
    cmp_ = train_card_vs_cpu(probe, cpu_batch, cpu_seq, seed,
                             extras and extras(cpu_batch, 0), tag)
    out["card_vs_cpu"] = cmp_
    log(f"{tag}: one step of the probe config at {cpu_batch} x "
        f"{cpu_seq} tokens, card vs CPU: loss {cmp_['cuda']['loss']} /"
        f" {cmp_['cpu']['loss']}, grad norm {cmp_['cuda']['grad_norm']} / "
        f"{cmp_['cpu']['grad_norm']}, lr {cmp_['cuda']['lr']} (within "
        f"{TRAIN_TOL} relative)")
    out["launches"] = {"fid_slots": stream_ops.launches - slots0,
                       "flash_attention": fa.launches - flash0}
    check(out["launches"] == {"fid_slots": 0, "flash_attention": 0},
          f"{tag}: kernel launches {out['launches']}: training runs neither "
          "TPU kernel's port")
    return out


# ------------------------------------------- phases 9 and 10: MoE and SSD
class RouteLog:
    """While active, keeps each MoE layer's routing (``top_e``, ``keep``
    from ``layers.moe_route``) in call order.  With ``replay``, call i
    routes to ``replay[i]``'s experts instead of the router's own top-k,
    weighted by its own probabilities (a check's instrument: the same
    computation with the routing of another run)."""

    def __init__(self, replay=None):
        self.calls = []
        self.replay = replay

    def __enter__(self):
        from repro_torch.models import layers as L
        self._real = real = L.moe_route

        def route(p, x, cfg, capacity):
            r = real(p, x, cfg, capacity)
            if self.replay is not None:
                top_e = self.replay[len(self.calls)]
                top_p = r.probs.gather(-1, top_e)
                top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
                pos, keep = L.route_slots(top_e, top_p, cfg.n_experts,
                                          capacity)
                r = r._replace(top_p=top_p, top_e=top_e, pos=pos, keep=keep)
            self.calls.append((r.top_e, r.keep))
            return r

        L.moe_route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as L
        L.moe_route = self._real

    def experts(self):
        return [e for e, _ in self.calls]


def route_flips(a: list, b: list, n_experts: int) -> list:
    """Layer by layer, how many router choices of run ``a`` run ``b``
    did not make on the same tokens."""
    counts = []
    for ea, eb in zip(a, b, strict=True):
        shape = (*ea.shape[:-1], n_experts)
        oh_a = torch.zeros(shape, device=ea.device).scatter_(-1, ea, 1.0)
        oh_b = torch.zeros(shape, device=eb.device).scatter_(-1, eb, 1.0)
        counts.append(int((oh_a > oh_b).sum()))
    return counts


def hold_logits(free: float, replayed: float, flips: list,
                what: str) -> None:
    """``what``'s logits within LOGIT_ATOL with one run replaying the
    other's routes (the same computation but for rounding); free-running
    too, unless route flips account for the excess."""
    check(replayed <= LOGIT_ATOL, f"{what} with the same routes: max |diff|"
          f" {replayed} > {LOGIT_ATOL}")
    check(free <= LOGIT_ATOL or sum(flips) > 0,
          f"{what}: max |diff| {free} > {LOGIT_ATOL} with no route flipped")


def layer_params(lp: dict, device, dtype=torch.float32) -> dict:
    return {k: v.to(device=device, dtype=dtype) for k, v in lp.items()}


def moe_card_vs_cpu(cfg, p: dict, batch: int, seq: int, seed: int) -> dict:
    """One MoE layer (parameters ``p``) in float32 on the card and on the
    CPU, the same seeded input: its routing decisions must be equal and
    its output within MOE_LAYER_TOL (rtol = atol)."""
    from repro_torch.models import layers as L
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, seq, cfg.d_model, generator=gen)
    C = L.moe_capacity(cfg, seq)
    got = {}
    for dev in ("cuda", "cpu"):
        pd, xd = layer_params(p, dev), x.to(dev)
        r = L.moe_route(pd, xd, cfg, C)
        y, aux = L.moe_layer(pd, xd, cfg)
        got[dev] = [t.cpu() for t in (r.top_e, r.pos, r.keep, y, aux)]
        del pd
    (e1, p1, k1, y1, a1), (e0, p0, k0, y0, a0) = got["cuda"], got["cpu"]
    err = (y1 - y0).abs()
    out = {"batch": batch, "seq": seq, "capacity": C,
           "top_e_equal": bool(torch.equal(e1, e0)),
           "pos_equal": bool(torch.equal(p1, p0)),
           "keep_equal": bool(torch.equal(k1, k0)),
           "dropped_share": float((~k0).float().mean()),
           "max_abs_err": float(err.max()),
           "beyond_tol": int((err > MOE_LAYER_TOL
                              + MOE_LAYER_TOL * y0.abs()).sum()),
           "aux_abs_err": float((a1 - a0).abs())}
    out["ok"] = (out["top_e_equal"] and out["pos_equal"] and out["keep_equal"]
                 and out["beyond_tol"] == 0)
    return out


def ssd_card_vs_cpu(cfg, p: dict, batch: int, seq: int, seed: int) -> dict:
    """One SSD layer (parameters ``p``) in float32 on the card and on the
    CPU, the same seeded inputs: the full-sequence output, its cache and
    two decode steps from it within SSD_LAYER_TOL (rtol = atol)."""
    from repro_torch.models import ssd as SSD
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, seq, cfg.d_model, generator=gen)
    steps = [torch.randn(batch, 1, cfg.d_model, generator=gen)
             for _ in range(2)]
    got = {}
    for dev in ("cuda", "cpu"):
        pd = layer_params(p, dev)
        y, cache = SSD.ssd_layer(pd, x.to(dev), cfg, return_cache=True)
        outs = [y, cache["conv"].clone(), cache["state"].clone()]
        for t in steps:
            outs.append(SSD.ssd_decode(pd, t.to(dev), cache, cfg)[0])
        outs += [cache["conv"], cache["state"]]
        got[dev] = [t.cpu() for t in outs]
        del pd
    names = ("output", "conv", "state", "decode 1", "decode 2",
             "conv after", "state after")
    errs = {n: float((a - b).abs().max())
            for n, a, b in zip(names, got["cuda"], got["cpu"])}
    bad = sum(int(((a - b).abs() > SSD_LAYER_TOL + SSD_LAYER_TOL * b.abs())
                  .sum()) for a, b in zip(got["cuda"], got["cpu"]))
    return {"batch": batch, "seq": seq, "max_abs_err": errs,
            "beyond_tol": bad, "ok": bad == 0}


class MaskTally:
    """While active, counts the calls of the attention kernel's wrapper
    from the model (``kernels.ops``) by its ``causal`` argument and by
    its ``window``."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.calls = {True: 0, False: 0}
        self.windows: dict = {}
        self._real = real = ops.flash_attention_bshd

        def wrapper(*args, **kw):
            self.calls[bool(kw["causal"])] += 1
            window = int(kw["window"])
            self.windows[window] = self.windows.get(window, 0) + 1
            return real(*args, **kw)

        ops.flash_attention_bshd = wrapper
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.flash_attention_bshd = self._real


def serve_family(cfg, params, tokens, n_attn: int, tag: str, extras=None,
                 n_noncausal: int = 0, windows=None):
    """Phase 5's serving run for another family: launches of each
    attention kernel counted from 0 (``n_attn`` wgmma launches, one per
    attention layer, ``n_noncausal`` of them without a causal mask, by
    window as ``windows`` maps a window to its calls (all of them with
    none by default), and none of the CUDA-core kernel) and of the
    ``fid_slots`` kernel (none: serving routes no records), launches of
    the decode kernel counted from 0 by the wrapper and on the card (one
    per causal attention layer a decode step), finite logits, well-formed
    tokens and phase 5's invalidation counts.  Returns the run's output
    (with ``decode_attention_launches``), the attention launches by
    kernel and the ``fid_slots`` launches."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa, stream_ops
    from repro_torch.launch import serve as S
    fa.launches = fa.launches_sm90 = fa.launches_simt = 0
    stream_ops.launches = 0
    da.launches = 0
    da.device_launches(reset=True)
    with MaskTally() as masks:
        out = S.serve(cfg, params, tokens, extras=extras, gen_len=SERVE_G,
                      replicas=SERVE_REPLICAS)
    launches = {fa.SM90: fa.launches_sm90, fa.SIMT: fa.launches_simt}
    slots = stream_ops.launches
    check(launches == {fa.SM90: n_attn, fa.SIMT: 0} and
          fa.launches == n_attn, f"{tag}: attention launches {launches}, "
          f"not {n_attn} of {fa.SM90} and none of {fa.SIMT}")
    check(masks.calls[False] == n_noncausal and
          masks.calls[True] == n_attn - n_noncausal,
          f"{tag}: attention calls by causal mask {masks.calls}, not "
          f"{n_noncausal} without one")
    windows = windows or ({0: n_attn} if n_attn else {})
    check(masks.windows == windows, f"{tag}: attention calls by window "
          f"{masks.windows}, not {windows}")
    # every call went to the wgmma kernel (checked above)
    out["noncausal_launches"] = {fa.SM90: masks.calls[False], fa.SIMT: 0}
    out["launches_by_window"] = {fa.SM90: masks.windows, fa.SIMT: {}}
    check(slots == 0, f"{tag}: {slots} fid_slots launches while serving")
    decode = {"wrapper": da.launches, "on_card": da.device_launches()}
    per_step = n_attn - n_noncausal
    want = per_step * out["decode_steps"]
    check(decode == {"wrapper": want, "on_card": want},
          f"{tag}: decode-kernel launches {decode}, not {want} "
          f"({per_step} self-attention layers x {out['decode_steps']} steps)")
    out["decode_attention_launches"] = decode
    logits, gen = out["prefill_logits"], out["generated"]
    B = tokens.shape[0]
    check(bool(torch.isfinite(logits).all()), f"{tag}: logits not finite")
    check(tuple(gen.shape) == (B, SERVE_G) and
          bool(((gen >= 0) & (gen < cfg.vocab_size)).all()),
          f"{tag}: generated tokens malformed: {tuple(gen.shape)}")
    # the launcher's admin write changes prompt 2: cached where B > 2
    evicted = int(B > 2)
    check(out["evicted_per_replica"] == [evicted] * SERVE_REPLICAS,
          f"{tag}: evicted_per_replica {out['evicted_per_replica']}")
    check(out["remaining_pages"] == [B - evicted] * SERVE_REPLICAS,
          f"{tag}: remaining_pages {out['remaining_pages']}")
    return out, launches, slots


def serve_numbers(out, prompt_len: int = SERVE_P) -> dict:
    """One serving call's times and rates."""
    steps = out["decode_steps"]
    B = out["generated"].shape[0]
    return {"prefill_ms": out["prefill_s"] * 1e3,
            "prompt_tokens_per_s": B * prompt_len / out["prefill_s"],
            "decode_ms_per_step": out["decode_s"] * 1e3 / steps,
            "decode_tokens_per_s": B * steps / out["decode_s"],
            "generated_tokens_per_s": B * SERVE_G
            / (out["prefill_s"] + out["decode_s"]),
            "decode_steps": steps,
            "evicted_per_replica": out["evicted_per_replica"],
            "remaining_pages": out["remaining_pages"]}


def warm_serve(cfg, params, tokens, first: dict, tag: str, smi: str,
               extras=None) -> dict:
    """WARM_CALLS more calls of the launcher after a phase's first
    (``first``: that call's ``serve_numbers``), on the same inputs: each
    time and rate becomes the median of the warm calls, the two times
    with their min and max beside them; the first call's times stay
    under ``first_call_*``.  One call can be an outlier, so phase 14's
    one-card shares read these medians."""
    from repro_torch.launch import serve as S
    runs = []
    for _ in range(WARM_CALLS):
        out = S.serve(cfg, params, tokens, extras=extras, gen_len=SERVE_G,
                      replicas=SERVE_REPLICAS)
        runs.append(serve_numbers(out, tokens.shape[1]))
        del out
    res = {"warm_calls": WARM_CALLS,
           "first_call_prefill_ms": first["prefill_ms"],
           "first_call_decode_ms_per_step": first["decode_ms_per_step"]}
    for key in ("prefill_ms", "decode_ms_per_step", "prompt_tokens_per_s",
                "decode_tokens_per_s", "generated_tokens_per_s"):
        res[key] = statistics.median(r[key] for r in runs)
    for key in ("prefill_ms", "decode_ms_per_step"):
        res[key + "_min_max"] = [min(r[key] for r in runs),
                                 max(r[key] for r in runs)]
    log(f"{tag}: {res['warm_calls']} warm calls of the launcher: prefill "
        f"median {res['prefill_ms']:.3f} ms (min-max "
        f"{res['prefill_ms_min_max'][0]:.3f}-"
        f"{res['prefill_ms_min_max'][1]:.3f}; first call "
        f"{res['first_call_prefill_ms']:.3f}), decode median "
        f"{res['decode_ms_per_step']:.3f} ms a step (min-max "
        f"{res['decode_ms_per_step_min_max'][0]:.3f}-"
        f"{res['decode_ms_per_step_min_max'][1]:.3f}; first call "
        f"{res['first_call_decode_ms_per_step']:.3f}) [{smi}]")
    return res


def profiled_serve(cfg, params, tokens, n_attn: int, tag: str,
                   extras=None) -> dict:
    """The launcher's prefill alone under the profiler (its device time
    and its attention kernels by name), then the whole serving run again
    under another (device busy against wall, by kind of kernel).  The
    prefill's attention launches are held three ways: by the wrapper's
    counters, by the counts the kernels keep of themselves on the card
    (``n_attn`` of the wgmma kernel, none of the CUDA-core one, exactly),
    and by the profiler's kernel names.  A CUDA trace may lose a record
    (one of the 40 wgmma records of pixtral-12b's prefill went missing
    once, and one of some 30,000 in a profile of a whole serving run,
    while both other counts were exact), so the names must show the
    wgmma kernel (if ``n_attn`` > 0), at most ``n_attn`` times, and no
    CUDA-core kernel."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as S
    from repro_torch.runtime.steps import build_prefill_step
    prefill = build_prefill_step(cfg, max_seq=tokens.shape[1] + SERVE_G,
                                 attn_impl="flash")
    want = {fa.SM90: n_attn, fa.SIMT: 0}
    for name in want:
        fa.device_launches(name, reset=True)
    fa.launches = fa.launches_sm90 = fa.launches_simt = 0
    torch.cuda.synchronize()
    with torch.inference_mode(), \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(params, {"tokens": tokens, **(extras or {})})
        torch.cuda.synchronize()
        prefill_wall_ms = (time.perf_counter() - t0) * 1e3
    counted = {fa.SM90: fa.launches_sm90, fa.SIMT: fa.launches_simt}
    on_card = {name: fa.device_launches(name) for name in want}
    seen = {name: kernel_count(prof, name) for name in want}
    check(counted == want and on_card == want,
          f"{tag}: the profiled prefill's attention launches: by the "
          f"wrapper {counted}, counted on the card {on_card}, want {want}")
    check(seen[fa.SM90] <= n_attn and (seen[fa.SM90] > 0) == (n_attn > 0)
          and seen[fa.SIMT] == 0,
          f"{tag}: the profiled prefill's attention kernels by name: {seen}"
          f", counted on the card {on_card}")
    out = {"profiled_prefill_ms": prefill_wall_ms,
           "prefill_device_busy_ms": device_busy_ms(prof),
           "prefill_idle_share": 1 - device_busy_ms(prof) / prefill_wall_ms,
           "prefill_device_ms_by_class": device_ms_by_class(prof),
           "prefill_top_device_ops_ms": top_device_ops(prof),
           "kernel_ms_in_prefill": device_busy_ms(prof, fa.SM90),
           "profiled_kernel_launches": seen,
           "device_counted_launches": on_card}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        S.serve(cfg, params, tokens, extras=extras, gen_len=SERVE_G,
                replicas=SERVE_REPLICAS)
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = device_busy_ms(prof)
    out.update({"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "idle_share": 1 - busy_ms / wall_ms,
                "device_ms_by_class": device_ms_by_class(prof),
                "top_device_ops_ms": top_device_ops(prof)})
    return out


def log_profiled(tag: str, res: dict) -> None:
    log(f"{tag} (profiled prefill alone): {res['profiled_prefill_ms']:.3f} "
        f"ms wall, device busy {res['prefill_device_busy_ms']:.3f} ms, of "
        f"which the wgmma kernel {res['kernel_ms_in_prefill']:.3f} ms; "
        f"kernels by name {res['profiled_kernel_launches']}, counted on the "
        f"card {res['device_counted_launches']}")
    pre = res["prefill_device_ms_by_class"]
    top = res["prefill_top_device_ops_ms"]
    log(f"{tag} (profiled prefill alone): idle "
        f"{100 * res['prefill_idle_share']:.3f} %; device ms by kind of "
        f"kernel: {', '.join(f'{k} {v:.3f}' for k, v in pre.items())}; top "
        f"device operations (ms, calls): "
        f"{[(n[:60], ms, c) for n, ms, c in top]}")
    by_class = res["device_ms_by_class"]
    log(f"{tag} (profiled serving run): {res['profiled_wall_ms']:.3f} ms "
        f"wall, device busy {res['device_busy_ms']:.3f} ms (idle "
        f"{100 * res['idle_share']:.3f} %); device ms by kind of kernel: "
        f"{', '.join(f'{k} {v:.3f}' for k, v in by_class.items())}; top "
        f"device operations (ms, calls): "
        f"{[(name[:60], ms, n) for name, ms, n in res['top_device_ops_ms']]}")


def profiled_decode(cfg, params, step, cache, pos) -> dict:
    """DECODE_PROFILE_STEPS decode steps alone under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T
    token = torch.argmax(step[:, 0], -1)[:, None]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(1, DECODE_PROFILE_STEPS + 1):
            step, cache = T.decode_step(params, cfg, token, cache, pos + i)
            token = torch.argmax(step[:, 0], -1)[:, None]
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / DECODE_PROFILE_STEPS
    busy = device_busy_ms(prof) / DECODE_PROFILE_STEPS
    return {"decode_profiled_wall_ms_per_step": wall,
            "decode_device_busy_ms_per_step": busy,
            "decode_idle_share": 1 - busy / wall,
            "decode_device_ms_by_class": {
                k: v / DECODE_PROFILE_STEPS
                for k, v in device_ms_by_class(prof).items()},
            "decode_top_device_ops_ms": top_device_ops(prof)}


def hybrid_config():
    """jamba-v0.1-52b cut to one period of its layer pattern (HYBRID_ARCH's
    comment): the full config but for ``n_layers``."""
    from repro_torch import configs as C
    cfg = C.get_config(HYBRID_ARCH)
    return cfg.replace(n_layers=cfg.hybrid_period)


def phase_config(res: dict):
    """The configuration a serving phase's record ``res`` ran: its arch's,
    at the depth it was served."""
    from repro_torch import configs as C
    return C.get_config(res["arch"]).replace(n_layers=res["layers"])


def family_params(arch: str, seed: int, tag: str, cfg=None, cut: str = ""):
    """``arch``'s seeded random weights on the card, at its full config or
    at ``cfg`` (the same widths, fewer layers; ``cut`` says why)."""
    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    depth = C.get_config(arch).n_layers
    cfg = cfg or C.get_config(arch)
    # phase 8's trainers hold themselves in reference cycles (a wrapped
    # checkpoint_tree): collect them before measuring what is left
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=seed, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in _tensors(params))
    out = {"arch": arch, "params": T.count_params(cfg),
           "active_params": T.count_params(cfg, active_only=True),
           "layers": cfg.n_layers, "weight_bytes": weight_bytes,
           "init_s": init_s, "batch": SERVE_B, "prompt_len": SERVE_P,
           "gen_len": SERVE_G, "held_by_earlier_phases_gb": held_gb}
    size = ("full width and depth" if cfg.n_layers == depth else
            f"full width, {cfg.n_layers} of {depth} layers ({cut})")
    log(f"{tag}: {arch} at {size} ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {out['params']} parameters, "
        f"{out['active_params']} active): {weight_bytes / 1e9:.3f} GB of "
        f"weights on the card in {init_s:.3f} s; {held_gb:.3f} GB were "
        "still allocated by earlier phases")
    return cfg, params, out


def routed_layers(cfg) -> int:
    """Layers whose MLP is an MoE: the router's calls in one pass."""
    return sum(cfg.layer_is_moe(l % cfg.scan_period)
               for l in range(cfg.n_layers))


def attention_layers(cfg) -> int:
    """Attention layers: the attention kernel's launches a prefill."""
    return sum(cfg.layer_kind(l % cfg.scan_period) == "attn"
               for l in range(cfg.n_layers))


def first_layer(cfg, pred) -> int | None:
    """The first layer index ``l`` with ``pred(l % scan_period)``."""
    return next((l for l in range(cfg.n_layers)
                 if pred(l % cfg.scan_period)), None)


def no_drop_config(cfg):
    """``cfg`` at capacity factor E/K: each expert has a slot for every
    token of a row, so no (token, k) slot drops (a decode step's never
    do; a prefill's at the default capacity may)."""
    return cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)


def routed_diffs(free, same, flips: list) -> dict:
    """Two paths' logits, each pair given as (under test, other path):
    ``free`` with each run's own routes, ``same`` with one run replaying
    the other's (``RouteLog``), ``flips`` the router choices that differ
    between the free runs."""
    return {"max_abs": float((free[0] - free[1]).abs().max()),
            "max_abs_same_routes": float((same[0] - same[1]).abs().max()),
            "route_flips_by_layer": flips}


def hold_routed(what: str, r: dict, free, same, truth=None) -> None:
    """``routed_diffs``' record ``r`` of ``free`` and ``same``: without
    ``truth``, ``hold_logits``.  With the float32 computation ``truth``,
    each pair that is the same computation but for rounding (``same``,
    and ``free`` where no route flipped) is held by ``hold_near_fp32``:
    within LOGIT_ATOL, or no farther from float32 than the other path
    (its record added to ``r``)."""
    flips = r["route_flips_by_layer"]
    if truth is None:
        hold_logits(r["max_abs"], r["max_abs_same_routes"], flips, what)
        return
    r["same_routes"] = hold_near_fp32(f"{what} with the same routes",
                                      *same, truth)
    if not sum(flips):
        r["free_running"] = hold_near_fp32(what, *free, truth)


def log_anchored(tag: str, name: str, r: dict) -> None:
    for key, how in (("same_routes", "with the same routes"),
                     ("free_running", "free-running")):
        if key in r:
            a = r[key]
            log(f"{tag}: {name} {how}: held by {a['held_by']}; to the "
                f"float32 computation max {a['max_abs_to_fp32']:.6f} / mean "
                f"{a['mean_abs_to_fp32']:.6f}, the other path's max "
                f"{a['plain_max_abs_to_fp32']:.6f} / mean "
                f"{a['plain_mean_abs_to_fp32']:.6f}")


def routed_phase(arch: str, tag: str, seed: int, smi: str, cfg=None,
                 cut: str = "", anchor: bool = False,
                 expect: dict | None = None) -> dict:
    """Phases 9 and 10a: an MoE model (``arch``, at ``cfg`` where its depth
    is cut) on phase 5's path.  The counts come from the layer pattern:
    one attention launch a prefill per attention layer, one routed call a
    pass per MoE layer.  The dropped-slot share of the prefill by layer
    and by quarter of the positions, none dropped at decode; warm
    medians, the profiled prefill, serving run and decode; flash-vs-naive
    and decode-vs-prefill logits held with the routes replayed
    (``hold_routed``; with ``anchor`` by the float32 computation where
    bf16 noise exceeds LOGIT_ATOL); the first MoE layer and the first SSD
    layer (if any) in float32 on the card against the CPU.  ``expect``
    holds the record's ``params`` and ``weight_bytes`` to exact counts."""
    from repro_torch import configs as C
    from repro_torch.launch import serve as S
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg, params, res = family_params(arch, seed, tag, cfg, cut)
    for key, want in (expect or {}).items():
        check(res[key] == want, f"{tag}: {key} {res[key]}, not {want}")
    dev, n, P = DEVICE, routed_layers(cfg), SERVE_P
    n_attn = attention_layers(cfg)
    res.update({"routed_layers": n, "attention_layers": n_attn})
    expert_bytes = sum(t.numel() * t.element_size() for lp in params["layers"]
                       if "moe" in lp
                       for k, t in lp["moe"].items() if k in L.EXPERT_KEYS)
    tokens = S.make_tokens(cfg, SERVE_B, P, seed=seed, device=dev)
    torch.cuda.reset_peak_memory_stats()
    with RouteLog() as timed:
        out, launches, slot_launches = serve_family(cfg, params, tokens,
                                                    n_attn, tag)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prefill_keep = [k for _, k in timed.calls[:n]]
    decode_keep = [k for _, k in timed.calls[n:]]
    check(len(decode_keep) == n * (SERVE_G - 1),
          f"{tag}: {len(timed.calls)} routed layers, not {n} x {SERVE_G}")
    dropped = [int((~k).sum()) for k in prefill_keep]
    slots = prefill_keep[0].numel()
    # where in the prompt the drops fall: the share of each quarter of the
    # token positions' slots dropped, over all layers
    by_quarter = torch.stack([
        (~k).reshape(SERVE_B, 4, P // 4, -1).float().mean((0, 2, 3))
        for k in prefill_keep]).mean(0).tolist()
    decode_dropped = sum(int((~k).sum()) for k in decode_keep)
    check(decode_dropped == 0, f"{tag}: decode dropped {decode_dropped} "
          "slots")
    res.update(serve_numbers(out))
    res.update(warm_serve(cfg, params, tokens, res, tag, smi))
    res.update({"attention_launches": launches,
                "decode_attention_launches":
                    out["decode_attention_launches"],
                "fid_slots_launches": slot_launches,
                "peak_memory_gb": peak_gb,
                "capacity": L.moe_capacity(cfg, P),
                "dropped_share": sum(dropped) / (slots * n),
                "dropped_share_by_layer": [d / slots for d in dropped],
                "dropped_share_by_position_quarter": by_quarter,
                "decode_dropped": decode_dropped,
                "expert_bytes": expert_bytes,
                "all_experts_read_ms": expert_bytes / HBM_BYTES_PER_S * 1e3,
                "weights_read_ms": res["weight_bytes"] / HBM_BYTES_PER_S
                * 1e3})
    log(f"{tag}: prefill {SERVE_B} x {P} tokens {res['prefill_ms']:.3f} ms "
        f"({res['prompt_tokens_per_s']:.1f} prompt tokens/s), decode "
        f"{res['decode_ms_per_step']:.3f} ms per step over "
        f"{res['decode_steps']} steps ({res['decode_tokens_per_s']:.1f} "
        f"generated tokens/s); attention launches {launches}, fid_slots "
        f"{slot_launches}; capacity "
        f"{res['capacity']} slots per expert and row, dropped "
        f"{100 * res['dropped_share']:.4f} % of the prefill's (token, k) "
        f"slots ({sum(dropped)} of {slots * n}; by layer from "
        f"{100 * min(dropped) / slots:.4f} to {100 * max(dropped) / slots:.4f}"
        f" %; by quarter of the prompt's positions "
        f"{[round(100 * q, 4) for q in by_quarter]} %), decode none; peak "
        f"memory {peak_gb:.3f} GB [{smi}]")
    if n != cfg.n_layers:
        log(f"{tag}: {n} routed layers a pass and {n_attn} attention "
            f"layer(s) of {cfg.n_layers}; the prefill's dropped share by "
            f"layer {[round(100 * d / slots, 4) for d in dropped]} %")
    res.update(profiled_serve(cfg, params, tokens, n_attn, tag))
    log_profiled(tag, res)

    logits = out["prefill_logits"]
    with torch.inference_mode():
        # flash vs naive attention, the same prompts and capacity
        flash_e = timed.experts()[:n]
        truth = fp32_prefill(params, cfg, tokens, {}) if anchor else None
        with RouteLog() as naive_routes:
            naive, _ = T.prefill(params, cfg, tokens, max_seq=P, impl="naive")
        flips = route_flips(flash_e, naive_routes.experts(), cfg.n_experts)
        del naive_routes
        with RouteLog(replay=flash_e):
            naive_r, _ = T.prefill(params, cfg, tokens, max_seq=P,
                                   impl="naive")
        torch.cuda.empty_cache()
        pairs = (logits, naive), (logits, naive_r)
        fvn = res["flash_vs_naive"] = routed_diffs(*pairs, flips)
        log(f"{tag}: last-position logits, flash vs naive attention: max "
            f"|diff| {fvn['max_abs']:.6f}; with the flash run's routes "
            f"replayed {fvn['max_abs_same_routes']:.6f} (bound {LOGIT_ATOL});"
            f" router choices that differ, by layer: {flips}")
        hold_routed(f"{tag}: flash vs naive prefill", fvn, *pairs, truth)
        log_anchored(tag, "flash vs naive", fvn)
        del naive, naive_r, truth, pairs

        # decode at P against a P + 1 token prefill, with capacity for
        # every slot (decode never drops; a prefill at the default does)
        nd = no_drop_config(cfg)
        check(L.moe_capacity(nd, P + 1) == P + 1, f"{tag}: no-drop capacity")
        ext = S.make_tokens(cfg, SERVE_B, P + 1, seed=seed + 1, device=dev)
        pos = torch.full((SERVE_B,), P, dtype=torch.int32, device=dev)
        truth = fp32_prefill(params, nd, ext, {}) if anchor else None
        torch.cuda.empty_cache()
        with RouteLog() as full_routes:
            full, _ = T.prefill(params, nd, ext, impl="flash")
        torch.cuda.empty_cache()
        max_seq = P + 1 + DECODE_PROFILE_STEPS
        with RouteLog() as dec_routes:
            _, cache = T.prefill(params, nd, ext[:, :P], max_seq=max_seq,
                                 impl="flash")
            step, cache = T.decode_step(params, nd, ext[:, P:], cache, pos)
        full_e = full_routes.experts()
        check(all(bool(k.all())
                  for _, k in full_routes.calls + dec_routes.calls),
              f"{tag}: a slot dropped at the no-drop capacity")
        replay = [e[:, :P] for e in full_e] + [e[:, P:] for e in full_e]
        flips = route_flips(replay, dec_routes.experts(), cfg.n_experts)
        flips = [a + b for a, b in zip(flips[:n], flips[n:])]
        del full_routes, dec_routes
        with RouteLog(replay=replay):
            _, cache_r = T.prefill(params, nd, ext[:, :P], max_seq=P + 1,
                                   impl="flash")
            step_r, _ = T.decode_step(params, nd, ext[:, P:], cache_r, pos)
        pairs = (step[:, 0], full), (step_r[:, 0], full)
        dvp = res["decode_vs_prefill"] = {
            **routed_diffs(*pairs, flips),
            "capacity_factor": nd.capacity_factor}
        log(f"{tag}: decode at position {P} vs a {P + 1}-token prefill "
            f"(capacity factor {nd.capacity_factor}: nothing drops): max "
            f"|diff| {dvp['max_abs']:.6f}; with the prefill's routes "
            f"replayed {dvp['max_abs_same_routes']:.6f} (bound "
            f"{LOGIT_ATOL}); router choices that differ, by layer: {flips}")
        hold_routed(f"{tag}: decode vs prefill", dvp, *pairs, truth)
        log_anchored(tag, "decode vs prefill", dvp)
        del cache_r, step_r, truth, pairs
        torch.cuda.empty_cache()
        res.update(profiled_decode(cfg, params, step, cache, pos))
        del cache, step, full
    log(f"{tag}: decode alone (profiled, {DECODE_PROFILE_STEPS} steps): "
        f"{res['decode_profiled_wall_ms_per_step']:.3f} ms wall per step, "
        f"device busy {res['decode_device_busy_ms_per_step']:.3f} ms (idle "
        f"{100 * res['decode_idle_share']:.3f} %); reading every expert "
        f"({expert_bytes / 1e9:.3f} GB) takes at least "
        f"{res['all_experts_read_ms']:.3f} ms, all the weights "
        f"{res['weights_read_ms']:.3f} ms [{smi}]")
    log(f"{tag}: a decode step's device ms by kind of kernel: "
        f"{res['decode_device_ms_by_class']}; top device operations over "
        f"{DECODE_PROFILE_STEPS} steps (ms, calls): "
        f"{[(k[:60], ms, c) for k, ms, c in res['decode_top_device_ops_ms']]}")
    depth = C.get_config(arch).n_layers
    if cfg.n_layers != depth:
        log(f"{tag}: the idle shares above are of {cfg.n_layers} of {depth} "
            f"layers ({cut}): a call's fixed host work (the embedding, the "
            f"unembedding over {cfg.vocab_size} rows, the greedy choice, the "
            f"launcher's loop) is spread over {cfg.n_layers} layers' device "
            f"work, not {depth}, so the host's share is larger here than a "
            f"stage of all {depth} layers would show")

    l = first_layer(cfg, cfg.layer_is_moe)
    layer = moe_card_vs_cpu(cfg, params["layers"][l]["moe"], LAYER_CHECK_B,
                            LAYER_CHECK_S, seed)
    res["layer_card_vs_cpu"] = layer
    log(f"{tag}: layer {l} in float32, card vs CPU, {LAYER_CHECK_B} x "
        f"{LAYER_CHECK_S} tokens at capacity {layer['capacity']} (dropped "
        f"{100 * layer['dropped_share']:.3f} %): top_e, pos, keep equal "
        f"{layer['top_e_equal']}, {layer['pos_equal']}, "
        f"{layer['keep_equal']}; output max |diff| {layer['max_abs_err']:.3g}"
        f" ({layer['beyond_tol']} beyond rtol=atol={MOE_LAYER_TOL}); aux "
        f"|diff| {layer['aux_abs_err']:.3g}")
    check(layer["ok"], f"{tag}: layer {l} on the card differs from the CPU: "
          f"{layer}")
    l = first_layer(cfg, lambda i: cfg.layer_kind(i) == "ssm")
    if l is not None:
        layer = ssd_card_vs_cpu(cfg, params["layers"][l]["ssm"],
                                LAYER_CHECK_B, LAYER_CHECK_S, seed)
        res["ssd_layer_card_vs_cpu"] = layer
        log(f"{tag}: SSD layer {l} in float32, card vs CPU, {LAYER_CHECK_B} "
            f"x {LAYER_CHECK_S} tokens then 2 decode steps: max |diff| "
            f"{layer['max_abs_err']} ({layer['beyond_tol']} beyond "
            f"rtol=atol={SSD_LAYER_TOL})")
        check(layer["ok"], f"{tag}: SSD layer {l} on the card differs from "
              f"the CPU: {layer}")
    res["phase_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"{tag}: peak device memory over the whole phase, checks included: "
        f"{res['phase_peak_memory_gb']:.3f} GB")
    del params, out, logits, timed
    torch.cuda.empty_cache()
    return res


def moe_phase(seed: int, smi: str) -> dict:
    return routed_phase(MOE_ARCH, "moe", seed, smi)


def hybrid_phase(seed: int, smi: str) -> dict:
    return routed_phase(HYBRID_ARCH, "hybrid", seed, smi, hybrid_config(),
                        HYBRID_CUT, anchor=True,
                        expect={"params": HYBRID_PARAMS,
                                "weight_bytes": HYBRID_WEIGHT_BYTES})


def ssm_phase(seed: int, smi: str) -> dict:
    from repro_torch.launch import serve as S
    from repro_torch.models import transformer as T
    cfg, params, res = family_params(SSM_ARCH, seed, "ssm")
    dev, P = DEVICE, SERVE_P
    tokens = S.make_tokens(cfg, SERVE_B, P, seed=seed, device=dev)
    torch.cuda.reset_peak_memory_stats()
    out, launches, slot_launches = serve_family(cfg, params, tokens, 0,
                                                "ssm")
    res.update(serve_numbers(out))
    res.update(warm_serve(cfg, params, tokens, res, "ssm", smi))
    res.update({"attention_launches": launches,
                "decode_attention_launches":
                    out["decode_attention_launches"],
                "fid_slots_launches": slot_launches,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "weights_read_ms": res["weight_bytes"] / HBM_BYTES_PER_S
                * 1e3})
    log(f"ssm: prefill {SERVE_B} x {P} tokens {res['prefill_ms']:.3f} ms "
        f"({res['prompt_tokens_per_s']:.1f} prompt tokens/s), decode "
        f"{res['decode_ms_per_step']:.3f} ms per step over "
        f"{res['decode_steps']} steps ({res['decode_tokens_per_s']:.1f} "
        f"generated tokens/s); attention launches {launches}, fid_slots "
        f"{slot_launches}; peak memory "
        f"{res['peak_memory_gb']:.3f} GB [{smi}]")
    res.update(profiled_serve(cfg, params, tokens, 0, "ssm"))
    log_profiled("ssm", res)
    with torch.inference_mode():
        ext = S.make_tokens(cfg, SERVE_B, P + 1, seed=seed + 1, device=dev)
        full, _ = T.prefill(params, cfg, ext, impl="flash")
        _, cache = T.prefill(params, cfg, ext[:, :P],
                             max_seq=P + 1 + DECODE_PROFILE_STEPS,
                             impl="flash")
        pos = torch.full((SERVE_B,), P, dtype=torch.int32, device=dev)
        step, cache = T.decode_step(params, cfg, ext[:, P:], cache, pos)
        dvp = float((step[:, 0] - full).abs().max())
        res["decode_vs_prefill_max_abs"] = dvp
        res.update(profiled_decode(cfg, params, step, cache, pos))
        del cache, step, full
    check(dvp <= LOGIT_ATOL, f"ssm: decode at position {P} differs from a "
          f"{P + 1}-token prefill by {dvp} > {LOGIT_ATOL}")
    log(f"ssm: decode at position {P} vs a {P + 1}-token prefill: max |diff|"
        f" {dvp:.6f} (bound {LOGIT_ATOL}); decode alone (profiled, "
        f"{DECODE_PROFILE_STEPS} steps): "
        f"{res['decode_profiled_wall_ms_per_step']:.3f} ms wall per step, "
        f"device busy {res['decode_device_busy_ms_per_step']:.3f} ms (idle "
        f"{100 * res['decode_idle_share']:.3f} %); reading the weights once "
        f"takes at least {res['weights_read_ms']:.3f} ms [{smi}]")
    log(f"ssm: a decode step's device ms by kind of kernel: "
        f"{res['decode_device_ms_by_class']}; top device operations over "
        f"{DECODE_PROFILE_STEPS} steps (ms, calls): "
        f"{[(k[:60], ms, c) for k, ms, c in res['decode_top_device_ops_ms']]}")
    layer = ssd_card_vs_cpu(cfg, params["layers"][0]["ssm"], LAYER_CHECK_B,
                            LAYER_CHECK_S, seed)
    res["layer_card_vs_cpu"] = layer
    log(f"ssm: layer 0 in float32, card vs CPU, {LAYER_CHECK_B} x "
        f"{LAYER_CHECK_S} tokens then 2 decode steps: max |diff| "
        f"{layer['max_abs_err']} ({layer['beyond_tol']} beyond "
        f"rtol=atol={SSD_LAYER_TOL})")
    check(layer["ok"], f"ssm: layer 0 on the card differs from the CPU: "
          f"{layer}")
    res["phase_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, out
    torch.cuda.empty_cache()
    return res


# ----------------------------------- phases 11 and 12: VLM and enc-dec
def encdec_card_vs_cpu(cfg, params: dict, batch: int, frames: int,
                       seq: int, seed: int) -> dict:
    """Encoder layer 0 over ``frames`` frames, then decoder layer 0 over
    ``seq`` positions with its cross attention to that layer's output,
    in float32 on the card and on the CPU, the same seeded inputs: both
    outputs and the cross k/v within ENCDEC_LAYER_TOL (rtol = atol)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    gen = torch.Generator().manual_seed(seed)
    f = torch.randn(batch, frames, cfg.d_model, generator=gen)
    x = torch.randn(batch, seq, cfg.d_model, generator=gen)
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    got = {}
    for dev in (str(DEVICE), "cpu"):
        enc, dec = (T._walk(lp, lambda _, t: t.to(device=dev,
                                                   dtype=torch.float32))
                    for lp in (params["enc_layers"][0], params["layers"][0]))
        fd, xd = f.to(dev), x.to(dev)
        e = T._enc_layer(enc, fd, cfg, T._positions(batch, frames, dev),
                         "naive")
        kv = tuple(L._split_heads(e @ dec["xattn"][w], KV, hd)
                   for w in ("wk", "wv"))
        y, _ = T._layer_forward(dec, xd, cfg, 0, T._positions(batch, seq, dev),
                                "naive", kv)
        got[dev] = [t.cpu() for t in (e, *kv, y)]
        del enc, dec
    card, host = got[str(DEVICE)], got["cpu"]
    names = ("encoder layer", "cross k", "cross v", "decoder layer")
    errs = {n: float((a - b).abs().max())
            for n, a, b in zip(names, card, host)}
    bad = sum(int(((a - b).abs() > ENCDEC_LAYER_TOL
                   + ENCDEC_LAYER_TOL * b.abs()).sum())
              for a, b in zip(card, host))
    return {"batch": batch, "frames": frames, "seq": seq,
            "max_abs_err": errs, "beyond_tol": bad, "ok": bad == 0}


def fp32_prefill(params, cfg, tokens, extras):
    """The last-position logits of the same model and inputs computed in
    float32 (each weight cast at use, plain attention): the anchor of the
    logits checks of phases 10a, 11 and 12."""
    from repro_torch.models import transformer as T
    T.COMPUTE_DTYPE = torch.float32
    try:
        return T.prefill(params, cfg, tokens, impl="naive", **extras)[0]
    finally:
        T.COMPUTE_DTYPE = torch.bfloat16


def hold_near_fp32(what: str, got, plain, truth) -> dict:
    """Logits of the path under test (``got``) against another path's
    (``plain``) within LOGIT_ATOL.  At pixtral-12b's depth two bf16
    evaluations of the same logits differ by about LOGIT_ATOL at the
    max over 4 x 131,072 logits whatever their attention, and each is
    about as far from the float32 computation ``truth`` (PERF.md): the
    max is a draw from that rounding noise.  So where the two differ by
    more, ``got``'s mean |diff| from ``truth`` must be within
    NOISE_MARGIN of ``plain``'s: no more error than the other path has."""
    d_got, d_plain = (got - truth).abs(), (plain - truth).abs()
    out = {"max_abs": float((got - plain).abs().max()),
           "max_abs_to_fp32": float(d_got.max()),
           "plain_max_abs_to_fp32": float(d_plain.max()),
           "mean_abs_to_fp32": float(d_got.mean()),
           "plain_mean_abs_to_fp32": float(d_plain.mean())}
    near = out["mean_abs_to_fp32"] <= (1 + NOISE_MARGIN) * \
        out["plain_mean_abs_to_fp32"]
    out["held_by"] = ("bound" if out["max_abs"] <= LOGIT_ATOL else
                      "fp32 anchor" if near else "none")
    check(out["held_by"] != "none", f"{what}: max |diff| {out['max_abs']} > "
          f"{LOGIT_ATOL}, and farther from the float32 computation than "
          f"the plain path: {out}")
    return out


def family_phase(arch: str, batch_size: int, prompt_len: int, n_attn: int,
                 tag: str, seed: int, smi: str, n_noncausal: int = 0,
                 windows=None) -> dict:
    """Phases 11, 12, 12a and 12b: ``arch`` at full width and depth on
    phase 5's path, with the inputs its launcher draws (``make_batch``:
    the tokens, and a VLM's image-patch or an encoder-decoder's frame
    embeddings), ``batch_size`` prompts of ``prompt_len`` tokens; launch
    counts (``serve_family``: ``n_noncausal`` calls without a causal
    mask, ``windows`` by window), warm calls' medians, the profiled
    prefill and serving run, flash-vs-naive and decode-vs-prefill logits
    held by ``hold_near_fp32``, and an encoder-decoder's layer check."""
    from repro_torch.launch import serve as S
    from repro_torch.models import transformer as T
    cfg, params, res = family_params(arch, seed, tag)
    dev, B, P = DEVICE, batch_size, prompt_len
    res.update({"batch": B, "prompt_len": P})
    batch = S.make_batch(cfg, B, P, seed=seed, device=dev)
    tokens = batch.pop("tokens")
    res["extra_inputs"] = {k: list(v.shape) for k, v in batch.items()}
    torch.cuda.reset_peak_memory_stats()
    out, launches, slot_launches = serve_family(
        cfg, params, tokens, n_attn, tag, extras=batch,
        n_noncausal=n_noncausal, windows=windows)
    res.update(serve_numbers(out, P))
    res.update({"attention_launches": launches,
                "decode_attention_launches":
                    out["decode_attention_launches"],
                "noncausal_launches": out["noncausal_launches"],
                "launches_by_window": out["launches_by_window"],
                "fid_slots_launches": slot_launches,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "weights_read_ms": res["weight_bytes"] / HBM_BYTES_PER_S
                * 1e3})
    res.update(warm_serve(cfg, params, tokens, res, tag, smi, batch))
    log(f"{tag}: prefill {B} x {P} tokens with {res['extra_inputs']} "
        f"{res['prefill_ms']:.3f} ms ({res['prompt_tokens_per_s']:.1f} prompt "
        f"tokens/s), decode {res['decode_ms_per_step']:.3f} ms per step over "
        f"{res['decode_steps']} steps ({res['decode_tokens_per_s']:.1f} "
        f"generated tokens/s); attention launches {launches} (without a "
        f"causal mask {out['noncausal_launches']}; by window "
        f"{out['launches_by_window']}), fid_slots "
        f"{slot_launches}; invalidation evicted {out['evicted_per_replica']}, "
        f"remaining pages {out['remaining_pages']}; peak memory "
        f"{res['peak_memory_gb']:.3f} GB [{smi}]")
    res.update(profiled_serve(cfg, params, tokens, n_attn, tag, batch))
    res["kernel_share_of_prefill"] = (res["kernel_ms_in_prefill"]
                                      / res["profiled_prefill_ms"])
    log_profiled(tag, res)

    logits = out["prefill_logits"]
    with torch.inference_mode():
        naive, _ = T.prefill(params, cfg, tokens, max_seq=P, impl="naive",
                             **batch)
        fvn = hold_near_fp32(f"{tag}: prefill logits, flash vs naive "
                             "attention", logits, naive,
                             fp32_prefill(params, cfg, tokens, batch))
        del naive
        torch.cuda.empty_cache()
        # one decode step at position P after a prefill of P tokens, against
        # the last logits of a prefill of P + 1 tokens (a sliding-window
        # layer's ring of slots has wrapped where P reaches its window)
        ext = S.make_tokens(cfg, B, P + 1, seed=seed + 1, device=dev)
        full, _ = T.prefill(params, cfg, ext, impl="flash", **batch)
        _, cache = T.prefill(params, cfg, ext[:, :P],
                             max_seq=P + 1 + DECODE_PROFILE_STEPS,
                             impl="flash", **batch)
        res["ring_slots"] = sorted({c["k"].shape[1] for c in cache
                                    if "k" in c})
        pos = torch.full((B,), P, dtype=torch.int32, device=dev)
        step, cache = T.decode_step(params, cfg, ext[:, P:], cache, pos)
        dvp = hold_near_fp32(f"{tag}: decode at position {P} vs a "
                             f"{P + 1}-token prefill", step[:, 0], full,
                             fp32_prefill(params, cfg, ext, batch))
        res.update(profiled_decode(cfg, params, step, cache, pos))
        del cache, step, full
    res.update({"flash_vs_naive": fvn, "decode_vs_prefill": dvp,
                "logit_bound": LOGIT_ATOL, "noise_margin": NOISE_MARGIN,
                "max_abs_logit": float(
                    logits[:, :cfg.vocab_size].abs().max())})
    for name, r in (("flash vs naive attention", fvn),
                    (f"decode at position {P} vs a {P + 1}-token prefill",
                     dvp)):
        log(f"{tag}: last-position logits, {name}: max |diff| "
            f"{r['max_abs']:.6f} (bound {LOGIT_ATOL}; held by "
            f"{r['held_by']}); to the float32 computation max "
            f"{r['max_abs_to_fp32']:.6f} / mean {r['mean_abs_to_fp32']:.6f}, "
            f"the other path's max {r['plain_max_abs_to_fp32']:.6f} / mean "
            f"{r['plain_mean_abs_to_fp32']:.6f}")
    log(f"{tag}: |logits| up to {res['max_abs_logit']:.3f}; decode caches "
        f"of {res['ring_slots']} slots, position {P} written to slot "
        f"{[P % n for n in res['ring_slots']]}")
    log(f"{tag}: decode alone (profiled, {DECODE_PROFILE_STEPS} steps): "
        f"{res['decode_profiled_wall_ms_per_step']:.3f} ms wall per step, "
        f"device busy {res['decode_device_busy_ms_per_step']:.3f} ms (idle "
        f"{100 * res['decode_idle_share']:.3f} %); reading the weights once "
        f"takes at least {res['weights_read_ms']:.3f} ms [{smi}]")
    if cfg.is_encoder_decoder:
        layer = encdec_card_vs_cpu(cfg, params, LAYER_CHECK_B, cfg.n_frames,
                                   P, seed)
        res["layer_card_vs_cpu"] = layer
        log(f"{tag}: encoder layer 0 over {cfg.n_frames} frames and decoder "
            f"layer 0 over {P} positions with its cross attention, float32, "
            f"card vs CPU: max |diff| {layer['max_abs_err']} "
            f"({layer['beyond_tol']} beyond rtol=atol={ENCDEC_LAYER_TOL})")
        check(layer["ok"], f"{tag}: layer 0 on the card differs from the "
              f"CPU: {layer}")
    res["phase_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"{tag}: peak device memory over the whole phase, checks included: "
        f"{res['phase_peak_memory_gb']:.3f} GB")
    del params, out, logits, batch
    torch.cuda.empty_cache()
    return res


def dense_windows(cfg) -> dict:
    """A prefill's attention calls by window: one per layer, at the
    layer's window (0: global)."""
    out: dict = {}
    for l in range(cfg.n_layers):
        w = cfg.layer_window(l % cfg.scan_period)
        out[w] = out.get(w, 0) + 1
    return out


# ----------------------------------------------- phase 13: the sharded path
def dtensor_host_share(fn) -> dict:
    """``fn()`` under ``cProfile``: its host seconds (inflated by the
    profiler), the share of them spent in the Python of
    ``torch.distributed.tensor`` itself (self time of its functions: a
    lower bound on DTensor's dispatch, whose C++ side is not counted),
    and the functions of most self time."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    stats = pstats.Stats(prof).stats
    total = sum(v[2] for v in stats.values())
    mark = str(Path("torch", "distributed", "tensor"))
    own = sum(v[2] for k, v in stats.items() if mark in k[0])
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:8]
    return {"profiled_s": total, "dtensor_python_s": own,
            "dtensor_python_share": own / total if total else 0.0,
            "top_self_s": [(f"{Path(k[0]).name}:{k[1]}({k[2]})",
                            round(v[2], 6), v[1]) for k, v in top]}


def mesh_serve(seed: int, mesh, smi: str, sv: dict) -> dict:
    """(a): phase 5's granite-8b run under the rules on the one-rank mesh,
    its weights placed by ``prefill_cell``'s placements."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.kernels import flash_attention as fa, stream_ops
    from repro_torch.launch import serve as S
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ShapeConfig
    from repro_torch.runtime import sharding as SH, specs as SP
    cfg, params, res = family_params(SERVE_ARCH, seed, "mesh")
    shape = ShapeConfig("mesh", SERVE_P, SERVE_B, "prefill")
    rules = SP.cell_rules(cfg, shape, mesh)
    _, (p_shard, _), _ = SP.prefill_cell(cfg, shape, rules)
    placed = SP.map_axes(lambda axes, t, pl: distribute_tensor(t, mesh, pl),
                         T.param_axes(cfg), params, p_shard)
    del params
    check(all(SH.is_dtensor(t) for t in _tensors(placed)),
          "mesh: a parameter was not placed")
    tokens = S.make_tokens(cfg, SERVE_B, SERVE_P, seed=seed, device=DEVICE)
    for name in (fa.SM90, fa.SIMT):
        fa.device_launches(name, reset=True)
    fa.launches = fa.launches_sm90 = fa.launches_simt = 0
    stream_ops.launches = 0
    torch.cuda.reset_peak_memory_stats()
    runs = []
    with SH.use_rules(rules):
        for i in range(2):
            out = S.serve(cfg, placed, tokens, gen_len=SERVE_G,
                          replicas=SERVE_REPLICAS)
            if i == 0:
                launches = {fa.SM90: fa.launches_sm90, fa.SIMT:
                            fa.launches_simt}
                on_card = {name: fa.device_launches(name)
                           for name in launches}
                slots = stream_ops.launches
            runs.append(serve_numbers(out))
    # where a decode step's host time goes: DTensor's own Python
    with SH.use_rules(rules), torch.inference_mode():
        _, cache = T.prefill(placed, cfg, tokens, max_seq=SERVE_P + 4,
                             impl="flash")
        token = out["generated"][:, -1:]

        def decode():
            for i in range(3):
                pos = torch.full((SERVE_B,), SERVE_P + i, dtype=torch.int32,
                                 device=DEVICE)
                T.decode_step(placed, cfg, token, cache, pos)
            torch.cuda.synchronize()

        host = dtensor_host_share(decode)
        del cache
    want = {fa.SM90: cfg.n_layers, fa.SIMT: 0}
    check(launches == want and on_card == want,
          f"mesh: attention launches of one sharded serving run: by the "
          f"wrapper {launches}, counted on the card {on_card}, want {want}")
    check(slots == 0, f"mesh: {slots} fid_slots launches while serving")
    logits = out["prefill_logits"]
    check(not SH.is_dtensor(logits) and tuple(logits.shape) ==
          (SERVE_B, cfg.padded_vocab) and bool(torch.isfinite(logits).all()),
          f"mesh: prefill logits {type(logits).__name__} "
          f"{tuple(logits.shape)} not finite and whole")
    diff = float((logits.float().cpu() - HELD["serve"]["logits"]).abs().max())
    same = float((out["generated"].cpu() ==
                  HELD["serve"]["generated"]).float().mean())
    check(diff <= MESH_LOGIT_TOL, f"mesh: prefill logits differ from phase "
          f"5's by {diff} > {MESH_LOGIT_TOL}")
    res.update({"attention_launches": launches, "device_launches": on_card,
                "fid_slots_launches": slots, "runs": runs,
                "phase5": {k: sv[k] for k in ("prefill_ms",
                                              "decode_ms_per_step")},
                "logits_max_abs_vs_phase5": diff,
                "generated_equal_share": same,
                "decode_host_profile": host,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    for i, r in enumerate(runs):
        log(f"mesh (a) run {i + 1}: prefill {SERVE_B} x {SERVE_P} tokens "
            f"{r['prefill_ms']:.3f} ms (phase 5: {sv['prefill_ms']:.3f}), "
            f"decode {r['decode_ms_per_step']:.3f} ms per step (phase 5: "
            f"{sv['decode_ms_per_step']:.3f}) [{smi}]")
    log(f"mesh (a): wgmma launches {launches[fa.SM90]} (on the card "
        f"{on_card[fa.SM90]}), CUDA-core {launches[fa.SIMT]}; prefill "
        f"logits max |diff| from phase 5's {diff!r} (bound "
        f"{MESH_LOGIT_TOL}); generated tokens equal to phase 5's "
        f"{100 * same:.3f} %; peak memory {res['peak_memory_gb']:.3f} GB")
    log(f"mesh (a): 3 decode steps under cProfile: {host['profiled_s']:.3f}"
        f" s of host time, {100 * host['dtensor_python_share']:.3f} % of it "
        f"in torch.distributed.tensor's own Python; most self time (s, "
        f"calls): {host['top_self_s']}")
    del placed, out, logits
    gc.collect()
    torch.cuda.empty_cache()
    return res


def compress_check(grads) -> dict:
    """(c): ``compressed_psum`` over the one rank, leaf by leaf (the
    whole tree's error buffer would not fit beside the training state):
    each mean within half a quantization step of the gradient, the error
    buffer exactly the gradient minus the mean."""
    from repro_torch.optim import adamw, compress
    from repro_torch.runtime.sharding import full
    leaves = adamw.leaves(grads)
    worst, n_bytes, n = 0.0, 0, 0
    for g in leaves:
        g = full(g.detach())
        mean, err = compress.compressed_psum({"g": g},
                                             {"g": torch.zeros_like(g)})
        mean, err = mean["g"], err["g"]
        # the step as compress computes it, in float32; a mean may miss
        # half of it by the float32 rounding of g / scale and q * scale
        # (each under 2^-17 of a step at |q| <= 127)
        scale = float(g.abs().max() / 127.0 + 1e-12)
        off = float((mean - g).abs().max())
        check(off <= scale * COMPRESS_HALF_STEP, f"mesh (c): a mean is {off}"
              f" from its gradient, more than half a step ({scale / 2})")
        check(bool(torch.equal(err, g - mean)), "mesh (c): the error "
              "buffer is not the gradient minus the mean")
        worst = max(worst, off / scale)
        n_bytes += compress.payload_bytes({"g": g})
        n += g.numel()
        del g, mean, err
    return {"leaves": len(leaves), "elements": n, "payload_bytes": n_bytes,
            "float32_bytes": 4 * n, "max_error_in_steps": worst}


def mesh_train(seed: int, mesh, smi: str, tr: dict) -> dict:
    """(b) and (c): phase 8's trainer on the mesh."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs as C
    from repro_torch.kernels import flash_attention as fa, stream_ops
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as SH
    from repro_torch.runtime.train_loop import Trainer
    cfg = C.get_config(TRAIN_ARCH)
    hp = train_hp()
    gc.collect()
    torch.cuda.empty_cache()
    slots0, flash0 = stream_ops.launches, fa.launches
    with tempfile.TemporaryDirectory() as wd:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = Trainer(cfg, workdir=wd, mesh=mesh, hp=hp,
                          global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                          n_hosts=TRAIN_HOSTS, ckpt_every=10 ** 9,
                          seed=seed, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        check(trainer.rules is not None and all(
            SH.is_dtensor(t) for t in adamw.leaves(trainer.params)),
            "mesh (b): the trainer's parameters are not placed")
        hist = list(trainer.run(1 + MESH_TIMED_STEPS))   # run() appends
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            prof_ms = trainer.run(1)[-1]["time"] * 1e3
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # (c) on the gradients of one more step, taken before AdamW
        got = {}
        update = adamw.update

        def compress_then_update(grads, *a, **kw):
            got.update(compress_check(grads))
            return update(grads, *a, **kw)

        adamw.update = compress_then_update
        try:
            trainer.run(1)
        finally:
            adamw.update = update
        drain_trainer(trainer)
        trainer.close()
        del trainer
    gc.collect()
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in hist]
    want = tr["losses"][:len(losses)]
    diff = max(abs(a - b) for a, b in zip(losses, want))
    check(all(np.isfinite(losses)) and diff <= MESH_LOSS_TOL,
          f"mesh (b): losses {losses} differ from phase 8's {want} by "
          f"{diff} > {MESH_LOSS_TOL}")
    timed = [h["time"] * 1e3 for h in hist[1:]]
    busy_ms = device_busy_ms(prof)
    out = {"losses": losses, "phase8_losses": want,
           "loss_max_abs_vs_phase8": diff, "init_s": init_s,
           "step_ms": timed, "step_ms_median": statistics.median(timed),
           "profiled_step_ms": prof_ms, "device_busy_ms": busy_ms,
           "idle_share": 1 - busy_ms / prof_ms, "peak_memory_gb": peak_gb,
           "device_ms_by_class": device_ms_by_class(prof),
           "top_device_ops_ms": top_device_ops(prof),
           "phase8": {k: tr[k] for k in ("step_ms_median", "idle_share",
                                         "peak_memory_gb")},
           "compress": got,
           "launches": {"fid_slots": stream_ops.launches - slots0,
                        "flash_attention": fa.launches - flash0}}
    check(out["launches"] == {"fid_slots": 0, "flash_attention": 0},
          f"mesh (b): kernel launches {out['launches']} while training")
    check(got.get("leaves", 0) > 0, "mesh (c): no gradients compressed")
    log(f"mesh (b): {TRAIN_ARCH} on the (1, 1) mesh: step "
        f"{out['step_ms_median']:.3f} ms (median of {MESH_TIMED_STEPS}: "
        f"{', '.join(f'{t:.3f}' for t in timed)}; phase 8: "
        f"{tr['step_ms_median']:.3f}), profiled step {prof_ms:.3f} ms wall, "
        f"device busy {busy_ms:.3f} ms (idle {100 * out['idle_share']:.3f} "
        f"%; phase 8: {100 * tr['idle_share']:.3f} %), peak memory "
        f"{peak_gb:.3f} GB (phase 8: {tr['peak_memory_gb']:.3f}); init "
        f"{init_s:.3f} s [{smi}]")
    log(f"mesh (b): losses {losses}, phase 8's {want}: max |diff| "
        f"{diff!r} (bound {MESH_LOSS_TOL})")
    log(f"mesh (c): compressed_psum over one NCCL rank, {got['leaves']} "
        f"leaves of {got['elements']} elements: every mean within "
        f"{got['max_error_in_steps']:.6f} of a quantization step of its "
        f"gradient, error buffers exact; payload {got['payload_bytes']} "
        f"bytes (int32, as the reference psums it; float32: "
        f"{got['float32_bytes']})")
    return out


def mesh_phase(seed: int, smi: str, sv: dict, tr: dict) -> dict:
    """Phase 13: a one-rank NCCL process group on a ``FileStore`` and
    ``make_elastic_mesh(1)``'s (1, 1) mesh; (a) serving, (b) training and
    (c) the compressed all-reduce on it; the group destroyed after."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.runtime.elastic import make_elastic_mesh
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", store=dist.FileStore(
            str(Path(d) / "store"), 1), rank=0, world_size=1)
        try:
            mesh = make_elastic_mesh(1, device="cuda")
            check(tuple(mesh.shape) == (1, 1) and
                  tuple(mesh.mesh_dim_names) == ("data", "model"),
                  f"mesh: {mesh}")
            log(f"mesh: {mesh} on a one-rank NCCL group "
                f"({dist.get_backend()})")
            out = {"mesh_shape": [1, 1], "backend": dist.get_backend()}
            out["serve"] = mesh_serve(seed, mesh, smi, sv)
            out["train"] = mesh_train(seed, mesh, smi, tr)
        finally:
            dist.destroy_process_group()
    return out


# ---------------------------------------------- phase 14: the cost models
def dryrun_records(cells) -> list:
    """``launch.dryrun.run_cell``'s records of ``cells`` (rows of
    ``DRYRUN_CELLS``) on the fake 16x16 mesh, in the cells' order, traced
    by ``DRYRUN_WORKERS`` processes at once, which end with the call."""
    import tempfile
    from repro_torch.launch import dryrun as D
    with tempfile.TemporaryDirectory() as d, \
            spawn_pool(DRYRUN_WORKERS) as pool:
        futures = [pool.submit(D.run_cell, arch, shape, "single", d,
                               device="cuda", full=full, probes=probes,
                               coarse=coarse)
                   for arch, shape, full, probes, coarse in cells]
        return [f.result() for f in futures]


def dryrun_cell(r: dict, full: bool, probes: bool, total_b: int,
                smi: str) -> dict:
    """One cell of the port's dry run from its record ``r``
    (``dryrun_records``), checked, and the line it prints."""
    arch, shape = r["arch"], r["shape"]
    check(r["status"] == "ok", f"roofline: dry run of {arch} {shape}: "
          f"{r['status']} {r.get('reason', '')}")
    out = {k: r[k] for k in (
        "arch", "shape", "n_devices", "n_micro", "full_trace",
        "flops_per_device", "bytes_per_device",
        "collective_bytes_per_device", "collective_bw",
        "model_flops_ratio", "dominant", "compute_s", "memory_s",
        "collective_s", "step_time_lower_bound_s", "memory",
        "attention_grid", "compile_wall_s")}
    out["raw"], out["corrected"] = r["raw"], r.get("corrected")
    out["probe_walls_s"] = r.get("probe_walls_s")
    if full and probes:
        out["probe_flops_rel_err"] = (abs(r["corrected"]["flops"]
                                          - r["raw"]["flops"])
                                      / r["raw"]["flops"])
    peak = r["memory"]["peak_bytes"]
    how = (f"whole trace in the {r['attention_grid']} attention grid"
           if full else "probes alone, in the coarse attention grid")
    whose = "rank" if full else "the deepest probe's"
    log(f"roofline: {arch} {shape} on 256 ranks ({how}"
        f"{' and probes' if full and probes else ''}, {r['compile_wall_s']} "
        f"s): per device {r['flops_per_device']:.6g} FLOPs, "
        f"{r['bytes_per_device']:.6g} bytes, "
        f"{r['collective_bytes_per_device']:.6g} collective bytes; "
        f"{whose} peak {peak / 1e9:.3f} GB of the card's "
        f"{total_b / 1e9:.3f} GB; "
        f"dominant {r['dominant']} ({r['step_time_lower_bound_s']:.6g} s at "
        f"989 TFLOP/s, 3.35 TB/s, {r['collective_bw'] / 1e9:.0f} GB/s a "
        f"link); model/traced FLOPs {r['model_flops_ratio']:.4f} [{smi}]")
    return out


def one_card_bound(cfg, shape, n_micro: int, measured_ms: float) -> dict:
    """The least time one card could take for a step of ``shape``: model
    FLOPs over the bf16 peak, or ``estimate_hbm_bytes`` on one device
    over HBM's rate, whichever is larger; and the model-FLOP share of the
    measured time."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch.hlo_analysis import roofline
    from repro_torch.launch.roofline_model import estimate_hbm_bytes
    from repro_torch.models.transformer import model_flops_per_token
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    per_tok = model_flops_per_token(cfg)
    if shape.kind != "train":
        per_tok /= 3.0
    flops = per_tok * tokens
    hbm = estimate_hbm_bytes(cfg, shape, n_dev=1, dp=1, tp=1,
                             n_micro=n_micro)
    rf = roofline(flops, hbm, 0.0, peak_flops=BF16_FLOP_PER_S,
                  hbm_bw=HBM_BYTES_PER_S, ici_bw=M.NETWORK_BW)
    bound_ms = rf["step_time_lower_bound_s"] * 1e3
    return {"model_flops": flops, "hbm_bytes": hbm, "bound_ms": bound_ms,
            "bound_by": "operations" if rf["dominant"] == "compute_s"
            else "bytes", "measured_ms": measured_ms,
            "bound_share": bound_ms / measured_ms,
            "model_flop_share_bf16": flops / (measured_ms / 1e3)
            / BF16_FLOP_PER_S}


def measured_rates(smi: str) -> dict:
    """The card's bf16 product and copy rates by CUDA events, beside the
    data sheet's."""
    n = RATE_MATMUL_N
    a = torch.randn(n, n, dtype=torch.bfloat16, device=DEVICE)
    b = torch.randn(n, n, dtype=torch.bfloat16, device=DEVICE)
    mm_ms = cuda_median_ms(lambda: torch.matmul(a, b), runs=20)
    del a, b
    src = torch.empty(RATE_COPY_BYTES, dtype=torch.uint8, device=DEVICE)
    dst = torch.empty_like(src)
    copy_ms = cuda_median_ms(lambda: dst.copy_(src), runs=10)
    del src, dst
    torch.cuda.empty_cache()
    out = {"matmul_ms": mm_ms,
           "matmul_flop_per_s": 2 * n ** 3 / (mm_ms / 1e3),
           "copy_ms": copy_ms,
           # each byte read once and written once
           "copy_bytes_per_s": 2 * RATE_COPY_BYTES / (copy_ms / 1e3)}
    log(f"roofline: measured bf16 {n}^3 product {mm_ms:.4f} ms = "
        f"{out['matmul_flop_per_s'] / 1e12:.2f} TFLOP/s (data sheet "
        f"{BF16_FLOP_PER_S / 1e12:.0f}); a {RATE_COPY_BYTES >> 30} GiB copy "
        f"{copy_ms:.4f} ms = {out['copy_bytes_per_s'] / 1e12:.4f} TB/s read "
        f"+ written (data sheet {HBM_BYTES_PER_S / 1e12:.2f}) [{smi}]")
    check(out["matmul_flop_per_s"] <= RATE_CEILING * BF16_FLOP_PER_S,
          f"roofline: the bf16 product reads {out['matmul_flop_per_s']:.4g} "
          f"FLOP/s, above {RATE_CEILING} x the data sheet")
    check(out["copy_bytes_per_s"] <= RATE_CEILING * HBM_BYTES_PER_S,
          f"roofline: the copy reads {out['copy_bytes_per_s']:.4g} B/s, "
          f"above {RATE_CEILING} x the data sheet")
    return out


def roofline_phase(smi: str, measured: dict) -> dict:
    """Phase 14: (a) the dry run on the fake 16x16 mesh, (b) the one-card
    bound of each measured step of phases 5, 8-12, 10a, 12a and 12b (the
    serving phases' medians of their warm calls, ``warm_serve``, at the
    depth each was served; phases 8-8c's median steps), (c) the card's
    rates.  ``measured`` maps a phase's
    tag to its record."""
    from repro_torch import configs as C
    from repro_torch.kernels import flash_attention as fa, stream_ops
    from repro_torch.models.config import ShapeConfig
    # the phase's own counts, from 0 (it must launch no kernel)
    fa.launches = fa.launches_sm90 = fa.launches_simt = 0
    stream_ops.launches = 0
    total_b = torch.cuda.get_device_properties(0).total_memory
    out = {"cells": []}
    t0 = time.perf_counter()
    records = dryrun_records(DRYRUN_CELLS)
    for (arch, shape, full, probes, _c), r in zip(DRYRUN_CELLS, records):
        cell = dryrun_cell(r, full, probes, total_b, smi)
        if full and probes:
            check(cell["probe_flops_rel_err"] <= DRYRUN_PROBE_TOL,
                  f"roofline: {arch} {shape}: the probe model's FLOPs are "
                  f"{cell['probe_flops_rel_err']:.3g} off the whole trace")
        out["cells"].append(cell)
    out["dryrun_s"] = time.perf_counter() - t0

    bounds = []
    for tag in SERVE_TAGS:
        res = measured[tag]
        arch, B, prompt = res["arch"], res["batch"], res["prompt_len"]
        cfg = phase_config(res)
        for kind, seq, key in (
                ("prefill", prompt, "prefill_ms"),
                # decode reads the whole cache: prompt + generated slots
                ("decode", prompt + SERVE_G, "decode_ms_per_step")):
            bounds.append({"phase": tag, "arch": arch, "kind": kind,
                           "batch": B, "seq": seq,
                           "measured_min_max_ms": res[key + "_min_max"],
                           "warm_calls": res["warm_calls"],
                           "first_call_ms": res["first_call_" + key],
                           **one_card_bound(cfg, ShapeConfig(
                               kind, seq, B, kind), 1, res[key])})
    for tag in TRAIN_TAGS:
        tr = measured[tag]
        bounds.append({"phase": tag, "arch": tr["arch"], "kind": "train",
                       **one_card_bound(C.get_config(tr["arch"]), ShapeConfig(
                           "train", tr["seq_len"], tr["global_batch"],
                           "train"), tr["hp"]["n_micro"],
                           tr["step_ms_median"])})
    for b in bounds:
        spread = (f" (median of {b['warm_calls']} warm calls, min-max "
                  f"{b['measured_min_max_ms'][0]:.4f}-"
                  f"{b['measured_min_max_ms'][1]:.4f}; first call "
                  f"{b['first_call_ms']:.4f})" if "warm_calls" in b else
                  " (median of the timed steps)")
        log(f"roofline: {b['phase']} {b['arch']} {b['kind']}: one-card "
            f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
            f"({b['model_flops']:.6g} model FLOPs, {b['hbm_bytes']:.6g} "
            f"bytes) against {b['measured_ms']:.4f} ms measured{spread} "
            f"({100 * b['bound_share']:.3f} %); model-FLOP share "
            f"{100 * b['model_flop_share_bf16']:.4f} % of 989 TFLOP/s "
            f"[{smi}]")
        check(b["bound_ms"] <= b["measured_ms"],
              f"roofline: {b['phase']} {b['kind']}: the bound "
              f"{b['bound_ms']:.4f} ms exceeds the measured "
              f"{b['measured_ms']:.4f} ms")
    out["one_card"] = bounds
    out["rates"] = measured_rates(smi)
    out["launches"] = {"fid_slots": stream_ops.launches,
                       fa.SM90: fa.launches_sm90, fa.SIMT: fa.launches_simt}
    check(not any(out["launches"].values()) and fa.launches == 0,
          f"roofline: the phase launched {out['launches']}")
    out["device"] = smi
    return out


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
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}"
              "; run it from a checkout of the repository", file=sys.stderr)
        return 3
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
    from repro_torch import configs as C
    from repro_torch.kernels import _build, flash_attention as fa, stream_ops
    from repro_torch.kernels import decode_attention as da
    t0 = time.perf_counter()
    built = _build.build(stream_ops.SOURCE, *fa.SOURCES, da.SOURCE,
                         verbose=True)
    for lib, seconds in built:
        log(f"build: {lib.name} in {seconds:.3f} s")
    log(f"build: {len(built)} sources in {time.perf_counter() - t0:.3f} s "
        "(one nvcc each, in parallel)")

    phase_s = {}

    def timed(name, fn, *a, **kw):
        # each phase's seconds, so that a run near the time limit shows
        # which phase to cut
        t = time.perf_counter()
        out = fn(*a, **kw)
        phase_s[name] = round(time.perf_counter() - t, 1)
        log(f"time: {name} {phase_s[name]} s")
        return out

    k = timed("kernels", kernel_phase, args.seed)
    fl = timed("flash", flash_phase, args.seed)
    dk = timed("decode", decode_phase, args.seed)
    main = timed("main", main_path_phase, args.seed)
    sv = timed("serve", serve_phase, args.seed, smi)
    wire = timed("wire", wire_phase, args.seed, smi)
    act = timed("activity", activity_phase, args.seed, smi)
    el = timed("elastic", elastic_phase, args.seed, smi)
    px = timed("proxy", proxy_phase, args.seed, smi, main["records_per_s"])
    tr = timed("train", train_phase, args.seed, smi)
    trf = {tag: timed(tag, train_family_phase, C.get_config(arch), tag,
                      args.seed, smi, **kw)
           for tag, arch, kw in TRAIN_FAMILIES}
    mo = timed("moe", moe_phase, args.seed, smi)
    sm = timed("ssm", ssm_phase, args.seed, smi)
    hy = timed("hybrid", hybrid_phase, args.seed, smi)
    vlm_layers = C.get_config(VLM_ARCH).n_layers
    audio = C.get_config(AUDIO_ARCH)
    vl = timed("vlm", family_phase, VLM_ARCH, SERVE_B, SERVE_P, vlm_layers,
               "vlm", args.seed, smi)
    au = timed("audio", family_phase, AUDIO_ARCH, SERVE_B, AUDIO_P,
               audio.n_encoder_layers + audio.n_layers, "audio",
               args.seed, smi, n_noncausal=audio.n_encoder_layers)
    gemma = C.get_config(GEMMA_ARCH)
    gm = timed("gemma", family_phase, GEMMA_ARCH, GEMMA_B, GEMMA_P,
               gemma.n_layers, "gemma", args.seed, smi,
               windows=dense_windows(gemma))
    qw = timed("qwen", family_phase, QWEN_ARCH, SERVE_B, SERVE_P,
               C.get_config(QWEN_ARCH).n_layers, "qwen", args.seed, smi)
    ms = timed("mesh", mesh_phase, args.seed, smi, sv, tr)
    rl = timed("roofline", roofline_phase, smi,
               {"serve": sv, "moe": mo, "ssm": sm, "hybrid": hy, "vlm": vl,
                "audio": au, "gemma": gm, "qwen": qw, "train": tr, **trf})
    log(f"time: phases {json.dumps(phase_s)}, "
        f"{sum(phase_s.values()):.1f} s in all")
    at = k["sizes"][BATCH]
    kernels = {"kernels": [{
        "name": "fid_slots",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fid_slots.cu",
        "replaces": "src/repro/kernels/stream_ops.py:119",
        "matched": k["max_abs_err"] == 0,
        "launches": main["launches"],
        # phase 6's own runs, each counted from 0 like the main path's
        "wire_launches": {"cluster_service": wire["service"]["launches"],
                          "shard_daemons": wire["daemons"]["launches"]},
        "activity_launches": act["launches"],
        # phase 7a's four parts, each counted from 0
        "elastic_launches": el["launches"],
        # phase 7b's two parts, each counted from 0; (b)'s by call site
        "proxy_launches": px["launches"],
        "train_launches": tr["launches"]["fid_slots"],
        "train_families_launches": {
            tag: r["launches_by_kernel"]["fid_slots"]
            for tag, r in trf.items()},
        # each serving phase's own run, counted from 0 like the main path's
        "serve_launches": sv["fid_slots_launches"],
        "moe_launches": mo["fid_slots_launches"],
        "ssm_launches": sm["fid_slots_launches"],
        "hybrid_launches": hy["fid_slots_launches"],
        "vlm_launches": vl["fid_slots_launches"],
        "audio_launches": au["fid_slots_launches"],
        "gemma_launches": gm["fid_slots_launches"],
        "qwen_launches": qw["fid_slots_launches"],
        "mesh_launches": ms["serve"]["fid_slots_launches"],
        "roofline_launches": rl["launches"]["fid_slots"],
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
        "out_ms": at["out_ms"], "device_ms": at["device_ms"],
        "at_2p16": k["sizes"][1 << 16],
        "at_2p20": k["sizes"][1 << 20],
        # SASS instructions of the built kernel, and one routing round of
        # ROUND_READS reads hashed in one launch against one launch a read
        "sass": k["sass"],
        "round_trip": k["round_trip"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": "src/repro/kernels/flash_attention.py:32",
        "launches": sv["attention_launches"][kernel],
        "max_abs_err": fl[kernel]["max_abs_err"],
        "ms": fl[kernel]["ms"], "plain_ms": fl[kernel]["plain_ms"],
        "bound_ms": fl[kernel]["bound_ms"],
        "bound_by": fl[kernel]["bound_by"],
        "library_ms": fl[kernel]["library_ms"],
        "shape": "q (4, 2048, 32, 128), k/v (4, 2048, 8, 128) bf16, causal",
        "kernel": kernel, "cases": fl[kernel]["cases"],
        "train_launches": tr["launches"]["flash_attention"],
        # each serving phase's own run, counted from 0 like phase 5's
        "launches_by_phase": {"serve": sv["attention_launches"][kernel],
                              "train": tr["launches"]["flash_attention"],
                              **{tag: r["launches_by_kernel"][kernel]
                                 for tag, r in trf.items()},
                              "moe": mo["attention_launches"][kernel],
                              "ssm": sm["attention_launches"][kernel],
                              "hybrid": hy["attention_launches"][kernel],
                              "vlm": vl["attention_launches"][kernel],
                              "audio": au["attention_launches"][kernel],
                              "gemma": gm["attention_launches"][kernel],
                              "qwen": qw["attention_launches"][kernel],
                              "mesh": ms["serve"]["attention_launches"][
                                  kernel],
                              "roofline": rl["launches"][kernel]},
        # phase 13's sharded serving run, through local_map, counted from 0
        "mesh_launches": ms["serve"]["attention_launches"][kernel],
        # of them, the audio phase's encoder layers, with no causal mask
        "audio_noncausal_launches": au["noncausal_launches"][kernel],
        # the gemma phase's prefill by window (local layers 4096)
        "gemma_launches_by_window": gm["launches_by_window"][kernel],
        "moe_shape": fl["moe_shape"][kernel],
        "vlm_shape": fl["vlm_shape"][kernel],
        "enc_shape": fl["enc_shape"][kernel],
        "dec_shape": fl["dec_shape"][kernel],
        "gemma_shape": fl["gemma_shape"][kernel],
        "gemma_global_shape": fl["gemma_global_shape"][kernel],
        "qwen_shape": fl["qwen_shape"][kernel],
        "turns_ms": fl[kernel]["turns_ms"],
        "back_to_back_ms": fl[kernel]["back_to_back_ms"],
        "library_back_to_back_ms": fl[kernel]["library_back_to_back_ms"],
        "device_ms": fl[kernel]["device_ms"], "flops": fl[kernel]["flops"],
        "bytes": fl[kernel]["bytes"],
        "max_abs_err_float32": fl[kernel]["max_abs_err_float32"],
        "max_abs_err_bfloat16": fl[kernel]["max_abs_err_bfloat16"],
        # the CUDA-core kernel in float32 at the serving shape, and at
        # qwen3-moe's and pixtral-12b's (phase 3)
        "float32_shape": fl["simt_float32"] if kernel == fa.SIMT else None,
        "float32_moe_shape":
            fl["simt_float32_moe"] if kernel == fa.SIMT else None,
        "float32_vlm_shape":
            fl["simt_float32_vlm"] if kernel == fa.SIMT else None,
        # the wgmma kernel's alone (the cap's cost)
        "gemma_global_nocap_shape":
            fl["gemma_global_nocap_shape"].get(kernel),
        "edge_cases": len(FLASH_SIMT_EDGE if kernel == fa.SIMT
                          else FLASH_SM90_EDGE),
        "sass": fl["sass"] if kernel == fa.SIMT else None,
        # each wgmma instance's registers, stack, spills and wgmmas
        "instances": fl["instances_sm90"] if kernel == fa.SM90 else None,
    } for name, kernel, source in (
        ("flash_attention_sm90", fa.SM90,
         "src/repro_torch/kernels/csrc/flash_attention_sm90.cu"),
        ("flash_attention", fa.SIMT,
         "src/repro_torch/kernels/csrc/flash_attention.cu"))]}
    cell = dk["cases"]["cell"]
    serving = {"serve": sv, "moe": mo, "ssm": sm, "hybrid": hy, "vlm": vl,
               "audio": au, "gemma": gm, "qwen": qw}
    kernels["kernels"].append({
        "name": "decode_attn_kernel",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        # no TPU kernel: the reference's decode attention is jnp einsums
        # that XLA fuses
        "replaces": None,
        "reference": "src/repro/models/layers.py:104",
        "launches": sv["decode_attention_launches"]["wrapper"],
        # each serving phase's own run, counted from 0 by the wrapper and
        # on the card
        "launches_by_phase": {tag: r["decode_attention_launches"]
                              for tag, r in serving.items()},
        "phase_launches": {"wrapper": dk["launches"],
                           "on_card": dk["device_launches"]},
        "max_abs_err": cell["max_abs_err"],
        # 50 calls back to back between two CUDA events, twice (the
        # merge included); per_launch_ms adds the host's launch cost
        "ms": cell["ms"], "per_launch_ms": cell["per_launch_ms"],
        "plain_ms": cell["plain_ms"],
        "bound_ms": cell["bound_ms"], "bound_by": cell["bound_by"],
        "library_ms": cell["library_ms"],
        "library_call": cell["library_call"],
        "former_path_ms": cell["former_path_ms"],
        "device_ms": cell["device_ms"],
        "merge_device_ms": cell["merge_device_ms"],
        "profiled_launches": cell["profiled_launches"],
        "bytes": cell["bytes"], "splits": cell["splits"],
        "shape": "q (32, 1, 32, 128), k/v (32, 4224, 8, 128) bf16, pos 4223",
        "cases": len(dk["cases"]),
        "by_family": {tag: r for tag, r in dk["cases"].items()
                      if tag != "cell"},
        "split_sweep": dk["split_sweep"],
    })
    kernels["main_path"] = {"records": N_MDTS * RECORDS_PER_MDT,
                            "seconds": main["seconds"],
                            "records_per_s": main["records_per_s"],
                            "routing_reads": main["reads"],
                            "routing_launches": main["launches"],
                            "routing_s": main["routing_s"],
                            "routing_share": main["routing_share"],
                            "device_busy_ms": main["device_busy_ms"]}
    print(json.dumps({"serve": sv}), flush=True)
    print(json.dumps({"wire": wire}), flush=True)
    print(json.dumps({"activity": act}), flush=True)
    print(json.dumps({"elastic": el}), flush=True)
    print(json.dumps({"proxy": px}), flush=True)
    print(json.dumps({"train": tr}), flush=True)
    print(json.dumps({"moe": mo}), flush=True)
    print(json.dumps({"ssm": sm}), flush=True)
    print(json.dumps({"hybrid": hy}), flush=True)
    print(json.dumps({"vlm": vl}), flush=True)
    print(json.dumps({"audio": au}), flush=True)
    print(json.dumps({"gemma": gm}), flush=True)
    print(json.dumps({"qwen": qw}), flush=True)
    print(json.dumps({"mesh": ms}), flush=True)
    print(json.dumps({"roofline": rl}), flush=True)
    print(json.dumps({"train_families": trf}), flush=True)
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
