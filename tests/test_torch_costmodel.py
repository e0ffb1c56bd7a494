"""Parity of the port's cost models (``repro_torch.launch.dryrun``,
``.hlo_analysis``, ``.roofline_model`` and
``models.transformer.model_flops_per_token``) with ``repro.launch``.

- The analytic pieces are pure functions of the configs and equal the
  reference's exactly: model FLOPs per token and active parameters for
  all ten full configs; the HBM-traffic model and the cache bytes for
  every architecture, every shape that applies to it, three meshes and
  one or sixteen microbatches (relative 1e-12); the roofline and the
  probe model's solve and prediction on the same points.
- The collective accounting: collectives issued on meta tensors over a
  fake process group, counted by ``OpCounter``, give the bytes and counts
  the reference's parse gives for HLO lines of the same collectives.
- The traced counts: one sharded product's FLOPs on a fake 16x16 mesh
  are each rank's local product's, checked by hand; the granite-8b smoke
  cell's whole trace on a fake 2x2 mesh (training, prefill and decode)
  equals a count by hand from its config, FLOPs and collective bytes of
  each type; and the probe model against that trace, the counterpart of
  ``tests/test_roofline.py`` (whose reference run cannot make its mesh
  under this jax, ROADMAP caveats): the port has no scans, so FLOPs and
  collectives agree exactly, and so do a training cell's bytes.
- The probes' coarse attention grid counts the FLOPs and collectives of
  the step's own grid, and fewer bytes.
- ``attn_impl="flash"`` is refused: no dispatch mode sees the kernels;
  and so is a process group the dry run did not make.

Each fake process group is created inside its test and destroyed
(``dryrun.fake_group``); the cost models start none at import.
"""

from __future__ import annotations

import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as RC                           # noqa: E402
from repro.launch import hlo_analysis as RH               # noqa: E402
from repro.launch import roofline_model as RR             # noqa: E402
from repro.models import transformer as RT                # noqa: E402
from repro.models.config import SHAPES as RSHAPES         # noqa: E402
from repro_torch import configs as PC                     # noqa: E402
from repro_torch.launch import dryrun as PD               # noqa: E402
from repro_torch.launch import hlo_analysis as PH         # noqa: E402
from repro_torch.launch import mesh as PM                 # noqa: E402
from repro_torch.launch import roofline_model as PR       # noqa: E402
from repro_torch.models import transformer as PT          # noqa: E402
from repro_torch.models.config import SHAPES, ShapeConfig, \
    shape_applicable                                       # noqa: E402
from repro_torch.runtime import specs as PSp              # noqa: E402
from repro_torch.runtime.sharding import use_rules        # noqa: E402


def reference_dryrun():
    """``repro.launch.dryrun`` without its import-time ``XLA_FLAGS``
    (512 host devices), which would give every JAX backend this process
    starts later, other test files' included, 512 devices."""
    import importlib
    import os
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


RD = reference_dryrun()
ARCHS = PC.list_archs()
#: (n_dev, dp, tp) of one card, the 16x16 pod and the 2x16x16 multi-pod
MESHES = [(1, 1, 1), (256, 16, 16), (512, 32, 16)]
REL = 1e-12
#: the probe model against the whole trace, by cell kind (relative).
#: Exact (float rounding) but for serving's bytes: there, at one local
#: row, some copies (``contiguous``, ``reshape``) cost nothing, so the
#: bytes are not quite linear in the local rows (measured 0.27 % in
#: prefill, 7.8 % in decode); the reference's own bands are 1e-6 for
#: FLOPs, 0.20 for bytes and 0.15 for collectives
EXACT = 1e-12
BANDS = {"train": {"flops": EXACT, "bytes": EXACT, "coll": EXACT},
         "prefill": {"flops": EXACT, "bytes": 0.005, "coll": EXACT},
         "decode": {"flops": EXACT, "bytes": 0.10, "coll": EXACT}}


def rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


# ----------------------------------------------------- the analytic models
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_active_params_equal_the_reference(arch):
    cfg, rcfg = PC.get_config(arch), RC.get_config(arch)
    assert PT.count_params(cfg, active_only=True) == \
        RT.count_params(rcfg, active_only=True)
    assert PT.model_flops_per_token(cfg) == RT.model_flops_per_token(rcfg)


def cells(arch):
    for name, shape in SHAPES.items():
        if shape_applicable(PC.get_config(arch), shape)[0]:
            yield name, shape


@pytest.mark.parametrize("arch", ARCHS)
def test_hbm_model_and_cache_bytes_equal_the_reference(arch):
    """Every applicable shape x mesh x n_micro: ``estimate_hbm_bytes``,
    ``_cache_bytes`` (the port's per-layer meta cache, the reference's
    stacked tree) and the roofline of the model FLOPs and those bytes."""
    cfg, rcfg = PC.get_config(arch), RC.get_config(arch)
    n = 0
    for name, shape in cells(arch):
        rshape = RSHAPES[name]
        assert PR._cache_bytes(cfg, shape) == RR._cache_bytes(rcfg, rshape)
        for n_dev, dp, tp in MESHES:
            for n_micro in (1, 16):
                kw = dict(n_dev=n_dev, dp=dp, tp=tp, n_micro=n_micro)
                got = PR.estimate_hbm_bytes(cfg, shape, **kw)
                want = RR.estimate_hbm_bytes(rcfg, rshape, **kw)
                assert rel(got, want) <= REL, (name, kw, got, want)
                flops = PT.model_flops_per_token(cfg) * shape.global_batch
                consts = dict(peak_flops=PM.PEAK_FLOPS_BF16,
                              hbm_bw=PM.HBM_BW, ici_bw=PM.NETWORK_BW)
                assert PH.roofline(flops / n_dev, got, got / 7, **consts) \
                    == RH.roofline(flops / n_dev, want, want / 7, **consts)
                n += 1
    assert n >= 3 * 2 * 3


def probe_points(rng, train: bool):
    keys = [(b, bl, 1) for b in PD.PROBE_BODIES for bl in (1, 2)]
    if train:
        keys += [(b, 2, 2) for b in PD.PROBE_BODIES]
    return {k: {m: float(rng.uniform(1e9, 1e13)) for m in PD.METRICS}
            for k in keys}


@pytest.mark.parametrize("train", [False, True])
def test_probe_model_equals_the_reference(train):
    assert PD.PROBE_BODIES == RD.PROBE_BODIES and PD.METRICS == RD.METRICS
    rng = np.random.default_rng(5 + train)
    for _ in range(20):
        pts = probe_points(rng, train)
        for m in PD.METRICS:
            got, want = (mod.solve_probe_model(pts, m) for mod in (PD, RD))
            assert got == want
            for bodies, b_loc, n_micro in ((36, 16, 16), (40, 2, 1),
                                           (12, 8, 1)):
                assert PD.predict_probe_model(got, bodies, b_loc, n_micro) \
                    == RD.predict_probe_model(want, bodies, b_loc, n_micro)
    cfg, rcfg = PC.get_config("jamba-v0.1-52b"), RC.get_config(
        "jamba-v0.1-52b")
    assert PD._reduced(cfg, 2) == PC.get_config("jamba-v0.1-52b").replace(
        n_layers=16)
    assert dataclasses.asdict(PD._reduced(cfg, 3)) == \
        dataclasses.asdict(RD._reduced(rcfg, 3))


# ----------------------------------------------- the collective accounting
def issue_collectives(mesh):
    """One of each collective a DTensor program issues, on meta tensors
    over ``mesh``'s ``model`` group (four ranks); returns the counter."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    group = mesh.get_group("model")
    x = torch.empty(4, 1024, dtype=torch.bfloat16, device="meta")
    y = torch.empty(1024, dtype=torch.float32, device="meta")
    counter = PH.OpCounter()
    with counter:
        for t in (funcol.all_gather_tensor(x, 0, group),
                  funcol.all_reduce(y, "sum", group),
                  funcol.reduce_scatter_tensor(y, "sum", 0, group),
                  funcol.all_to_all_single(x, None, None, group)):
            funcol.wait_tensor(t)
        dist.all_reduce(y, group=group)
    return counter


#: the reference's HLO for the same collectives: per-device output
#: shapes, an async all-gather pair counted once
SAME_HLO = "\n".join([
    "  %ag-start = (bf16[4,1024]{1,0}, bf16[16,1024]{1,0}) all-gather-start("
    "bf16[4,1024]{1,0} %x), replica_groups={{0,1,2,3}}, dimensions={0}",
    "  %ag-done = bf16[16,1024]{1,0} all-gather-done((bf16[4,1024]{1,0}, "
    "bf16[16,1024]{1,0}) %ag-start)",
    "  %ar = f32[1024]{0} all-reduce(f32[1024]{0} %y), "
    "replica_groups={{0,1,2,3}}, to_apply=%add",
    "  %rs = f32[256]{0} reduce-scatter(f32[1024]{0} %y), "
    "replica_groups={{0,1,2,3}}, dimensions={0}, to_apply=%add",
    "  %a2a = bf16[4,1024]{1,0} all-to-all(bf16[4,1024]{1,0} %x), "
    "replica_groups={{0,1,2,3}}, dimensions={0}",
    "  ROOT %ar.1 = f32[1024]{0} all-reduce(f32[1024]{0} %y), "
    "replica_groups={{0,1,2,3}}, to_apply=%add"])


def test_collective_bytes_match_the_reference_parse():
    with PD.fake_group(16):
        counter = issue_collectives(PM.make_host_mesh(4, 4, device="cpu"))
    got = PH.collective_bytes(counter.records)
    want = RH.collective_bytes(SAME_HLO)
    # the async all-gather's start tuple holds its operand too: the
    # reference counts both shapes of the tuple
    want["all-gather"]["bytes"] -= 4 * 1024 * 2
    print(f"collectives: {got}")
    assert got == want
    assert PH.total_collective_bytes(got) == \
        16 * 1024 * 2 + 2 * 2 * 1024 * 4 + 256 * 4 + 4 * 1024 * 2
    assert PH.COLLECTIVES == RH.COLLECTIVES
    assert PH.DTYPE_BYTES == RH.DTYPE_BYTES


# ---------------------------------------------------------- traced counts
def test_sharded_product_counts_each_rank_s_local_flops():
    """(256, 4096) sharded by rows over ``data`` times (4096, 14336)
    sharded by columns over ``model``: rank 0 multiplies (16, 4096) by
    (4096, 896), 2 * 16 * 4096 * 896 FLOPs, not the global product's
    256 times as many (DTensor's op is the global one)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with PD.fake_group(256):
        mesh = PM.make_production_mesh(device="cpu")
        x = DTensor.from_local(torch.empty(16, 4096, device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(4096, 896, device="meta"), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        counter = PH.OpCounter()
        with counter:
            counter.track((x, w))
            y = x @ w
            assert y.to_local().shape == (16, 896)
            y = y.redistribute(mesh, [Shard(0), Replicate()])
    assert counter.flops == 2 * 16 * 4096 * 896
    assert PH.collective_bytes(counter.records)["all-gather"] == \
        {"bytes": 16 * 14336 * 4, "count": 1}
    assert counter.peak >= (16 * 4096 + 4096 * 896 + 16 * 896) * 4


#: the smoke cell of the probe and by-hand checks: granite-8b's smoke
#: config at depth 5, 8 sequences of 32 tokens on a fake 2x2 mesh
CELL_LAYERS, CELL_B, CELL_S, CELL_DP, CELL_TP = 5, 8, 32, 2, 2


@functools.lru_cache(maxsize=None)
def cell_traces(kind):
    """The probe traces (2 and 3 bodies, 1 and 2 local rows) and the
    whole trace of the smoke cell of ``kind`` (train, prefill or
    decode), traced once for this file's tests."""
    cfg = PC.get_smoke("granite-8b").replace(n_layers=CELL_LAYERS)
    shape = ShapeConfig("t", CELL_S, CELL_B, kind)
    with PD.fake_group(CELL_DP * CELL_TP):
        mesh = PM.make_host_mesh(CELL_DP, CELL_TP, device="cpu")
        rules = PSp.cell_rules(cfg, shape, mesh)
        pts = PD.run_probes(cfg, shape, rules, mesh, 1)
        with use_rules(rules):
            truth = PD._trace_and_measure(cfg, shape, rules, mesh, 1)
    return cfg, pts, truth


def by_hand(cfg, kind):
    """Per-device FLOPs and collective bytes of the smoke cell of
    ``kind``, counted from the config: a dense GQA model with a SwiGLU
    MLP and an untied unembedding, batch over ``data`` (dp) and heads,
    MLP columns and vocabulary over ``model`` (tp), FSDP shards of
    ``embed`` over ``data``.  Collectives in the reference's convention
    (output bytes per device, an all-reduce twice).  Returns (FLOPs,
    {type: bytes})."""
    L, dp, tp = CELL_LAYERS, CELL_DP, CELL_TP
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    ff, V = cfg.d_ff, cfg.padded_vocab
    Bl, S = CELL_B // dp, CELL_S
    T = Bl * (1 if kind == "decode" else S)      # local tokens a step
    P = d * (H + 2 * KV) * hd + H * hd * d + 3 * d * ff  # products' weights
    bf16, f32 = 2, 4
    coll = {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0}

    def add(kind_, nbytes, n=1):
        coll[kind_] += n * nbytes * (2 if kind_ == "all-reduce" else 1)

    # the products: each weight's tp shard on the local tokens
    mm = 2 * P * T // tp
    if kind == "decode":
        # the new token, every head, against the rank's 1/tp of the
        # cache's positions (sequence-sharded): q.k and p.v
        attn = 2 * 2 * Bl * H * (S // tp) * hd
    else:
        # the rank's heads over the whole S x S grid, masked blocks too
        attn = 2 * 2 * Bl * (H // tp) * S * S * hd
    unembed_rows = T if kind == "train" else Bl  # serving: last position
    unembed = 2 * unembed_rows * d * V // tp
    if kind == "train":
        # forward and backward (twice) of every product; attention's
        # batched products once more in the recompute (remat "dots"
        # keeps only the unbatched products)
        flops = 3 * (L * mm + unembed) + 4 * L * attn
    else:
        flops = L * (mm + attn) + unembed

    # each layer: FSDP all-gathers of its weights (bf16, to their tp
    # shard) and of its two norms (f32, whole); the residual stream's
    # all-reduce after attention and after the MLP
    weights, norms = bf16 * P // tp, 2 * f32 * d
    residual = bf16 * T * d
    gathers = weights + norms
    if kind == "decode":
        # the new token's q, k and v gathered over heads; the softmax
        # over the sequence-sharded cache combined: its max and
        # denominator (f32, a row and head each) and its partial output
        gathers += bf16 * Bl * (H + 2 * KV) * hd
        add("all-reduce", f32 * Bl * H, 2 * L)
        add("all-reduce", f32 * Bl * H * hd, L)
    else:
        # k and v gathered over ``model`` whole before each rank slices
        # its q heads' kv heads (``map_local_heads``)
        gathers += 2 * bf16 * Bl * S * KV * hd
    if kind == "prefill":
        # k and v laid out for the cache (sequence over ``model``):
        # gathered whole, then sliced
        gathers += 2 * bf16 * Bl * S * KV * hd
    add("all-gather", gathers, L)
    add("all-reduce", residual, 2 * L)
    if kind == "train":
        # the recompute gathers the layer's weights again and repeats
        # the attention's all-reduce; the backward all-reduces the
        # residual's gradient twice (``grad_placed_as``), reduce-scatters
        # each weight's gradient (bf16) to its FSDP shard, each norm's
        # (f32) over ``data`` and all-reduces it over ``model``; the
        # gradient norm all-reduces a scalar per sharded mesh dimension
        # of each leaf (two for the products' weights, one for a norm)
        add("all-gather", gathers, L)
        add("all-reduce", residual, 3 * L)
        add("reduce-scatter", bf16 * P // (dp * tp), L)
        add("reduce-scatter", f32 * d // dp, 2 * L)
        add("all-reduce", f32 * d // dp, 2 * L)
        add("all-reduce", f32, (7 * 2 + 2) * L)

    # once a step: the embedding table gathered whole in f32 (over
    # ``data``, then over ``model``), the final norm, the unembedding's
    # tp shard
    add("all-gather", f32 * V * d // tp + f32 * V * d + f32 * d
        + bf16 * d * V // tp)
    if kind == "train":
        # the loss, vocab-parallel: three all-reduces of a float32 a
        # token over ``model`` (the max of the ranks' log-sum-exps, the
        # sum of their shifted exponentials, the label logit) and none in
        # its backward; the unembedding's gradient
        # reduce-scattered, the final norm's as a layer norm's, the
        # embedding's reduce-scattered over ``data`` then all-reduced
        # over ``model``; the gradient norm's scalars for the embedding,
        # unembedding and final norm (2 + 2 + 1) and the loss's mean
        add("all-reduce", f32 * T, 3)
        add("reduce-scatter", bf16 * d * V // (dp * tp))
        add("reduce-scatter", f32 * d // dp)
        add("all-reduce", f32 * d // dp)
        add("reduce-scatter", f32 * V * d // dp)
        add("all-reduce", f32 * V * d // dp)
        add("all-reduce", f32, 2 + 2 + 1 + 1)
    return flops, coll


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_traced_counts_equal_a_count_by_hand(kind):
    """The whole trace of the smoke cell counts, per device, exactly the
    FLOPs and the collective bytes of each type that ``by_hand`` counts
    from the config: a plan that repeats work over a mesh axis, or moves
    what it need not, shows here even where it is linear in depth and
    local rows (so the probe model would fit it)."""
    cfg, _pts, truth = cell_traces(kind)
    flops, coll = by_hand(cfg, kind)
    got = {k: v["bytes"] for k, v in truth["per_coll"].items() if v["count"]}
    print(f"{kind}: traced {truth['flops']:.0f} FLOPs, {got}; by hand "
          f"{flops} FLOPs, {coll}")
    assert truth["flops"] == flops
    assert got == {k: v for k, v in coll.items() if v}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_probe_model_matches_the_full_depth_trace(kind):
    """The port has no scans and places its weights and residual stream
    as the rules say, so its per-device counts are linear in depth and
    local rows: the probe model of the four probes (2 and 3 bodies, 1
    and 2 local rows) gives the whole trace's counts at depth 5 and 4
    local rows within ``BANDS``."""
    _cfg, pts, truth = cell_traces(kind)
    assert truth["flops"] > 0 and truth["coll"] > 0
    errs = {m: rel(PD.predict_probe_model(PD.solve_probe_model(pts, m),
                                          CELL_LAYERS, CELL_B // CELL_DP),
                   truth[m]) for m in PD.METRICS}
    print(f"{kind}: probe model vs the full-depth trace, relative: {errs}")
    for m, e in errs.items():
        assert e <= BANDS[kind][m], m


def test_coarse_grid_counts_the_same_flops_and_fewer_bytes():
    """One smoke layer at 8192 tokens: the step's grid (512 x 1024
    blocks, 16 x 8) and the probes' (at most 8 x 8) count the same FLOPs
    and collectives; the coarse grid passes over its running sums fewer
    times, so counts fewer bytes."""
    cfg = PC.get_smoke("granite-8b").replace(n_layers=1)
    shape = ShapeConfig("t", 8192, 2, "prefill")
    with PD.fake_group(4):
        mesh = PM.make_host_mesh(2, 2, device="cpu")
        rules = PSp.cell_rules(cfg, shape, mesh)
        with use_rules(rules):
            step, coarse = (PD._trace_and_measure(
                cfg, shape, rules, mesh, 1, coarse=c) for c in (False, True))
    print(f"step's grid: {step['flops']:.0f} FLOPs, {step['bytes']:.0f} "
          f"bytes; coarse: {coarse['flops']:.0f}, {coarse['bytes']:.0f}")
    assert step["flops"] == coarse["flops"] > 0
    assert step["per_coll"] == coarse["per_coll"]
    assert step["bytes"] > coarse["bytes"]


def test_run_cell_writes_the_reference_record(tmp_path):
    """whisper-small's 32k decode at full width on the fake 16x16 mesh
    through ``main``: the reference's keys, a FLOP count consistent with
    the probes, memory from the trace; long_500k skips a dense model."""
    assert PD.main(["--device", "cpu", "--arch", "whisper-small",
                    "--shape", "decode_32k", "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "whisper-small__decode_32k__single.json")
                     .read_text())
    for key in ("arch", "shape", "mesh", "status", "n_devices", "dp",
                "n_micro", "n_bodies", "raw", "collectives_full", "memory",
                "probe_coeffs", "corrected", "flops_per_device",
                "bytes_per_device", "collective_bytes_per_device",
                "model_flops_global", "hlo_flops_global",
                "model_flops_ratio", "compute_s", "memory_s",
                "collective_s", "dominant", "step_time_lower_bound_s",
                "roofline_fraction"):
        assert key in rec, key
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rel(rec["corrected"]["flops"], rec["raw"]["flops"]) <= 1e-6
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
    assert rec["collective_bw"] == PM.NETWORK_BW
    skip = PD.run_cell("granite-8b", "long_500k", "single", str(tmp_path),
                       device="cpu")
    assert skip["status"] == "skip"


def test_flash_attention_cannot_be_traced(tmp_path):
    with pytest.raises(ValueError, match="ctypes"):
        PD.run_cell("granite-8b", "prefill_32k", "single", str(tmp_path),
                    attn_impl="flash", device="cpu")
    with pytest.raises(ValueError, match="ctypes"):
        PD.main(["--device", "cpu", "--arch", "granite-8b", "--shape",
                 "prefill_32k", "--attn-impl", "flash"])
    with pytest.raises(ValueError, match="unknown attention impl"):
        PD._check_impl("pallas")


def test_the_dry_run_refuses_a_group_it_did_not_make():
    """Real collectives on meta tensors, and rank 0's shards on every
    rank, would count nothing true: ``fake_group`` (and so ``run_cell``)
    refuses any initialised process group, and destroys its own."""
    import torch.distributed as dist
    with PD.fake_group(4):
        with pytest.raises(RuntimeError, match="already initialised"):
            with PD.fake_group(4):
                pass
    assert not dist.is_initialized()
