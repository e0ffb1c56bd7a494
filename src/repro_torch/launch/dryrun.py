"""Multi-pod dry run: trace every (arch x shape x mesh) cell on a fake
mesh.  The port of ``repro/launch/dryrun.py``.

The reference lowers and compiles each cell's step for the production
16x16 and 2x16x16 meshes of host devices and reads XLA's per-device
``cost_analysis``, ``memory_analysis`` and HLO.  The port has no
compiler to ask: it runs the step once on ``meta`` tensors (shapes and
dtypes, no storage, no device work) placed as DTensors on a
``DeviceMesh`` over a fake process group of 256 (or 512) ranks, as rank
0, and counts what that rank's local operations would do
(``hlo_analysis.OpCounter``).  Meta tensors, not ``FakeTensorMode``:
under a fake mode DTensor's own bookkeeping tensors turn fake too, and
a strided shard's offsets (``.tolist()``) then fail.

- ``flops``: of the matrix products, on the local shapes DTensor's
  sharding propagation picked;
- ``bytes``: operand plus result bytes of every local operation, an
  unfused upper bound like XLA:CPU's ``bytes accessed``;
- ``coll``: output bytes of every collective (all-reduce x2);
- ``memory``: the most local storage alive at once.

The fake process group is created inside ``run_cell``/``main``, never
at import, and destroyed after; a missing fake backend fails.

Differential probes.  The reference's XLA counts a ``while`` body once,
so it compiles reduced-depth, reduced-batch variants and solves the
per-device linear cost model

    f(bodies b, B_local, micros M) =
        opt(b) + M*g(b) + B_local*(e + b*c)

with opt(b) = o0 + b*o1 (once per step), g(b) = g0 + b*g1 (once per
microbatch) and e + b*c per local batch row.  The port has no scans:
its layers, microbatches and attention blocks are Python loops, so a
trace counts every body, and the probe model should reproduce the
full-depth trace; the probes are kept so that a cell too deep to trace
whole can be predicted, and so that the two packages' records compare
key for key.  ``hlo_flops_global`` and ``model_flops_ratio`` keep the
reference's names; here they are traced counts, not HLO's.

Attention is traced ``blockwise`` (the reference's default) or
``naive``.  The whole cell is traced in the step's own blocks (512 x
1024), the probes in blocks of at least an eighth of each sequence
(``layers.coarse_blocks``), as the reference's probes are
(``UNROLL_BLOCKS``): the same FLOPs and collectives, fewer bytes (fewer
passes over the running sums), and a trace of 32k tokens in 8 x 8
blocks, not 64 x 32.  ``coarse=True`` traces the whole cell in the
probes' grid too, where the host has not the time for the step's; the
record's ``attention_grid`` says which grid its ``raw``, ``memory`` and
counts are of.  ``flash`` is refused: the port's kernels are launched
through ``ctypes``, which neither a dispatch mode nor a meta tensor
sees.  The port's blockwise has no ``skip_blocks``, so a causal cell's
FLOPs include the masked blocks.

Usage (on the card's host by default; ``--device cpu`` anywhere):
    python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both --skip-existing
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "artifacts", "dryrun_torch")
METRICS = ("flops", "bytes", "coll")
#: attention implementations a trace can see
TRACEABLE_IMPLS = ("blockwise", "naive")


def _check_impl(attn_impl: str) -> None:
    if attn_impl == "flash":
        raise ValueError(
            "attn_impl='flash' cannot be traced: the attention kernels are "
            "launched through ctypes, which no dispatch mode or meta tensor "
            "sees; trace 'blockwise' (the reference's default) or 'naive'")
    if attn_impl not in TRACEABLE_IMPLS:
        raise ValueError(f"unknown attention impl {attn_impl!r}: "
                         f"{', '.join(TRACEABLE_IMPLS)}")


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0
    (no communication: collectives return at once), destroyed on exit.
    The dry run owns its group: one already initialised is refused, since
    real collectives on meta tensors, and rank 0's shards on every rank,
    would count nothing true."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError(
            f"a process group of {dist.get_world_size()} ranks is already "
            f"initialised; the dry run makes its own fake group")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_shape(shape, mesh, placements):
    """Rank 0's shard of a tensor of ``shape`` (the largest, where a
    dimension does not split evenly)."""
    from torch.distributed.tensor import Shard
    out = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            out[p.dim] = -(-out[p.dim] // mesh.size(i))
    return out


def _meta_args(tree, placements, mesh):
    """A DTensor for every meta tensor of ``tree``, placed by the
    matching leaf (a list of placements) of ``placements``: rank 0's
    local shard, a meta tensor with a storage of its own."""
    import torch
    from torch.distributed.tensor import DTensor
    if isinstance(tree, torch.Tensor):
        local = torch.empty(_local_shape(tree.shape, mesh, placements),
                            dtype=tree.dtype, device="meta")
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=tree.shape, stride=tree.stride())
    if isinstance(tree, dict):
        return {k: _meta_args(v, placements[k], mesh)
                for k, v in tree.items()}
    return [_meta_args(v, p, mesh) for v, p in zip(tree, placements)]


def _build_step(cfg, shape, rules, n_micro, attn_impl="blockwise",
                param_dtype=None, remat_policy="dots"):
    """(step, args) of a cell: the step of ``runtime.steps`` and its
    arguments as meta DTensors placed on ``rules.mesh`` as the ``specs``
    cell says.  The counterpart of the reference's ``_build_jitted``."""
    from ..optim.adamw import AdamWState
    from ..runtime import specs as SP
    from ..runtime.steps import (TrainHParams, build_decode_step,
                                 build_prefill_step, build_train_step)

    _check_impl(attn_impl)
    mesh = rules.mesh
    if shape.kind == "train":
        hp = TrainHParams(n_micro=n_micro, attn_impl=attn_impl,
                          remat_policy=remat_policy)
        (params, opt, batch), (p_sh, o_sh, b_sh), _ = SP.train_cell(
            cfg, shape, rules, param_dtype)
        params = _meta_args(params, p_sh, mesh)
        # the port's step counts on the host (``AdamWState.step``)
        opt = AdamWState(0, _meta_args(opt.m, o_sh.m, mesh),
                         _meta_args(opt.v, o_sh.v, mesh))
        return build_train_step(cfg, hp), (
            params, opt, _meta_args(batch, b_sh, mesh))
    if shape.kind == "prefill":
        step = build_prefill_step(cfg, max_seq=shape.seq_len,
                                  attn_impl=attn_impl)
        (params, batch), (p_sh, b_sh), _ = SP.prefill_cell(
            cfg, shape, rules, param_dtype)
        return step, (_meta_args(params, p_sh, mesh),
                      _meta_args(batch, b_sh, mesh))
    (params, cache, token, pos), shardings, _ = SP.decode_cell(
        cfg, shape, rules, param_dtype)
    return build_decode_step(cfg), tuple(
        _meta_args(a, s, mesh)
        for a, s in zip((params, cache, token, pos), shardings))


def _trace_and_measure(cfg, shape, rules, mesh, n_micro,
                       attn_impl="blockwise", param_dtype=None,
                       remat_policy="dots", coarse=False):
    """Run the cell's step once on meta DTensors on ``mesh`` (inside
    ``use_rules(rules)``) and count rank 0's local operations; blockwise
    attention in the step's own blocks, or with ``coarse`` in at most
    8 x 8 (a probe's).  The counterpart of the reference's
    ``_compile_and_measure``."""
    from ..models.layers import coarse_blocks
    from .hlo_analysis import (OpCounter, _nbytes, collective_bytes,
                               total_collective_bytes)

    t0 = time.time()
    step, args = _build_step(cfg, shape, rules, n_micro, attn_impl,
                             param_dtype, remat_policy)
    counter = OpCounter()
    with counter, (coarse_blocks() if coarse
                   else contextlib.nullcontext()):
        arg_bytes = counter.track(args)
        out = step(*args)
        peak = counter.peak
    out_bytes = _nbytes(_locals(out))
    del out, args
    per_coll = collective_bytes(counter.records)
    return {
        "flops": float(counter.flops),
        "bytes": float(counter.bytes),
        "coll": float(total_collective_bytes(per_coll)),
        "per_coll": per_coll,
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": peak - arg_bytes, "peak_bytes": peak},
        "wall_s": time.time() - t0,
    }


def _locals(tree):
    """``tree`` with each DTensor replaced by its local shard."""
    from ..runtime.sharding import is_dtensor
    if isinstance(tree, dict):
        return {k: _locals(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_locals(v) for v in tree]
    return tree.to_local() if is_dtensor(tree) else tree


def _reduced(cfg, k):
    """Config with k scan bodies (and k encoder layers for enc-dec)."""
    kw = {"n_layers": k * cfg.scan_period}
    if cfg.is_encoder_decoder:
        kw["n_encoder_layers"] = k
    return cfg.replace(**kw)


#: probe depths for the differential solve, the reference's
PROBE_BODIES = (2, 3)


def solve_probe_model(pts, metric):
    """Fit f(b, B, M) = opt(b) + M*g(b) + B*(e + b*c) to the probe
    traces in ``pts`` (keyed ``(bodies, B_local, M)``), for one
    metric.  Returns the coefficient dict {o0, o1, g0, g1, e, c}."""
    b1, b2 = PROBE_BODIES
    db = b2 - b1
    f11, f21 = pts[(b1, 1, 1)][metric], pts[(b2, 1, 1)][metric]
    f12, f22 = pts[(b1, 2, 1)][metric], pts[(b2, 2, 1)][metric]
    c = (f22 - f21 - f12 + f11) / db
    e = f12 - f11 - b1 * c
    a1 = (f21 - f11) / db - c       # = o1 + g1 (one micro at M=1)
    a0 = f11 - b1 * a1 - e - b1 * c  # = o0 + g0
    g0 = g1 = 0.0
    if (b1, 2, 2) in pts:
        gb1 = pts[(b1, 2, 2)][metric] - f12     # g(b1) = g0 + b1*g1
        gb2 = pts[(b2, 2, 2)][metric] - f22     # g(b2) = g0 + b2*g1
        g1 = (gb2 - gb1) / db
        g0 = gb1 - b1 * g1
    return {"o0": a0 - g0, "o1": a1 - g1, "g0": g0, "g1": g1,
            "e": e, "c": c}


def predict_probe_model(coeffs, bodies, b_local, n_micro=1):
    """Evaluate the fitted per-device cost model at production depth."""
    return (coeffs["o0"] + bodies * coeffs["o1"]
            + n_micro * (coeffs["g0"] + bodies * coeffs["g1"])
            + b_local * (coeffs["e"] + bodies * coeffs["c"]))


def run_probes(cfg, shape, rules, mesh, n_micro_full, attn_impl="blockwise",
               param_dtype=None, remat_policy="dots"):
    """The probe traces of a cell, keyed ``(bodies, B_local, M)``: both
    probe depths at one and two local batch rows, and for a training
    cell of several microbatches the two M = 2 points."""
    from ..runtime.sharding import use_rules

    dp = _dp(rules)
    pts = {}
    for k in PROBE_BODIES:    # bodies
        for bl in (1, 2):     # local batch rows per device
            pshape = dataclasses.replace(shape, global_batch=dp * bl)
            with use_rules(rules):
                pts[(k, bl, 1)] = _trace_and_measure(
                    _reduced(cfg, k), pshape, rules, mesh, 1, attn_impl,
                    param_dtype, remat_policy, coarse=True)
    if shape.kind == "train" and n_micro_full > 1:
        pshape = dataclasses.replace(shape, global_batch=dp * 2)
        for k in PROBE_BODIES:  # measure the per-micro term g(b)
            with use_rules(rules):
                pts[(k, 2, 2)] = _trace_and_measure(
                    _reduced(cfg, k), pshape, rules, mesh, 2, attn_impl,
                    param_dtype, remat_policy, coarse=True)
    return pts


def _dp(rules) -> int:
    from ..runtime.sharding import mesh_size
    return max(mesh_size(rules.mesh, rules.rules["batch"]), 1)


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             overrides_json: str = "", tag: str = "",
             probes: bool = True, attn_impl: str = "blockwise",
             n_micro: int = 0, serve_dtype: str = "",
             cfg_overrides: str = "", remat_policy: str = "dots",
             device: str = "cuda", full: bool = True,
             coarse: bool = False) -> dict:
    """Trace one cell (and its probes) on the production mesh of
    ``mesh_kind`` over a fake process group; writes and returns the
    reference's record.  ``full=False`` traces the probes alone (a cell
    too deep to trace whole in the time it has): the record's ``raw``
    and ``memory`` are then those of the deepest, widest probe.
    ``coarse`` traces the whole cell in the probes' attention grid."""
    import torch

    from .. import configs as C
    from ..models import transformer as T
    from ..models.config import SHAPES, shape_applicable
    from ..runtime import specs as SP
    from ..runtime.sharding import use_rules
    from . import mesh as M
    from .hlo_analysis import roofline

    _check_impl(attn_impl)
    if not (full or probes):
        raise ValueError("a cell with neither its full trace nor its probes "
                         "measures nothing")
    dev = T.resolve_device(device).type
    cfg = C.get_config(arch)
    if cfg_overrides:
        cfg = cfg.replace(**json.loads(cfg_overrides))
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "tag": tag, "status": "skip", "reason": reason}
    os.makedirs(out_dir, exist_ok=True)
    fn = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}"
                      + (f"__{tag}" if tag else "") + ".json")
    if not ok:
        with open(fn, "w") as fh:
            json.dump(result, fh, indent=1)
        return result

    multi = mesh_kind == "multi"
    n_dev = 512 if multi else 256
    with fake_group(n_dev):
        mesh = M.make_production_mesh(multi_pod=multi, device=dev)
        overrides = json.loads(overrides_json) if overrides_json else None
        rules = SP.cell_rules(cfg, shape, mesh, overrides)
        dp = _dp(rules)
        n_micro_full = max(1, shape.global_batch // dp) \
            if shape.kind == "train" else 1
        if n_micro:
            n_micro_full = n_micro
        param_dtype = {"": None, "bf16": torch.bfloat16,
                       "f32": torch.float32}[serve_dtype]
        n_bodies = cfg.n_bodies
        b_loc_full = max(1, shape.global_batch // dp)

        # ------------------------------------------------- 1. full trace
        if full:
            with use_rules(rules):
                whole = _trace_and_measure(
                    cfg, shape, rules, mesh, n_micro_full, attn_impl,
                    param_dtype, remat_policy, coarse=coarse)
        # --------------------------------------------- 2. roofline probes
        if probes:
            pts = run_probes(cfg, shape, rules, mesh, n_micro_full,
                             attn_impl, param_dtype, remat_policy)
    if not full:
        whole = pts[max(pts)]
    result.update({
        "status": "ok", "n_devices": n_dev, "dp": dp,
        "n_micro": n_micro_full, "n_bodies": n_bodies, "device": dev,
        "full_trace": full,
        # the blockwise grid of ``raw``, ``memory`` and (where the whole
        # cell was traced) the roofline's counts
        "attention_grid": "coarse" if coarse or not full else "default",
        "compile_wall_s": round(whole["wall_s"], 1),
        "raw": {k: whole[k] for k in METRICS},
        "collectives_full": whole["per_coll"],
        "memory": whole["memory"],
    })
    if probes:
        corrected, coeffs = {}, {}
        for m in METRICS:
            coeffs[m] = solve_probe_model(pts, m)
            corrected[m] = predict_probe_model(coeffs[m], n_bodies,
                                               b_loc_full, n_micro_full)
        result["probe_walls_s"] = {str(k): round(v["wall_s"], 1)
                                   for k, v in pts.items()}
        result["probe_coeffs"] = coeffs
        result["corrected"] = corrected
    # the traced counts where the full trace ran (the port counts every
    # body), else the probe model's prediction
    src = whole if full else corrected
    flops, bytes_, coll = (src[m] for m in METRICS)

    # useful-model-FLOPs accounting (per step, global)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    per_tok = T.model_flops_per_token(cfg)           # 6·N_active
    if shape.kind != "train":
        per_tok /= 3.0                                # 2·N_active (no bwd)
    model_flops = per_tok * tokens

    rf = roofline(flops, bytes_, coll, peak_flops=M.PEAK_FLOPS_BF16,
                  hbm_bw=M.HBM_BW, ici_bw=M.NETWORK_BW)
    result.update({
        "flops_per_device": flops, "bytes_per_device": bytes_,
        "collective_bytes_per_device": coll,
        "collective_bw": M.NETWORK_BW,
        "model_flops_global": model_flops,
        "hlo_flops_global": flops * n_dev,
        "model_flops_ratio": (model_flops / (flops * n_dev)
                              if flops else None),
        **rf,
    })
    with open(fn, "w") as fh:
        json.dump(result, fh, indent=1)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--coarse", action="store_true",
                    help="trace the whole cell in the probes' attention "
                         "grid (at most 8 x 8 blocks; a faster trace)")
    ap.add_argument("--attn-impl", default="blockwise")
    ap.add_argument("--out", default=os.path.abspath(ARTIFACTS))
    ap.add_argument("--overrides", default="",
                    help="JSON dict of logical-rule overrides (perf exps)")
    ap.add_argument("--tag", default="", help="artifact suffix for perf exps")
    ap.add_argument("--n-micro", type=int, default=0,
                    help="override microbatch count (train cells)")
    ap.add_argument("--serve-dtype", default="",
                    help="param dtype for serve cells (bf16|f32)")
    ap.add_argument("--cfg-overrides", default="",
                    help="JSON dict applied via ModelConfig.replace")
    ap.add_argument("--remat-policy", default="dots",
                    choices=["dots", "none", "everything"])
    ap.add_argument("--device", default="cuda",
                    help="device type of the mesh (cuda, the default, "
                         "or cpu)")
    args = ap.parse_args(argv)
    _check_impl(args.attn_impl)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.all:
        from .. import configs as C
        from ..models.config import SHAPES
        failures = []
        for arch in C.list_archs():
            for shape in SHAPES:
                for mesh_kind in meshes:
                    fn = os.path.join(args.out,
                                      f"{arch}__{shape}__{mesh_kind}.json")
                    if args.skip_existing and os.path.exists(fn):
                        print(f"[skip] {arch} {shape} {mesh_kind}",
                              flush=True)
                        continue
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape,
                           "--mesh", mesh_kind, "--out", args.out,
                           "--device", args.device]
                    if mesh_kind == "multi" or args.no_probes:
                        cmd.append("--no-probes")  # roofline is single-pod
                    if args.coarse:
                        cmd.append("--coarse")
                    t0 = time.time()
                    print(f"[run ] {arch} {shape} {mesh_kind}", flush=True)
                    rc = subprocess.call(cmd, stdout=subprocess.DEVNULL)
                    print(f"       rc={rc} {time.time()-t0:.0f}s", flush=True)
                    if rc != 0:
                        failures.append((arch, shape, mesh_kind))
        print(f"done; {len(failures)} failures: {failures}")
        return 1 if failures else 0

    res = run_cell(args.arch, args.shape, meshes[0], args.out,
                   overrides_json=args.overrides, tag=args.tag,
                   probes=not args.no_probes, attn_impl=args.attn_impl,
                   n_micro=args.n_micro, serve_dtype=args.serve_dtype,
                   cfg_overrides=args.cfg_overrides,
                   remat_policy=args.remat_policy, device=args.device,
                   coarse=args.coarse)
    if res.get("status") == "skip":
        print(f"SKIP {args.arch} {args.shape}: {res['reason']}")
        return 0
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("collectives_full", "memory", "raw")},
                     indent=1))
    print("memory:", res.get("memory"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
