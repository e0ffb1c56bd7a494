"""Parity of the port's sharded path (``repro_torch.runtime.sharding``,
``.specs``, the model's axes and head padding) with ``repro.runtime`` and
``repro.models``, and the sharded model on four gloo ranks.

The spec, layout and cell tests run in this process: on a (1, 1) mesh (a
one-rank gloo group on a ``FileStore``, destroyed afterwards; the
reference's ``jax.make_mesh``) and on the production shapes, which one
CPU device cannot make (the reference's ``AbstractMesh``; a stand-in with
the port's ``mesh_dim_names`` and ``shape``: both packages' rules read
only the axis names and sizes).  The port's layout drops the
reference's stacked ``layers`` axis: layer ``l`` is body ``l //
scan_period``, slot ``l % scan_period``.

The sharded model runs in one spawn of four ranks on a 2x2 ``(data,
model)`` mesh (``torch_ranks_sharding.py``), against the reference's
unsharded loss computed here: seeded numpy weights in the reference's
layout (its ``init_params`` seeds by Python's salted ``hash``, so it
differs per process).  Tolerances are the reference's own
(``tests/test_sharding.py``: 5e-2 on the loss; 2e-5 on head padding),
1e-2 relative on the grad norm, and 2e-5 in float32 where sharding must
not change the numbers beyond the order of sums.  The vocab-parallel
cross entropy (logits split over the vocabulary) holds its float32 loss
within 1.2e-4 of the reference's and its gradients within 1e-5 of each
gradient's largest entry of the unsharded port's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                # noqa: E402
import jax.numpy as jnp                                   # noqa: E402
from jax.sharding import AbstractMesh                     # noqa: E402

from repro import configs as RC                           # noqa: E402
from repro.models import layers as RL                     # noqa: E402
from repro.models import transformer as RT                # noqa: E402
from repro.models.config import ModelConfig as RModelConfig  # noqa: E402
from repro.models.config import ShapeConfig as RShape     # noqa: E402
from repro.runtime import sharding as RSh                 # noqa: E402
from repro.runtime import specs as RSp                    # noqa: E402
from repro_torch import configs as PC                     # noqa: E402
from repro_torch.models import layers as PL               # noqa: E402
from repro_torch.models import transformer as PT          # noqa: E402
from repro_torch.models.config import ModelConfig, ShapeConfig  # noqa: E402
from repro_torch.optim import adamw as PA                 # noqa: E402
from repro_torch.runtime import sharding as PSh           # noqa: E402
from repro_torch.runtime import specs as PSp              # noqa: E402
from test_torch_encdec import draw_extras                 # noqa: E402
from test_torch_moe import ref_weights                    # noqa: E402
import torch_ranks                                        # noqa: E402
from torch_ranks_sharding import CE_ARCHS, FAMILIES       # noqa: E402

ARCHS = PC.list_archs()
LOSS_ATOL = 5e-2
GRAD_NORM_RTOL = 1e-2
HEAD_PAD_TOL = 2e-5
FP32_ATOL = 2e-5
#: the families' float32 prefill and decode logits against the
#: reference's (the families' own cross-package bound)
FAMILY_FP32_ATOL = 1e-4
#: the vocab-parallel cross entropy's float32 loss against the
#: reference's single-device loss; and its gradients against the
#: unsharded port's, relative to each gradient's largest entry: the same
#: float32 sums in another order over the ranks' columns, and the
#: table's entries sums over the batch's tokens, which cancel
CE_LOSS_ATOL = 1.2e-4
CE_GRAD_RTOL = 1e-5
#: (B, S) of the families' inputs: the batch splits over the data axis
FAMILY_BS = (4, 16)
#: (B, S) of the cells: the second batch divides no DP axis of the
#: production meshes
CELL_SHAPES = [(64, 32), (6, 16)]


@dataclass
class StandIn:
    """The port's view of a mesh for specs: axis names and sizes."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


MESHES = {"host": ((1, 1), ("data", "model")),
          "pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def host_mesh(tmp_path_factory):
    """The port's (1, 1) ``DeviceMesh`` over a one-rank gloo group."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield make_host_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def meshes(name, host_mesh):
    """(port mesh, reference mesh) of a ``MESHES`` entry."""
    shape, names = MESHES[name]
    if name == "host":
        return host_mesh, jax.make_mesh(shape, names)
    return StandIn(names, shape), AbstractMesh(shape, names)


def stacked(ref_tree, cfg, l):
    """Layer ``l`` of a tree stacked over bodies (``body/slot{s}``)."""
    return ref_tree["body"][f"slot{l % cfg.scan_period}"]


def each_leaf(port, ref, fn, path=()):
    """``fn(path, port_leaf, ref_leaf)`` over two trees of one structure
    (dicts), the port's leaves tuples of logical axes or tensors."""
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref), path
        for k in port:
            each_leaf(port[k], ref[k], fn, path + (k,))
    else:
        fn(path, port, ref)


def each_layer_leaf(cfg, port_tree, ref_tree, fn, drop_layers=True):
    """``fn`` over the top leaves and, layer by layer, over the port's
    per-layer leaves against the reference's stacked ones."""
    for k in ("embed", "final_norm", "unembed", "enc_norm"):
        if k in ref_tree:
            fn((k,), port_tree[k], ref_tree[k])
    for l, layer in enumerate(port_tree["layers"]):
        each_leaf(layer, stacked(ref_tree, cfg, l), fn, ("layers", l))
    if "enc_body" in ref_tree:
        for l, layer in enumerate(port_tree["enc_layers"]):
            each_leaf(layer, ref_tree["enc_body"]["slot0"], fn,
                      ("enc_layers", l))
    assert set(port_tree) - {"layers", "enc_layers"} == \
        set(ref_tree) - {"body", "enc_body"}


def cache_pairs(cfg, port_cache, ref_cache):
    """(port leaf, reference leaf) of every cache tensor, layer by layer
    (the reference's ``cross`` k/v are each layer's ``cross_k``/``v``)."""
    out = []
    for l, layer in enumerate(port_cache):
        slot = stacked({"body": ref_cache}, cfg, l)
        for k, v in layer.items():
            ref = ref_cache["cross"][k[len("cross_"):]] \
                if k.startswith("cross_") else slot[k]
            out.append((f"{l}/{k}", v, ref))
    return out


def ref_placements(spec, names):
    """The DTensor placements a reference ``PartitionSpec`` means, one
    per mesh axis (an implementation of the mapping independent of the
    port's)."""
    from torch.distributed.tensor import Replicate, Shard
    out = {n: Replicate() for n in names}
    for d, entry in enumerate(spec):
        for n in ((entry,) if isinstance(entry, str) else entry or ()):
            out[n] = Shard(d)
    return [out[n] for n in names]


# -------------------------------------------------------------------- specs
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(arch, mesh, host_mesh):
    """``LogicalRules.spec`` equals the reference's ``PartitionSpec`` entry
    for entry over every axes tuple of ``param_axes``, ``cache_axes`` and
    ``batch_axes``, and ``placements`` is what that spec means."""
    pm, rm = meshes(mesh, host_mesh)
    cfg, rcfg = PC.get_smoke(arch), RC.get_smoke(arch)
    pr, rr = PSh.LogicalRules(pm), RSh.LogicalRules(rm)
    assert pr.rules == rr.rules
    names = tuple(rm.axis_names)
    n = [0]

    def same(path, axes, ref_axes):
        ref_axes = tuple(ref_axes)
        if path[0] in ("layers", "enc_layers", "cache"):
            assert ref_axes[0] == "layers", path
            ref_axes = ref_axes[1:]
        assert axes == ref_axes, path
        want = tuple(rr.spec(("layers",) + ref_axes))[1:]
        assert pr.spec(axes) == want, (path, pr.spec(axes), want)
        assert pr.placements(axes) == ref_placements(want, names), path
        n[0] += 1

    each_layer_leaf(cfg, PT.param_axes(cfg), RT.param_axes(rcfg), same)
    for key, axes, ref_axes in cache_pairs(cfg, PT.cache_axes(cfg),
                                           RT.cache_axes(rcfg)):
        same(("cache", key), axes, ref_axes)
    for kind in ("train", "prefill"):
        shape = ShapeConfig("s", 16, 4, kind)
        pb = PSp.batch_axes(cfg, shape)
        rb = RSp.batch_axes(rcfg, RShape("s", 16, 4, kind))
        assert pb == rb
        for k in pb:
            assert pr.spec(pb[k]) == tuple(rr.spec(rb[k])), k
    assert n[0] > 10


def test_rules_drop_a_mesh_axis_used_twice(host_mesh):
    """The reference's rule: a mesh axis is used at most once per spec;
    and multi-pod rules shard the batch over both DP axes."""
    rules = PSh.LogicalRules(host_mesh)
    assert rules.spec(("vocab", "mlp")) == ("model", None)
    from torch.distributed.tensor import Replicate, Shard
    assert rules.placements(("vocab", "mlp")) == [Replicate(), Shard(0)]
    multi = PSh.LogicalRules(StandIn(("pod", "data", "model"), (2, 16, 16)))
    assert multi.rules["batch"] == ("pod", "data")
    assert multi.placements(("batch", None, "vocab")) == \
        [Shard(0), Shard(0), Shard(2)]
    with PSh.use_rules(multi):
        assert PSh.axis_size("batch") == 32 and PSh.axis_size("seq") == 1
    assert PSh.axis_size("batch") == 1 and PSh.current_rules() is None


def test_lshard_without_rules_and_rank_mismatch(host_mesh):
    x = torch.ones(2, 3)
    assert PSh.lshard(x, "batch", None) is x
    with PSh.use_rules(PSh.LogicalRules(host_mesh)):
        with pytest.raises(ValueError, match="rank 2"):
            PSh.lshard(x, "batch")
        y = PSh.lshard(x, "batch", "vocab")
        assert PSh.is_dtensor(y) and torch.equal(y.full_tensor(), x)


# ------------------------------------------------------------------ layouts
@pytest.mark.parametrize("arch", ARCHS)
def test_layouts_equal_the_reference(arch):
    """``param_axes``, ``cache_axes`` and ``abstract_params`` (meta
    tensors) have the reference's axes, shapes and dtypes, layer by
    layer, without its stacked ``layers`` axis."""
    cfg, rcfg = PC.get_smoke(arch), RC.get_smoke(arch)
    abstract = PT.abstract_params(cfg, torch.float32)
    ref = RT.abstract_params(rcfg, jnp.float32)
    n_layers = {"layers": cfg.n_layers, "enc_layers": cfg.n_encoder_layers}

    def same_leaf(path, t, r):
        assert t.device.type == "meta", path
        stack = n_layers.get(path[0])
        want = tuple(r.shape[1:]) if stack else tuple(r.shape)
        if stack:
            assert r.shape[0] * (cfg.scan_period if path[0] == "layers"
                                 else 1) == stack, path
        assert tuple(t.shape) == want and str(t.dtype)[6:] == \
            str(r.dtype), path

    each_layer_leaf(cfg, abstract, ref, same_leaf)
    cache = PT.init_cache(cfg, 2, 8, abstract=True)
    rcache = RT.init_cache(rcfg, 2, 8, abstract=True)
    pairs = cache_pairs(cfg, cache, rcache)
    assert pairs
    for key, t, r in pairs:
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(r.shape[1:]), key
        assert str(t.dtype)[6:] == str(r.dtype), key
    axes = cache_pairs(cfg, PT.cache_axes(cfg), RT.cache_axes(rcfg))
    assert [k for k, _, _ in axes] == [k for k, _, _ in pairs]


# -------------------------------------------------------------------- cells
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("B,S", CELL_SHAPES)
@pytest.mark.parametrize("arch", ["granite-8b", "qwen2.5-14b",
                                  "whisper-small"])
def test_cells_equal_the_reference(arch, B, S, mesh, host_mesh):
    """``train_cell``, ``prefill_cell`` and ``decode_cell``: abstract
    arguments with the reference's shapes and dtypes (the port's layout),
    and the placements of the reference's shardings; ``cell_rules``
    replicates a batch that does not divide the DP axes."""
    pm, rm = meshes(mesh, host_mesh)
    cfg, rcfg = PC.get_smoke(arch), RC.get_smoke(arch)
    pr = PSp.cell_rules(cfg, ShapeConfig("c", S, B, "train"), pm)
    rr = RSp.cell_rules(rcfg, RShape("c", S, B, "train"), rm)
    assert pr.rules == rr.rules
    names = tuple(rm.axis_names)

    def placements(path, got, want):
        spec = tuple(want.spec)
        if path[0] in ("layers", "enc_layers"):
            spec = spec[1:]                  # the stacked layers axis
        assert got == ref_placements(spec, names), path

    def meta(path, got, want):
        assert tuple(got.shape) == tuple(want.shape[1:] if path[0] in (
            "layers", "enc_layers") else want.shape), path
        assert str(got.dtype)[6:] == str(want.dtype), path

    def tree(port, ref, leaf):
        each_layer_leaf(cfg, port, ref, leaf)

    # train
    (pp, po, pb), (pps, pos_, pbs), (_, _, pms) = PSp.train_cell(
        cfg, ShapeConfig("c", S, B, "train"), pr)
    (rp, ro, rb), (rps, ros, rbs), (_, _, rms) = RSp.train_cell(
        rcfg, RShape("c", S, B, "train"), rr)
    tree(pp, rp, meta)
    tree(po.m, ro.m, meta)
    tree(pps, rps, placements)
    tree(pos_.v, ros.v, placements)
    assert pos_.step == ref_placements(ros.step.spec, names)
    for k in rb:
        meta((k,), pb[k], rb[k])
        placements((k,), pbs[k], rbs[k])
    assert sorted(pms) == sorted(rms)
    # prefill
    (pp, pb), (pps, pbs), (pl, pcs) = PSp.prefill_cell(
        cfg, ShapeConfig("c", S, B, "prefill"), pr)
    (rp, rb), (rps, rbs), (rl, rcs) = RSp.prefill_cell(
        rcfg, RShape("c", S, B, "prefill"), rr)
    for k in rb:
        meta((k,), pb[k], rb[k])
        placements((k,), pbs[k], rbs[k])
    placements(("logits",), pl, rl)
    for key, got, want in cache_pairs(cfg, pcs, rcs):
        assert got == ref_placements(tuple(want.spec)[1:], names), key
    # decode
    (pp, pc, pt, ppos), (_, pcs, pts, pposs), _ = PSp.decode_cell(
        cfg, ShapeConfig("c", S, B, "decode"), pr)
    (rp, rc, rt, rpos), (_, rcs, rts, rposs), _ = RSp.decode_cell(
        rcfg, RShape("c", S, B, "decode"), rr)
    for key, got, want in cache_pairs(cfg, pc, rc):
        assert tuple(got.shape) == tuple(want.shape[1:]), key
    for got, want in ((pt, rt), (ppos, rpos)):
        assert tuple(got.shape) == tuple(want.shape)
        assert str(got.dtype)[6:] == str(want.dtype)
    placements(("token",), pts, rts)
    placements(("pos",), pposs, rposs)
    for key, got, want in cache_pairs(cfg, pcs, rcs):
        assert got == ref_placements(tuple(want.spec)[1:], names), key


# -------------------------------------------------------------- head padding
@pytest.mark.parametrize("H,KV", [(24, 2), (40, 8), (12, 12)])
def test_head_padding_preserves_gqa_semantics(H, KV, monkeypatch):
    """At tp = 16 (``axis_size`` patched, as the reference's test does),
    ``pad_heads_for_tp`` pads as the reference's does, and the port's
    padded ``run_attention`` equals its unpadded attention and the
    reference's padded one within 2e-5."""
    rng = np.random.default_rng(H)
    q, k, v = (rng.standard_normal((2, 8, n, 16), dtype=np.float32)
               for n in (H, KV, KV))
    pq, pk, pv = (torch.from_numpy(a) for a in (q, k, v))
    assert PL.pad_heads_for_tp(pq, pk, pv)[0] is pq           # tp = 1
    monkeypatch.setattr(PL, "axis_size",
                        lambda name: 16 if name == "heads" else 1)
    monkeypatch.setattr(RL, "axis_size",
                        lambda name: 16 if name == "heads" else 1)
    q2, k2, v2, H0 = PL.pad_heads_for_tp(pq, pk, pv)
    rq2, rk2, rv2, rH0 = RL.pad_heads_for_tp(*map(jnp.asarray, (q, k, v)))
    assert (tuple(q2.shape), tuple(k2.shape), H0) == \
        (tuple(rq2.shape), tuple(rk2.shape), rH0)
    assert q2.shape[2] % 16 == 0 and q2.shape[2] % k2.shape[2] == 0
    np.testing.assert_array_equal(q2.numpy(), np.asarray(rq2))
    cfg = ModelConfig(arch_id="t", family="dense", n_layers=1,
                      d_model=H * 16, n_heads=H, n_kv_heads=KV, d_ff=32,
                      vocab_size=8)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32)[None], (2, 8))
    tpos = torch.from_numpy(pos.copy())
    want = PL.attention_core_naive(pq, pk, pv, tpos, tpos, causal=True)
    got = PL.run_attention(pq, pk, pv, tpos, tpos, cfg, causal=True)
    ref = RL.run_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                           RModelConfig(**dataclasses.asdict(cfg)),
                           causal=True)
    assert got.shape == want.shape == (2, 8, H, 16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=HEAD_PAD_TOL,
                               atol=HEAD_PAD_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=HEAD_PAD_TOL, atol=HEAD_PAD_TOL)


# ------------------------------------------------ four ranks on a 2x2 mesh
def family_inputs() -> dict:
    """Each family's seeded weights (the reference's layout), tokens,
    extra inputs and two decode steps' tokens, keyed ``<arch>/...`` and
    ``<arch>:...``."""
    out = {}
    for i, arch in enumerate(FAMILIES):
        cfg = RC.get_smoke(arch)
        out.update({f"{arch}/{k}": a for k, a in torch_ranks.flatten(
            ref_weights(cfg, 20 + i)).items()})
        rng = np.random.RandomState(20 + i)
        out[f"{arch}:tokens"] = rng.randint(
            0, cfg.vocab_size, FAMILY_BS).astype(np.int64)
        for k, a in draw_extras(cfg, rng, FAMILY_BS[0]).items():
            out[f"{arch}:{k}"] = a
        out[f"{arch}:decode"] = rng.randint(
            0, cfg.vocab_size, (2, FAMILY_BS[0], 1)).astype(np.int64)
    return out


@pytest.fixture(scope="module")
def family_refs():
    """The reference's single-device runs of ``family_inputs`` in
    float32 (its ``COMPUTE_DTYPE`` patched, as the families' float32
    tests do): the loss, the prefill's last logits, two decode steps, and
    the experts of every MoE call (a callback in its ``moe_layer``)."""
    inputs = family_inputs()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RT, "COMPUTE_DTYPE", jnp.float32)
        routes = []
        real = RL.moe_layer

        def moe_layer(p, x, cfg, capacity=None):
            logits = jnp.einsum("bsd,de->bse", x,
                                p["w_router"].astype(x.dtype))
            probs = jax.nn.softmax(logits.astype(jnp.float32), -1)
            jax.debug.callback(lambda e: routes.append(np.asarray(e)),
                               jax.lax.top_k(probs, cfg.top_k)[1],
                               ordered=True)
            return real(p, x, cfg, capacity)

        mp.setattr(RL, "moe_layer", moe_layer)
        for arch in FAMILIES:
            cfg = RC.get_smoke(arch)
            params = jax.tree.map(jnp.asarray, torch_ranks.unflatten(
                inputs, f"{arch}/"))
            tokens = jnp.asarray(inputs[f"{arch}:tokens"].astype(np.int32))
            extras = {k: jnp.asarray(inputs[f"{arch}:{k}"])
                      for k in ("frames", "image_embeds")
                      if f"{arch}:{k}" in inputs}
            B, S = tokens.shape
            routes.clear()
            res = {"loss": float(RT.loss_fn(params, cfg, tokens,
                                            jnp.roll(tokens, -1, 1),
                                            **extras)[1][0])}
            last, cache = RT.prefill(params, cfg, tokens[:, :-1],
                                     max_seq=S + 2, impl="naive", **extras)
            res["prefill"] = np.asarray(last)
            for i, tok in enumerate(inputs[f"{arch}:decode"]):
                logits, cache = RT.decode_step(
                    params, cfg, jnp.asarray(tok.astype(np.int32)), cache,
                    jnp.full((B,), S - 1 + i, jnp.int32))
                res[f"decode {i}"] = np.asarray(logits[:, 0])
            jax.effects_barrier()
            res["routes"] = [r.copy() for r in routes]
            out[arch] = res
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of four gloo ranks running ``torch_ranks_sharding.py``'s
    cases, and the reference's unsharded granite-8b loss on the same
    weights and inputs."""
    d = tmp_path_factory.mktemp("ranks")
    granite, qwen = RC.get_smoke("granite-8b"), RC.get_smoke("qwen2.5-14b")
    gemma = RC.get_smoke("gemma2-9b")
    wg, wq, wm = (ref_weights(granite, 11), ref_weights(qwen, 12),
                  ref_weights(gemma, 13))
    # the reference's test_sharded_equals_unsharded_loss inputs
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, granite.vocab_size, (4, 16)).astype(np.int32)
    labels = np.roll(tokens, -1, 1)
    rng = np.random.RandomState(0)            # test_sharded_train_step_...
    qt = rng.randint(0, qwen.vocab_size, (4, 16)).astype(np.int32)
    ql = rng.randint(0, qwen.vocab_size, (4, 16)).astype(np.int32)
    gqa = np.random.default_rng(2).integers(0, 256, (4, 16)).astype(np.int64)
    gemma_tokens = np.random.RandomState(3).randint(
        0, gemma.vocab_size, (4, 16)).astype(np.int64)
    torch_ranks.save_inputs(
        d, granite_tokens=tokens.astype(np.int64), qwen_tokens=qt,
        qwen_labels=ql, gqa_tokens=gqa, gemma_tokens=gemma_tokens,
        **{f"granite/{k}": a for k, a in torch_ranks.flatten(wg).items()},
        **{f"qwen/{k}": a for k, a in torch_ranks.flatten(wq).items()},
        **{f"gemma/{k}": a for k, a in torch_ranks.flatten(wm).items()},
        **family_inputs())
    ref_loss, _ = jax.jit(lambda p: RT.loss_fn(
        p, granite, jnp.asarray(tokens), jnp.asarray(labels)))(
        jax.tree.map(jnp.asarray, wg))
    # the ``ce`` case's losses, in float32 as the ranks compute them
    ce_ref = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RT, "COMPUTE_DTYPE", jnp.float32)
        for key, cfg, w, t in (("granite", granite, wg, tokens),
                               ("gemma", gemma, wm, gemma_tokens)):
            t = jnp.asarray(t.astype(np.int32))
            ce_ref[key] = float(RT.loss_fn(jax.tree.map(jnp.asarray, w),
                                           cfg, t, jnp.roll(t, -1, 1))[1][0])
    out = torch_ranks.launch("torch_ranks_sharding.py", d)
    out["ref_loss"] = float(ref_loss)
    out["ce_ref"] = ce_ref
    print(f"four ranks: {out['seconds']:.1f} s")
    return out


def test_sharded_equals_unsharded_loss(ranks):
    loss = ranks["loss"]
    to_ref = abs(loss["sharded"] - ranks["ref_loss"])
    to_port = abs(loss["sharded"] - loss["plain"])
    print(f"sharded loss {loss['sharded']}: |diff| to the reference's "
          f"unsharded loss {to_ref}, to the port's {to_port}")
    assert to_ref < LOSS_ATOL and to_port < LOSS_ATOL


def test_sharded_train_step_runs_on_the_mesh(ranks):
    train = ranks["train"]
    got, want = train["sharded"], train["plain"]
    print(f"train step: sharded {got}, unsharded {want}")
    assert train["finite"]
    n_leaves = len(PA.leaves(PT.abstract_params(PC.get_smoke("qwen2.5-14b"))))
    assert train["placed"] and train["leaves"] == n_leaves
    assert abs(got["loss"] - want["loss"]) < LOSS_ATOL
    assert abs(got["grad_norm"] - want["grad_norm"]) <= \
        GRAD_NORM_RTOL * abs(want["grad_norm"])
    assert got["lr"] == want["lr"]


@pytest.mark.parametrize("heads", ["12:3", "8:2"])
def test_local_gqa_prefill_and_decode(ranks, heads):
    """Each rank's q heads read their own kv heads: a flash-impl prefill
    and two decode steps in float32 equal the unsharded ones within
    2e-5, with the decode caches' slots split over the model axis."""
    case = ranks["gqa"][heads]
    print(f"{heads}: |diff| prefill, decode x2: {case['diffs']}")
    assert case["cache_shard_dims"] == [0, 1]       # batch; slots
    assert max(case["diffs"]) <= FP32_ATOL
    assert case["cache_diff"] <= FP32_ATOL


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_under_rules_matches_the_reference(ranks, family_refs, arch):
    """Each family's smoke model, sharded under the rules on the 2x2
    mesh, against the reference's single-device run in float32: the
    loss within 5e-2 and the prefill's and decode steps' logits within
    1e-4 (the families' own bound between the packages) and within 2e-5
    of the port's unsharded run.  A MoE model's routes are recorded in
    both runs; logits are held in the batch rows whose every MoE call
    chose the same experts in both, and every row must agree in the
    port's two runs."""
    got, ref = ranks["families"][arch], family_refs[arch]
    sharded, plain = got["sharded"], got["plain"]
    agree = np.ones(FAMILY_BS[0], bool)
    assert len(got["routes"]["sharded"]) == len(got["routes"]["plain"])
    for a, b in zip(got["routes"]["sharded"], got["routes"]["plain"]):
        np.testing.assert_array_equal(a, b)
    # the port's calls: the loss's forward, the prefill, two decode steps
    # (the reference's come in the same order)
    assert len(ref["routes"]) == len(got["routes"]["sharded"])
    for mine, theirs in zip(got["routes"]["sharded"], ref["routes"]):
        mine = np.asarray(mine)
        agree &= (mine == theirs.reshape(mine.shape)).reshape(
            mine.shape[0], -1).all(1)
    if ref["routes"]:
        print(f"{arch}: {len(ref['routes'])} MoE calls; batch rows routed "
              f"alike in both packages: {agree.tolist()}")
        assert agree.any()
    diffs = {"loss": abs(sharded["loss"] - ref["loss"])}
    for name in ("prefill", "decode 0", "decode 1"):
        s, p = np.asarray(sharded[name]), np.asarray(plain[name])
        diffs[name] = float(np.abs(s - ref[name])[agree].max())
        diffs[name + " vs plain"] = float(np.abs(s - p).max())
    print(f"{arch} under rules: {diffs}")
    assert diffs["loss"] < LOSS_ATOL
    assert abs(sharded["loss"] - plain["loss"]) <= FP32_ATOL
    for name in ("prefill", "decode 0", "decode 1"):
        assert diffs[name] <= FAMILY_FP32_ATOL, name
        assert diffs[name + " vs plain"] <= FP32_ATOL, name


@pytest.mark.parametrize("key", list(CE_ARCHS))
def test_vocab_parallel_cross_entropy(ranks, key):
    """The loss of logits split over the vocabulary (granite-8b's smoke
    model, untied; gemma2-9b's, tied and soft-capped) in float32 on the
    2x2 mesh, through the vocab-parallel cross entropy: the loss within
    CE_LOSS_ATOL of the reference's single-device loss and within
    FP32_ATOL of the port's unsharded one, and its gradients with
    respect to the logits and to the unembedding table within
    CE_GRAD_RTOL of the unsharded port's."""
    case = ranks["ce"][key]
    got, want = case["sharded"], case["plain"]
    assert got["vocab_split"] and not want["vocab_split"]
    diffs = {"to the reference": abs(got["loss"] - ranks["ce_ref"][key]),
             "to the port": abs(got["loss"] - want["loss"])}
    for name in ("logits_grad", "table_grad"):
        a, b = np.asarray(got[name]), np.asarray(want[name])
        diffs[name] = float(np.abs(a - b).max())
        diffs[name + " max"] = float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=CE_GRAD_RTOL,
                                   atol=CE_GRAD_RTOL * np.abs(b).max(),
                                   err_msg=name)
    print(f"{CE_ARCHS[key][0]} vocab-parallel loss {got['loss']}: {diffs}")
    assert diffs["to the reference"] <= CE_LOSS_ATOL
    assert diffs["to the port"] <= FP32_ATOL
