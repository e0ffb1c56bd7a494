"""Port parity, training on one device: ``repro_torch.optim``,
``models.transformer.loss_fn`` and remat, ``runtime.steps.
build_train_step``, ``data``, ``runtime.straggler``, ``runtime.elastic``,
``runtime.train_loop.Trainer`` and ``launch.train`` against the
reference's, on the same seeded numpy inputs, on the CPU.

Tolerances:
- AdamW in fp32, the same parameters, gradients and state fed to both
  ``update`` functions: parameters, m and v within 1e-6 relative;
  ``cosine_lr`` and ``clip_by_global_norm`` within 1e-6 (the warmup's
  learning rate is bit-equal).
- ``loss_fn`` in bf16 compute over fp32 weights carried across by
  ``params_from_jax``: the loss within 2e-2 absolute, each gradient leaf
  at cosine similarity >= 0.99 with the reference's (both sides round
  to bf16 at different places).
- remat, each policy against none: gradients within 1e-6 (the same
  arithmetic, recomputed).
- ``build_train_step`` over 3 steps (starcoder2-3b, and the MoE and
  SSD families' smoke configs): loss and grad norm within 2e-2
  relative, ``lr`` exact.
- The pipeline, straggler response, mesh plan and the trainer's
  journals (wall clock replaced by a counter, wall-time metrics left
  out, STEP_COMMIT's loss within 2e-2): equal.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                # noqa: E402
import jax.numpy as jnp                                   # noqa: E402

from repro import configs as RC                           # noqa: E402
from repro.checkpoint import save_checkpoint as ref_save  # noqa: E402
from repro.core import records as R                       # noqa: E402
from repro.core.proxy import LcapProxy as RefProxy        # noqa: E402
from repro.core.reader import LocalReader as RefReader    # noqa: E402
from repro.data import ShardedTokenPipeline as RefPipe    # noqa: E402
from repro.models import transformer as RT                # noqa: E402
from repro.optim import adamw as RA                       # noqa: E402
from repro.runtime import elastic as RE                   # noqa: E402
from repro.runtime import steps as RS                     # noqa: E402
from repro.runtime import straggler as RSt                # noqa: E402
from repro.runtime.train_loop import Trainer as RefTrainer  # noqa: E402
import repro.track as ref_track                           # noqa: E402
from repro_torch import configs as PC                     # noqa: E402
from repro_torch.core import records as T                 # noqa: E402
from repro_torch.core.proxy import LcapProxy as PortProxy  # noqa: E402
from repro_torch.core.reader import LocalReader as PortReader  # noqa: E402
from repro_torch.data import ShardedTokenPipeline as PortPipe  # noqa: E402
from repro_torch.kernels import flash_attention as fa     # noqa: E402
from repro_torch.models import transformer as PT          # noqa: E402
from repro_torch.optim import adamw as PA                 # noqa: E402
from repro_torch.runtime import elastic as PE             # noqa: E402
from repro_torch.runtime import steps as PS               # noqa: E402
from repro_torch.runtime import straggler as PSt          # noqa: E402
from repro_torch.runtime.train_loop import Trainer as PortTrainer  # noqa: E402
import repro_torch.track as port_track                    # noqa: E402
from test_torch_moe import ref_weights                    # noqa: E402

DENSE = ["granite-8b", "starcoder2-3b", "qwen2.5-14b", "gemma2-9b"]
ROOT = Path(__file__).resolve().parents[1]
REL = dict(rtol=1e-6, atol=0)
B, S = 2, 16


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree) -> dict:
    """keystr name -> numpy leaf of a reference-layout tree."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def fid(f) -> tuple:
    return (f.seq, f.oid, f.ver)


def port_tree(np_tree):
    """A numpy tree of dicts as fp32 torch tensors (fresh copies)."""
    return jax.tree.map(lambda a: torch.tensor(np.array(a, np.float32)),
                        np_tree)


def tree_np(t_tree):
    return jax.tree.map(lambda t: t.detach().numpy().copy(), t_tree,
                        is_leaf=lambda x: isinstance(x, torch.Tensor))


# -------------------------------------------------------------- optimizer
def opt_case(seed: int):
    rng = np.random.default_rng(seed)
    shapes = {"w": (4, 5), "b": (3,), "blk": {"u": (2, 3, 4), "z": (7,)}}
    draw = lambda s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    params = jax.tree.map(draw, shapes, is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree.map(lambda s: draw(s) * np.float32(0.3 + k), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
             for k in range(4)]
    return params, grads


def test_adamw_update_matches_reference():
    params, grads = opt_case(0)
    rp, rs = jax.tree.map(jnp.asarray, params), RA.init(
        jax.tree.map(jnp.asarray, params))
    pp = port_tree(params)
    ps = PA.init(pp)
    for k, g in enumerate(grads):       # norms 0.3x .. 3.3x: clipped and not
        lr = 1e-2 * (k + 1)
        rp, rs, rgn = RA.update(jax.tree.map(jnp.asarray, g), rs, rp, lr=lr)
        pp, ps, pgn = PA.update(port_tree(g), ps, pp, lr=lr)
        np.testing.assert_allclose(float(pgn), float(rgn), **REL)
        assert ps.step == int(rs.step) == k + 1
        for ours, theirs in ((pp, rp), (ps.m, rs.m), (ps.v, rs.v)):
            for a, b in zip(jax.tree.leaves(tree_np(ours)),
                            jax.tree.leaves(to_np(theirs))):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 100, 10_000),
                                               (1.0, 10, 100),
                                               (1e-2, 3, 10_000),
                                               (3e-4, 2, 10)])
def test_cosine_lr_matches_reference(peak, warmup, total):
    """Against the schedule as the reference's train step runs it: jitted
    (XLA rewrites its divisions by constants)."""
    ref = jax.jit(lambda s: RA.cosine_lr(s, peak=peak, warmup=warmup,
                                         total=total))
    for step in range(0, min(total + 5, 300)):
        ours = PA.cosine_lr(step, peak=peak, warmup=warmup, total=total)
        theirs = float(ref(jnp.asarray(step, jnp.int32)))
        if step < warmup:
            assert ours == theirs, step
        np.testing.assert_allclose(ours, theirs, **REL)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    _, grads = opt_case(1)
    g = grads[2]
    rc, rgn = RA.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    pc, pgn = PA.clip_by_global_norm(port_tree(g), max_norm)
    np.testing.assert_allclose(float(pgn), float(rgn), **REL)
    for a, b in zip(jax.tree.leaves(tree_np(pc)), jax.tree.leaves(to_np(rc))):
        np.testing.assert_allclose(a, b, **REL)


# tests/test_optim.py's cases on the port
def test_adamw_descends_quadratic():
    params = {"w": torch.zeros(4), "b": torch.zeros(3)}

    def quad(p):
        return torch.sum((p["w"] - 3.0) ** 2) + torch.sum((p["b"] + 1.0) ** 2)

    state = PA.init(params)
    for _ in range(200):
        for p in params.values():
            p.requires_grad_(True)
            p.grad = None
        quad(params).backward()
        grads = {k: p.grad for k, p in params.items()}
        params, state, _ = PA.update(grads, state, params, lr=5e-2,
                                     weight_decay=0.0)
    assert float(quad(params).detach()) < 1e-2
    assert state.step == 200


def test_cosine_schedule_shape():
    lrs = [PA.cosine_lr(s, peak=1.0, warmup=10, total=100)
           for s in range(100)]
    assert lrs[0] < lrs[9] <= 1.0 + 1e-6
    assert abs(max(lrs) - 1.0) < 0.11
    assert lrs[-1] < 0.2
    assert lrs[-1] >= 0.099


def test_clip_by_global_norm():
    clipped, gn = PA.clip_by_global_norm({"a": torch.full((4,), 100.0)}, 1.0)
    assert float(gn) == pytest.approx(200.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0,
                                                                 rel=1e-3)


# --------------------------------------------------------------- the loss
def loss_inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def port_params(ref_params):
    p = PT.params_from_jax(to_np(ref_params), device="cpu",
                           dtype=torch.float32)
    for t in PA.leaves(p):
        t.requires_grad_(True)
    return p


def port_grads(params, cfg):
    return flat(PT.params_to_jax(PA.tree_map(lambda t: t.grad, params), cfg))


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_reference(arch):
    rcfg, pcfg = RC.get_smoke(arch), PC.get_smoke(arch)
    ref_params = RT.init_params(rcfg, seed=0)
    tokens, labels = loss_inputs(rcfg)

    def loss(p):
        return RT.loss_fn(p, rcfg, jnp.asarray(tokens),
                          jnp.asarray(labels))[0]

    ref_loss, ref_grads = jax.value_and_grad(loss)(ref_params)
    params = port_params(ref_params)
    total, (p_loss, aux) = PT.loss_fn(params, pcfg, torch.from_numpy(tokens),
                                      torch.from_numpy(labels))
    total.backward()
    assert float(aux) == 0.0
    assert abs(p_loss.item() - float(ref_loss)) < 2e-2
    # a sensible init, as the reference's own test asks
    assert total.item() < 2 * np.log(pcfg.vocab_size) + 1
    ours, theirs = port_grads(params, pcfg), flat(ref_grads)
    assert sorted(ours) == sorted(theirs)
    for name, g in theirs.items():
        a, b = ours[name].ravel().astype(np.float64), g.ravel()
        assert np.isfinite(a).all(), name
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30)
        assert cos >= 0.99, (name, cos)


@pytest.mark.parametrize("policy", PS.REMAT_POLICIES)
def test_remat_policies_give_the_same_gradients(policy):
    cfg = PC.get_smoke("gemma2-9b")        # local/global windows, softcaps
    ref_params = RT.init_params(RC.get_smoke("gemma2-9b"), seed=1)
    tokens, labels = (torch.from_numpy(a) for a in loss_inputs(cfg, 1))
    grads = []
    for remat in (False, True):
        params = port_params(ref_params)
        total, _ = PT.loss_fn(params, cfg, tokens, labels, remat=remat,
                              remat_policy=policy)
        total.backward()
        grads.append(port_grads(params, cfg))
    for name, g in grads[0].items():
        np.testing.assert_allclose(grads[1][name], g, rtol=1e-6, atol=1e-6,
                                   err_msg=name)


def test_dots_policy_saves_the_unbatched_products():
    """``dots`` keeps the (B, S, D) @ (D, F) projections (aten.mm) and
    recomputes attention's batched products (aten.bmm)."""
    seen = []
    orig = PT._save_dots

    def spy(ctx, op, *args, **kwargs):
        seen.append((op, orig(ctx, op)))
        return seen[-1][1]

    cfg = PC.get_smoke("starcoder2-3b")
    params = port_params(RT.init_params(RC.get_smoke("starcoder2-3b")))
    tokens, labels = (torch.from_numpy(a) for a in loss_inputs(cfg))
    try:
        PT._save_dots = spy
        total, _ = PT.loss_fn(params, cfg, tokens, labels, remat=True,
                              remat_policy="dots")
        total.backward()
    finally:
        PT._save_dots = orig
    saved = {op for op, how in seen
             if how == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE}
    recomputed = {op for op, how in seen} - saved
    assert torch.ops.aten.mm.default in saved
    assert torch.ops.aten.bmm.default in recomputed


# --------------------------------------------------------- the train step
@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_reference(n_micro):
    arch = "starcoder2-3b"
    rcfg, pcfg = RC.get_smoke(arch), PC.get_smoke(arch)
    kw = dict(n_micro=n_micro, peak_lr=1e-2, warmup=3)
    rstep = jax.jit(RS.build_train_step(rcfg, RS.TrainHParams(**kw)))
    pstep = PS.build_train_step(pcfg, PS.TrainHParams(**kw))
    rp = RT.init_params(rcfg, seed=2)
    params = PT.params_from_jax(to_np(rp), device="cpu", dtype=torch.float32)
    ro, po = RA.init(rp), PA.init(params)
    pipe = RefPipe(rcfg.vocab_size, S, 4, 1, 0, seed=5)
    for step in range(3):
        batch = next(pipe)
        rp, ro, rm = rstep(rp, ro, batch)
        params, po, pm = pstep(params, po, batch)
        assert pm["lr"] == float(rm["lr"]), step
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                                   rtol=2e-2)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=2e-2)
    assert po.step == int(ro.step) == 3
    assert all(p.grad is None for p in PA.leaves(params))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-780m"])
def test_family_train_step_matches_reference(monkeypatch, arch):
    """The MoE and SSD families' whole training step, AdamW included,
    over 3 steps of two microbatches against the reference's jitted
    step from the same fp32 weights (seeded numpy, the reference's
    layout): loss (the MoE aux loss apart) and grad norm within 2e-2
    relative, lr exact.  mamba2's smoke chunk is 8, so 16 tokens cross a
    chunk boundary where the reference's gradient is finite.  The MoE
    model computes in float32 in both packages: in bf16 the two round
    the router's logits apart, and by the third step 3 and 7 of the 64
    tokens of its two layers choose other experts (probability gaps of
    1e-3 to 3e-2), which moves the grad norm by 2.8 %."""
    if arch == "granite-moe-1b-a400m":
        monkeypatch.setattr(RT, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(PT, "COMPUTE_DTYPE", torch.float32)
    rcfg, pcfg = RC.get_smoke(arch), PC.get_smoke(arch)
    kw = dict(n_micro=2, peak_lr=1e-2, warmup=3)
    rstep = jax.jit(RS.build_train_step(rcfg, RS.TrainHParams(**kw)))
    pstep = PS.build_train_step(pcfg, PS.TrainHParams(**kw))
    w = ref_weights(rcfg, 6)
    rp = jax.tree.map(jnp.asarray, w)
    params = PT.params_from_jax(w, device="cpu", dtype=torch.float32)
    ro, po = RA.init(rp), PA.init(params)
    pipe = RefPipe(rcfg.vocab_size, S, 4, 1, 0, seed=5)
    for step in range(3):
        batch = next(pipe)
        rp, ro, rm = rstep(rp, ro, batch)
        params, po, pm = pstep(params, po, batch)
        assert pm["lr"] == float(rm["lr"]), step
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                                   rtol=2e-2)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=2e-2)
        assert np.isfinite(float(pm["grad_norm"]))
    assert po.step == int(ro.step) == 3
    assert all(p.grad is None for p in PA.leaves(params))


def test_flash_cannot_train():
    cfg = PC.get_smoke("starcoder2-3b")
    with pytest.raises(ValueError, match="no backward"):
        PS.build_train_step(cfg, PS.TrainHParams(attn_impl="flash"))
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    k, v = torch.randn(1, 8, 1, 16), torch.randn(1, 8, 1, 16)
    with pytest.raises(NotImplementedError, match="forward only"):
        fa.flash_attention_bshd(q, k, v)
    with torch.no_grad():                      # inference still runs
        assert fa.flash_attention_bshd(q, k, v).shape == q.shape
    params = port_params(RT.init_params(RC.get_smoke("starcoder2-3b")))
    tokens, labels = (torch.from_numpy(a) for a in loss_inputs(cfg))
    with pytest.raises(NotImplementedError, match="forward only"):
        PT.loss_fn(params, cfg, tokens, labels, impl="flash")


# ------------------------------------------------------------------- data
def test_pipeline_batches_and_records_match_reference():
    recs = []
    for pipe_cls, proxy_cls, reader_cls, track in (
            (RefPipe, RefProxy, RefReader, ref_track),
            (PortPipe, PortProxy, PortReader, port_track)):
        tr = track.ActivityTracker(run_id=1, host_id=0)
        proxy = proxy_cls({tr.llog.producer_id: tr.llog})
        reader = reader_cls(proxy, "replay")
        pipe = pipe_cls(1000, 16, 8, 2, 1, seed=3, tracker=tr)
        batches = [next(pipe) for _ in range(4)]
        pipe.seek(2)
        batches.append(next(pipe))
        proxy.pump()
        got = [rec for _, rec in reader.fetch(100)]
        recs.append((batches, [(r.type, fid(r.tfid), r.name, r.xattr)
                               for r in got],
                     pipe_cls.resume_step_from_records(got)))
    (rb, rr, rs), (pb, pr, ps) = recs
    for a, b in zip(pb, rb):
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()
    assert pr == rr and ps == rs == 4


# ------------------------------------------------- straggler and the mesh
@pytest.mark.parametrize("n_shards,hosts,ewma", [
    (8, [0, 1, 2, 3], {}),
    (16, [0, 1, 2, 3], {0: 0.1, 1: 0.1, 2: 0.4, 3: 0.1}),
    (7, [3, 1, 2], {1: 0.2, 2: 0.05}),
    (5, [], {})])
def test_rebalance_shards_matches_reference(n_shards, hosts, ewma):
    ours = PSt.rebalance_shards(n_shards, hosts, ewma)
    assert ours == RSt.rebalance_shards(n_shards, hosts, ewma)
    if hosts:
        assert sorted(sum(ours.values(), [])) == list(range(n_shards))


def test_straggler_mitigator_matches_reference():
    out = []
    for R_, proxy_cls, reader_cls, track, st in (
            (R, RefProxy, RefReader, ref_track, RSt),
            (T, PortProxy, PortReader, port_track, PSt)):
        trackers = [track.ActivityTracker(run_id=1, host_id=h)
                    for h in range(3)]
        proxy = proxy_cls({t.llog.producer_id: t.llog for t in trackers})
        det = track.StragglerDetector(proxy)
        audit = reader_cls(proxy, "audit")
        mit = st.StragglerMitigator(det, n_shards=6, tracker=trackers[0])
        for step in range(8):
            for h, t in enumerate(trackers):
                t.heartbeat(step, step_time_s=0.5 if h == 1 else 0.1)
        proxy.pump()
        det.poll()
        new = mit.maybe_rebalance([0, 1, 2], step=8)
        proxy.pump()
        recs = [(r.type, fid(r.tfid), r.xattr)
                for _, r in audit.fetch(100) if r.type == R_.CL_STRAGGLER]
        again = mit.maybe_rebalance([0, 1, 2], step=9)
        out.append((sorted(det.flagged), new, recs, again))
    assert out[1] == out[0]
    assert out[0][0] == [1] and len(out[0][2]) == 1 and out[0][3] is None


def test_plan_mesh_shape_matches_reference():
    for n in range(0, 300):
        assert PE.plan_mesh_shape(n) == RE.plan_mesh_shape(n)


def test_one_device_mesh():
    mesh = PE.make_elastic_mesh(device="cpu")
    assert mesh.shape == (1, 1) and mesh.device == torch.device("cpu")
    # more devices need a process group, and this process has none
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        PE.make_elastic_mesh(4, device="cpu")


# -------------------------------------------------------------- the trainer
T0 = 1_700_000_000_000_000_000
CLOCK = {"t": 0}


@pytest.fixture
def stream_clock(monkeypatch):
    """Replace ``records.now_ns`` in both packages by a counter."""
    def now_ns():
        CLOCK["t"] += 1000
        return T0 + CLOCK["t"]

    for mod in (R, T):
        monkeypatch.setattr(mod, "now_ns", now_ns)


def journal(trainer, workdir) -> list:
    """Every record the trainer's hosts logged (a reader registered
    before the run holds the trim back), as comparable values: wall-time
    metrics left out, STEP_COMMIT's loss apart, checkpoint paths
    relative to the workdir; sorted, because the checkpoint thread logs
    CKPT_WRITE records concurrently with the steps."""
    rows, losses = [], []
    for t in trainer.trackers:
        log = t.llog
        batch = log.read(log.first_index, log.last_index - log.first_index + 1)
        for r in batch.to_records():
            metrics = r.metrics
            if r.type == R.CL_STEP_COMMIT:
                losses.append((r.tfid.oid, r.tfid.ver, metrics[0]))
                metrics = metrics[2:]
            elif r.type == R.CL_HEARTBEAT:
                metrics = ()
            name = r.name
            if r.type == R.CL_CKPT_WRITE:
                name = os.path.relpath(name.decode(), workdir).encode()
            rows.append((log.producer_id, r.type, fid(r.tfid), name,
                         json.dumps(r.xattr, sort_keys=True),
                         tuple(metrics or ()), r.jobid, r.shard))
    return sorted(rows), sorted(losses)


def run_trainer(trainer_cls, workdir, init_tree, n_steps):
    """A trainer of the starcoder2-3b smoke config from the step-0
    checkpoint ``init_tree`` (so both packages start from the same
    weights); returns its journal, history and consumers' views."""
    ref_save(init_tree, 0, os.path.join(workdir, "ckpt"), n_shards=2)
    kw = {"device": "cpu"} if trainer_cls is PortTrainer else {}
    cfg = (PC if trainer_cls is PortTrainer else RC).get_smoke(
        "starcoder2-3b")
    t = trainer_cls(cfg, workdir=workdir, global_batch=4, seq_len=16,
                    n_hosts=2, ckpt_every=2, **kw)
    for tr in t.trackers:
        tr.llog.register_reader("audit")
    assert t.step == 0
    hist = t.run(n_steps)
    t.ckpt.wait()
    t.pump_consumers()
    rows = t.metrics[0].query(
        "SELECT type, COUNT(*) FROM events GROUP BY type ORDER BY type")
    out = (journal(t, workdir), [h["step"] for h in hist],
           [h["loss"] for h in hist], rows, t.committer.latest_committed(),
           sorted(os.listdir(os.path.join(workdir, "ckpt"))))
    t.close()
    return out


def test_trainer_journals_match_reference(tmp_path, stream_clock):
    cfg = RC.get_smoke("starcoder2-3b")
    params = RT.init_params(cfg, seed=4)
    init_tree = {"params": params, "opt": RA.init(params)}
    runs = []
    for name, cls in (("ref", RefTrainer), ("port", PortTrainer)):
        CLOCK["t"] = 0
        runs.append(run_trainer(cls, str(tmp_path / name), init_tree, 4))
    (r_j, r_steps, r_loss, r_rows, r_last, r_files), \
        (p_j, p_steps, p_loss, p_rows, p_last, p_files) = runs
    assert p_j[0] == r_j[0]
    assert [k[:2] for k in p_j[1]] == [k[:2] for k in r_j[1]]
    np.testing.assert_allclose([k[2] for k in p_j[1]],
                               [k[2] for k in r_j[1]], atol=2e-2)
    np.testing.assert_allclose(p_loss, r_loss, atol=2e-2)
    assert p_steps == r_steps == [1, 2, 3, 4]
    assert p_rows == r_rows and p_last == r_last == 4
    assert p_files == r_files
    types = {row[1] for row in p_j[0]}
    assert types == {R.CL_STEP_COMMIT, R.CL_HEARTBEAT, R.CL_DATA_CONSUME,
                     R.CL_CKPT_WRITE}


CRASH = """
import json, sys
import torch
from repro_torch import configs as C
from repro_torch.runtime.train_loop import Trainer
cfg = C.get_smoke("starcoder2-3b")
phase, wd = sys.argv[1], sys.argv[2]
t = Trainer(cfg, workdir=wd, global_batch=4, seq_len=16, n_hosts=2,
            ckpt_every=3, device="cpu")
if phase == "first":
    hist = t.run(4)          # crash after step 4 (checkpoint at 3)
    t.ckpt.wait()
else:
    assert t.step == 3, t.step
    assert all(p.step == 3 for p in t.pipes)
    hist = t.run(2)
    t.ckpt.wait()
print(json.dumps({"steps": [h["step"] for h in hist],
                  "losses": [h["loss"] for h in hist],
                  "committed": t.committer.latest_committed()}))
t.close()
"""


def test_crash_restart_resumes_exactly(tmp_path):
    """tests/test_checkpoint.py's case on the port's trainer: 4 steps with
    a checkpoint at 3, a crash, a restart that resumes at step 3 with the
    same data; its step 4 loss is the first run's (on the CPU, exactly)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    wd = str(tmp_path / "run")
    outs = []
    for phase in ("first", "second"):
        r = subprocess.run([sys.executable, "-c", CRASH, phase, wd],
                           capture_output=True, text=True, env=env,
                           timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        outs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    first, second = outs
    assert first["steps"] == [1, 2, 3, 4] and first["committed"] == 3
    assert second["steps"] == [4, 5]
    assert second["losses"][0] == first["losses"][3]


def test_launcher_prints_the_reference_keys(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    outs = []
    for pkg, extra in (("repro", []), ("repro_torch", ["--device", "cpu"])):
        r = subprocess.run(
            [sys.executable, "-m", f"{pkg}.launch.train", "--smoke",
             "--steps", "3", "--ckpt-every", "2", "--workdir",
             str(tmp_path / pkg)] + extra,
            capture_output=True, text=True, env=env, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        outs.append(json.loads(r.stdout))
    ref, port = outs
    assert sorted(port) == sorted(ref)
    for k in ("arch", "steps", "metrics_rows", "event_types", "stragglers",
              "last_ckpt"):
        assert port[k] == ref[k], k
