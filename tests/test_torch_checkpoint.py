"""Checkpoints interchangeable between the packages: a checkpoint that
either package writes restores in the other's ``restore_checkpoint`` to
the same arrays, with the same leaf names and ``index.json``; and
tests/test_checkpoint.py's cases on the port (round trip, asynchronous
writes, landing a restored state on the one-device mesh).  The crash and
restart case is in tests/test_torch_train.py.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                # noqa: E402

from repro import configs as RC                           # noqa: E402
from repro import checkpoint as RCk                       # noqa: E402
from repro.models import transformer as RT                # noqa: E402
from repro.optim import adamw as RA                       # noqa: E402
from repro_torch import checkpoint as PCk                 # noqa: E402
from repro_torch import configs as PC                     # noqa: E402
from repro_torch.models import transformer as PT          # noqa: E402
from repro_torch.optim import adamw as PA                 # noqa: E402
from repro_torch.runtime import elastic as PE             # noqa: E402

DENSE = ["granite-8b", "starcoder2-3b", "qwen2.5-14b", "gemma2-9b"]
#: the archs whose checkpoints cross packages, and leaves of each that
#: must be among the files' (the optimizer's first moment of a slot-0
#: layer): the expert stacks, the SSD's decay, skip and conv leaves, the
#: encoder's layers
CROSS = {"starcoder2-3b": ["['opt'].m['body']['slot0']['attn']['wq']"],
         "gemma2-9b": ["['opt'].m['body']['slot0']['attn']['wq']"],
         "granite-moe-1b-a400m": [
             f"['opt'].m['body']['slot0']['moe']['{k}']"
             for k in ("w_router", "w_gate", "w_up", "w_down")],
         "mamba2-780m": [f"['opt'].m['body']['slot0']['ssm']['{k}']"
                         for k in ("A_log", "skip_D", "conv_w", "conv_b")],
         "whisper-small": ["['opt'].m['enc_body']['slot0']['attn']['wq']",
                           "['opt'].m['enc_body']['slot0']['mlp']['w_up']",
                           "['opt'].m['body']['slot0']['xattn']['wk']"]}


def flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def ref_state(arch: str, seed: int = 1):
    """A reference training state whose moments are not zero: one AdamW
    step on random gradients."""
    cfg = RC.get_smoke(arch)
    params = RT.init_params(cfg, seed=seed)
    grads = jax.tree.map(
        lambda p: jax.random.normal(jax.random.PRNGKey(seed), p.shape), params)
    params, opt, _ = RA.update(grads, RA.init(params), params, lr=1e-2)
    return cfg, {"params": params, "opt": opt}


def port_state(ref_tree):
    """The same state as the port holds it: per-layer fp32 tensors on the
    CPU, a host step count."""
    np_tree = jax.tree.map(np.asarray, ref_tree)
    land = lambda t: PT.params_from_jax(t, device="cpu",  # noqa: E731
                                        dtype=torch.float32)
    opt = np_tree["opt"]
    return land(np_tree["params"]), PA.AdamWState(
        int(opt.step), land(opt.m), land(opt.v))


def as_ref_layout(cfg, params, opt):
    return {"params": PT.params_to_jax(params, cfg),
            "opt": PA.AdamWState(np.int32(opt.step),
                                 PT.params_to_jax(opt.m, cfg),
                                 PT.params_to_jax(opt.v, cfg))}


@pytest.mark.parametrize("arch", DENSE)
def test_params_to_jax_inverts_params_from_jax(arch):
    cfg = PC.get_smoke(arch)
    ref = jax.tree.map(np.asarray, RT.init_params(RC.get_smoke(arch), seed=3))
    back = PT.params_to_jax(PT.params_from_jax(ref, device="cpu",
                                               dtype=torch.float32), cfg)
    ours, theirs = flat(back), flat(ref)
    assert sorted(ours) == sorted(theirs)
    for name, a in theirs.items():
        assert ours[name].dtype == a.dtype and ours[name].shape == a.shape
        np.testing.assert_array_equal(ours[name], a, err_msg=name)


@pytest.mark.parametrize("arch", list(CROSS))
def test_reference_checkpoint_restores_in_the_port(tmp_path, arch):
    _, tree = ref_state(arch)
    RCk.save_checkpoint(tree, 5, str(tmp_path), n_shards=3)
    want = flat(tree)
    by_names = PCk.restore_checkpoint(None, 5, str(tmp_path))
    donor = jax.tree.map(np.asarray, tree)
    by_donor = PCk.restore_checkpoint(donor, 5, str(tmp_path))
    assert isinstance(by_donor["opt"], RA.AdamWState)
    o = by_names["opt"]           # NamedTuple fields come back as dict keys
    assert sorted(o) == ["m", "step", "v"]
    named = {"params": by_names["params"],
             "opt": PA.AdamWState(o["step"], o["m"], o["v"])}
    for got in (by_donor, named):
        got = {n: np.asarray(v) for n, v in PCk.ckpt._flatten(got)}
        assert sorted(got) == sorted(want)
        for name, a in want.items():
            assert got[name].dtype == a.dtype, name
            np.testing.assert_array_equal(got[name], a, err_msg=name)
    # landed on the one-device mesh: the port's per-layer fp32 state
    cfg = PC.get_smoke(arch)
    params, opt, rules = PE.reshard_state(
        cfg, by_names["params"], PA.AdamWState(o["step"], o["m"], o["v"]),
        PE.make_elastic_mesh(device="cpu"))
    assert rules is None          # no rules on the one-device record
    assert opt.step == 1 and isinstance(opt.step, int)
    assert len(params["layers"]) == cfg.n_layers
    assert len(params.get("enc_layers", [])) == cfg.n_encoder_layers
    assert all(t.dtype == torch.float32 for t in PA.leaves(params))
    again = flat(as_ref_layout(cfg, params, opt))
    for name, a in want.items():
        np.testing.assert_array_equal(again[name], a, err_msg=name)


@pytest.mark.parametrize("arch", list(CROSS))
def test_port_checkpoint_restores_in_the_reference(tmp_path, arch):
    _, tree = ref_state(arch, seed=2)
    params, opt = port_state(tree)
    pcfg = PC.get_smoke(arch)
    paths = PCk.save_checkpoint(as_ref_layout(pcfg, params, opt), 9,
                                str(tmp_path / "port"), n_shards=2)
    assert [os.path.basename(p) for p in paths] == \
        ["step-00000009-shard0.npz", "step-00000009-shard1.npz"]
    assert RCk.latest_step(str(tmp_path / "port")) == 9
    got = RCk.restore_checkpoint(tree, 9, str(tmp_path / "port"))
    assert int(got["opt"].step) == 1
    for (name, a), (_, b) in zip(flat(got).items(), flat(tree).items()):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the same state written by each package: the same index and arrays
    RCk.save_checkpoint(tree, 9, str(tmp_path / "ref"), n_shards=2)
    idx = [json.loads((tmp_path / d / "step-00000009.index.json").read_text())
           for d in ("port", "ref")]
    assert idx[0] == idx[1]
    assert idx[0]["leaves"][0] == "['opt'].step"
    assert all(leaf in idx[0]["leaves"] for leaf in CROSS[arch])
    for shard in range(2):
        zs = [np.load(tmp_path / d / f"step-00000009-shard{shard}.npz")
              for d in ("port", "ref")]
        assert zs[0].files == zs[1].files
        for k in zs[0].files:
            assert zs[0][k].dtype == zs[1][k].dtype
            np.testing.assert_array_equal(zs[0][k], zs[1][k])


def test_save_restore_roundtrip(tmp_path):
    _, tree = ref_state("granite-8b")
    params, opt = port_state(tree)
    pcfg = PC.get_smoke("granite-8b")
    host = as_ref_layout(pcfg, params, opt)
    PCk.save_checkpoint(host, 7, str(tmp_path), n_shards=3)
    assert PCk.latest_step(str(tmp_path)) == 7
    out = PCk.restore_checkpoint(host, 7, str(tmp_path))
    for (na, a), (nb, b) in zip(PCk.ckpt._flatten(host),
                                PCk.ckpt._flatten(out)):
        assert na == nb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="leaves differ"):
        PCk.restore_checkpoint({"params": host["params"]}, 7, str(tmp_path))


def test_async_checkpointer_overlap(tmp_path):
    """Writes off-thread from host copies taken at submit: a tensor
    changed in place after ``submit`` does not change what is written."""
    t = torch.zeros(4)
    ck = PCk.AsyncCheckpointer(str(tmp_path), n_shards=2)
    f1 = ck.submit({"w": t, "s": np.int32(1)}, 1)
    t.add_(1.0)
    f2 = ck.submit({"w": t, "s": np.int32(2)}, 2)
    ck.close()
    assert f1.done() and f2.done()
    assert PCk.latest_step(str(tmp_path)) == 2
    one = PCk.restore_checkpoint(None, 1, str(tmp_path))
    assert one["w"].tolist() == [0.0] * 4 and one["s"] == 1
    assert PCk.restore_checkpoint(None, 2, str(tmp_path))["w"].tolist() == \
        [1.0] * 4
