"""Parity of the port's int8 error-feedback all-reduce
(``repro_torch.optim.compress``) with ``repro.optim.compress``, and the
elastic restore of a reference checkpoint onto a 2x2 mesh.

The reference's ``compressed_psum`` runs here under ``jax.vmap`` with
``axis_name="dp"`` on one CPU device (its own test needs four host
devices, which the reference's jax cannot make here); the port's runs on
four gloo ranks in one spawn (``torch_ranks_compress.py``), rank r
holding row r of the same (4, 64) gradients.  Means and error buffers
agree within 1e-6 at each of 8 steps, and the port meets the reference
test's own bounds (0.05 a step, 0.02 on the mean of 8).

The same spawn lands a reference checkpoint on the mesh with
``reshard_state`` and saves what it gathers back: the gathered tensors
equal the checkpoint's, and the files equal the reference's bytes.
"""

from __future__ import annotations

import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                # noqa: E402
import jax.numpy as jnp                                   # noqa: E402

from repro import checkpoint as RCk                       # noqa: E402
from repro import configs as RC                           # noqa: E402
from repro.optim import adamw as RA                       # noqa: E402
from repro.optim import compress as RCo                   # noqa: E402
from repro_torch import configs as PC                     # noqa: E402
from repro_torch.models import transformer as PT          # noqa: E402
from repro_torch.optim import adamw as PA                 # noqa: E402
from repro_torch.optim import compress as PCo             # noqa: E402
from test_torch_moe import ref_weights                    # noqa: E402
import torch_ranks                                        # noqa: E402

STEPS = 8
MATCH_ATOL = 1e-6
#: the reference test's bounds (tests/test_optim.py)
STEP_ATOL, MEAN_ATOL = 0.05, 0.02


def reference_psum(grads: np.ndarray):
    """The reference's ``compressed_psum`` over the rows of ``grads`` as
    the "dp" axis of a ``vmap``: per step, the means (4, 64) and the
    error buffers (4, 64)."""
    step = jax.jit(jax.vmap(
        lambda g, e: RCo.compressed_psum({"g": g}, {"g": e}, "dp"),
        axis_name="dp"))
    err = jnp.zeros_like(grads)
    out = []
    for _ in range(STEPS):
        mean, err_t = step(jnp.asarray(grads), {"g": err})
        err = err_t["g"]
        out.append((np.asarray(mean["g"]), np.asarray(err)))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    grads = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 64)))
    cfg = RC.get_smoke("granite-8b")
    params = jax.tree.map(jnp.asarray, ref_weights(cfg, 21))
    g = jax.tree.map(lambda p: jax.random.normal(jax.random.PRNGKey(2),
                                                 p.shape), params)
    params, opt, _ = RA.update(g, RA.init(params), params, lr=1e-2)
    tree = {"params": params, "opt": opt}
    RCk.save_checkpoint(tree, 5, str(d / "ckpt"), n_shards=3)
    RCk.save_checkpoint(tree, 6, str(d / "ref_ckpt"), n_shards=3)
    torch_ranks.save_inputs(d, grads=grads)
    out = torch_ranks.launch("torch_ranks_compress.py", d)
    out.update(grads=grads, reference=reference_psum(grads), dir=d)
    print(f"four ranks: {out['seconds']:.1f} s")
    return out


def test_compressed_psum_matches_the_reference(ranks):
    psum = ranks["psum"]
    worst = 0.0
    for it, (mean, err) in enumerate(ranks["reference"]):
        got_mean = np.asarray(psum["means"][it])
        got_err = np.asarray([e[it] for e in psum["errs"]])
        worst = max(worst, float(np.abs(got_mean - mean[0]).max()),
                    float(np.abs(got_err - err).max()))
        np.testing.assert_allclose(got_mean, mean[0], rtol=0,
                                   atol=MATCH_ATOL, err_msg=str(it))
        np.testing.assert_allclose(got_err, err, rtol=0, atol=MATCH_ATOL,
                                   err_msg=str(it))
    print(f"largest |diff| from the reference over {STEPS} steps: {worst}")


def test_compressed_psum_within_the_reference_bounds(ranks):
    """The reference test's own bounds: each step within 0.05 of the
    exact mean, and with error feedback the mean of 8 steps within
    0.02."""
    exact = ranks["grads"].mean(0)
    means = np.asarray(ranks["psum"]["means"])
    for it in range(STEPS):
        assert np.max(np.abs(means[it] - exact)) < STEP_ATOL, it
    assert np.max(np.abs(means.mean(0) - exact)) < MEAN_ATOL


def test_payload_is_int32():
    """The payload all-reduced is int32, as the reference psums it (an
    int8 sum would overflow at two ranks of +-127): 4 bytes an element
    and a 4-byte scale a leaf, what a float32 all-reduce moves."""
    g = {"a": torch.zeros(64), "b": [torch.zeros(3, 5)]}
    assert PCo.payload_bytes(g) == 4 * (64 + 15) + 4 * 2


def test_compression_ratio_is_8x():
    """The reference test's arithmetic: the int8 quantization is 4x
    smaller than float32 per element, and the dequantized values are
    within one step of the grid; equal to the reference's."""
    g = torch.linspace(-1, 1, 1024)
    q, scale = PCo._quantize(g)
    assert q.dtype == torch.int8 and q.numel() * q.element_size() * 4 == \
        g.numel() * g.element_size()
    deq = q.float() * scale
    assert float((deq - g).abs().max()) < 1.0 / 127
    rq, rscale = RCo._quantize(jnp.linspace(-1, 1, 1024))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(scale) == float(rscale)


def test_plain_psum_mean_over_one_rank(tmp_path):
    """``plain_psum_mean`` is the mean over the group: over one rank,
    the gradients themselves."""
    import torch.distributed as dist
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        g = {"a": torch.randn(4, 3), "b": [torch.randn(5)]}
        out = PCo.plain_psum_mean(g)
        for x, y in zip(PA.leaves(out), PA.leaves(g)):
            assert torch.equal(x, y) and x is not y
    finally:
        dist.destroy_process_group()


def test_reference_checkpoint_restores_onto_the_mesh(ranks):
    """``reshard_state`` of a reference checkpoint onto the 2x2 mesh: every
    parameter and moment a DTensor placed by its logical axes, the
    gathered tensors equal to the checkpoint's, the step kept, and the
    gathered state written by rank 0 byte for byte as the reference
    writes it."""
    r = ranks["restore"]
    cfg = PC.get_smoke("granite-8b")
    assert r["rules"] and r["placed"] and r["same_names"]
    assert r["leaves"] == 3 * len(PA.leaves(PT.abstract_params(cfg)))
    assert r["max_diff"] == 0.0 and r["step"] == 1
    d = ranks["dir"]
    ref_files = sorted(os.listdir(d / "ref_ckpt"))
    assert ref_files and sorted(os.listdir(d / "port_ckpt")) == ref_files
    for name in ref_files:
        if name.endswith(".npz"):
            # npz members carry zip timestamps; compare the arrays' bytes
            with np.load(d / "ref_ckpt" / name) as a, \
                    np.load(d / "port_ckpt" / name) as b:
                assert sorted(a.files) == sorted(b.files), name
                for k in a.files:
                    assert a[k].dtype == b[k].dtype and \
                        a[k].tobytes() == b[k].tobytes(), (name, k)
        else:
            assert filecmp.cmp(d / "ref_ckpt" / name, d / "port_ckpt" / name,
                               shallow=False), name


def test_trainer_on_the_mesh_checkpoints_from_rank_0(ranks):
    """A ``Trainer`` on the 2x2 mesh trains as one on the one-device
    record (losses within the reference's 5e-2 of
    ``tests/test_sharding.py``), and only rank 0 writes the step-2
    checkpoint, in the unsharded run's leaf names, holding exactly the
    whole tensors the sharded trainer holds."""
    t = ranks["trainer"]
    print(f"trainer losses: sharded {t['sharded']}, plain {t['plain']}")
    assert t["sharded_dtensors"] and not t["plain_dtensors"]
    assert len(t["sharded"]) == len(t["plain"]) == 2
    assert max(abs(a - b) for a, b in zip(t["sharded"], t["plain"])) < 5e-2
    assert t["checkpoint_steps"] == [2, None, None, None]
    assert t["same_names"] and t["checkpoint_vs_held"] == 0.0
