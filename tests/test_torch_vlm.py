"""Port parity, the VLM family (pixtral-12b): ``repro_torch.models``
against ``repro.models`` on the CPU, the same seeded numpy weights and
inputs on both sides (the helpers of tests/test_torch_encdec.py).

- Configs field for field the reference's, CONFIG and SMOKE; parameter
  counts equal (12,772,070,400 at full width); ``params_to_jax`` after
  ``params_from_jax`` is the identity.
- ``_embed`` with image-patch embeddings equals the reference's exactly:
  the first ``n_image_patches`` positions are the embeddings cast to
  bf16, the rest the tokens' embeddings.  A prompt shorter than the
  patches raises ``ValueError`` in the port; the reference fails later,
  with a ``TypeError`` in RoPE.
- The whole model (``forward``, ``loss_fn``, ``prefill`` with its
  caches and three ``decode_step``s, image embeddings in the prompt)
  within 1e-4 in float32, and within 0.1 in bf16 against the
  reference's compiled run and its op-by-op run with silu rounded once.
- One ``build_train_step`` step with the image embeddings: loss and
  grad norm within 2e-2 relative.
- The launcher (``--smoke --device cpu``) prints the reference
  launcher's JSON.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                # noqa: E402
import jax.numpy as jnp                                   # noqa: E402

from repro import configs as RC                           # noqa: E402
from repro.models import transformer as RT                # noqa: E402
from repro_torch import configs as PC                     # noqa: E402
from repro_torch.models import transformer as PT          # noqa: E402
from test_torch_checkpoint import flat                    # noqa: E402
from test_torch_encdec import (check_bf16, check_fp32,  # noqa: E402
                               check_launcher, check_train_step,
                               model_case)
from test_torch_moe import close, ref_weights              # noqa: E402

ARCH = "pixtral-12b"


def test_configs_and_counts_equal_reference():
    for get in ("get_config", "get_smoke"):
        port, ref = getattr(PC, get)(ARCH), getattr(RC, get)(ARCH)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), get
        assert PT.count_params(port) == RT.count_params(ref)
        assert port.param_count() == ref.param_count()
    assert PT.count_params(PC.get_config(ARCH)) == 12_772_070_400


def test_params_round_trip():
    cfg = RC.get_smoke(ARCH)
    w = ref_weights(cfg, 3, zero_std="random")
    back = PT.params_to_jax(PT.params_from_jax(w, device="cpu",
                                               dtype=torch.float32),
                            PC.get_smoke(ARCH))
    ours, theirs = flat(back), flat(w)
    assert sorted(ours) == sorted(theirs)
    for name, a in theirs.items():
        np.testing.assert_array_equal(ours[name], a, err_msg=name)


def test_embed_takes_the_image_patches():
    cfg_r, cfg_p, params, port, tokens, extras = model_case(ARCH)
    img = extras["image_embeds"]
    want = RT._embed(params, cfg_r, jnp.asarray(tokens), jnp.asarray(img))
    got = PT._embed(port, cfg_p, torch.from_numpy(tokens),
                    torch.from_numpy(img))
    assert got.dtype == torch.bfloat16
    close(got, want, rtol=0, atol=0)
    n = cfg_p.n_image_patches
    assert torch.equal(got[:, :n], torch.from_numpy(img).bfloat16())
    assert torch.equal(got[:, n:], PT._embed(
        port, cfg_p, torch.from_numpy(tokens))[:, n:])


def test_prompt_shorter_than_the_patches_raises():
    """P = 2 < n_image_patches = 4: the port says so; the reference
    builds 4 positions of embeddings for 2 of RoPE and fails there."""
    cfg_r, cfg_p, params, port, tokens, extras = model_case(ARCH)
    short = tokens[:, :2]
    img = extras["image_embeds"]
    with pytest.raises(ValueError, match="first 4 positions"):
        PT.prefill(port, cfg_p, torch.from_numpy(short),
                   image_embeds=torch.from_numpy(img))
    with pytest.raises(TypeError):
        RT.prefill(params, cfg_r, jnp.asarray(short),
                   image_embeds=jnp.asarray(img))
    with pytest.raises(ValueError, match="must be"):
        PT.forward(port, cfg_p, torch.from_numpy(tokens),
                   image_embeds=torch.from_numpy(img[:, :3]))


def test_whole_model_matches_in_fp32(monkeypatch):
    check_fp32(monkeypatch, ARCH)


@pytest.mark.parametrize("run", ["compiled", "op_by_op"])
def test_whole_model_matches_in_bf16(monkeypatch, run):
    check_bf16(monkeypatch, ARCH, run)


def test_train_step_passes_the_image_embeds():
    check_train_step(ARCH)


def test_launcher_matches_reference(monkeypatch, capsys):
    check_launcher(monkeypatch, capsys, ARCH)
