"""Port parity, the encoder-decoder family (whisper-small):
``repro_torch.models`` against ``repro.models`` on the CPU, the same
seeded numpy weights (the reference's layout, ``test_torch_moe.
ref_weights``) and inputs on both sides.

- Configs field for field the reference's, CONFIG and SMOKE; parameter
  counts equal (334,674,432 at full width, its untied unembedding
  included); ``params_to_jax`` after ``params_from_jax`` is the identity,
  the encoder's ``enc_body`` and the decoder's ``lnx``/``xattn`` included.
- ``sinusoidal_positions`` within 1e-6 of the reference's at (1500, 768)
  and (16, 64), once the reference's fp32 ``exp`` is the correctly
  rounded one (XLA:CPU's misses it at some frequencies, and at position
  1499 one ulp of a frequency moves sin by about 1e-4; the port takes
  the correctly rounded value, the same on every device).
- In float32 (``COMPUTE_DTYPE`` of both set to float32):
  ``cross_attention_layer``, the encoder (``_encode``: the port's
  ``flash``, the plain version on the CPU, against the reference's
  ``pallas`` in interpret mode) and ``_enc_kv`` within 1e-5; the whole
  model (``forward``, ``loss_fn``, ``prefill`` with its caches, cross
  k/v included, and three ``decode_step``s) within 1e-4.
- In bf16 the whole model within 0.1 (the dense models' bound,
  tests/test_torch_models.py), against the reference's compiled run and
  against its op-by-op run (``jax.disable_jit``) with its gelu and silu
  rounded once from float32; ``test_gelu_rounding_in_bf16`` records how
  far each package's bf16 gelu is from the correctly rounded value.
- One ``build_train_step`` step with the frames (two microbatches):
  loss and grad norm within 2e-2 relative, the learning rate equal.
- Checkpoints: one the port writes restores in the reference, and one
  the reference writes restores in the port, array for array.
- The launcher (``--smoke --device cpu``) prints the reference
  launcher's JSON; its prefill calls the kernel wrapper once per encoder
  layer without a causal mask and once per decoder layer with one.
"""

import dataclasses
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                # noqa: E402
import jax.numpy as jnp                                   # noqa: E402

from repro import checkpoint as RCk                       # noqa: E402
from repro import configs as RC                           # noqa: E402
from repro.launch import serve as ref_serve               # noqa: E402
from repro.models import layers as RL                     # noqa: E402
from repro.models import transformer as RT                # noqa: E402
from repro.optim import adamw as RA                       # noqa: E402
from repro.runtime import steps as RS                     # noqa: E402
from repro_torch import checkpoint as PCk                 # noqa: E402
from repro_torch import configs as PC                     # noqa: E402
from repro_torch.launch import serve as port_serve        # noqa: E402
from repro_torch.models import layers as PL               # noqa: E402
from repro_torch.models import transformer as PT          # noqa: E402
from repro_torch.optim import adamw as PA                 # noqa: E402
from repro_torch.runtime import elastic as PE             # noqa: E402
from repro_torch.runtime import steps as PS               # noqa: E402
from test_torch_checkpoint import (as_ref_layout, flat,  # noqa: E402
                                   port_state, ref_state)
from test_torch_moe import close, ref_weights, silu_rounded_once  # noqa: E402

ARCH = "whisper-small"
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
FP32_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_ATOL = 0.1
B, S = 2, 16


# ------------------------------------------------------ shared with vlm
def draw_extras(cfg, rng, batch: int) -> dict:
    """Frames and image-patch embeddings as numpy float32, drawn from
    ``rng`` after the tokens, as the reference's launcher draws them."""
    out = {}
    if cfg.is_encoder_decoder:
        out["frames"] = rng.randn(batch, cfg.n_frames,
                                  cfg.d_model).astype(np.float32)
    if cfg.n_image_patches:
        out["image_embeds"] = rng.randn(batch, cfg.n_image_patches,
                                        cfg.d_model).astype(np.float32)
    return out


def model_case(arch, compute=None, seed=0, batch=B):
    """The smoke configs, the same seeded weights in both packages (the
    port's in ``compute``: float32 or the compute type), tokens and the
    extra inputs the family takes."""
    cfg_r, cfg_p = RC.get_smoke(arch), PC.get_smoke(arch)
    w = ref_weights(cfg_r, seed)
    dtype = torch.float32 if compute == "float32" else PT.COMPUTE_DTYPE
    port = PT.params_from_jax(w, device="cpu", dtype=dtype)
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg_r.vocab_size, (batch, S)).astype(np.int32)
    return (cfg_r, cfg_p, jax.tree.map(jnp.asarray, w), port, tokens,
            draw_extras(cfg_r, rng, batch))


def run_both(cfg_r, cfg_p, params, port, tokens, extras):
    """forward, loss_fn, prefill of S - 1 tokens with its caches and
    three decode steps in both packages, the reference's attention
    through its Pallas kernel (interpret mode), the port's through
    ``flash`` (the plain version on the CPU): a list of (name, port
    tensor, reference array)."""
    rk = {k: jnp.asarray(v) for k, v in extras.items()}
    pk = {k: torch.from_numpy(v) for k, v in extras.items()}
    t = torch.from_numpy(tokens)
    Bx, Sx = tokens.shape
    out = []
    r_logits, _ = RT.forward(params, cfg_r, jnp.asarray(tokens),
                             impl="pallas", **rk)
    p_logits, _ = PT.forward(port, cfg_p, t, impl="flash", **pk)
    out.append(("forward", p_logits, r_logits))
    labels = np.roll(tokens, -1, axis=1)
    _, (r_loss, _) = RT.loss_fn(params, cfg_r, jnp.asarray(tokens),
                                jnp.asarray(labels), **rk)
    _, (p_loss, _) = PT.loss_fn(port, cfg_p, t, torch.from_numpy(labels),
                                **pk)
    out.append(("loss", p_loss, r_loss))
    cut = Sx - 1
    r_last, r_cache = RT.prefill(params, cfg_r, jnp.asarray(tokens[:, :cut]),
                                 max_seq=Sx + 2, impl="pallas", **rk)
    p_last, p_cache = PT.prefill(port, cfg_p, t[:, :cut], max_seq=Sx + 2,
                                 impl="flash", **pk)
    out.append(("prefill", p_last, r_last))
    for l, layer in enumerate(p_cache):
        body, slot = divmod(l, cfg_p.scan_period)
        for key, got in layer.items():
            if key.startswith("cross_"):
                want = r_cache["cross"][key[len("cross_"):]][body]
            else:
                want = r_cache[f"slot{slot}"][key][body]
            assert got.shape == want.shape, (l, key)
            # a copy: decode writes the port's cache in place
            out.append((f"prefill cache {l} {key}", got.clone(), want))
    tok = tokens[:, cut:]
    for step in range(3):
        pos = np.full((Bx,), cut + step, np.int32)
        r_step, r_cache = RT.decode_step(params, cfg_r, jnp.asarray(tok),
                                         r_cache, jnp.asarray(pos))
        p_step, p_cache = PT.decode_step(port, cfg_p, torch.from_numpy(tok),
                                         p_cache, torch.from_numpy(pos))
        out.append((f"decode {step}", p_step, r_step))
        tok = np.asarray(jnp.argmax(r_step, -1)).astype(np.int32)
    return out


def check_fp32(monkeypatch, arch):
    monkeypatch.setattr(RT, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(PT, "COMPUTE_DTYPE", torch.float32)
    for name, got, want in run_both(*model_case(arch, compute="float32")):
        close(got, want, **FP32_TOL, err_msg=name)


#: the reference's gelu, kept before a test patches ``jax.nn.gelu``
_GELU = jax.nn.gelu


def gelu_rounded_once(x, approximate=True):
    """The reference's gelu taken in float32 and rounded once to ``x``'s
    type, as the port's bf16 gelu is."""
    return _GELU(x.astype(jnp.float32), approximate).astype(x.dtype)


def check_bf16(monkeypatch, arch, run):
    """The whole model in bf16 within MODEL_ATOL of the reference's
    compiled run, or of its op-by-op run (``jax.disable_jit``: each
    operation rounds to its result type, as the port's do) with its
    gelu and silu rounded once from float32."""
    case = model_case(arch)
    if run == "op_by_op":
        monkeypatch.setattr(jax.nn, "gelu", gelu_rounded_once)
        monkeypatch.setattr(jax.nn, "silu", silu_rounded_once)
        with jax.disable_jit():
            results = run_both(*case)
    else:
        results = run_both(*case)
    worst = {}
    for name, got, want in results:
        err = np.abs(got.detach().float().numpy() - np.asarray(want,
                                                              np.float32))
        worst[name] = float(err.max())
        assert worst[name] <= MODEL_ATOL, (name, worst[name])
    print(f"{arch} bf16 against the reference's {run} run: max |diff| "
          f"{max(worst.values()):.6f} ({max(worst, key=worst.get)})")


def check_train_step(arch):
    """One training step of the smoke config with the family's extra
    inputs, two microbatches, in both packages from the same fp32
    weights: loss and grad norm within 2e-2 relative, lr equal."""
    rcfg, pcfg = RC.get_smoke(arch), PC.get_smoke(arch)
    kw = dict(n_micro=2, peak_lr=1e-2, warmup=3)
    rstep = jax.jit(RS.build_train_step(rcfg, RS.TrainHParams(**kw)))
    pstep = PS.build_train_step(pcfg, PS.TrainHParams(**kw))
    w = ref_weights(rcfg, 4)
    rp = jax.tree.map(jnp.asarray, w)
    params = PT.params_from_jax(w, device="cpu", dtype=torch.float32)
    rng = np.random.RandomState(4)
    tokens = rng.randint(0, rcfg.vocab_size, (4, S + 1)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
             **draw_extras(rcfg, rng, 4)}
    rp, ro, rm = rstep(rp, RA.init(rp), batch)
    params, po, pm = pstep(params, PA.init(params), batch)
    assert pm["lr"] == float(rm["lr"])
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                               rtol=2e-2)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(rm["grad_norm"]), rtol=2e-2)
    assert po.step == int(ro.step) == 1


def check_launcher(monkeypatch, capsys, arch):
    argv = ["--arch", arch, "--smoke", "--batch", "3", "--prompt-len", "10",
            "--gen-len", "5", "--replicas", "3"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    assert ref_serve.main() == 0
    ref = json.loads(capsys.readouterr().out)
    assert port_serve.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got == ref
    assert got["generated_shape"] == [3, 5] and got["generated_finite"]


# ------------------------------------------------------------- configs
def test_configs_and_counts_equal_reference():
    for get in ("get_config", "get_smoke"):
        port, ref = getattr(PC, get)(ARCH), getattr(RC, get)(ARCH)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), get
        assert PT.count_params(port) == RT.count_params(ref)
        assert port.param_count() == ref.param_count()
    assert PT.count_params(PC.get_config(ARCH)) == 334_674_432


def test_layout_follows_the_reference():
    cfg = PC.get_smoke(ARCH)
    layout = PT.param_layout(cfg)
    ref = RT.param_layout(RC.get_smoke(ARCH))
    assert sorted(layout["layers"][0]) == sorted(ref["body"]["slot0"])
    assert sorted(layout["enc_layers"][0]) == \
        sorted(ref["enc_body"]["slot0"])
    assert len(layout["enc_layers"]) == cfg.n_encoder_layers
    assert "unembed" in layout and "enc_norm" in layout
    assert sorted(layout["layers"][0]["xattn"]) == ["wk", "wo", "wq", "wv"]
    p = PT.init_params(cfg, seed=0, device="cpu")
    leaves = jax.tree.leaves(p, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert sum(t.numel() for t in leaves) == PT.count_params(cfg)
    assert p["enc_norm"].dtype == p["layers"][0]["lnx"].dtype == torch.float32
    assert p["layers"][0]["xattn"]["wq"].dtype == torch.bfloat16


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


# --------------------------------------------------------------- layers
def correctly_rounded_exp(x):
    return jnp.asarray(np.exp(np.asarray(x, np.float64)).astype(np.float32))


@pytest.mark.parametrize("n,d", [(1500, 768), (16, 64)])
def test_sinusoidal_positions_match_reference(monkeypatch, n, d):
    got = PL.sinusoidal_positions(n, d)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    as_is = float(np.abs(got.numpy() - np.asarray(
        RL.sinusoidal_positions(n, d))).max())
    monkeypatch.setattr(jnp, "exp", correctly_rounded_exp)
    close(got, RL.sinusoidal_positions(n, d), rtol=0, atol=1e-6)
    print(f"sinusoidal positions ({n}, {d}): max |diff| to the reference "
          f"{as_is:.3g} with XLA:CPU's exp, within 1e-6 with the correctly "
          "rounded one")


def test_gelu_rounding_in_bf16():
    """What each package's bf16 gelu (tanh form) gives against the
    correctly rounded value (float64, rounded once): the port's is its
    float32 gelu rounded once, and misses the correctly rounded value in
    a few per cent of these values (float32's tanh is not exact); the
    reference's on XLA:CPU (``jax.nn.gelu`` on a bf16 array, rounded to
    bf16 step by step) misses it in almost half, and in a few per cent
    once taken in float32 and rounded once (``gelu_rounded_once``, what
    the op-by-op model test runs)."""
    x = np.random.default_rng(0).standard_normal(100_000).astype(
        np.float32) * 3
    xb = torch.from_numpy(x).bfloat16()
    x64 = xb.double()
    exact = (0.5 * x64 * (1 + torch.tanh(np.sqrt(2 / np.pi) * (
        x64 + 0.044715 * x64 ** 3)))).bfloat16().float().numpy()
    port = torch.nn.functional.gelu(xb, approximate="tanh")
    assert torch.equal(port, torch.nn.functional.gelu(
        xb.float(), approximate="tanh").bfloat16())
    xr = jnp.asarray(x, jnp.bfloat16)
    with jax.disable_jit():
        native = np.asarray(jax.nn.gelu(xr).astype(jnp.float32))
    once = np.asarray(gelu_rounded_once(xr).astype(jnp.float32))
    miss = {"port": float(np.mean(port.float().numpy() != exact)),
            "reference": float(np.mean(native != exact)),
            "reference rounded once": float(np.mean(once != exact))}
    print(f"bf16 gelu off the correctly rounded value: "
          f"{ {k: f'{100 * v:.2f} %' for k, v in miss.items()} }")
    assert miss["port"] < 0.1 and miss["reference rounded once"] < 0.1
    assert miss["reference"] > 0.3


def fp32(monkeypatch):
    monkeypatch.setattr(RT, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(PT, "COMPUTE_DTYPE", torch.float32)
    return model_case(ARCH, compute="float32")


def test_cross_attention_layer_matches(monkeypatch):
    cfg_r, cfg_p, params, port, _, _ = fp32(monkeypatch)
    rng = np.random.default_rng(1)
    KV, hd = cfg_p.n_kv_heads, cfg_p.resolved_head_dim
    x = rng.standard_normal((B, 5, cfg_p.d_model), dtype=np.float32)
    k = rng.standard_normal((B, 24, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, 24, KV, hd), dtype=np.float32)
    rp = jax.tree.map(lambda a: a[0], params["body"]["slot0"]["xattn"])
    want = RL.cross_attention_layer(rp, jnp.asarray(x),
                                    (jnp.asarray(k), jnp.asarray(v)), cfg_r)
    got = PL.cross_attention_layer(port["layers"][0]["xattn"],
                                   torch.from_numpy(x),
                                   (torch.from_numpy(k), torch.from_numpy(v)),
                                   cfg_p)
    close(got, want, **LAYER_TOL)


def test_encoder_and_cross_kv_match(monkeypatch):
    """The encoder over 20 frames (not a multiple of the reference
    kernel's blocks): the port's ``flash`` (the plain version on the
    CPU) against the reference's Pallas kernel in interpret mode, then
    each decoder layer's cross k and v."""
    cfg_r, cfg_p, params, port, _, _ = fp32(monkeypatch)
    frames = np.random.default_rng(2).standard_normal(
        (B, 20, cfg_p.d_model), dtype=np.float32)
    want = RT._encode(params, cfg_r, jnp.asarray(frames), impl="pallas")
    got = PT._encode(port, cfg_p, torch.from_numpy(frames), impl="flash")
    close(got, want, **LAYER_TOL)
    close(PT._encode(port, cfg_p, torch.from_numpy(frames), impl="naive"),
          want, **LAYER_TOL)
    r_k, r_v = RT._enc_kv(params, cfg_r, want)
    kv = PT._enc_kv(port, cfg_p, got)
    assert len(kv) == cfg_p.n_layers
    for l, (k, v) in enumerate(kv):
        close(k, r_k[l], **LAYER_TOL)
        close(v, r_v[l], **LAYER_TOL)


def test_encoder_needs_frames():
    cfg_r, cfg_p, _, port, tokens, _ = model_case(ARCH)
    with pytest.raises(ValueError, match="frames"):
        PT.forward(port, cfg_p, torch.from_numpy(tokens))


# ---------------------------------------------------------- whole model
def test_whole_model_matches_in_fp32(monkeypatch):
    check_fp32(monkeypatch, ARCH)


@pytest.mark.parametrize("run", ["compiled", "op_by_op"])
def test_whole_model_matches_in_bf16(monkeypatch, run):
    check_bf16(monkeypatch, ARCH, run)


def test_init_cache_holds_the_cross_kv():
    cfg = PC.get_smoke(ARCH)
    cache = PT.init_cache(cfg, 3, 20, device="cpu")
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    assert len(cache) == cfg.n_layers
    for layer in cache:
        assert sorted(layer) == ["cross_k", "cross_v", "k", "v"]
        assert layer["k"].shape == (3, 20, KV, hd)
        assert layer["cross_v"].shape == (3, cfg.n_frames, KV, hd)


def test_train_step_passes_the_frames():
    check_train_step(ARCH)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    _, tree = ref_state(ARCH)
    RCk.save_checkpoint(tree, 5, str(tmp_path), n_shards=3)
    names = PCk.restore_checkpoint(None, 5, str(tmp_path))
    o = names["opt"]
    cfg = PC.get_smoke(ARCH)
    params, opt, rules = PE.reshard_state(
        cfg, names["params"], PA.AdamWState(o["step"], o["m"], o["v"]),
        PE.make_elastic_mesh(device="cpu"))
    assert rules is None          # no rules on the one-device record
    assert len(params["enc_layers"]) == cfg.n_encoder_layers
    assert "xattn" in params["layers"][0]
    got, want = flat(as_ref_layout(cfg, params, opt)), flat(tree)
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        np.testing.assert_array_equal(got[name], a, err_msg=name)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    _, tree = ref_state(ARCH, seed=2)
    params, opt = port_state(tree)
    PCk.save_checkpoint(as_ref_layout(PC.get_smoke(ARCH), params, opt), 9,
                        str(tmp_path), n_shards=2)
    got = RCk.restore_checkpoint(tree, 9, str(tmp_path))
    want = flat(tree)
    assert "['params']['enc_body']['slot0']['attn']['wq']" in want
    assert "['params']['body']['slot0']['xattn']['wk']" in want
    for name, a in flat(got).items():
        assert a.dtype == want[name].dtype, name
        np.testing.assert_array_equal(a, want[name], err_msg=name)


# ------------------------------------------------------------- serving
def test_launcher_matches_reference(monkeypatch, capsys):
    check_launcher(monkeypatch, capsys, ARCH)


def test_prefill_calls_the_kernel_without_a_causal_mask_in_the_encoder(
        monkeypatch):
    """The serving prefill goes through the kernel's wrapper once per
    encoder layer with ``causal=False`` and once per decoder layer with
    ``causal=True``; cross attention calls no kernel (plain PyTorch, as
    the reference's ``naive``)."""
    from repro_torch.kernels import flash_attention as fa
    calls = []
    real = fa.flash_attention_bshd
    monkeypatch.setattr("repro_torch.kernels.ops.flash_attention_bshd",
                        lambda *a, **kw: calls.append(kw["causal"])
                        or real(*a, **kw))
    cfg = PC.get_smoke(ARCH)
    params = PT.init_params(cfg, seed=0, device="cpu")
    batch = port_serve.make_batch(cfg, 3, 6, device="cpu")
    assert batch["frames"].shape == (3, cfg.n_frames, cfg.d_model)
    tokens = batch.pop("tokens")
    out = port_serve.serve(cfg, params, tokens, extras=batch, gen_len=3,
                           replicas=2)
    assert calls == [False] * cfg.n_encoder_layers + [True] * cfg.n_layers
    assert bool(torch.isfinite(out["prefill_logits"]).all())
    assert out["evicted_per_replica"] == [1, 1]
