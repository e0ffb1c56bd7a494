"""Port parity, the dense model: ``repro_torch.configs`` and
``repro_torch.models`` against ``repro.configs`` and ``repro.models``.

- Configs are field for field the reference's; parameter counts equal.
- Layers in float32, the same seeded numpy weights and inputs on both
  sides: ``rms_norm``, ``apply_rope``, ``attention_layer`` (every
  attention impl), ``mlp_layer`` (silu and tanh-gelu) and
  ``decode_attention`` with full and ring caches, within 1e-5.
- The whole model in bf16, the reference's parameters carried across by
  ``params_from_jax``: ``forward``, ``prefill`` and ``decode_step``
  logits of the four dense smoke configs within 0.1 absolute.  Both
  sides compute in bf16 with fp32 softmax and norms; they round at
  different places (fused elementwise ops, matmul blocking), and logits
  of magnitude up to ~6 carry a bf16 step of 1/32, so a few steps of
  difference are expected.  0.1 is tighter than the reference's own
  prefill/decode tolerance (rtol = atol = 0.12, tests/test_models.py).

Logits are compared, not greedy tokens, which can flip on a near tie.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                # noqa: E402
import jax.numpy as jnp                                   # noqa: E402

from repro import configs as RC                           # noqa: E402
from repro.models import layers as RL                     # noqa: E402
from repro.models import transformer as RT                # noqa: E402
from repro_torch import configs as PC                     # noqa: E402
from repro_torch.models import layers as PL               # noqa: E402
from repro_torch.models import transformer as PT          # noqa: E402

DENSE = ["granite-8b", "starcoder2-3b", "qwen2.5-14b", "gemma2-9b"]
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_ATOL = 0.1
B, S = 2, 16


def both(a: np.ndarray):
    """The same numpy array as a jnp array and a torch CPU tensor."""
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def layout_weights(layout, rng, path=""):
    """Seeded float32 numpy weights for a port layout (shape, axes,
    std); zero std leaves (norms, biases) get small nonzero values so they
    count."""
    if isinstance(layout, dict):
        return {k: layout_weights(v, rng, f"{path}/{k}")
                for k, v in layout.items()}
    shape, _axes, std = layout
    return (rng.standard_normal(shape, dtype=np.float32)
            * np.float32(std or 0.1))


def split(weights):
    ref = jax.tree.map(jnp.asarray, weights)
    port = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), weights)
    return ref, port


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", DENSE)
def test_configs_equal_reference(arch):
    for get in ("get_config", "get_smoke"):
        port, ref = getattr(PC, get)(arch), getattr(RC, get)(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), get
        assert port.scan_period == ref.scan_period
        assert [port.layer_window(i) for i in range(port.n_layers)] == \
            [ref.layer_window(i) for i in range(ref.n_layers)]
        assert PT.count_params(port) == RT.count_params(ref)
        assert port.param_count() == ref.param_count()


def test_granite_8b_full_width_count():
    assert PT.count_params(PC.get_config("granite-8b")) == 8_254_689_280


def test_unported_archs_name_their_roadmap_item():
    """No architecture is left to port: the registry lists the
    reference's ten, in its order, and every family among them runs
    (``FAMILIES``); an unknown arch raises ``KeyError``, as the
    reference's does."""
    assert PC.list_archs() == RC.list_archs()
    assert {RC.get_config(a).family for a in RC.list_archs()} == \
        set(PT.FAMILIES)
    for get in (PC.get_config, RC.get_config):
        with pytest.raises(KeyError, match="unknown arch"):
            get("llama-7b")


def test_init_params_seeded_on_the_host():
    cfg = PC.get_smoke("qwen2.5-14b")
    a = PT.init_params(cfg, seed=3, device="cpu")
    b = PT.init_params(cfg, seed=3, device="cpu")
    c = PT.init_params(cfg, seed=4, device="cpu")
    assert len(a["layers"]) == cfg.n_layers
    assert torch.equal(a["layers"][1]["attn"]["wq"], b["layers"][1]["attn"]["wq"])
    assert not torch.equal(a["embed"], c["embed"])
    assert a["embed"].dtype == torch.bfloat16
    assert a["final_norm"].dtype == torch.float32
    assert a["layers"][0]["ln1"].dtype == torch.float32
    assert not a["layers"][0]["attn"]["bq"].any()
    std = a["layers"][0]["mlp"]["w_down"].float().std().item()
    assert abs(std - cfg.d_ff ** -0.5) < 0.2 * cfg.d_ff ** -0.5
    total = sum(t.numel() for t in jax.tree.leaves(
        a, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert total == PT.count_params(cfg)


# ------------------------------------------------------------------- layers
def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    rx, px = both(rng.standard_normal((2, 5, 64), dtype=np.float32))
    rw, pw = both(rng.standard_normal(64, dtype=np.float32) * 0.1)
    close(PL.rms_norm(px, pw, 1e-6), RL.rms_norm(rx, rw, 1e-6), **LAYER_TOL)
    for theta in (1e4, 1e6):
        rq, pq = both(rng.standard_normal((2, 24, 4, 32), dtype=np.float32))
        pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
        rp, pp = both(pos)
        close(PL.apply_rope(pq, pp, theta), RL.apply_rope(rq, rp, theta),
              **LAYER_TOL)


def attn_case(arch):
    cfg_p, cfg_r = PC.get_smoke(arch), RC.get_smoke(arch)
    rng = np.random.default_rng(len(arch))
    rw, pw = split(layout_weights(PL.attn_params_layout(cfg_p), rng))
    rx, px = both(rng.standard_normal((B, S, cfg_p.d_model),
                                      dtype=np.float32))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    return cfg_p, cfg_r, rw, pw, rx, px, pos


@pytest.mark.parametrize("impl", ["naive", "blockwise", "flash"])
@pytest.mark.parametrize("arch", DENSE)
def test_attention_layer_matches(arch, impl):
    cfg_p, cfg_r, rw, pw, rx, px, pos = attn_case(arch)
    for window in {0, cfg_p.layer_window(0)}:
        ref = RL.attention_layer(rw, rx, cfg_r, positions=jnp.asarray(pos),
                                 window=window, impl="naive")
        got = PL.attention_layer(pw, px, cfg_p,
                                 positions=torch.from_numpy(pos.copy()),
                                 window=window, impl=impl)
        close(got, ref, **LAYER_TOL)


@pytest.mark.parametrize("arch", ["granite-8b", "gemma2-9b"])
def test_mlp_layer_matches(arch):
    cfg_p, cfg_r = PC.get_smoke(arch), RC.get_smoke(arch)
    rng = np.random.default_rng(5)
    rw, pw = split(layout_weights(PL.mlp_params_layout(cfg_p), rng))
    rx, px = both(rng.standard_normal((B, S, cfg_p.d_model),
                                      dtype=np.float32))
    close(PL.mlp_layer(pw, px, cfg_p), RL.mlp_layer(rw, rx, cfg_r),
          **LAYER_TOL)


@pytest.mark.parametrize("slots,window,pos", [
    (16, 0, (5, 15)),           # full cache
    (16, 8, (3, 13)),           # windowed, cache longer than the window
    (8, 8, (5, 13)),            # ring buffer, position 13 wraps round
])
def test_decode_attention_matches(slots, window, pos):
    cfg_p, cfg_r, rw, pw, _, _, _ = attn_case("qwen2.5-14b")
    KV, hd = cfg_p.n_kv_heads, cfg_p.resolved_head_dim
    rng = np.random.default_rng(slots + window)
    x = rng.standard_normal((B, 1, cfg_p.d_model), dtype=np.float32)
    ck = rng.standard_normal((B, slots, KV, hd), dtype=np.float32)
    cv = rng.standard_normal((B, slots, KV, hd), dtype=np.float32)
    p = np.array(pos, dtype=np.int32)
    r_out, r_k, r_v = RL.decode_attention(rw, jnp.asarray(x), jnp.asarray(ck),
                                          jnp.asarray(cv), jnp.asarray(p),
                                          cfg_r, window=window)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    p_out, p_k, p_v = PL.decode_attention(pw, torch.from_numpy(x), tk, tv,
                                          torch.from_numpy(p), cfg_p,
                                          window=window)
    assert p_k is tk and p_v is tv            # written in place
    close(p_out, r_out, **LAYER_TOL)
    close(p_k, r_k, rtol=0, atol=1e-6)
    close(p_v, r_v, rtol=0, atol=1e-6)


# -------------------------------------------------------------- whole model
def model_pair(arch, seq=S):
    cfg_r, cfg_p = RC.get_smoke(arch), PC.get_smoke(arch)
    params = RT.init_params(cfg_r, seed=0)
    port = PT.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    tokens = np.random.RandomState(0).randint(
        0, cfg_r.vocab_size, (B, seq)).astype(np.int32)
    return cfg_r, cfg_p, params, port, tokens


def test_params_from_jax_layout():
    cfg_r, cfg_p, params, port, _ = model_pair("gemma2-9b")
    assert len(port["layers"]) == cfg_p.n_layers == 4
    # layer = body * scan_period + slot
    want = np.asarray(params["body"]["slot1"]["attn"]["wq"][1])
    got = port["layers"][3]["attn"]["wq"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.from_numpy(want.copy()).bfloat16())
    assert port["layers"][2]["ln2"].dtype == torch.float32
    assert "unembed" not in port                       # tied embeddings


@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_decode_match(arch):
    cfg_r, cfg_p, params, port, tokens = model_pair(arch)
    t = torch.from_numpy(tokens.copy())
    r_logits, r_aux = RT.forward(params, cfg_r, jnp.asarray(tokens))
    for impl in ("naive", "blockwise", "flash"):
        p_logits, p_aux = PT.forward(port, cfg_p, t, impl=impl)
        assert p_logits.dtype == torch.float32
        assert p_logits.shape == (B, S, cfg_p.vocab_size)
        close(p_logits, r_logits, rtol=0, atol=MODEL_ATOL)
        assert float(p_aux) == float(r_aux) == 0.0

    cut = S - 1
    r_last, r_cache = RT.prefill(params, cfg_r, jnp.asarray(tokens[:, :cut]),
                                 max_seq=S)
    p_last, p_cache = PT.prefill(port, cfg_p, t[:, :cut], max_seq=S,
                                 impl="flash")
    close(p_last, r_last, rtol=0, atol=MODEL_ATOL)
    for l, layer_cache in enumerate(p_cache):
        body, slot = divmod(l, cfg_p.scan_period)
        want = r_cache[f"slot{slot}"]["k"][body]
        assert layer_cache["k"].shape == want.shape
        close(layer_cache["k"], want, rtol=0, atol=MODEL_ATOL)

    pos = np.full((B,), cut, np.int32)
    r_step, _ = RT.decode_step(params, cfg_r, jnp.asarray(tokens[:, cut:]),
                               r_cache, jnp.asarray(pos))
    p_step, _ = PT.decode_step(port, cfg_p, t[:, cut:], p_cache,
                               torch.from_numpy(pos))
    close(p_step, r_step, rtol=0, atol=MODEL_ATOL)


def test_ring_cache_decode_matches_across_wraps():
    """gemma2's local layers decode from an 8-slot ring cache; 20 steps
    after a 4-token prefill wrap it twice, and every step's logits match
    the reference's."""
    cfg_r, cfg_p, params, port, tokens = model_pair("gemma2-9b", seq=24)
    cut = 4
    _, r_cache = RT.prefill(params, cfg_r, jnp.asarray(tokens[:, :cut]),
                            max_seq=24)
    _, p_cache = PT.prefill(port, cfg_p, torch.from_numpy(tokens[:, :cut]),
                            max_seq=24, impl="flash")
    assert p_cache[0]["k"].shape[1] == 8 and p_cache[1]["k"].shape[1] == 24
    for step in range(cut, 24):
        pos = np.full((B,), step, np.int32)
        tok = tokens[:, step:step + 1]
        r_logits, r_cache = RT.decode_step(params, cfg_r, jnp.asarray(tok),
                                           r_cache, jnp.asarray(pos))
        p_logits, p_cache = PT.decode_step(port, cfg_p, torch.from_numpy(tok),
                                           p_cache, torch.from_numpy(pos))
        close(p_logits, r_logits, rtol=0, atol=MODEL_ATOL)
