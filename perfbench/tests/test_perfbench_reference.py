"""The plain reference against hand-worked cases, and against the port at
a size the CPU runs."""

import math

import pytest
from conftest import SMALL_MODELS

torch = pytest.importorskip("torch")

from perfbench.reference import model as R  # noqa: E402


def dense(D=4, H=2, KV=1, hd=2, F=3, V=5, layers=1):
    return {"family": "dense", "n_layers": layers, "d_model": D,
            "n_heads": H, "n_kv_heads": KV, "head_dim": hd, "d_ff": F,
            "vocab_size": V, "use_rope": True, "rope_theta": 10000.0,
            "norm_eps": 1e-6}


def test_norm_by_hand():
    ref = R.Model(dense(), {})
    x = torch.tensor([[3.0, 4.0, 0.0, 0.0]])
    out = ref.norm(x, torch.tensor([0.0, 1.0, 0.0, 0.0]))
    rms = math.sqrt(25 / 4)
    assert torch.allclose(out, torch.tensor([[3 / rms, 8 / rms, 0, 0]]),
                          atol=1e-6)


def test_rope_by_hand():
    ref = R.Model(dense(hd=2), {})
    x = torch.tensor([[[1.0, 0.0]], [[1.0, 0.0]]])        # positions 0, 1
    out = ref.rope(x)
    assert torch.allclose(out[0, 0], torch.tensor([1.0, 0.0]))
    assert torch.allclose(out[1, 0], torch.tensor([math.cos(1),
                                                   math.sin(1)]), atol=1e-6)


def test_attention_by_hand():
    # one head of width 2, identity projections, no RoPE: position 1
    # attends to keys e1 and e2 with scores 0 and 1/sqrt(2)
    m = {**dense(D=2, H=1, KV=1, hd=2), "use_rope": False}
    eye = torch.eye(2)
    p = {"wq": eye, "wk": eye, "wv": eye, "wo": eye}
    h = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    out = R.Model(m, {}).attention(p, h)
    w = torch.softmax(torch.tensor([0.0, 1.0]) / math.sqrt(2), 0)
    assert torch.allclose(out[0], torch.tensor([1.0, 0.0]))
    assert torch.allclose(out[1], w[0] * h[0] + w[1] * h[1], atol=1e-6)


def test_moe_capacity_drops_in_token_order():
    # 2 experts, top 1, capacity factor 1: S=4 tokens -> 2 slots each;
    # the router sends all four to expert 0, so tokens 2 and 3 drop
    m = {"family": "moe", "d_model": 2, "n_experts": 2, "top_k": 1,
         "capacity_factor": 1.0, "moe_d_ff": 2}
    p = {"w_router": torch.tensor([[5.0, 0.0], [5.0, 0.0]]),
         "w_gate": torch.stack([torch.eye(2) * 10, torch.eye(2)]),
         "w_up": torch.stack([torch.eye(2), torch.eye(2)]),
         "w_down": torch.stack([torch.eye(2), torch.eye(2)])}
    h = torch.ones(4, 2)
    out = R.Model(m, {}).moe(p, h)
    one = torch.nn.functional.silu(torch.tensor(10.0))   # silu(10) * 1
    assert torch.allclose(out[:2], torch.full((2, 2), float(one)))
    assert torch.equal(out[2:], torch.zeros(2, 2))


def test_ssd_chunks_match_the_recurrence_step_by_step():
    torch.manual_seed(0)
    m = {"family": "ssm", "d_model": 4, "ssm_expand": 2, "ssm_state": 3,
         "ssm_groups": 1, "ssm_head_dim": 4, "ssm_conv": 2, "norm_eps": 1e-6}
    inner, N, H, P = 8, 3, 2, 4
    conv = inner + 2 * N
    p = {"w_in": torch.randn(4, 2 * inner + 2 * N + H) * 0.5,
         "conv_w": torch.randn(conv, 2) * 0.5, "conv_b": torch.randn(conv),
         "dt_bias": torch.randn(H), "A_log": torch.randn(H),
         "skip_D": torch.randn(H), "w_norm": torch.randn(inner) * 0.1,
         "w_out": torch.eye(inner)[:, :4]}
    S = 2 * R.CHUNK + 5
    h = torch.randn(S, 4)
    got = R.Model(m, {}).ssd(p, h)
    # the recurrence, one token at a time
    proj = h @ p["w_in"]
    z, xbc, dt = torch.split(proj, [inner, inner + 2 * N, H], -1)
    prev = torch.cat([torch.zeros(1, conv), xbc[:-1]])
    xbc = torch.nn.functional.silu(prev * p["conv_w"][:, 0]
                                   + xbc * p["conv_w"][:, 1] + p["conv_b"])
    x, B, C = torch.split(xbc, [inner, N, N], -1)
    x = x.view(S, H, P)
    dt = torch.nn.functional.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    state = torch.zeros(H, P, N)
    ys = []
    for t in range(S):
        state = state * torch.exp(dt[t] * A)[:, None, None] + \
            dt[t][:, None, None] * x[t][:, :, None] * B[t][None, None, :]
        ys.append((state * C[t][None, None, :]).sum(-1)
                  + x[t] * p["skip_D"][:, None])
    y = torch.stack(ys).reshape(S, inner) * torch.nn.functional.silu(z)
    y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + 1e-6) * \
        (1 + p["w_norm"])
    assert torch.allclose(got, y @ p["w_out"], atol=1e-4, rtol=1e-4)


def test_fp8_control_rounds_to_three_mantissa_bits():
    t = torch.tensor([[1.0, 1.0625, 448.0]])
    out = R._fp8(t, -1)
    assert out[0, 0] == 1.0 and out[0, 2] == 448.0
    assert out[0, 1] in (1.0, 1.125)


@pytest.mark.parametrize("config", sorted(SMALL_MODELS))
def test_reference_agrees_with_the_port_at_a_small_size(config):
    import json
    from conftest import ROOT
    from perfbench import weights
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ModelConfig
    m = {**json.loads((ROOT / "perfbench" / "configs" /
                       f"{config}.json").read_text())["model"],
         **SMALL_MODELS[config]}
    cfg = ModelConfig(**m)
    params = weights.make(T.param_layout(cfg), 11, "cpu",
                          lambda path: path[-1] in T.FP32_KEYS)
    tokens = torch.randint(0, m["vocab_size"], (2, 40),
                           generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        prog, _ = T.prefill(params, cfg, tokens, impl="flash")
        full, _ = T.forward(params, cfg, tokens)
    ref = R.logits(m, params, list(tokens),
                   [torch.arange(40)] * 2)
    for b in range(2):
        rms = ref[b].pow(2).mean(-1).sqrt()
        err = (full[b] - ref[b]).abs().amax(-1) / rms
        # bf16 against float32: a few positions whose MoE routes flip
        # read far off; the median does not
        assert float(err.median()) < 0.15
        assert float(((prog[b] - full[b, -1]).abs().max()) / rms[-1]) < 0.1


@pytest.mark.parametrize("layer", ["attention", "mlp", "moe", "ssd"])
def test_reference_layers_are_the_ports_in_float32(layer):
    """Each block of the reference against the port's own in float32 on
    the same weights: the same equations, to float32 rounding."""
    import json
    from conftest import ROOT
    from perfbench import weights
    from repro_torch.models import layers as L
    from repro_torch.models import ssd as S
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ModelConfig
    m = {**json.loads((ROOT / "perfbench" / "configs" /
                       "jamba-v0.1-52b-stage.json").read_text())["model"],
         **SMALL_MODELS["jamba-v0.1-52b-stage"], "capacity_factor": 1.0,
         "use_rope": True}
    cfg = ModelConfig(**m)
    params = weights.make(T.param_layout(cfg), 3, "cpu",
                          lambda path: True, dtype=torch.float32)
    lp = params["layers"][{"attention": 4, "mlp": 0, "moe": 1,
                           "ssd": 0}[layer]]
    x = torch.randn(1, 50, m["d_model"],
                    generator=torch.Generator().manual_seed(1))
    ref = R.Model(m, params)
    with torch.no_grad():
        if layer == "attention":
            pos = torch.arange(50)[None]
            want = L.attention_layer(lp["attn"], x, cfg, positions=pos)
            got = ref.attention(lp["attn"], x[0])
        elif layer == "mlp":
            want = L.mlp_layer(lp["mlp"], x, cfg)
            got = ref.mlp(lp["mlp"], x[0])
        elif layer == "moe":
            want, _ = L.moe_layer(lp["moe"], x, cfg)
            got = ref.moe(lp["moe"], x[0])
        else:
            lp["ssm"]["dt_bias"].normal_(generator=torch.Generator()
                                         .manual_seed(2))
            want = S.ssd_layer(lp["ssm"], x, cfg)
            got = ref.ssd(lp["ssm"], x[0])
    assert torch.allclose(got, want[0], atol=2e-5, rtol=1e-4), \
        float((got - want[0]).abs().max())
