"""The hybrid family as ``chip_smoke.py``'s phase 10a serves it, on the
CPU.

- The one-period configuration (``chip_smoke.hybrid_config``):
  jamba-v0.1-52b's published config field for field but for
  ``n_layers`` (32 -> 8, one stage of a four-stage pipeline), every
  layer kind in its published ratio (1 attention : 7 SSD, MoE at the odd
  indices), and the port's parameter and model-FLOP counts equal to the
  reference's on its own config cut alike; the phase's capacities and
  phase 14 (b)'s bound of the prefill.
- The phase's MoE-serving bookkeeping (``routed_layers``,
  ``attention_layers``, ``first_layer``, ``no_drop_config``, shared with
  phase 9), on jamba's smoke config (one period of 8 layers) through
  ``launch/serve.py`` on the CPU: 4 routed calls a pass under
  ``RouteLog``, 1 attention call a prefill under ``MaskTally``, nothing
  dropped at decode at capacity factor E/K, and a decode step at P equal
  to a P + 1 token prefill's last logits in float32 within 1e-4 (the
  bound of ``tests/test_torch_moe.py::test_whole_model_matches_in_fp32``).
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as RC                           # noqa: E402
from repro.models import transformer as RT                # noqa: E402
from repro_torch import configs as PC                     # noqa: E402
from repro_torch.launch import serve as PS                # noqa: E402
from repro_torch.models import layers as PL               # noqa: E402
from repro_torch.models import transformer as PT          # noqa: E402

ARCH = "jamba-v0.1-52b"
FP32_TOL = dict(rtol=1e-4, atol=1e-4)


def load_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.fixture(scope="module")
def smoke():
    return load_smoke()


# ------------------------------------------------ the one-period config
def test_one_period_is_the_published_config_but_for_depth(smoke):
    full, cut = PC.get_config(ARCH), smoke.hybrid_config()
    assert smoke.HYBRID_ARCH == ARCH
    assert (full.n_layers, cut.n_layers) == (32, full.hybrid_period) == (32, 8)
    differ = [f.name for f in dataclasses.fields(full)
              if getattr(full, f.name) != getattr(cut, f.name)]
    assert differ == ["n_layers"]
    assert full.n_layers % cut.n_layers == 0        # whole periods a stage
    assert full.n_layers // cut.n_layers == 4       # four pipeline stages


def test_one_period_holds_every_layer_kind_in_its_ratio(smoke):
    cfg = smoke.hybrid_config()
    kinds = [cfg.layer_kind(l % cfg.scan_period) for l in range(cfg.n_layers)]
    assert kinds.count("attn") == 1 and kinds.count("ssm") == 7
    assert kinds.index("attn") == cfg.hybrid_attn_index == 4
    moe = [l for l in range(cfg.n_layers) if cfg.layer_is_moe(l)]
    assert moe == [1, 3, 5, 7]
    # the bookkeeping phases 9 and 10a share
    assert smoke.routed_layers(cfg) == 4
    assert smoke.attention_layers(cfg) == 1
    assert smoke.first_layer(cfg, cfg.layer_is_moe) == 1
    assert smoke.first_layer(cfg, lambda i: cfg.layer_kind(i) == "ssm") == 0
    # the published widths of each kind
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim) == (4096, 32, 8, 128)
    assert not cfg.use_rope
    assert (cfg.n_experts, cfg.top_k, cfg.moe_d_ff,
            cfg.capacity_factor) == (16, 2, 14336, 1.25)
    assert (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
            cfg.ssm_chunk) == (128, 64, 16, 256)


def test_phase_9_keeps_its_counts(smoke):
    """Phase 9's model routes and attends in every layer: the shared
    bookkeeping gives it the counts it had (n_layers each)."""
    cfg = PC.get_config(smoke.MOE_ARCH)
    assert smoke.routed_layers(cfg) == smoke.attention_layers(cfg) == 48
    assert smoke.first_layer(cfg, cfg.layer_is_moe) == 0
    assert smoke.first_layer(cfg, lambda i: cfg.layer_kind(i) == "ssm") \
        is None


@pytest.mark.parametrize("what,want", [
    ("params", 13_267_656_416), ("active", 3_402_653_408),
    ("model_flops", 2.0415920448e10)])
def test_one_period_counts_equal_the_reference(smoke, what, want):
    cut = smoke.hybrid_config()
    ref = RC.get_config(ARCH)
    ref = ref.replace(n_layers=ref.hybrid_period)
    port = {"params": PT.count_params(cut),
            "active": PT.count_params(cut, active_only=True),
            "model_flops": PT.model_flops_per_token(cut)}[what]
    theirs = {"params": RT.count_params(ref),
              "active": RT.count_params(ref, active_only=True),
              "model_flops": RT.model_flops_per_token(ref)}[what]
    assert port == theirs == want


def test_one_period_weights_and_capacities(smoke):
    """26.54 GB of weights (bf16, the fp32 leaves in fp32), counted from
    the layout without allocating; capacity 320 a row at the prompt's
    2048 tokens, 1 at a decode step, and every token's at E/K."""
    cfg = smoke.hybrid_config()
    total = 0

    def add(path, leaf):
        nonlocal total
        dt = PT._leaf_dtype(path, torch.bfloat16)
        total += int(np.prod(leaf[0])) * torch.empty(0, dtype=dt).element_size()

    PT._walk(PT.param_layout(cfg), add)
    assert total == smoke.HYBRID_WEIGHT_BYTES
    assert round(total / 1e9, 2) == 26.54
    assert PL.moe_capacity(cfg, smoke.SERVE_P) == 320
    assert PL.moe_capacity(cfg, 1) == 1
    nd = smoke.no_drop_config(cfg)
    assert nd.capacity_factor == 8.0
    assert PL.moe_capacity(nd, smoke.SERVE_P + 1) == smoke.SERVE_P + 1


def test_phase_14_bound_of_the_one_period_prefill(smoke):
    """Phase 14 (b)'s anchor: the prefill's 5.575e13 model FLOPs at 989
    TFLOP/s take 56.4 ms; every weight read once at 3.35 TB/s 7.92 ms."""
    from repro_torch.models.config import ShapeConfig
    cfg = smoke.phase_config({"arch": ARCH, "layers": 8})
    assert cfg == smoke.hybrid_config()
    b = smoke.one_card_bound(cfg, ShapeConfig("prefill", smoke.SERVE_P,
                                              smoke.SERVE_B, "prefill"),
                             1, 1e3)
    assert b["bound_by"] == "operations"
    assert b["model_flops"] == pytest.approx(5.5749073e13, rel=1e-7)
    assert b["bound_ms"] == pytest.approx(56.369, abs=1e-3)
    assert smoke.HYBRID_WEIGHT_BYTES / smoke.HBM_BYTES_PER_S * 1e3 == \
        pytest.approx(7.921, abs=1e-3)


# --------------------------------------- the serving bookkeeping, on the CPU
B, P, G = 3, 24, 5


@pytest.fixture(scope="module")
def served(smoke):
    cfg = PC.get_smoke(ARCH)
    params = PT.init_params(cfg, seed=0, device="cpu")
    tokens = PS.make_tokens(cfg, B, P, seed=0, device="cpu")
    with smoke.RouteLog() as routes, smoke.MaskTally() as masks:
        out = PS.serve(cfg, params, tokens, gen_len=G, replicas=2)
    return cfg, params, routes, masks, out


def test_smoke_config_is_one_period(smoke):
    cfg = PC.get_smoke(ARCH)
    assert cfg.n_layers == cfg.hybrid_period == 8
    assert smoke.routed_layers(cfg) == 4
    assert smoke.attention_layers(cfg) == 1


def test_serving_routes_four_layers_a_pass(smoke, served):
    cfg, _params, routes, _masks, out = served
    n = smoke.routed_layers(cfg)
    assert len(routes.calls) == n * G          # the prefill and G - 1 steps
    assert out["decode_steps"] == G - 1
    assert [tuple(e.shape) for e in routes.experts()[:n]] == \
        [(B, P, cfg.top_k)] * n
    assert [tuple(e.shape) for e in routes.experts()[n:]] == \
        [(B, 1, cfg.top_k)] * (n * (G - 1))
    decode_dropped = sum(int((~k).sum()) for _, k in routes.calls[n:])
    assert decode_dropped == 0


def test_serving_calls_attention_once_a_prefill(smoke, served):
    """The one attention layer goes through the kernel's wrapper once a
    prefill, causal and with no window; decode attention is plain."""
    cfg, _params, _routes, masks, out = served
    assert masks.calls == {True: smoke.attention_layers(cfg), False: 0} \
        == {True: 1, False: 0}
    assert masks.windows == {0: 1}
    assert tuple(out["generated"].shape) == (B, G)
    assert out["evicted_per_replica"] == [1, 1]


def test_decode_at_no_drop_capacity_drops_nothing(smoke, served):
    cfg, params, *_ = served
    nd = smoke.no_drop_config(cfg)
    ext = PS.make_tokens(cfg, B, P + 1, seed=1, device="cpu")
    pos = torch.full((B,), P, dtype=torch.int32)
    with torch.inference_mode(), smoke.RouteLog() as routes:
        _, cache = PT.prefill(params, nd, ext[:, :P], max_seq=P + 1,
                              impl="flash")
        PT.decode_step(params, nd, ext[:, P:], cache, pos)
    n = smoke.routed_layers(cfg)
    assert len(routes.calls) == 2 * n
    assert all(bool(k.all()) for _, k in routes.calls)


def test_decode_equals_a_longer_prefill_in_fp32(smoke, served, monkeypatch):
    """Decode at position P after a P-token prefill against the last
    logits of a P + 1 token prefill, at capacity E/K, computing in
    float32: the same routes (counted), the logits within 1e-4."""
    cfg, params, *_ = served
    monkeypatch.setattr(PT, "COMPUTE_DTYPE", torch.float32)
    nd = smoke.no_drop_config(cfg)
    ext = PS.make_tokens(cfg, B, P + 1, seed=1, device="cpu")
    pos = torch.full((B,), P, dtype=torch.int32)
    with torch.inference_mode():
        with smoke.RouteLog() as full_routes:
            full, _ = PT.prefill(params, nd, ext, impl="flash")
        with smoke.RouteLog() as dec_routes:
            _, cache = PT.prefill(params, nd, ext[:, :P], max_seq=P + 1,
                                  impl="flash")
            step, _ = PT.decode_step(params, nd, ext[:, P:], cache, pos)
    n = smoke.routed_layers(cfg)
    full_e = full_routes.experts()
    replay = [e[:, :P] for e in full_e] + [e[:, P:] for e in full_e]
    assert smoke.route_flips(replay, dec_routes.experts(),
                             cfg.n_experts) == [0] * (2 * n)
    np.testing.assert_allclose(step[:, 0].numpy(), full.numpy(), **FP32_TOL)
