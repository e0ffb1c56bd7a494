"""The model path's spans and MoE slot counters (``repro_torch.obs.spans``)
under a CPU ``torch.profiler``.

- A smoke dense model (granite-8b) and a smoke MoE + SSD model
  (jamba-v0.1-52b, one period of 8 layers) through ``prefill`` and one
  ``decode_step`` emit each ``model::`` span as often as the layers call
  its function, each inside its step's root span.
- The counters equal an independent count from ``layers.moe_route``:
  kept slots ``keep.sum()``, routed ``B·S·K``, capacity ``E·B·C``; they
  count serving calls only (autograd off), and only while a profiler
  records.
- With no profiler recording, no profiler range is entered and
  the counters neither move nor add an operation; with one, counting
  adds a sum and an add a MoE call; spans of one name do not nest.
- Logits are bit-equal with tracing on and off.
"""

import collections

import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import configs as PC                     # noqa: E402
from repro_torch.models import layers as PL               # noqa: E402
from repro_torch.models import transformer as PT          # noqa: E402
from repro_torch.obs import spans                         # noqa: E402

ARCHS = ("granite-8b", "jamba-v0.1-52b")
B, S = 2, 12


@pytest.fixture(autouse=True)
def fresh_counters():
    spans.reset()
    yield
    spans.reset()


def profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def model(arch, **changes):
    cfg = PC.get_smoke(arch).replace(**changes)
    return cfg, PT.init_params(cfg, 0, device="cpu")


def serve(cfg, params):
    """A prefill of B x S tokens and one decode step: both logits."""
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        first, cache = PT.prefill(params, cfg, tokens, max_seq=S + 1)
        pos = torch.full((B,), S, dtype=torch.int32)
        nxt, _ = PT.decode_step(params, cfg, tokens[:, -1:], cache, pos)
    return first, nxt


def expected_spans(cfg, params):
    """Each span's calls in one prefill and one decode step."""
    kinds = [cfg.layer_kind(l % cfg.scan_period) for l in range(cfg.n_layers)]
    attn, ssm = kinds.count("attn"), kinds.count("ssm")
    moe = sum("moe" in lp for lp in params["layers"])
    ln2 = sum("ln2" in lp for lp in params["layers"])
    norms = cfg.n_layers + ln2 + ssm + 1          # ln1, ln2, gated, final
    want = {"prefill": 1, "decode_step": 1, "rms_norm": 2 * norms,
            "attention_core": attn, "decode_attention": attn,
            "ssd_layer": ssm, "moe_layer": 2 * moe,
            "rope": 2 * 2 * attn if cfg.use_rope else 0}
    return {k: v for k, v in want.items() if v}


def span_events(prof):
    return [e for e in prof.events() if e.name.startswith(spans.PREFIX)]


@pytest.mark.parametrize("arch", ARCHS)
def test_each_span_once_a_call_inside_its_step(arch):
    cfg, params = model(arch)
    with profiler() as prof:
        serve(cfg, params)
    events = span_events(prof)
    got = collections.Counter(e.name[len(spans.PREFIX):] for e in events)
    assert got == expected_spans(cfg, params)
    roots = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events
                   if e.name in ("model::prefill", "model::decode_step"))
    assert [r[2] for r in roots] == ["model::prefill", "model::decode_step"]
    for e in events:
        if e.name in ("model::prefill", "model::decode_step"):
            continue
        inside = [name for lo, hi, name in roots
                  if lo <= e.time_range.start and e.time_range.end <= hi]
        assert len(inside) == 1, e.name


def test_counters_equal_an_independent_count_from_the_router():
    # a capacity factor of 1 drops slots on these shapes
    cfg, params = model("jamba-v0.1-52b", capacity_factor=1.0)
    p = params["layers"][1]["moe"]
    x = torch.randn(B, S, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    C = PL.moe_capacity(cfg, S)
    with torch.inference_mode():
        with profiler():
            PL.moe_layer(p, x, cfg)
            PL.moe_layer(p, x, cfg)
        route = PL.moe_route(p, x, cfg, C)
    kept = int(route.keep.sum())
    assert kept < B * S * cfg.top_k                  # some were dropped
    assert spans.counters() == {"routed": 2 * B * S * cfg.top_k,
                                "kept": 2 * kept,
                                "capacity": 2 * cfg.n_experts * B * C}


def test_counters_count_serving_calls_while_a_profiler_records():
    cfg, params = model("jamba-v0.1-52b", capacity_factor=1.0)
    p = params["layers"][1]["moe"]
    x = torch.randn(B, S, cfg.d_model,
                    generator=torch.Generator().manual_seed(3))
    zero = {"routed": 0, "kept": 0, "capacity": 0}
    with torch.no_grad():
        PL.moe_layer(p, x, cfg)                     # no profiler
    assert spans.counters() == zero
    with profiler():
        # a call with autograd on (a training step's) counts nothing
        out, aux = PL.moe_layer(p, x.requires_grad_(), cfg)
        (out.sum() + aux).backward()
        assert spans.counters() == zero
        with torch.no_grad():
            PL.moe_layer(p, x, cfg)
    c = spans.counters()
    assert 0 < c["kept"] < c["routed"] == B * S * cfg.top_k <= c["capacity"]


class OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ARCHS)
def test_off_path_enters_no_span_and_counts_nothing(arch, monkeypatch):
    cfg, params = model(arch, capacity_factor=1.0)

    def refuse(*_a, **_k):
        raise AssertionError("a profiler range entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(spans, "_record", refuse)
    with OpLog() as off:
        serve(cfg, params)
    assert spans.counters() == {"routed": 0, "kept": 0, "capacity": 0}
    assert not [op for op in off.ops if "profiler" in op]
    monkeypatch.undo()
    with profiler(), OpLog() as on:
        serve(cfg, params)
    # counting adds a sum and an add a MoE call (and the running total's
    # zeros once), and nothing else
    calls = 2 * sum("moe" in lp for lp in params["layers"])
    extra = collections.Counter(on.ops) - collections.Counter(off.ops)
    assert sum(extra.values()) == len(on.ops) - len(off.ops)
    assert extra == ({"aten.sum.default": calls, "aten.add_.Tensor": calls,
                      "aten.zeros.default": 1} if calls else {})


def test_spans_of_one_name_do_not_nest():
    @spans.span("outer")
    def down(n):
        return down(n - 1) + 1 if n else 0

    @spans.span("inner")
    def leaf():
        return 0

    @spans.span("outer")
    def calls_leaf():
        return leaf() + down(2)

    with profiler() as prof:
        assert down(3) == 3
        calls_leaf()
    got = collections.Counter(e.name for e in span_events(prof))
    assert got == {"model::outer": 2, "model::inner": 1}


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_bit_equal_with_tracing_on_and_off(arch):
    cfg, params = model(arch)
    off = serve(cfg, params)
    with profiler():
        on = serve(cfg, params)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
