"""The frozen counts against hand counts."""

import json

import pytest
from conftest import ROOT

from perfbench import counts


def model(name):
    return json.loads((ROOT / "perfbench" / "configs" /
                       f"{name}.json").read_text())["model"]


@pytest.mark.parametrize("name,total,active", [
    ("granite-8b", 8_053_362_688, 8_053_362_688),
    ("jamba-v0.1-52b-stage", 13_267_656_416, 3_402_653_408)])
def test_parameter_counts(name, total, active):
    m = model(name)
    assert counts.param_count(m) == total
    assert counts.param_count(m, active=True) == active


def test_granite_layer_by_hand():
    m = model("granite-8b")
    attn = 4096 * 4096 * 2 + 2 * 4096 * 1024
    mlp = 3 * 4096 * 14336
    assert counts.body_params(m) == 36 * (attn + mlp)
    assert counts.unembed_params(m) == 4096 * 49152


@pytest.mark.parametrize("Sq,Sk,causal,window,pairs", [
    (4, 4, True, 0, 10), (4, 4, False, 0, 16), (5, 5, True, 2, 9),
    (3, 6, True, 0, 6), (6, 3, True, 0, 15), (8192, 8192, True, 0,
                                               8192 * 8193 // 2)])
def test_visible_pairs(Sq, Sk, causal, window, pairs):
    assert counts.visible_pairs(Sq, Sk, causal, window) == pairs


def test_attention_call_by_hand():
    # 2 batches, 4 tokens causal (10 pairs), 8 heads over 2 kv heads, D 16
    flops, nbytes = counts.attention_call(2, 4, 4, 8, 2, 16, True, 0)
    assert flops == 4 * 16 * 2 * 8 * 10
    assert nbytes == 2 * 16 * (2 * 2 * 4 * 8 + 2 * 2 * 4 * 2)


def test_roofline_takes_the_larger_bound():
    assert counts.roofline_s(989e12, 0) == pytest.approx(1.0)
    assert counts.roofline_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.roofline_s(989e12, 6.7e12) == pytest.approx(2.0)


def test_prefill_and_decode_flops_by_hand():
    m = model("granite-8b")
    body, unembed = counts.body_params(m), counts.unembed_params(m)
    attn = 36 * 4 * 128 * 32
    assert counts.prefill_flops(m, 4, 1024) == pytest.approx(
        2 * body * 4 * 1024 + 2 * unembed * 4 + attn * 4 * 1024 * 1025 // 2)
    assert counts.decode_flops(m, [4097, 4097]) == pytest.approx(
        2 * (body + unembed) * 2 + attn * 2 * 4097)


def test_jamba_counts_one_attention_layer_and_top2_experts():
    m = model("jamba-v0.1-52b-stage")
    assert counts.attention_layers(m) == 1
    assert [counts.layer_is_moe(m, l) for l in range(8)] == \
        [False, True] * 4
    assert [counts.layer_kind(m, l) for l in range(8)] == \
        ["ssm"] * 4 + ["attn"] + ["ssm"] * 3
