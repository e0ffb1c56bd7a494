"""``BENCHMARK.json`` against the benchmark's files: every name finds its
file, every metric file names the layer and the end-to-end metric it
moves as the benchmark does, every cell reports what its per-layer
metrics move, and every cell has its limits."""

import json
import re

import pytest
from conftest import ROOT

pytest.importorskip("torch")

from perfbench import harness  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_files_match(metric):
    mod = harness.metric_module(metric["name"])
    if "layer" in metric:
        assert mod.LAYER == metric["layer"]
        assert mod.MOVES == metric["moves"]
    else:
        assert mod.MOVES == metric["name"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_find_their_files(cell):
    c = harness.load_cell(ROOT, cell["name"])
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    assert all(m["moves"] in e2e for m in c.per_layer)
    numbers = c.limits["numbers"]
    assert numbers and set(numbers) <= {"logit_err", "logit_err_median",
                                        "logit_err_mean",
                                        "token_gap"}
    for v in numbers.values():
        # room on both sides, the more of it above the lower reading
        assert v["lower"] < v["limit"] < v["upper"]
        assert v["limit"] - v["lower"] <= v["upper"] - v["limit"]
    assert set(c.limits["sample"]) <= {"longest_batches", "other_prompts",
                                       "sessions"}
