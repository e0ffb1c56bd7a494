"""Shared helpers of the benchmark's own tests: the checkout's root and
``src`` on the import path, and the cells at a size the CPU runs in a
second (the configurations' own fields, narrowed)."""

import itertools
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the same families as the cells, narrowed for the CPU
SMALL_MODELS = {
    "granite-8b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       head_dim=16, d_ff=128, vocab_size=256),
    "jamba-v0.1-52b-stage": dict(n_layers=8, d_model=64, n_heads=4,
                                 n_kv_heads=2, d_ff=128, moe_d_ff=128,
                                 vocab_size=256, n_experts=4, ssm_state=8,
                                 ssm_head_dim=32, ssm_chunk=8,
                                 capacity_factor=8.0),
}
SMALL_TRAFFIC = {
    "prefill": {"batch": 2, "trace_batches": 1,
                "lengths": {"min": 16, "max": 48, "count": 3,
                            "round_to": 8}},
    "decode": {"batch": 4, "prompt_len": 24, "gen_tokens": 10,
               "trace_steps": 2, "check": {"sessions": 2}},
}
CELLS = ("granite-8b.prefill-grouped", "jamba-v0.1-52b-stage.prefill-grouped",
         "granite-8b.decode-longctx")


def small_cell(workload: str):
    """``workload``'s cell, its model and traffic narrowed for the CPU;
    its limits as committed."""
    from perfbench import harness
    cell = harness.load_cell(ROOT, workload)
    config = workload.rsplit(".", 1)[0]
    cell.model = {**cell.model, **SMALL_MODELS[config]}
    cell.traffic = {**cell.traffic, **SMALL_TRAFFIC[cell.traffic["kind"]]}
    return cell


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def fixed_clock(monkeypatch):
    """The harness's host clock as a counter (10 ms a reading), so that a
    window holds the same batches on a loaded machine as on an idle one."""
    from perfbench import harness
    ticks = itertools.count()
    monkeypatch.setattr(harness, "time", types.SimpleNamespace(
        perf_counter=lambda: next(ticks) * 0.01))
