"""The benchmark's run of one cell: set-up, the measured window, the
traced stretch, the check against the plain reference, the result line.

Everything a cell is made of is found by name: ``BENCHMARK.json`` names
the cell's configuration and traffic mix and its metrics; the files are
``perfbench/configs/<config>.json``, ``perfbench/traffic/<mix>.json``,
``perfbench/metrics/<metric>.py`` and ``perfbench/limits/<cell>.json``.

The window drives the port's serving steps as ``launch/serve.py``
composes them (``runtime.steps.build_prefill_step(cfg, max_seq,
attn_impl="flash")`` and the greedy ``build_decode_step(cfg)``); the
loop is the harness's own, so that every token is copied to the host as
a streaming server returns it, and timed there.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import counts, traffic as traffic_mod, weights
from .reference import model as reference
from .trace import Spans, Trace

HERE = Path(__file__).resolve().parent
#: modules that must not be loaded in the process that prints a result
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# ------------------------------------------------------------------ the cell
@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    model: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    limits: Dict


def _applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {', '.join(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    return Cell(workload, w["chips"], config["model"], mix,
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)],
                limits)


def metric_module(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------------- a run
@dataclasses.dataclass
class Run:
    """What the metric readers read.  ``setup_s`` holds the process's
    start on the host clock until the window opens."""
    kind: str
    setup_s: float = 0.0
    window_s: float = 0.0
    tokens: int = 0
    requests: int = 0
    flops: float = 0.0
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    itl_s: List[float] = dataclasses.field(default_factory=list)
    #: the window's longest gaps, (seconds, arrival after the window's
    #: start), longest first
    longest_gaps: List[tuple] = dataclasses.field(default_factory=list)
    spans: Optional[Spans] = None
    trace: Optional[Trace] = None
    trace_steps: int = 0


@dataclasses.dataclass
class Checked:
    """What the check compares: each checked sequence's tokens, the
    positions whose logits served a token, the program's logits there
    (n, vocab) and the tokens the host got (n,)."""
    sequences: List[torch.Tensor] = dataclasses.field(default_factory=list)
    positions: List[torch.Tensor] = dataclasses.field(default_factory=list)
    logits: List[torch.Tensor] = dataclasses.field(default_factory=list)
    served: List[torch.Tensor] = dataclasses.field(default_factory=list)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Profile:
    """The traced stretch: the profiler on, the spans tagging calls."""

    def __init__(self, spans: Spans, device: torch.device):
        self.spans, self.device = spans, device
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.trace: Optional[Trace] = None

    def __enter__(self):
        self.spans.recording, self.spans.tagging = False, True
        _sync(self.device)
        self.prof.__enter__()
        self._window = torch.profiler.record_function("pb::window")
        self._window.__enter__()
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        self._window.__exit__(*exc)
        self.prof.__exit__(*exc)
        self.spans.tagging = False
        if exc[0] is None:
            self.trace = Trace(self.prof)
        return False


def _prefill_loop(cell: Cell, cfg, params, mix, seconds: float, spans,
                  device, run: Run, checked: Checked, steps):
    B = mix.batch
    gen = cell.traffic.get("gen_tokens", 1)
    kept = {}                     # batch -> program logits (B, vocab)

    def batch(j):
        tokens = mix.tokens(j, device)
        L = tokens.shape[1]
        step = steps.build_prefill_step(cfg, max_seq=L + gen,
                                        attn_impl="flash")
        t0 = time.perf_counter()
        logits, cache = step(params, {"tokens": tokens})
        first = torch.argmax(logits, -1).cpu()
        t1 = time.perf_counter()
        del cache
        return L, logits, first, t1 - t0

    for L in (min(mix.lengths), max(mix.lengths)):      # warm-up
        step = steps.build_prefill_step(cfg, max_seq=L + gen,
                                        attn_impl="flash")
        logits, _ = step(params, {"tokens": mix.warmup_tokens(L, device)})
        torch.argmax(logits, -1).cpu()
    _sync(device)
    run.setup_s = time.perf_counter() - run.setup_s
    if spans:
        spans.recording = True
    j, t0 = 0, time.perf_counter()
    end = t0
    while time.perf_counter() - t0 < seconds:
        L, logits, first, ttft = batch(j)
        end = time.perf_counter()
        kept[j] = (logits, first)
        run.ttft_s += [ttft] * B
        run.tokens += B * L
        run.requests += B
        run.flops += counts.prefill_flops(cell.model, B, L)
        j += 1
    run.window_s = end - t0
    done = list(kept)
    if spans:
        n = cell.traffic.get("trace_batches", 1)
        with _Profile(spans, device) as prof:
            for i in range(n):
                batch(j + i)
        run.trace, run.trace_steps = prof.trace, n
    for j, r in mix.check_sample(done, cell.limits["sample"]):
        logits, first = kept[j]
        seq = mix.tokens(j, device)[r]
        checked.sequences.append(seq)
        checked.positions.append(torch.tensor([seq.shape[0] - 1]))
        checked.logits.append(logits[r:r + 1, :cfg.vocab_size].float())
        checked.served.append(first[r:r + 1])


def _decode_loop(cell: Cell, cfg, params, mix, seconds: float, spans,
                 device, run: Run, checked: Checked, steps):
    """Session batches one after another: the first prefilled in set-up,
    each next one once the last has returned its last token (its prefill
    inside the window).  The window is ``seconds`` long from the last
    set-up token's arrival; what arrives in it counts: every token, every
    gap between consecutive tokens of a sequence."""
    B, P, G = mix.batch, mix.spec["prompt_len"], mix.spec["gen_tokens"]
    rows = torch.tensor([r for _, r in mix.check_sample(
        [0], cell.limits["sample"])],
                        device=device)
    prefill = steps.build_prefill_step(cfg, max_seq=P + G, attn_impl="flash")
    decode = steps.build_decode_step(cfg)
    kept_logits, served = [], []          # batch 0's checked rows, by step
    state = {}

    def start(k):
        state.pop("cache", None)          # the finished batch's cache
        logits, cache = prefill(params, {"tokens": mix.tokens(k, device)})
        tok = torch.argmax(logits, -1)
        host = tok.cpu()
        state.update(k=k, cache=cache, tok=tok, n=1, t=time.perf_counter())
        if k == 0:
            kept_logits.append(logits.index_select(0, rows))
            served.append(host)

    def step():
        """One decode step of every session, or the next session batch
        started where the last one finished: the gap between a sequence's
        tokens, or None for a batch's first token."""
        if state["n"] == G:
            start(state["k"] + 1)
            return None
        pos = torch.full((B,), P + state["n"] - 1, dtype=torch.int32,
                         device=device)
        logits, state["cache"] = decode(params, state["cache"],
                                        state["tok"][:, None], pos)
        tok = torch.argmax(logits, -1)
        if state["k"] == 0:
            kept_logits.append(logits.index_select(0, rows))
        host = tok.cpu()
        t = time.perf_counter()
        if state["k"] == 0:
            served.append(host)
        gap, state["t"] = t - state["t"], t
        state["tok"] = tok
        state["n"] += 1
        return gap

    start(0)
    for _ in range(cell.traffic.get("warmup_steps", 1)):
        step()
    _sync(device)
    run.setup_s = time.perf_counter() - run.setup_s
    if spans:
        spans.recording = True
    t0 = state["t"]
    deadline = t0 + seconds
    gaps = []
    while True:
        context = P + state["n"]
        gap = step()
        if state["t"] > deadline:
            break
        run.tokens += B
        if gap is not None:
            run.itl_s.append(gap)
            run.flops += counts.decode_flops(cell.model, [context] * B)
            gaps.append((gap, state["t"] - t0))
    run.window_s = seconds
    run.requests = B * (state["k"] + 1)
    run.longest_gaps = sorted(gaps, reverse=True)[:5]
    if spans:
        n = cell.traffic.get("trace_steps", 1)
        with _Profile(spans, device) as prof:
            for _ in range(n):
                step()
        run.trace, run.trace_steps = prof.trace, n
    prompts = mix.tokens(0, device)
    logits = torch.cat(kept_logits, 0).view(len(kept_logits), len(rows), -1)
    tokens = torch.stack(served, 0)                       # (n, B)
    n = tokens.shape[0]
    for i, r in enumerate(rows.tolist()):
        toks = tokens[:, r].to(device)
        checked.sequences.append(torch.cat([prompts[r], toks[:-1]]))
        checked.positions.append(torch.arange(P - 1, P - 1 + n))
        checked.logits.append(logits[:, i, :cfg.vocab_size].float())
        checked.served.append(tokens[:, r])
    state.clear()


# ----------------------------------------------------------------- compare
def compare(model: Dict, params: Dict, checked: Checked,
            quant: Optional[str] = None) -> Dict[str, float]:
    """The numbers the check compares, against the float32 reference:

    - ``logit_err``: the largest |program - reference| logit of any
      checked position, in units of that position's reference logits'
      root mean square;
    - ``logit_err_median`` and ``logit_err_mean``: the median and the
      mean over the checked positions of each position's largest error
      (a few positions whose MoE routes flipped on rounding do not move
      the median and move the mean a little; answers wrong at a share of
      the positions move the mean far);
    - ``token_gap``: the widest gap by which a served token's reference
      logit lies below the reference's best, in the same units.

    A cell's limits file names the numbers it compares.

    With ``quant`` the reference in that precision stands in the
    program's place (the control): its logits, and the tokens it puts
    first."""
    reference.no_tf32()
    truth = reference.logits(model, params, checked.sequences,
                             checked.positions)
    if quant:
        other = reference.logits(model, params, checked.sequences,
                                 checked.positions, quant=quant)
        served = [o.argmax(-1) for o in other]
    else:
        other, served = checked.logits, checked.served
    errs, gaps = [], []
    if not truth:
        return dict.fromkeys(("logit_err", "logit_err_median",
                              "logit_err_mean", "token_gap"), math.inf)
    for r, p, s in zip(truth, other, served):
        p = p.to(r.device)
        rms = r.pow(2).mean(-1).sqrt()
        errs.append((p - r).abs().amax(-1) / rms)
        got = r.gather(1, s.to(r.device).long()[:, None])[:, 0]
        gaps.append((r.amax(-1) - got) / rms)
    err, gap = torch.cat(errs), torch.cat(gaps)
    return {"logit_err": float(err.max()),
            "logit_err_median": float(err.median()),
            "logit_err_mean": float(err.mean()),
            "token_gap": float(gap.max())}


def judge(numbers: Dict[str, float], limits: Dict) -> bool:
    """Every number a cell compares within its limit (``limits`` is the
    limits file's ``numbers``)."""
    return bool(limits) and all(
        math.isfinite(numbers[k]) and numbers[k] <= v["limit"]
        for k, v in limits.items())


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


# --------------------------------------------------------------------- run
def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        started: float, quant: Optional[str] = None):
    """One run of ``cell``; returns (result, run, checked, params, numbers).
    ``started`` is the host clock at the process's start.  ``quant`` adds
    the control's numbers (``numbers["control"]``)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ModelConfig
    from repro_torch.runtime import steps

    device = torch.device(device)
    run_ = Run(kind=cell.traffic["kind"], setup_s=started)
    compile_s = 0.0
    marks = {"imports": time.perf_counter() - started}
    if device.type == "cuda":
        from repro_torch.kernels import _build, flash_attention
        torch.cuda.init()
        marks["cuda_init"] = time.perf_counter() - started
        compile_s = sum(s for _, s in _build.build(*flash_attention.SOURCES))
        marks["kernels_built"] = time.perf_counter() - started
    cfg = ModelConfig(**cell.model)
    params = weights.make(T.param_layout(cfg), traffic_mod.derive(seed, 3),
                          device, lambda path: path[-1] in T.FP32_KEYS)
    _sync(device)
    marks["weights"] = time.perf_counter() - started
    mix = traffic_mod.Traffic(cell.traffic, seed, cfg.vocab_size)
    spans = None
    if trace:
        spans = Spans()
        for m in cell.per_layer:
            for name, target in getattr(metric_module(m["name"]), "SPANS",
                                        {}).items():
                fn, hook = target if isinstance(target, tuple) else (target,
                                                                     None)
                spans.wrap(name, fn, hook)
        spans.recording = False
    run_.spans = spans
    checked = Checked()
    loop = _prefill_loop if run_.kind == "prefill" else _decode_loop
    try:
        with torch.inference_mode():
            loop(cell, cfg, params, mix, seconds, spans, device, run_,
                 checked, steps)
    finally:
        if spans:
            spans.unwrap()
    _sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    alloc_retries = (torch.cuda.memory_stats(device).get(
        "num_alloc_retries", 0) if device.type == "cuda" else 0)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = compare(cell.model, params, checked)
    if quant:
        numbers["control"] = compare(cell.model, params, checked, quant)
    check_s = time.perf_counter() - t_check
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_module(m["name"]).read(run_)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": judge(numbers, cell.limits["numbers"]),
              "attempted": run_.requests, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace and run_.trace is not None:
        dev["busy_s"] = run_.trace.busy_s
        dev["window_s"] = run_.trace.window_s
        result["breakdown"] = {"device_ops": run_.trace.top_device_ops(),
                               "idle_gaps": run_.trace.idle_gaps()}
        result["trace_unlinked_ops"] = run_.trace.unlinked
    result["setup_s"] = run_.setup_s
    result["setup_marks_s"] = marks
    result["compile_s"] = compile_s
    result["check_s"] = check_s
    result["window"] = {"seconds": run_.window_s, "tokens": run_.tokens,
                        "requests": run_.requests,
                        "longest_gaps_s": run_.longest_gaps,
                        "alloc_retries": alloc_retries,
                        "checked_positions": sum(len(p) for p in
                                                 checked.positions)}
    result["checks"] = {k: {"value": numbers[k], "limit": v["limit"]}
                        for k, v in cell.limits["numbers"].items()}
    return result, run_, checked, params, numbers


def power_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"
