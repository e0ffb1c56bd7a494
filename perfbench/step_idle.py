"""The decode cell's device idle inside a step, untraced, from CUDA events.

    python3 perfbench/step_idle.py --workload granite-8b.decode-longctx \
        --seed <n> --seconds <s> [--every 4] [--sleep-ms 400]

From the root of a checkout, on a card.  Runs the cell's window as
``run.py`` does, with no profiler, and times each call of
``transformer.decode_step`` with device events that the host records at
the call's entry and at its return:

- a plain step gives ``step_ms``, entry to return on the device.  The
  loop copies each step's tokens to the host, so the device has drained
  when the host enters the next step and the entry event passes at once:
  ``step_ms`` is the step's device work and whatever time the device
  waited for the host's launches;
- every ``--every``-th step follows a device sleep longer than the host
  takes to launch a step, so the device reaches the entry event with the
  whole step queued behind it: entry to return is the step's device work
  alone (``work_ms``).

The difference of the two medians is the device's idle inside a step,
untraced (``idle_in_step_ms``).  ``between_ms`` is the device time from
a plain step's return to the next plain step's entry: the token copy,
the loop's host work, a session batch's prefill where one starts.
``host_ms`` is the host's time inside a plain step.  A slept step whose
host time reaches the sleep's was held inside the step (``blocked``
counts them): by a host synchronisation, or by CUDA's launch queue,
which holds about a thousand launches.  Past that point the host
launches as the device frees the queue, so ``work_ms`` also holds any
device idle that follows, and ``idle_in_step_ms`` is a lower bound.
Prints one JSON line.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


class StepTimer:
    """Device events around each call of a wrapped function; a call
    whose index is ``every - 1`` modulo ``every`` runs after
    ``sleep()``."""

    def __init__(self, every: int, event: Callable, sleep: Callable,
                 sleep_ms: float):
        self.every, self.event, self.sleep = every, event, sleep
        self.sleep_ms = sleep_ms
        self.steps: List[tuple] = []    # (slept, entry, return, host s)

    def wrap(self, fn: Callable) -> Callable:
        def timed(*args, **kwargs):
            slept = len(self.steps) % self.every == self.every - 1
            if slept:
                self.sleep()
            entry, done = self.event(), self.event()
            entry.record()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            host = time.perf_counter() - t
            done.record()
            self.steps.append((slept, entry, done, host))
            return out
        return timed

    @contextlib.contextmanager
    def around(self, module, name: str):
        """Time ``module.name`` inside the block."""
        fn = getattr(module, name)
        setattr(module, name, self.wrap(fn))
        try:
            yield self
        finally:
            setattr(module, name, fn)

    def summary(self, skip: int) -> Dict[str, Optional[float]]:
        """Medians over the calls after the first ``skip`` (the events
        must have passed on the device)."""
        step, work, host, between = [], [], [], []
        blocked = 0
        prev = None
        for slept, entry, done, host_s in self.steps[skip:]:
            if slept:
                work.append(entry.elapsed_time(done))
                blocked += host_s * 1e3 >= self.sleep_ms
            else:
                step.append(entry.elapsed_time(done))
                host.append(host_s * 1e3)
                if prev is not None:
                    between.append(prev.elapsed_time(entry))
            prev = None if slept else done

        def med(xs):
            return statistics.median(xs) if xs else None

        out = {"steps": len(step), "slept_steps": len(work),
               "blocked": blocked, "step_ms": med(step),
               "work_ms": med(work), "host_ms": med(host),
               "between_ms": med(between)}
        out["idle_in_step_ms"] = (out["step_ms"] - out["work_ms"]
                                  if step and work else None)
        return out


def cuda_sleep(sleep_ms: float) -> Callable[[], None]:
    """A device sleep of about ``sleep_ms``, its cycles calibrated once."""
    import torch
    cycles = 10 ** 7
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    b.synchronize()
    cycles = int(cycles * sleep_ms / a.elapsed_time(b))
    return lambda: torch.cuda._sleep(cycles)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--every", type=int, default=4)
    ap.add_argument("--sleep-ms", type=float, default=400.0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import run as bench_run
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(bench_run.CACHE / sub)
    import torch
    from perfbench import harness
    from repro_torch.models import transformer

    cell = harness.load_cell(ROOT, args.workload)
    if cell.traffic["kind"] != "decode" or not torch.cuda.is_available():
        print("step_idle: needs a decode cell and a CUDA card",
              file=sys.stderr)
        return 2
    torch.cuda.init()
    timer = StepTimer(args.every,
                      lambda: torch.cuda.Event(enable_timing=True),
                      cuda_sleep(args.sleep_ms), args.sleep_ms)
    with timer.around(transformer, "decode_step"):
        result, *_ = harness.run(cell, args.seed, args.seconds, False,
                                 "cuda:0", STARTED)
    torch.cuda.synchronize()
    # the set-up's warm-up steps and the first window step
    skip = cell.traffic.get("warmup_steps", 1) + 1
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "correct": result["correct"],
                      "metrics": {k: v["value"] for k, v in
                                  result["metrics"].items()},
                      **timer.summary(skip), "card": harness.power_line()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
