"""The readings the check's limits are set from, on the card, at a cell's
own size: the program's numbers on many seeds, and the control's (the
reference in float8 put in the program's place) on some of them.

    python3 perfbench/control.py --workload <name> --seconds <s> \
        --seeds 11,12,... --control-seeds 11,12,13

One process runs every seed (each with its own weights and traffic,
drawn from that seed) through the same window and check as
``perfbench/run.py``, and prints one JSON line a seed: the program's
numbers and, for a control seed, the control's on the same prompts and
tokens.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from perfbench import harness

    if not torch.cuda.is_available():
        print("perfbench: no CUDA device is available", file=sys.stderr)
        return 3
    cell = harness.load_cell(ROOT, args.workload)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        result, _run, _checked, _params, numbers = harness.run(
            cell, seed, args.seconds, False, "cuda:0", t,
            quant="fp8" if seed in control else None)
        del _run, _checked, _params
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "numbers": numbers,
                          "correct": result["correct"],
                          "window": result["window"],
                          "check_s": result["check_s"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
