"""Run one cell of the benchmark of the PyTorch/CUDA port (``repro_torch``).

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Prints, as the last line of standard
output, one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``; with ``--trace 1`` also ``breakdown``; the
numbers compared with their limits last, under ``checks``), and the same
numbers compared as the last lines of standard error.  Exits non-zero,
printing no result, without a CUDA card (or with fewer than the cell
asks for), without the program's sources beside the benchmark, or when
JAX or the JAX package is loaded in the process.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: build and kernel caches of the program, inside the checkout, at fixed
#: paths (the port's nvcc libraries already go to
#: src/repro_torch/kernels/build/)
CACHE = ROOT / ".bench_cache"


def fail(code: int, message: str) -> int:
    print(f"perfbench: {message}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail(2, f"the program (src/repro_torch) is not in {ROOT}")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from perfbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        return fail(3, "no CUDA device is available")
    if torch.cuda.device_count() < cell.chips:
        return fail(3, f"{args.workload} needs {cell.chips} cards, "
                       f"{torch.cuda.device_count()} found")
    result, *_ = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                             "cuda:0", STARTED)
    found = harness.forbidden_modules()        # the window has closed
    if found:
        return fail(4, "loaded in the result's process: " + ", ".join(found))
    checks = result.pop("checks")
    result["card"] = harness.power_line()
    result["checks"] = checks
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
