"""95th percentile, over every prompt completed in the window, of the
milliseconds from its batch's start to its first token on the host."""

from perfbench.traffic import p95

LAYER = "Benchmark run"
MOVES = "ttft_ms_p95"


def read(run):
    if run.kind != "prefill" or not run.ttft_s:
        return None
    return 1e3 * p95(run.ttft_s)
