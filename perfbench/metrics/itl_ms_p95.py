"""95th percentile of every gap between consecutive tokens of a sequence
that arrived in the window, in milliseconds (host clock, each gap from
the arrival of a sequence's token on the host to that of its next)."""

from perfbench.traffic import p95

LAYER = "Benchmark run"
MOVES = "itl_ms_p95"


def read(run):
    if run.kind != "decode" or not run.itl_s:
        return None
    return 1e3 * p95(run.itl_s)
