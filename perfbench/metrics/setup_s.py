"""Set-up seconds: from the process's start to the window's, host clock:
imports, the kernels' build (only where none is built yet), the weights,
the warm-up of every shape the mix uses, and the cache the traffic needs
(a decode mix's first prefill)."""

LAYER = "Benchmark run"
MOVES = "setup_s"


def read(run):
    return run.setup_s
