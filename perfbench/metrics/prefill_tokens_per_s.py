"""Prompt tokens prefilled in the window over the window's seconds (host
clock: from the first batch's start to the last batch's first tokens on
the host)."""

LAYER = "Benchmark run"
MOVES = "prefill_tokens_per_s"


def read(run):
    if run.kind != "prefill" or not run.window_s:
        return None
    return run.tokens / run.window_s
