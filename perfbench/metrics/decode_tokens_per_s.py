"""Generated tokens returned to the host in the window over the window's
seconds (host clock: the window runs ``--seconds`` from the last set-up
token's arrival; a session batch's first tokens, from its prefill inside
the window, count with the rest)."""

LAYER = "Benchmark run"
MOVES = "decode_tokens_per_s"


def read(run):
    if run.kind != "decode" or not run.window_s:
        return None
    return run.tokens / run.window_s
