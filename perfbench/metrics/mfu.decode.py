"""Model FLOPs of the window's decode steps (``counts.decode_flops``: 2 x
the active matrix parameters and the unembedding a token, attention over
each sequence's context) over the window's seconds, as a share of the
card's 989 TFLOP/s bf16 peak."""

from perfbench.counts import PEAKS

LAYER = "Model step (models/transformer.py)"
MOVES = "decode_tokens_per_s"


def read(run):
    if run.kind != "decode" or not run.window_s:
        return None
    return 100.0 * run.flops / run.window_s / PEAKS["bf16_flop_per_s"]
