"""Model FLOPs of the window's prefills (``counts.prefill_flops``: 2 x
the active matrix parameters a prompt token, the unembedding once a
prompt, attention's visible pairs) over the window's seconds, as a share
of the card's 989 TFLOP/s bf16 peak."""

from perfbench.counts import PEAKS

LAYER = "Model step (models/transformer.py)"
MOVES = "prefill_tokens_per_s"


def read(run):
    if run.kind != "prefill" or not run.window_s:
        return None
    return 100.0 * run.flops / run.window_s / PEAKS["bf16_flop_per_s"]
