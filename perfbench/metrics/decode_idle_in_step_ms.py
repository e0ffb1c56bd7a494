"""Milliseconds a decode step in which the device ran nothing while the
host was inside the port's own span ``model::decode_step``
(``transformer.decode_step``, launching a step's work), as against the
loop's token copy between steps.  The mean over the traced stretch's
decode steps.  The profiler's own per-operation host cost lengthens the
traced step's host time, so this reads the idle of a traced step: an
upper bound on the untraced one, which ``perfbench/step_idle.py`` times
with CUDA events instead."""

from perfbench import program_trace

LAYER = "Model step (models/transformer.py)"
MOVES = "itl_ms_p95"
program_trace.install()


def read(run):
    tr = run.trace
    steps = getattr(tr, "program_spans", {}).get("decode_step")
    if run.kind != "decode" or not steps:
        return None
    return 1e3 * tr.idle_within("decode_step") / len(steps)
