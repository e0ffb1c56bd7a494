"""Device time of the operations launched inside the port's own span
``model::moe_layer`` (``layers.moe_layer``: the router, the dispatch
into capacity buffers, the expert products and the combine) as a share
of all device time, in the traced stretch of prefills."""

from perfbench import program_trace

LAYER = "Model layers (models/layers.py, models/ssd.py)"
MOVES = "prefill_tokens_per_s"
program_trace.install()


def read(run):
    tr = run.trace
    if run.kind != "prefill" or not hasattr(tr, "program_span_device_s") \
            or not tr.device_s:
        return None
    moe = tr.program_span_device_s.get("moe_layer", 0.0)
    if not moe:
        return None
    return 100.0 * moe / tr.device_s
