"""``decode_attn_device_ms`` over the port's own span
``model::decode_attention`` (``layers.decode_attention``) in place of
the benchmark's wrapper around the same function: device milliseconds a
traced decode step of the operations launched inside it."""

from perfbench import program_trace

LAYER = "Model layers (models/layers.py, models/ssd.py)"
MOVES = "itl_ms_p95"
program_trace.install()


def read(run):
    tr = run.trace
    if run.kind != "decode" or not hasattr(tr, "program_span_device_s") \
            or not run.trace_steps:
        return None
    ms = tr.program_span_device_s.get("decode_attention", 0.0)
    if not ms:
        return None
    return 1e3 * ms / run.trace_steps
