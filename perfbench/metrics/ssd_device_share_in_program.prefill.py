"""``ssd_device_share.prefill`` over the port's own span
``model::ssd_layer`` (``ssd.ssd_layer``) in place of the benchmark's
wrapper around the same function: the device time of the operations
launched inside it as a share of all device time, in the traced stretch
of prefills."""

from perfbench import program_trace

LAYER = "Model layers (models/layers.py, models/ssd.py)"
MOVES = "prefill_tokens_per_s"
program_trace.install()


def read(run):
    tr = run.trace
    if run.kind != "prefill" or not hasattr(tr, "program_span_device_s") \
            or not tr.device_s:
        return None
    ssd = tr.program_span_device_s.get("ssd_layer", 0.0)
    if not ssd:
        return None
    return 100.0 * ssd / tr.device_s
