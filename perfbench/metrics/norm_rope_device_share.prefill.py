"""Device time of the operations launched inside the port's own spans
``model::rms_norm`` and ``model::rope`` (``layers.rms_norm``, the gated
norm of the SSD block among its callers, and ``layers.apply_rope``) as
a share of all device time, in the traced stretch of prefills.  The two
spans never nest in each other."""

from perfbench import program_trace

LAYER = "Model layers (models/layers.py, models/ssd.py)"
MOVES = "prefill_tokens_per_s"
program_trace.install()


def read(run):
    tr = run.trace
    if run.kind != "prefill" or not hasattr(tr, "program_span_device_s") \
            or not tr.device_s:
        return None
    s = sum(tr.program_span_device_s.get(n, 0.0) for n in ("rms_norm", "rope"))
    if not s:
        return None
    return 100.0 * s / tr.device_s
