"""``attn_kernel_roofline.prefill`` over the device time of the
operations launched inside the port's own span ``model::attention_core``
(``layers.attention_core``) in place of the benchmark's wrapper around
the same function; the least time of each call is counted as there,
from the wrapper's call records."""

from perfbench import counts, harness, program_trace

LAYER = ("Attention kernels (kernels/flash_attention.py, "
         "csrc/flash_attention*.cu)")
MOVES = "prefill_tokens_per_s"
SPANS = harness.metric_module("attn_kernel_roofline.prefill").SPANS
program_trace.install()


def read(run):
    tr = run.trace
    if run.kind != "prefill" or not hasattr(tr, "program_span_device_s") \
            or not run.spans:
        return None
    device = tr.program_span_device_s.get("attention_core", 0.0)
    calls = run.spans.calls.get("attention_core", [])
    if not device or not calls:
        return None
    return 100.0 * sum(counts.roofline_s(f, b) for f, b in calls) / device
