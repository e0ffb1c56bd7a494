"""Device milliseconds a decode step of the operations launched inside
the port's ``models.layers.decode_attention``, in the traced stretch."""

LAYER = "Model layers (models/layers.py, models/ssd.py)"
MOVES = "itl_ms_p95"
SPANS = {"decode_attention": "repro_torch.models.layers:decode_attention"}


def read(run):
    tr = run.trace
    if run.kind != "decode" or tr is None or not run.trace_steps:
        return None
    ms = tr.span_device_s.get("decode_attention", 0.0)
    if not ms:
        return None
    return 1e3 * ms / run.trace_steps
