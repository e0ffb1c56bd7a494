"""Device time of the operations launched inside the port's
``models.ssd.ssd_layer`` as a share of all device time, in the traced
stretch of prefills."""

LAYER = "Model layers (models/layers.py, models/ssd.py)"
MOVES = "prefill_tokens_per_s"
SPANS = {"ssd_layer": "repro_torch.models.ssd:ssd_layer"}


def read(run):
    tr = run.trace
    if run.kind != "prefill" or tr is None or not tr.device_s:
        return None
    ssd = tr.span_device_s.get("ssd_layer", 0.0)
    if not ssd:
        return None
    return 100.0 * ssd / tr.device_s
