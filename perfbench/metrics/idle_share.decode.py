"""The share of the traced stretch of decode steps in which no operation
ran on the device: 1 minus the union of device operation intervals over
the stretch's length."""

LAYER = "Device"
MOVES = "itl_ms_p95"


def read(run):
    tr = run.trace
    if run.kind != "decode" or tr is None or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
