"""The share of the MoE capacity slots the expert products compute that
hold a routed token, over the traced stretch of prefills: the port's own
counters (``repro_torch.obs.spans``), kept (token, k) slots over the
experts x batch rows x capacity slots of every ``layers.moe_layer``
call.  At most K / (E x capacity per token) of it: 80 % at top-2 of 16
experts and capacity factor 1.25, less the dropped share."""

from perfbench import program_trace

LAYER = "Model layers (models/layers.py, models/ssd.py)"
MOVES = "prefill_tokens_per_s"
program_trace.install()


def read(run):
    slots = getattr(run.trace, "moe_slots", None)
    if run.kind != "prefill" or not slots or not slots["capacity"]:
        return None
    return 100.0 * slots["kept"] / slots["capacity"]
