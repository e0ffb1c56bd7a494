"""The attention kernels' share of their roofline in the traced stretch
of prefills: for every call of the port's ``models.layers.attention_core``
the least time the card could take (the larger of its FLOPs at the bf16
peak and its bytes at HBM's rate, ``counts.attention_call`` from the
q/k/v shapes, the mask and the window), summed, over the device time of
the operations launched inside those calls."""

from perfbench import counts

LAYER = ("Attention kernels (kernels/flash_attention.py, "
         "csrc/flash_attention*.cu)")
MOVES = "prefill_tokens_per_s"


def on_call(q, k, v, q_pos=None, k_pos=None, impl="naive", causal=True,
            window=0, **_):
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    return counts.attention_call(B, Sq, Sk, H, KV, D, bool(causal),
                                 int(window or 0), q.element_size())


SPANS = {"attention_core": ("repro_torch.models.layers:attention_core",
                            on_call)}


def read(run):
    tr = run.trace
    if run.kind != "prefill" or tr is None or not run.spans:
        return None
    device = tr.span_device_s.get("attention_core", 0.0)
    calls = run.spans.calls.get("attention_core", [])
    if not device or not calls:
        return None
    return 100.0 * sum(counts.roofline_s(f, b) for f, b in calls) / device
