"""Host milliseconds of a decode step, from the call of the port's
``models.transformer.decode_step`` until it returns (before the token is
taken to the host): the mean over the window's steps."""

LAYER = "Serving loop (runtime/steps.py, the loop of launch/serve.py)"
MOVES = "itl_ms_p95"
SPANS = {"decode_step": "repro_torch.models.transformer:decode_step"}


def read(run):
    times = run.spans.host_s.get("decode_step") if run.spans else None
    if run.kind != "decode" or not times:
        return None
    return 1e3 * sum(times) / len(times)
