"""Port parity at the regimes the dense serving phases of ``chip_smoke.py``
run on the card at full width (gemma2-9b and qwen2.5-14b), on the CPU at
a small size:

- gemma2-9b's smoke model at its own head_dim of 224 (2 q heads, 1 kv
  head; the wgmma kernel pads it to 256), a sliding window of 16 on its
  local layers, its attention softcap (50) and logit softcap (30), gelu
  and tied, scaled embeddings: a 40-token prefill, whose window masks
  the early keys of the last queries and whose local layers keep the
  last 16 positions in a ring, then 12 decode steps, the ring's writes
  wrapping to slot 0 at position 48;
- qwen2.5-14b's smoke model at GQA 5:1 (10 q heads, 2 kv heads; its
  full width has 40:8) with nonzero QKV biases: the same 40-token
  prefill and 12 decode steps on a full cache.

Both packages take the same seeded numpy weights in the reference's
layout (biases and norms drawn nonzero, so they count) and the same
tokens; the decode steps are fed the next prompt token, not a greedy
choice.  The reference prefills through its Pallas kernel in interpret
mode, the port through ``flash`` (its kernel's plain version on the
CPU).  Held: the prefill's last logits, every decode step's logits and
the caches after the prefill and after the last step, in bf16 within
0.1 (the dense model tests' bound, ``tests/test_torch_models.py``) and
in float32 (``COMPUTE_DTYPE`` patched in both packages) within 1e-4
(the families' float32 bound between the packages).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                   # noqa: E402

from repro import configs as RC                           # noqa: E402
from repro.models import transformer as RT                # noqa: E402
from repro_torch import configs as PC                     # noqa: E402
from repro_torch.models import transformer as PT          # noqa: E402
from test_torch_moe import ref_weights                    # noqa: E402

#: the smoke configs at the full models' attention regimes
SHAPES = {"gemma2-9b": dict(n_heads=2, n_kv_heads=1, head_dim=224,
                            sliding_window=16),
          "qwen2.5-14b": dict(n_heads=10, n_kv_heads=2, head_dim=16)}
B, PROMPT, STEPS = 2, 40, 12
TOL = {"bfloat16": 0.1, "float32": 1e-4}


def configs(arch):
    kw = SHAPES[arch]
    return RC.get_smoke(arch).replace(**kw), PC.get_smoke(arch).replace(**kw)


def test_the_regimes_are_the_full_models():
    """The smoke shapes keep what the full models bring: gemma2's
    head_dim 224 with both softcaps and alternating windows, qwen2.5's
    q heads a kv head that are no power of two, and its QKV bias."""
    full = PC.get_config("gemma2-9b")
    assert full.resolved_head_dim == configs("gemma2-9b")[1].\
        resolved_head_dim == 224
    gemma = configs("gemma2-9b")[1]
    assert (gemma.attn_softcap, gemma.logit_softcap) == \
        (full.attn_softcap, full.logit_softcap) == (50.0, 30.0)
    assert [gemma.layer_window(i) for i in range(2)] == [16, 0]
    assert [full.layer_window(i) for i in range(2)] == [4096, 0]
    qwen, qfull = configs("qwen2.5-14b")[1], PC.get_config("qwen2.5-14b")
    assert qwen.n_heads // qwen.n_kv_heads == \
        qfull.n_heads // qfull.n_kv_heads == 5
    assert qwen.qkv_bias and qfull.qkv_bias


def ref_cache(cache, cfg, l, key):
    body, slot = divmod(l, cfg.scan_period)
    return cache[f"slot{slot}"][key][body]


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", list(SHAPES))
def test_prefill_then_decode_across_the_ring(arch, compute, monkeypatch):
    cfg_r, cfg_p = configs(arch)
    if compute == "float32":
        monkeypatch.setattr(RT, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(PT, "COMPUTE_DTYPE", torch.float32)
    params = ref_weights(cfg_r, 7, zero_std="random")
    port = PT.params_from_jax(params, device="cpu", dtype=PT.COMPUTE_DTYPE)
    tokens = np.random.RandomState(7).randint(
        0, cfg_r.vocab_size, (B, PROMPT + STEPS)).astype(np.int32)
    t = torch.from_numpy(tokens.astype(np.int64))
    max_seq = PROMPT + STEPS
    tol = TOL[compute]
    worst = {}

    def hold(name, got, want):
        err = float(np.abs(got.detach().float().numpy()
                           - np.asarray(want, np.float32)).max())
        worst[name] = err
        assert err <= tol, (name, err)

    r_last, r_cache = RT.prefill(params, cfg_r,
                                 jnp.asarray(tokens[:, :PROMPT]),
                                 max_seq=max_seq, impl="pallas")
    p_last, p_cache = PT.prefill(port, cfg_p, t[:, :PROMPT], max_seq=max_seq,
                                 impl="flash")
    hold("prefill", p_last, r_last)
    windows = [cfg_p.layer_window(l % cfg_p.scan_period)
               for l in range(cfg_p.n_layers)]
    for l, layer in enumerate(p_cache):
        want_slots = min(max_seq, windows[l]) if windows[l] else max_seq
        assert layer["k"].shape[1] == want_slots
        hold(f"prefill cache {l}", layer["k"], ref_cache(r_cache, cfg_p, l,
                                                         "k"))
    for i in range(STEPS):
        pos = np.full((B,), PROMPT + i, np.int32)
        tok = tokens[:, PROMPT + i:PROMPT + i + 1]
        r_step, r_cache = RT.decode_step(params, cfg_r, jnp.asarray(tok),
                                         r_cache, jnp.asarray(pos))
        p_step, p_cache = PT.decode_step(port, cfg_p, t[:, PROMPT + i:
                                                        PROMPT + i + 1],
                                         p_cache, torch.from_numpy(pos))
        hold(f"decode {PROMPT + i}", p_step, r_step)
    for l, layer in enumerate(p_cache):
        for key in ("k", "v"):
            hold(f"final cache {l} {key}", layer[key],
                 ref_cache(r_cache, cfg_p, l, key))
    print(f"{arch} {compute}: worst |diff| {max(worst.values()):.3g} "
          f"({max(worst, key=worst.get)}; bound {tol})")
