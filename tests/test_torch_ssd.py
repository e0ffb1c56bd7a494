"""Port parity, the SSD family and the hybrid: ``repro_torch.models.ssd``,
``layers.rms_norm_gated`` and the mamba2 and jamba models against
``repro.models``.

- float32, the same seeded numpy weights and inputs on both sides:
  ``rms_norm_gated``, ``_causal_conv`` with and without a cache,
  ``ssd_scan`` (S a multiple of the chunk or not, with and without an
  initial state, and at a chunk of 32 with decays up to ``exp(-8 dt)``,
  where the reference's masked exponentials overflow to inf),
  ``ssd_layer`` with its returned cache and ``ssd_decode``, within 1e-5;
  ``ssd_scan`` also against the sequential per-token recurrence of
  ``tests/test_sharding.py::test_ssd_scan_matches_sequential_reference``
  (copied here, with its tolerance of 2e-3).
- mamba2-780m's smoke model in bf16: ``forward``, ``loss_fn``,
  ``prefill`` and three ``decode_step``s within 0.1, as the MoE models
  (tests/test_torch_moe.py); its ``loss_fn`` gradients against
  ``jax.grad`` in float32 within 1e-4, all finite.
- jamba-v0.1-52b's smoke model, the hybrid (SSD layers, attention at
  index 4 of 8, MoE on odd layers), is held whole in float32 and, in
  bf16, whole against the reference run op by op
  (tests/test_torch_moe.py: within 0.1 everywhere, caches and decode
  included, no route flipped) and layer by layer against its compiled
  run: each of its 8 layers from the reference's input, and the logits
  from the reference's last hidden state, within 0.1 at the tokens
  whose route agreed.  Whole, against the compiled run, the bf16 logits
  drift past 0.1, and so does the reference against itself: its
  compiled run (``lax.scan`` compiles each layer; XLA keeps excess
  precision across the operations it fuses) and its op-by-op run differ
  past 0.1 on the same weights and tokens, which
  ``test_jamba_reference_drifts_between_its_own_runs`` measures.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                # noqa: E402
import jax.numpy as jnp                                   # noqa: E402

from repro import configs as RC                           # noqa: E402
from repro.models import layers as RL                     # noqa: E402
from repro.models import ssd as RS                        # noqa: E402
from repro.models import transformer as RT                # noqa: E402
from repro_torch import configs as PC                     # noqa: E402
from repro_torch.models import layers as PL               # noqa: E402
from repro_torch.models import ssd as PS                  # noqa: E402
from repro_torch.models import transformer as PT          # noqa: E402
from test_torch_moe import (MODEL_ATOL, Routes, check_gradients,  # noqa: E402
                            check_model_bf16, close, model_pair,
                            silu_rounded_once, slot_weights, to_port)

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
B = 2


def both(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def randn(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def ssd_weights(cfg, rng):
    w = slot_weights(RS.ssd_params_layout(cfg), rng)
    w["A_log"] = np.log(np.linspace(1.0, 8.0, cfg.ssm_heads,
                                    dtype=np.float32))
    return w


def test_rms_norm_gated():
    rng = np.random.default_rng(0)
    (rx, px), (rz, pz) = both(randn(rng, 2, 5, 64)), both(randn(rng, 2, 5, 64))
    rw, pw = both(randn(rng, 64) * 0.1)
    close(PL.rms_norm_gated(px, pz, pw, 1e-6),
          RL.rms_norm_gated(rx, rz, rw, 1e-6), **LAYER_TOL)


@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv(with_cache):
    rng = np.random.default_rng(1)
    rx, px = both(randn(rng, 2, 9, 12))
    rw, pw = both(randn(rng, 12, 4) * 0.5)
    rb, pb = both(randn(rng, 12) * 0.1)
    rc, pc = both(randn(rng, 2, 3, 12)) if with_cache else (None, None)
    ry, rcache = RS._causal_conv(rx, rw, rb, rc)
    py, pcache = PS._causal_conv(px, pw, pb, pc)
    close(py, ry, **LAYER_TOL)
    close(pcache, rcache, rtol=0, atol=0)


def scan_inputs(seed, B_, S_, H, P, G, N, a_max=None):
    rng = np.random.default_rng(seed)
    xh = randn(rng, B_, S_, H, P)
    dt = np.log1p(np.exp(randn(rng, B_, S_, H)))
    if a_max is None:
        A = -np.exp(randn(rng, H) * 0.3)
    else:
        A = -np.linspace(1.0, a_max, H, dtype=np.float32)
    return xh, dt.astype(np.float32), A.astype(np.float32), \
        randn(rng, B_, S_, G, N), randn(rng, B_, S_, G, N)


@pytest.mark.parametrize("S_,chunk,init", [(24, 8, False), (21, 8, False),
                                           (21, 8, True), (5, 8, True),
                                           (40, 32, False)])
def test_ssd_scan_matches_reference(S_, chunk, init):
    H, P, G, N = 4, 8, 2, 6
    a_max = 8.0 if chunk == 32 else None
    args = scan_inputs(S_ + chunk, B, S_, H, P, G, N, a_max)
    state = randn(np.random.default_rng(2), B, H, P, N) if init else None
    ref_args = [jnp.asarray(a) for a in args]
    port_args = [torch.from_numpy(a.copy()) for a in args]
    ry, rfin = RS.ssd_scan(*ref_args, chunk,
                           None if state is None else jnp.asarray(state))
    py, pfin = PS.ssd_scan(*port_args, chunk, None if state is None
                           else torch.from_numpy(state.copy()))
    assert bool(torch.isfinite(py).all() and torch.isfinite(pfin).all())
    close(py, ry, **LAYER_TOL)
    close(pfin, rfin, **LAYER_TOL)


def test_ssd_scan_matches_sequential_reference():
    """Chunked SSD == naive per-token recurrence (the oracle of
    tests/test_sharding.py, in float64 numpy)."""
    Bx, S_, H, P, G, N = 2, 24, 4, 8, 2, 6
    xh, dt, A, Bm, Cm = scan_inputs(11, Bx, S_, H, P, G, N)
    y, fin = PS.ssd_scan(*(torch.from_numpy(a.copy())
                           for a in (xh, dt, A, Bm, Cm)), chunk=8)
    hpg = H // G
    state = np.zeros((Bx, H, P, N))
    ys = np.zeros((Bx, S_, H, P))
    for t in range(S_):
        for b in range(Bx):
            for h in range(H):
                g = h // hpg
                a = np.exp(float(dt[b, t, h]) * float(A[h]))
                state[b, h] = state[b, h] * a + float(dt[b, t, h]) * \
                    np.outer(xh[b, t, h], Bm[b, t, g])
                ys[b, t, h] = state[b, h] @ Cm[b, t, g]
    np.testing.assert_allclose(y.numpy(), ys, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(fin.numpy(), state, rtol=2e-3, atol=2e-3)


def test_ssd_scan_gradient_is_finite_at_a_full_chunk():
    """The port takes the decay's exponential only where it is used, so
    its backward pass stays finite at a full chunk (256, A down to -8),
    where the reference's masked half overflows to inf and its gradient
    with respect to dt is NaN (0 * inf: a caveat of the reference,
    ROADMAP.md)."""
    inputs = scan_inputs(5, 1, 256, 4, 8, 1, 6, a_max=8.0)
    args = [torch.from_numpy(a.copy()) for a in inputs]
    for a in args:
        a.requires_grad_(True)
    y, fin = PS.ssd_scan(*args, 256)
    (y.sum() + fin.sum()).backward()
    assert all(bool(torch.isfinite(a.grad).all()) for a in args)

    def ref_total(xh, dt):
        ry, rfin = RS.ssd_scan(xh, dt, *map(jnp.asarray, inputs[2:]), 256)
        return ry.sum() + rfin.sum()

    r_dxh, r_ddt = jax.grad(ref_total, argnums=(0, 1))(
        *map(jnp.asarray, inputs[:2]))
    assert bool(jnp.isfinite(r_dxh).all()) and bool(jnp.isnan(r_ddt).any())
    close(args[0].grad, r_dxh, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-v0.1-52b"])
def test_ssd_layer_and_decode_match(arch):
    cfg_r, cfg_p = RC.get_smoke(arch), PC.get_smoke(arch)
    rng = np.random.default_rng(len(arch))
    w = ssd_weights(cfg_r, rng)
    rw, pw = jax.tree.map(jnp.asarray, w), to_port(w)
    rx, px = both(randn(rng, B, 13, cfg_r.d_model))
    close(PS.ssd_layer(pw, px, cfg_p), RS.ssd_layer(rw, rx, cfg_r),
          **LAYER_TOL)
    r_out, r_cache = RS.ssd_layer(rw, rx, cfg_r, return_cache=True)
    p_out, p_cache = PS.ssd_layer(pw, px, cfg_p, return_cache=True)
    close(p_out, r_out, **LAYER_TOL)
    for key in ("conv", "state"):
        close(p_cache[key], r_cache[key], **LAYER_TOL)
    # a second segment continues from the cache
    rx2, px2 = both(randn(rng, B, 6, cfg_r.d_model))
    close(PS.ssd_layer(pw, px2, cfg_p, cache=p_cache),
          RS.ssd_layer(rw, rx2, cfg_r, cache=r_cache), **LAYER_TOL)
    for step in range(3):
        rt, pt = both(randn(rng, B, 1, cfg_r.d_model))
        r_y, r_cache = RS.ssd_decode(rw, rt, r_cache, cfg_r)
        conv, state = p_cache["conv"], p_cache["state"]
        p_y, p_cache = PS.ssd_decode(pw, pt, p_cache, cfg_p)
        assert p_cache["conv"] is conv and p_cache["state"] is state
        close(p_y, r_y, **LAYER_TOL)
        for key in ("conv", "state"):
            close(p_cache[key], r_cache[key], **LAYER_TOL)


def test_mamba2_model_matches_in_bf16(monkeypatch):
    check_model_bf16("mamba2-780m", monkeypatch)


def test_mamba2_gradients_match_in_fp32(monkeypatch):
    monkeypatch.setattr(RT, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(PT, "COMPUTE_DTYPE", torch.float32)
    check_gradients("mamba2-780m")


def test_jamba_layers_match_in_bf16(monkeypatch):
    arch = "jamba-v0.1-52b"
    cfg_r, cfg_p, params, port, tokens = model_pair(arch)
    routes = Routes(monkeypatch)
    Bx, Sx = tokens.shape
    pos = jnp.broadcast_to(jnp.arange(Sx, dtype=jnp.int32)[None], (Bx, Sx))
    ppos = torch.from_numpy(np.array(pos))
    x = RT._embed(params, cfg_r, jnp.asarray(tokens))
    close(PT._embed(port, cfg_p, torch.from_numpy(tokens)), x, rtol=0,
          atol=0)
    seen = set()
    for l in range(cfg_p.n_layers):
        body, i = divmod(l, cfg_p.scan_period)
        sp = jax.tree.map(lambda a: a[body], params["body"][f"slot{i}"])
        want, r_aux = jax.jit(lambda sp, x: RT._slot_forward(
            sp, x, cfg_r, i, pos))(sp, x)
        got, p_aux = PT._layer_forward(
            port["layers"][l], torch.from_numpy(np.array(
                x.astype(jnp.float32))).bfloat16(), cfg_p, l, ppos, "flash")
        ok = np.ones((Bx, Sx), bool)
        if cfg_p.layer_is_moe(i):
            seen.add("moe")
            (differ,), shown = routes.flips(cfg_p.top_k)
            for flip in shown:
                print(f"jamba layer {l}: route flip at row {flip[1]}, token "
                      f"{flip[2]}, probability gap {flip[3]:.3g}")
            ok = ~differ
            assert ok.mean() >= 0.5
            close(p_aux, r_aux, rtol=0, atol=1e-3)
        seen.add(cfg_p.layer_kind(i))
        np.testing.assert_allclose(got.float().numpy()[ok],
                                   np.asarray(want, np.float32)[ok],
                                   rtol=0, atol=MODEL_ATOL,
                                   err_msg=f"layer {l}")
        x = want
    assert seen == {"moe", "ssm", "attn"}
    r_logits = RT._unembed(params, cfg_r, RL.rms_norm(
        x, params["final_norm"], cfg_r.norm_eps))
    xp = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    p_logits = PT._unembed(port, cfg_p, PL.rms_norm(
        xp, port["final_norm"], cfg_p.norm_eps))
    close(p_logits, r_logits, rtol=0, atol=MODEL_ATOL)


def test_jamba_reference_drifts_between_its_own_runs(monkeypatch):
    """The reference against itself, jamba's smoke model in bf16: its
    compiled run and its op-by-op run (``jax.disable_jit``), the same
    weights, tokens and silu (rounded once, as in the op-by-op test of
    tests/test_torch_moe.py), differ past 0.1 at the logits; the port
    holds within 0.1 of the op-by-op run.  So a whole-model bound of 0.1
    against the compiled run would measure the reference's own two
    roundings, not the port."""
    monkeypatch.setattr(jax.nn, "silu", silu_rounded_once)
    cfg_r, cfg_p, params, port, tokens = model_pair("jamba-v0.1-52b")
    t = jnp.asarray(tokens)
    compiled = np.asarray(RT.forward(params, cfg_r, t)[0])
    with jax.disable_jit():
        op_by_op = np.asarray(RT.forward(params, cfg_r, t)[0])
    got = PT.forward(port, cfg_p, torch.from_numpy(tokens),
                     impl="flash")[0].float().numpy()
    drift = float(np.abs(compiled - op_by_op).max())
    to_compiled = float(np.abs(got - compiled).max())
    to_op_by_op = float(np.abs(got - op_by_op).max())
    print(f"jamba bf16 logits: reference compiled vs op by op {drift:.6f}; "
          f"port vs compiled {to_compiled:.6f}, vs op by op "
          f"{to_op_by_op:.6f}")
    assert drift > MODEL_ATOL
    assert to_op_by_op <= MODEL_ATOL
