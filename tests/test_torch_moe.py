"""Port parity, the MoE family: ``repro_torch.models.layers`` MoE and the
MoE models against ``repro.models``.

- Configs of granite-moe-1b-a400m and qwen3-moe-30b-a3b (and the SSD
  family's, for the counts) field for field the reference's; parameter
  counts, total and active, equal without allocating anything.
- ``_dispatch_positions`` and the router's decisions (``top_e``, ``pos``,
  ``keep``) exactly; the capacity buffer exactly (the reference's is
  caught where it hands it to ``lshard``); the layer's output within 1e-5
  and its aux loss within 1e-6, in float32.  A router of zeros ties every
  probability: the reference routes every token to experts 0..K-1 and
  overflows their capacity, and the port must choose, place and drop
  exactly the same slots.
- The whole model in bf16 (granite-moe-1b-a400m and qwen3-moe-30b-a3b
  smoke configs): ``forward`` logits and aux, ``loss_fn``, ``prefill``
  and three ``decode_step``s within 0.1, the dense tests' bound
  (``tests/test_torch_models.py``).  bf16 rounds differently in the two
  packages, so a router choice within a rounding step of the K-th/K+1-th
  boundary can flip: both packages' routing is recorded layer by layer,
  every flip is shown (layer, token, probability gap), and the bound
  holds at each position whose causal prefix routed alike in every
  layer (a flipped token changes by about one expert's share; that is a
  different computation, not a rounding error).  The aux loss holds
  within 1e-3 (its router probabilities come from bf16 logits).
- The same, for all four new families, against the reference run op by
  op (``jax.disable_jit``) with its silu rounded once: the only bf16
  operation the two packages round differently there is the reference's
  bf16 silu on XLA:CPU, which misses the correctly rounded value by an
  ulp in about 40 % of values; with it rounded once, every position
  holds within 0.1 and no route flips (the MoE models come out equal).
- Gradients of ``loss_fn`` against ``jax.grad`` in float32 within 1e-4.
- ``params_from_jax`` -> ``params_to_jax`` carries a MoE tree both ways
  bit for bit.

The reference's ``init_params`` seeds each leaf by Python's ``hash`` of
its path, which changes from one process to the next, so the model tests
draw their weights with numpy from a fixed seed instead, laid out by the
reference's ``param_layout``, with its initial values where its std is 0.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                # noqa: E402
import jax.numpy as jnp                                   # noqa: E402
from jax import lax                                       # noqa: E402

from repro import configs as RC                           # noqa: E402
from repro.models import layers as RL                     # noqa: E402
from repro.models import transformer as RT                # noqa: E402
from repro_torch import configs as PC                     # noqa: E402
from repro_torch.models import layers as PL               # noqa: E402
from repro_torch.models import transformer as PT          # noqa: E402

MOE = ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b"]
NEW = MOE + ["mamba2-780m", "jamba-v0.1-52b"]
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_ATOL = 0.1
AUX_BF16_ATOL = 1e-3
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 16


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def ref_weights(cfg, seed: int, zero_std: str = "init"):
    """Seeded float32 numpy weights in the reference's layout (stacked
    bodies).  Leaves of std 0 take the reference's initial values
    (``zero_std="init"``: zeros, ``A_log = log(linspace(1, 8, H))``,
    ``skip_D = 1``) or, for layer tests, small random values so that
    they count (``"random"``; ``A_log`` keeps its spread of decays)."""
    rng = np.random.default_rng(seed)

    def leaf(path, shape, std):
        if path[-1] == "A_log":
            return np.broadcast_to(np.log(np.linspace(
                1.0, 8.0, shape[-1], dtype=np.float32)), shape).copy()
        if std == 0.0 and zero_std == "init":
            return (np.ones if path[-1] == "skip_D" else np.zeros)(
                shape, np.float32)
        return rng.standard_normal(shape, dtype=np.float32) * \
            np.float32(std or 0.1)

    def walk(layout, path):
        if isinstance(layout, dict):
            return {k: walk(v, path + (k,)) for k, v in layout.items()}
        return leaf(path, layout[0], layout[2])

    return walk(RT.param_layout(cfg), ())


def slot_weights(layout, rng):
    """Seeded float32 numpy weights for one reference layer layout."""
    return {k: rng.standard_normal(v[0], dtype=np.float32)
            * np.float32(v[2] or 0.1) for k, v in layout.items()}


def to_port(w, dtype=torch.float32):
    return {k: torch.from_numpy(np.array(v)).to(dtype) for k, v in w.items()}


# ------------------------------------------------------------ configs/counts
@pytest.mark.parametrize("arch", NEW)
def test_configs_and_counts_equal_reference(arch):
    for get in ("get_config", "get_smoke"):
        port, ref = getattr(PC, get)(arch), getattr(RC, get)(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), get
        assert [port.layer_kind(i) for i in range(port.n_layers)] == \
            [ref.layer_kind(i) for i in range(ref.n_layers)]
        assert [port.layer_is_moe(i) for i in range(port.n_layers)] == \
            [ref.layer_is_moe(i) for i in range(ref.n_layers)]
        for active in (False, True):
            assert PT.count_params(port, active_only=active) == \
                RT.count_params(ref, active_only=active)
        assert port.active_param_count() == ref.active_param_count()


def test_full_width_counts():
    counts = {arch: (PT.count_params(PC.get_config(arch)),
                     PT.count_params(PC.get_config(arch), active_only=True))
              for arch in NEW}
    assert counts["qwen3-moe-30b-a3b"] == (30_079_125_504, 2_900_035_584)
    assert counts["jamba-v0.1-52b"] == (51_460_000_640, 11_999_988_608)
    assert counts["mamba2-780m"] == (780_185_856, 780_185_856)
    assert counts["granite-moe-1b-a400m"][1] < counts[
        "granite-moe-1b-a400m"][0]


def test_moe_layers_follow_the_reference_slots():
    cfg = PC.get_smoke("jamba-v0.1-52b")
    layout = PT.param_layout(cfg)
    ref = RT.param_layout(RC.get_smoke("jamba-v0.1-52b"))["body"]
    for l, layer in enumerate(layout["layers"]):
        assert sorted(layer) == sorted(ref[f"slot{l % cfg.scan_period}"])
    assert "moe" in layout["layers"][1] and "mlp" in layout["layers"][0]
    assert "attn" in layout["layers"][4] and "ssm" in layout["layers"][3]


# ------------------------------------------------------------------ routing
@pytest.mark.parametrize("T,E", [(1, 4), (16, 4), (64, 8), (256, 128)])
def test_dispatch_positions_equal(T, E):
    rng = np.random.default_rng(T + E)
    ids = rng.integers(0, E, (3, T)).astype(np.int32)
    got = PL._dispatch_positions(torch.from_numpy(ids), E)
    for b in range(3):
        want = RL._dispatch_positions(jnp.asarray(ids[b]), E)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            PL._dispatch_positions(torch.from_numpy(ids[b]), E).numpy(),
            np.asarray(want))


def ref_routing(p, x, cfg, C):
    """The reference's routing decisions, by its own lines
    (``layers.py:409-428``)."""
    Bx, Sx, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    logits = jnp.einsum("bsd,de->bse", x, p["w_router"].astype(x.dtype))
    probs = jax.nn.softmax(logits.astype(jnp.float32), -1)
    top_p, top_e = lax.top_k(probs, K)
    top_p = top_p / jnp.clip(top_p.sum(-1, keepdims=True), 1e-9)
    pos = jax.vmap(lambda e: RL._dispatch_positions(e, E))(
        top_e.reshape(Bx, Sx * K))
    keep = (pos < C) & (top_p.reshape(Bx, Sx * K) > 0)
    return np.asarray(top_e), np.asarray(pos), np.asarray(keep)


def ref_moe_with_buffer(monkeypatch, p, x, cfg):
    """The reference layer's (out, aux) and its capacity buffer, caught
    where ``moe_layer`` hands it to ``lshard``."""
    caught = []

    def spy(t, *axes):
        if t.ndim == 4 and not caught:
            caught.append(np.asarray(t))
        return t

    monkeypatch.setattr(RL, "lshard", spy)
    out, aux = RL.moe_layer(p, x, cfg)
    return out, aux, caught[0]


def check_moe_layer(monkeypatch, cfg_r, cfg_p, w, x):
    rw = jax.tree.map(jnp.asarray, w)
    pw = to_port(w)
    C = PL.moe_capacity(cfg_p, x.shape[1])
    top_e, pos, keep = ref_routing(rw, jnp.asarray(x), cfg_r, C)
    route = PL.moe_route(pw, torch.from_numpy(x), cfg_p, C)
    np.testing.assert_array_equal(route.top_e.numpy(), top_e)
    np.testing.assert_array_equal(route.pos.numpy(), pos)
    np.testing.assert_array_equal(route.keep.numpy(), keep)
    r_out, r_aux, r_buf = ref_moe_with_buffer(monkeypatch, rw,
                                              jnp.asarray(x), cfg_r)
    buf = PL.moe_dispatch(torch.from_numpy(x), route, cfg_p.n_experts, C)
    np.testing.assert_array_equal(buf.transpose(0, 1).numpy(), r_buf)
    out, aux = PL.moe_layer(pw, torch.from_numpy(x), cfg_p)
    close(out, r_out, **LAYER_TOL)
    close(aux, r_aux, rtol=0, atol=1e-6)
    return route


@pytest.mark.parametrize("S_", [16, 64])
@pytest.mark.parametrize("cf", [None, 1.0])
@pytest.mark.parametrize("arch", MOE)
def test_moe_layer_matches(monkeypatch, arch, cf, S_):
    """float32, the smoke config's capacity (8.0: nothing drops) and a
    capacity factor of 1 (slots drop)."""
    cfg_r, cfg_p = RC.get_smoke(arch), PC.get_smoke(arch)
    if cf is not None:
        cfg_r, cfg_p = (c.replace(capacity_factor=cf) for c in (cfg_r, cfg_p))
    rng = np.random.default_rng(S_)
    w = slot_weights(RL.moe_params_layout(cfg_r), rng)
    x = rng.standard_normal((B, S_, cfg_r.d_model), dtype=np.float32)
    route = check_moe_layer(monkeypatch, cfg_r, cfg_p, w, x)
    if cf == 1.0:
        assert not bool(route.keep.all())                 # drops happened


def test_moe_router_ties(monkeypatch):
    """A router of zeros: every probability is 1/E; the reference routes
    every token to experts 0..K-1 (``lax.top_k`` keeps the lower index
    first) and their capacity overflows."""
    cfg_r = RC.get_smoke("qwen3-moe-30b-a3b").replace(capacity_factor=1.25)
    cfg_p = PC.get_smoke("qwen3-moe-30b-a3b").replace(capacity_factor=1.25)
    rng = np.random.default_rng(7)
    w = slot_weights(RL.moe_params_layout(cfg_r), rng)
    w["w_router"][:] = 0.0
    x = rng.standard_normal((B, 32, cfg_r.d_model), dtype=np.float32)
    route = check_moe_layer(monkeypatch, cfg_r, cfg_p, w, x)
    K, C = cfg_p.top_k, PL.moe_capacity(cfg_p, 32)
    assert (route.top_e == torch.arange(K)).all()
    assert int(route.keep.sum()) == B * K * C < B * 32 * K


def test_full_width_first_layer_drops_alike():
    """qwen3-moe-30b-a3b's first layer at full width (d_model 2048, 32/4
    heads of 64, 128 experts top-8), one row of 2048 tokens, float32, the
    same seeded weights at the reference's initial scales in both
    packages: embedded tokens, the attention sublayer and the router, up
    to the default capacity's decisions (160 slots an expert; the
    experts' products do not change which slots drop, so their weights
    are left out).  ``top_e``, ``pos`` and ``keep`` are equal, so the
    share of dropped slots is too; it is large, and larger late in the
    prompt: with random weights the attention output dominates a
    residual of embeddings of scale d_model**-0.5, and for late tokens it
    tends to the mean of the prefix's values, so their routers agree on
    a few experts.  The drops are the reference's with these weights,
    not the port's."""
    arch = "qwen3-moe-30b-a3b"
    cfg_r, cfg_p = RC.get_config(arch), PC.get_config(arch)
    Sx, D = 2048, cfg_r.d_model
    slot = RT._slot_layout(cfg_r, 0)
    rng = np.random.default_rng(0)
    w = {"attn": slot_weights(slot["attn"], rng),
         "w_router": slot_weights({"w_router": slot["moe"]["w_router"]},
                                  rng)["w_router"],
         "ln1": np.zeros(D, np.float32), "ln2": np.zeros(D, np.float32)}
    x = rng.standard_normal((1, Sx, D), dtype=np.float32) * np.float32(
        D ** -0.5)                       # rows of ``embed``, std D**-0.5
    C = PL.moe_capacity(cfg_p, Sx)
    assert C == 160

    rw = jax.tree.map(jnp.asarray, w)
    rpos = jnp.arange(Sx, dtype=jnp.int32)[None]
    rx = jnp.asarray(x)
    rx1 = rx + RL.attention_layer(rw["attn"], RL.rms_norm(rx, rw["ln1"]),
                                  cfg_r, positions=rpos)
    rh2 = RL.rms_norm(rx1, rw["ln2"])
    top_e, pos, keep = ref_routing(rw, rh2, cfg_r, C)

    pw = {k: to_port(v) if isinstance(v, dict) else torch.from_numpy(v)
          for k, v in w.items()}
    px = torch.from_numpy(x)
    with torch.no_grad():
        px1 = px + PL.attention_layer(pw["attn"], PL.rms_norm(px, pw["ln1"]),
                                      cfg_p, positions=torch.from_numpy(
                                          np.array(rpos)))
        ph2 = PL.rms_norm(px1, pw["ln2"])
        route = PL.moe_route(pw, ph2, cfg_p, C)
    close(ph2, rh2, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(route.top_e.numpy(), top_e)
    np.testing.assert_array_equal(route.pos.numpy(), pos)
    np.testing.assert_array_equal(route.keep.numpy(), keep)
    dropped = ~keep.reshape(4, Sx // 4, cfg_r.top_k)
    by_quarter = dropped.mean((1, 2))
    print(f"qwen3-moe-30b-a3b layer 0, 2048 tokens: dropped "
          f"{100 * dropped.mean():.2f} % of slots in both packages; by "
          f"quarter of the prompt {np.round(100 * by_quarter, 2)} %")
    assert dropped.mean() > 0.1
    assert by_quarter[-1] > by_quarter[0]


# ---------------------------------------------------------- whole models
class Routes:
    """Each MoE layer's router decisions in both packages, in call order:
    the port's from ``moe_route``, the reference's from a callback in
    ``moe_layer`` (its own lines, inside its scan)."""

    def __init__(self, monkeypatch):
        self.ref, self.port = [], []
        real_ref, real_port = RL.moe_layer, PL.moe_route

        def ref_layer(p, x, cfg, capacity=None):
            logits = jnp.einsum("bsd,de->bse", x,
                                p["w_router"].astype(x.dtype))
            probs = jax.nn.softmax(logits.astype(jnp.float32), -1)
            jax.debug.callback(self._ref, probs,
                               lax.top_k(probs, cfg.top_k)[1], ordered=True)
            return real_ref(p, x, cfg, capacity)

        def port_route(p, x, cfg, capacity):
            r = real_port(p, x, cfg, capacity)
            self.port.append((r.probs.numpy(), r.top_e.numpy()))
            return r

        monkeypatch.setattr(RL, "moe_layer", ref_layer)
        monkeypatch.setattr(PL, "moe_route", port_route)

    def _ref(self, probs, top_e):
        self.ref.append((np.asarray(probs), np.asarray(top_e)))

    def flips(self, K):
        """Per call, a bool (B, S) of tokens routed to different expert
        sets, and the list of (call, row, token, gap between the
        reference's K-th and K+1-th probabilities) flipped."""
        assert len(self.ref) == len(self.port)
        out, shown = [], []
        for c, ((rp, re), (_pp, pe)) in enumerate(zip(self.ref, self.port)):
            differ = (np.sort(re, -1) != np.sort(pe, -1)).any(-1)
            out.append(differ)
            for b, s in np.argwhere(differ):
                sp = np.sort(rp[b, s])[::-1]
                shown.append((c, int(b), int(s),
                              float(sp[K - 1] - sp[K])))
        self.ref.clear()
        self.port.clear()
        return out, shown


def agreed_prefix(differs, shape):
    """Positions whose causal prefix routed alike in every layer."""
    ok = np.ones(shape, bool)
    for d in differs:
        ok &= ~np.cumsum(d, axis=1).astype(bool)
    return ok


def model_pair(arch, seed=0, compute=None):
    cfg_r, cfg_p = RC.get_smoke(arch), PC.get_smoke(arch)
    w = ref_weights(cfg_r, seed)
    dtype = torch.float32 if compute == "float32" else PT.COMPUTE_DTYPE
    port = PT.params_from_jax(w, device="cpu", dtype=dtype)
    tokens = np.random.RandomState(0).randint(
        0, cfg_r.vocab_size, (B, S)).astype(np.int32)
    return cfg_r, cfg_p, jax.tree.map(jnp.asarray, w), port, tokens


def run_both(cfg_r, cfg_p, params, port, tokens, routes=None):
    """forward, loss_fn, prefill of S-1 tokens and three decode steps in
    both packages: a list of (name, port tensor, reference array, the
    positions held), the positions from ``routes`` when given."""
    K = cfg_p.top_k
    t = torch.from_numpy(tokens)
    Bx, Sx = tokens.shape
    out = []

    def held(shape):
        if routes is None:
            return np.ones(shape, bool), []
        differs, shown = routes.flips(K)
        return agreed_prefix(differs, shape), shown

    r_logits, r_aux = RT.forward(params, cfg_r, jnp.asarray(tokens))
    p_logits, p_aux = PT.forward(port, cfg_p, t, impl="flash")
    ok, shown = held((Bx, Sx))
    out += [("forward", p_logits, r_logits, ok, shown),
            ("aux", p_aux, r_aux, None, [])]
    labels = np.roll(tokens, -1, axis=1)
    r_total, (r_loss, _) = RT.loss_fn(params, cfg_r, jnp.asarray(tokens),
                                      jnp.asarray(labels))
    p_total, (p_loss, _) = PT.loss_fn(port, cfg_p, t,
                                      torch.from_numpy(labels))
    held((Bx, Sx))
    out.append(("loss", p_loss, r_loss, None, []))
    cut = Sx - 1
    r_last, r_cache = RT.prefill(params, cfg_r, jnp.asarray(tokens[:, :cut]),
                                 max_seq=Sx + 2)
    p_last, p_cache = PT.prefill(port, cfg_p, t[:, :cut], max_seq=Sx + 2,
                                 impl="flash")
    ok, shown = held((Bx, cut))
    rows = ok[:, -1]
    out.append(("prefill", p_last, r_last, rows, shown))
    for l, layer in enumerate(p_cache):
        body, slot = divmod(l, cfg_p.scan_period)
        for key, got in layer.items():
            want = r_cache[f"slot{slot}"][key][body]
            assert got.shape == want.shape, (l, key)
            # a copy: decode writes the port's cache in place
            out.append((f"prefill cache {l} {key}", got.clone(), want,
                        rows, []))
    tok = tokens[:, cut:]
    for step in range(3):
        pos = np.full((Bx,), cut + step, np.int32)
        r_step, r_cache = RT.decode_step(params, cfg_r, jnp.asarray(tok),
                                         r_cache, jnp.asarray(pos))
        p_step, p_cache = PT.decode_step(port, cfg_p, torch.from_numpy(tok),
                                         p_cache, torch.from_numpy(pos))
        ok, shown = held((Bx, 1))
        rows &= ok[:, 0]
        out.append((f"decode {step}", p_step[:, 0], r_step[:, 0], rows.copy(),
                    shown))
        tok = np.asarray(jnp.argmax(r_step, -1)).astype(np.int32)
    return out


def check_model_bf16(arch, monkeypatch, seed=0, flips_allowed=True):
    cfg_r, cfg_p, params, port, tokens = model_pair(arch, seed)
    routes = Routes(monkeypatch) if cfg_p.n_experts else None
    results = run_both(cfg_r, cfg_p, params, port, tokens, routes)
    for name, got, want, ok, shown in results:
        for flip in shown:
            print(f"{arch} {name}: route flip at MoE call {flip[0]}, row "
                  f"{flip[1]}, token {flip[2]}, probability gap {flip[3]:.3g}")
        assert flips_allowed or not shown, f"{name}: a route flipped"
        got = got.detach().float().numpy()
        want = np.asarray(want, np.float32)
        if name == "aux":
            np.testing.assert_allclose(got, want, rtol=0, atol=AUX_BF16_ATOL)
        elif name == "loss":
            np.testing.assert_allclose(got, want, rtol=0, atol=MODEL_ATOL)
        else:
            assert ok.mean() >= 0.5, f"{name}: most positions flipped"
            np.testing.assert_allclose(got[ok], want[ok], rtol=0,
                                       atol=MODEL_ATOL, err_msg=name)


@pytest.mark.parametrize("arch", MOE)
def test_whole_model_matches_in_bf16(monkeypatch, arch):
    check_model_bf16(arch, monkeypatch)


def silu_rounded_once(x):
    """silu taken in float32 and rounded once to ``x``'s type: the
    correctly rounded value, as ``F.silu`` gives it in the port."""
    x32 = x.astype(jnp.float32)
    return (x32 * jax.nn.sigmoid(x32)).astype(x.dtype)


def test_silu_is_correctly_rounded_in_bf16():
    """The port's bf16 silu is the float64 value rounded once, and so is
    ``silu_rounded_once``; the reference's ``jax.nn.silu`` on a bf16
    array (``x * logistic(x)``, each rounded to bf16, the logistic by
    XLA:CPU's approximation) is not: it misses by an ulp in about 40 %
    of these values.  That one operation is where the two packages'
    bf16 layers differ when the reference runs op by op."""
    x = np.random.default_rng(0).standard_normal(100_000).astype(
        np.float32) * 3
    xb = torch.from_numpy(x).bfloat16()
    x64 = xb.double()
    exact = (x64 * torch.sigmoid(x64)).bfloat16()
    assert torch.equal(torch.nn.functional.silu(xb), exact)
    xr = jnp.asarray(x, jnp.bfloat16)
    ours = silu_rounded_once(xr)
    np.testing.assert_array_equal(np.asarray(ours.astype(jnp.float32)),
                                  exact.float().numpy())
    with jax.disable_jit():
        native = jax.nn.silu(xr)
    missed = float(np.mean(np.asarray(native.astype(jnp.float32))
                           != exact.float().numpy()))
    print(f"reference bf16 silu off the correctly rounded value: "
          f"{100 * missed:.2f} %")


@pytest.mark.parametrize("arch", NEW)
def test_whole_model_matches_op_by_op_in_bf16(monkeypatch, arch):
    """The whole model in bf16 against the reference run op by op
    (``jax.disable_jit``: each operation rounds to its result type, as
    the port's do) with its silu rounded once (see
    ``test_silu_is_correctly_rounded_in_bf16``): ``forward`` logits and
    aux, ``loss_fn``, ``prefill`` with its caches and three
    ``decode_step``s, within 0.1 at every position, and no route flips."""
    monkeypatch.setattr(jax.nn, "silu", silu_rounded_once)
    with jax.disable_jit():
        check_model_bf16(arch, monkeypatch, flips_allowed=False)


@pytest.mark.parametrize("arch", NEW)
def test_whole_model_matches_in_fp32(monkeypatch, arch):
    """Both packages computing in float32 (``COMPUTE_DTYPE`` of each set
    to float32): no rounding flips a route, so every position, the
    caches after prefill and decode included, hold within 1e-4."""
    monkeypatch.setattr(RT, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(PT, "COMPUTE_DTYPE", torch.float32)
    cfg_r, cfg_p, params, port, tokens = model_pair(arch, compute="float32")
    for name, got, want, _ok, _shown in run_both(cfg_r, cfg_p, params, port,
                                                 tokens):
        close(got, want, rtol=1e-4, atol=1e-4, err_msg=name)


def test_gradients_match_in_fp32(monkeypatch):
    arch = "qwen3-moe-30b-a3b"
    monkeypatch.setattr(RT, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(PT, "COMPUTE_DTYPE", torch.float32)
    check_gradients(arch)


def check_gradients(arch):
    """``loss_fn`` gradients, port autograd (with and without per-layer
    remat) against ``jax.grad``, every leaf within 1e-4 (shared with
    tests/test_torch_ssd.py)."""
    cfg_r, cfg_p, params, port, tokens = model_pair(arch, compute="float32")
    labels = np.roll(tokens, -1, axis=1)
    r_grads = jax.grad(lambda p: RT.loss_fn(p, cfg_r, jnp.asarray(tokens),
                                            jnp.asarray(labels))[0])(params)
    r_flat = dict(jax.tree.flatten_with_path(r_grads)[0])
    leaves = [t for t in jax.tree.leaves(
        port, is_leaf=lambda x: isinstance(x, torch.Tensor))]
    for t in leaves:
        t.requires_grad_(True)
    for remat in (False, True):
        for t in leaves:
            t.grad = None
        total, _ = PT.loss_fn(port, cfg_p, torch.from_numpy(tokens),
                              torch.from_numpy(labels), remat=remat)
        total.backward()
        grads = jax.tree.map(lambda t: t.grad, port,
                             is_leaf=lambda x: isinstance(x, torch.Tensor))
        flat_w, _ = jax.tree.flatten_with_path(PT.params_to_jax(grads,
                                                                cfg_p))
        assert len(flat_w) == len(r_flat)
        for path, g in flat_w:
            np.testing.assert_allclose(
                g, np.asarray(r_flat[path]), **GRAD_TOL,
                err_msg=f"remat={remat} {jax.tree_util.keystr(path)}")
            assert np.isfinite(g).all()


def test_params_round_trip_moe():
    cfg = RC.get_smoke("jamba-v0.1-52b")
    w = ref_weights(cfg, 3, zero_std="random")
    port = PT.params_from_jax(w, device="cpu", dtype=torch.float32)
    back = PT.params_to_jax(port, PC.get_smoke("jamba-v0.1-52b"))
    flat = jax.tree.flatten_with_path(back)[0]
    want = dict(jax.tree.flatten_with_path(w)[0])
    assert len(flat) == len(want)
    for path, a in flat:
        np.testing.assert_array_equal(a, want[path])
    moe = port["layers"][1]["moe"]
    assert moe["w_gate"].shape == (4, 64, 128)
    bf = PT.params_from_jax(w, device="cpu")
    assert bf["layers"][1]["moe"]["w_up"].dtype == torch.bfloat16
    assert bf["layers"][0]["ssm"]["A_log"].dtype == torch.float32


def test_init_params_new_families():
    for arch in ("qwen3-moe-30b-a3b", "jamba-v0.1-52b"):
        cfg = PC.get_smoke(arch)
        p = PT.init_params(cfg, seed=1, device="cpu")
        leaves = jax.tree.leaves(
            p, is_leaf=lambda x: isinstance(x, torch.Tensor))
        assert sum(t.numel() for t in leaves) == PT.count_params(cfg)
    ssm = p["layers"][0]["ssm"]
    H = PC.get_smoke("jamba-v0.1-52b").ssm_heads
    close(ssm["A_log"], np.log(np.linspace(1.0, 8.0, H, dtype=np.float32)),
          rtol=0, atol=1e-6)
    assert torch.equal(ssm["skip_D"], torch.ones(H))
    for k in PT.FP32_KEYS & set(ssm):
        assert ssm[k].dtype == torch.float32, k
    assert ssm["w_in"].dtype == torch.bfloat16
    assert p["layers"][1]["moe"]["w_router"].dtype == torch.bfloat16
