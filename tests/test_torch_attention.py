"""Port parity, attention: ``repro_torch.kernels.ops.flash_attention``
(whose CPU path is the CUDA kernel's plain PyTorch version) against the
reference's ``repro.kernels.ops.flash_attention`` running its Pallas
kernel in interpret mode, at every case of tests/test_kernels.py; and
the port's ``attention_core`` for ``naive``, ``blockwise`` and
``flash`` against the reference's ``naive``; and the port's oracle
``repro_torch.kernels.ref.attention_reference`` against the reference's
(float32 within 1e-6, NaN on the same fully masked rows).

The same seeded numpy inputs go to both packages.  Tolerances are the
reference's own (tests/test_kernels.py): 2e-5 for float32 and 2e-2 for
bfloat16.  The kernel itself is held against its plain version on the
card by tests/test_torch_card.py and chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                   # noqa: E402

from repro.kernels import ops as ref_ops                  # noqa: E402
from repro.kernels import ref as ref_oracle               # noqa: E402
from repro.models import layers as ref_layers             # noqa: E402
from repro_torch.kernels import flash_attention as fa     # noqa: E402
from repro_torch.kernels import ops as port_ops           # noqa: E402
from repro_torch.kernels import ref as port_oracle        # noqa: E402
from repro_torch.models import layers as port_layers      # noqa: E402

SHAPES = [
    # B, Sq, Sk, H, KV, D
    (1, 128, 128, 4, 4, 64),      # MHA, block-multiple
    (2, 256, 256, 8, 2, 64),      # GQA 4:1
    (1, 100, 100, 4, 2, 80),      # ragged seq + non-128 head_dim
    (2, 64, 192, 4, 1, 32),       # cross lengths, MQA
    (1, 512, 512, 2, 2, 128),     # exact MXU dims
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def qkv(shape, dtype, seed, q_scale=1.0):
    """Seeded inputs as (reference jnp arrays, port CPU tensors): drawn
    in float32 (q times ``q_scale``) and rounded once to ``dtype`` on
    each side (both round to nearest even, so the two sides hold
    identical values)."""
    B, Sq, Sk, H, KV, D = shape
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s, dtype=np.float32)
              for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D))]
    arrays[0] = arrays[0] * np.float32(q_scale)
    ref = tuple(jnp.asarray(a, getattr(jnp, dtype)) for a in arrays)
    port = tuple(torch.from_numpy(a).to(getattr(torch, dtype))
                 for a in arrays)
    return ref, port


def assert_close(port_out, ref_out, tol):
    np.testing.assert_allclose(port_out.float().numpy(),
                               np.asarray(ref_out, np.float32),
                               rtol=tol, atol=tol)


def run_both(shape, dtype, seed, block_q, block_k, **kw):
    (rq, rk, rv), (pq, pk, pv) = qkv(shape, dtype, seed)
    ref = ref_ops.flash_attention(rq, rk, rv, block_q=block_q,
                                  block_k=block_k, interpret=True, **kw)
    before = fa.launches
    got = port_ops.flash_attention(pq, pk, pv, **kw)
    assert fa.launches == before       # CPU tensors: the plain version
    assert got.shape == pq.shape and got.dtype == pq.dtype
    return got, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_matches_reference_kernel_causal(shape, dtype):
    got, ref = run_both(shape, dtype, sum(shape), 64, 64, causal=True)
    assert_close(got, ref, TOL[dtype])


@pytest.mark.parametrize("window", [8, 64])
def test_flash_sliding_window(window):
    got, ref = run_both((2, 128, 128, 4, 2, 64), "float32", 1, 32, 32,
                        causal=True, window=window)
    assert_close(got, ref, TOL["float32"])


def test_flash_softcap():
    got, ref = run_both((1, 128, 128, 4, 4, 64), "float32", 2, 64, 64,
                        causal=True, cap=20.0)
    assert_close(got, ref, TOL["float32"])


def test_flash_non_causal():
    got, ref = run_both((1, 64, 128, 4, 4, 64), "float32", 3, 32, 64,
                        causal=False)
    assert_close(got, ref, TOL["float32"])


def test_flash_window_one_is_finite():
    got, ref = run_both((1, 32, 32, 2, 2, 32), "float32", 6, 16, 16,
                        causal=True, window=1)
    assert bool(torch.isfinite(got).all())
    assert_close(got, ref, TOL["float32"])


def test_flash_fully_masked_rows_are_zero():
    """Causal with a 4-wide window over 16 keys: query rows 20.. see no
    key at all.  The kernel (and so the port) gives 0 there, where the
    reference's jnp oracle (kernels/ref.py) gives NaN."""
    got, ref = run_both((1, 64, 16, 2, 1, 32), "float32", 7, 16, 16,
                        causal=True, window=4)
    assert bool((got[:, 20:] == 0).all())
    assert bool(torch.isfinite(got).all())
    assert_close(got, ref, TOL["float32"])


#: the CUDA-core kernel's tile edges (tests/test_torch_card.py holds the
#: kernel to the port's plain version at the same geometry): head_dims 1,
#: 4, 36, 100, 200 and 256, lengths 1, 63, 65, 129 and 1000, Sq != Sk
#: causal and not, GQA 8:1, windows of 100 and 200 that end inside a
#: 64-row kv tile, the softcap with q times 24 (so that the cap changes
#: the scores), and rows with nothing visible (window 5 over 65 keys);
#: (shape, causal, window, cap)
EDGE_GEOMETRY = [((1, 1, 1, 2, 1, 1), True, 0, 0.0),
                 ((2, 63, 65, 8, 1, 4), True, 0, 0.0),
                 ((1, 65, 63, 4, 2, 36), False, 0, 0.0),
                 ((1, 129, 1000, 8, 1, 100), False, 0, 0.0),
                 ((1, 1000, 129, 4, 1, 200), True, 0, 0.0),
                 ((1, 1000, 1000, 2, 1, 256), True, 100, 0.0),
                 ((1, 129, 129, 4, 4, 100), True, 0, 30.0),
                 ((1, 129, 65, 4, 1, 36), True, 5, 0.0),
                 ((1, 1000, 1000, 8, 1, 64), True, 200, 50.0),
                 ((2, 65, 1000, 4, 2, 1), False, 0, 0.0)]
CAP_Q_SCALE = 24.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", EDGE_GEOMETRY,
                         ids=lambda c: "-".join(map(str, c[0])) +
                         f"-causal{int(c[1])}-w{c[2]}-cap{c[3]:g}")
def test_flash_tile_edges_match_reference_kernel(case, dtype):
    """The port's plain version against the reference's Pallas kernel
    (64-row q and kv blocks, in interpret mode) at the geometry of the
    CUDA-core kernel's tile edges; rows with nothing visible give 0."""
    check_tile_edge(case, dtype)


#: the wgmma kernel's tile edges, in bf16, the only type it takes
#: (tests/test_torch_card.py holds the kernel to the port's plain version
#: at the same geometry): head_dims 16, 48, 64, 96, 128, 144, 160, 192,
#: 208, 224 and 256 (each of its instances, at its own width and padded
#: up to it), lengths 1, 63, 65, 127, 129, 191, 193, 257 and 1000 (under,
#: at and past its 128- and 192-row q tiles and 64- to 128-row kv tiles),
#: Sq != Sk causal and not, GQA 8:1, windows of 100, 200 and 300 that end
#: inside a kv tile, the softcap with q times 24, and rows with nothing
#: visible (window 5 over 65 keys)
SM90_EDGE_GEOMETRY = [((1, 1, 1, 2, 1, 16), True, 0, 0.0),
                      ((2, 63, 65, 8, 1, 48), True, 0, 0.0),
                      ((1, 65, 63, 4, 2, 64), False, 0, 0.0),
                      ((1, 127, 129, 4, 1, 96), False, 0, 0.0),
                      ((1, 129, 1000, 8, 1, 128), False, 0, 0.0),
                      ((1, 1000, 129, 4, 1, 144), True, 0, 0.0),
                      ((1, 193, 191, 4, 2, 128), True, 0, 0.0),
                      ((1, 257, 257, 4, 2, 160), True, 100, 0.0),
                      ((1, 1000, 1000, 2, 1, 192), True, 200, 50.0),
                      ((1, 129, 65, 4, 1, 208), True, 5, 0.0),
                      ((1, 1000, 1000, 2, 1, 224), True, 300, 50.0),
                      ((2, 257, 1000, 4, 2, 256), False, 0, 30.0)]


@pytest.mark.parametrize("case", SM90_EDGE_GEOMETRY,
                         ids=lambda c: "-".join(map(str, c[0])) +
                         f"-causal{int(c[1])}-w{c[2]}-cap{c[3]:g}")
def test_flash_wgmma_tile_edges_match_reference_kernel(case):
    """The port's plain version against the reference's Pallas kernel
    (in interpret mode) at the geometry of the wgmma kernel's tile edges;
    rows with nothing visible give 0."""
    check_tile_edge(case, "bfloat16")


def check_tile_edge(case, dtype):
    """One tile-edge case: the port against the reference, rows with
    nothing visible 0."""
    shape, causal, window, cap = case
    (rq, rk, rv), (pq, pk, pv) = qkv(shape, dtype, sum(shape),
                                     CAP_Q_SCALE if cap else 1.0)
    kw = {"causal": causal, "window": window, "cap": cap}
    ref = ref_ops.flash_attention(rq, rk, rv, block_q=64, block_k=64,
                                  interpret=True, **kw)
    before = fa.launches
    got = port_ops.flash_attention(pq, pk, pv, **kw)
    assert fa.launches == before       # CPU tensors: the plain version
    assert got.shape == pq.shape and got.dtype == pq.dtype
    assert bool(torch.isfinite(got).all())
    _, Sq, Sk = shape[:3]
    q = np.arange(Sq)
    hi = np.minimum(q, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(Sq, int)
    assert bool((got[:, torch.from_numpy(q[hi < lo])] == 0).all())
    if window == 5:
        assert (hi < lo).sum() == Sq - 69
    assert_close(got, ref, TOL[dtype])


CORE_CASES = [
    # shape (B, S, S, H, KV, D), causal, window, cap
    ((2, 96, 96, 4, 2, 64), True, 0, 0.0),
    ((2, 96, 96, 4, 2, 64), True, 8, 0.0),
    ((1, 80, 80, 4, 4, 32), True, 0, 50.0),
    ((1, 64, 64, 4, 1, 48), False, 0, 0.0),
]


@pytest.mark.parametrize("impl", ["naive", "blockwise", "flash"])
@pytest.mark.parametrize("case", CORE_CASES,
                         ids=lambda c: f"{c[0][1]}x{c[0][3]}x{c[0][4]}-"
                         f"causal{int(c[1])}-w{c[2]}-cap{c[3]:g}")
def test_attention_core_matches_reference_naive(case, impl):
    """Every port impl against the reference's ``naive``.  Blockwise runs
    with 32-row blocks, so the window case crosses kv blocks (where the
    reference's own blockwise gives NaN: ROADMAP.md Queue 3)."""
    shape, causal, window, cap = case
    (rq, rk, rv), (pq, pk, pv) = qkv(shape, "float32", 11)
    B, S = shape[0], shape[1]
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    ref = ref_layers.attention_core(rq, rk, rv, jnp.asarray(pos),
                                    jnp.asarray(pos), impl="naive",
                                    causal=causal, window=window, cap=cap)
    tpos = torch.from_numpy(pos.copy())
    got = port_layers.attention_core(pq, pk, pv, tpos, tpos, impl=impl,
                                     causal=causal, window=window, cap=cap,
                                     block_q=32, block_k=32)
    assert bool(torch.isfinite(got).all())
    assert_close(got, ref, TOL["float32"])


def test_attention_core_refuses_unknown_impl():
    q = torch.zeros(1, 4, 2, 8)
    pos = torch.arange(4)[None]
    with pytest.raises(ValueError):
        port_layers.attention_core(q, q, q, pos, pos, impl="pallas")


# ------------------------------------------------------- the kernel choice
HEAD_DIMS = [32, 64, 80, 100, 128, 224, 256]


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_choice_by_dtype_and_head_dim(monkeypatch, dtype, head_dim):
    """bf16 with D % 16 == 0 goes to the wgmma kernel, everything else to
    the CUDA-core kernel; the wrapper launches what ``kernel_for`` picks
    (tensors on the meta device stand in for the card's)."""
    dt = getattr(torch, dtype)
    want = fa.SM90 if dtype == "bfloat16" and head_dim % 16 == 0 else fa.SIMT
    assert fa.kernel_for(dt, head_dim) == want
    seen = []
    monkeypatch.setattr(fa, "_launch", lambda kernel, *a: seen.append(kernel))
    q = torch.empty(1, 8, 4, head_dim, dtype=dt, device="meta")
    kv = torch.empty(1, 8, 2, head_dim, dtype=dt, device="meta")
    fa.flash_attention_bshd(q, kv, kv)
    assert seen == [want]


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


Q, KV = (1, 8, 4, 32), (1, 8, 2, 32)
REFUSALS = {
    "half": (TypeError, lambda: fa.flash_attention_bshd(
        _meta(Q, torch.half), _meta(KV, torch.half), _meta(KV, torch.half))),
    "int": (TypeError, lambda: fa.flash_attention_bshd(
        _meta(Q, torch.int32), _meta(KV, torch.int32),
        _meta(KV, torch.int32))),
    "mixed-dtypes": (TypeError, lambda: fa.flash_attention_bshd(
        _meta(Q), _meta(KV, torch.float32), _meta(KV))),
    "3-d": (ValueError, lambda: fa.flash_attention_bshd(
        _meta(Q[1:]), _meta(KV), _meta(KV))),
    "not-contiguous": (ValueError, lambda: fa.flash_attention_bshd(
        _meta((1, 4, 8, 32)).transpose(1, 2), _meta(KV), _meta(KV))),
    "heads-not-a-multiple": (ValueError, lambda: fa.flash_attention_bshd(
        _meta((1, 8, 3, 32)), _meta(KV), _meta(KV))),
    "head-dim-264": (ValueError, lambda: fa.flash_attention_bshd(
        _meta((1, 8, 4, 264)), _meta((1, 8, 2, 264)), _meta((1, 8, 2, 264)))),
    "k-v-shapes-differ": (ValueError, lambda: fa.flash_attention_bshd(
        _meta(Q), _meta(KV), _meta((1, 9, 2, 32)))),
    "negative-window": (ValueError, lambda: fa.flash_attention_bshd(
        _meta(Q), _meta(KV), _meta(KV), window=-1)),
    "negative-cap": (ValueError, lambda: fa.flash_attention_bshd(
        _meta(Q), _meta(KV), _meta(KV), cap=-1.0)),
    "unknown-kernel": (ValueError, lambda: fa.launch_kernel(
        "flash_fwd_tf32", _meta(Q), _meta(KV), _meta(KV))),
    "sm90-float32": (ValueError, lambda: fa.launch_kernel(
        fa.SM90, _meta(Q, torch.float32), _meta(KV, torch.float32),
        _meta(KV, torch.float32))),
    "sm90-head-dim-40": (ValueError, lambda: fa.launch_kernel(
        fa.SM90, _meta((1, 8, 4, 40)), _meta((1, 8, 2, 40)),
        _meta((1, 8, 2, 40)))),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_wrapper_refuses_before_any_device_check(monkeypatch, case):
    """What no kernel takes is refused from the tensors' metadata alone,
    before the device is looked at and before any launch."""
    seen = []
    monkeypatch.setattr(fa, "_launch", lambda *a: seen.append(a))
    error, call = REFUSALS[case]
    before = fa.launches
    with pytest.raises(error):
        call()
    assert seen == [] and fa.launches == before


def test_wrapper_refuses_a_device_it_does_not_run_on():
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention_bshd(_meta(Q), _meta(KV), _meta(KV))


#: the oracle's cases: tests/test_kernels.py's shapes, a window, a
#: softcap, a non-causal case with Sq != Sk, and rows with nothing
#: visible (window 4 over 16 keys: q >= 19), where both give NaN
ORACLE_CASES = ([(shape, {}) for shape in SHAPES]
                + [((2, 128, 128, 4, 2, 64), {"window": 8}),
                   ((1, 128, 128, 4, 4, 64), {"cap": 20.0}),
                   ((1, 64, 128, 4, 4, 64), {"causal": False}),
                   ((1, 64, 16, 2, 1, 32), {"window": 4}),
                   ((1, 32, 32, 2, 2, 32), {"scale": 0.3})])
ORACLE_TOL = 1e-6


@pytest.mark.parametrize("case", ORACLE_CASES,
                         ids=lambda c: "-".join(map(str, c[0])) + str(c[1]))
def test_attention_oracle_matches_reference(case):
    shape, kw = case
    (rq, rk, rv), (pq, pk, pv) = qkv(shape, "float32", sum(shape))
    want = np.asarray(ref_oracle.attention_reference(rq, rk, rv, **kw))
    got = port_oracle.attention_reference(pq, pk, pv, **kw).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if "window" in kw and shape[2] < shape[1]:
        assert np.isnan(want).any()              # the fully masked rows
    np.testing.assert_allclose(got, want, rtol=ORACLE_TOL, atol=ORACLE_TOL)
