"""Port parity, attention: ``repro_torch.kernels.ops.flash_attention``
(whose CPU path is the CUDA kernel's plain PyTorch version) against the
reference's ``repro.kernels.ops.flash_attention`` running its Pallas
kernel in interpret mode, at every case of tests/test_kernels.py; and
the port's ``attention_core`` for ``naive``, ``blockwise`` and
``flash`` against the reference's ``naive``.

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
from repro.models import layers as ref_layers             # noqa: E402
from repro_torch.kernels import flash_attention as fa     # noqa: E402
from repro_torch.kernels import ops as port_ops           # noqa: E402
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


def qkv(shape, dtype, seed):
    """Seeded inputs as (reference jnp arrays, port CPU tensors): drawn
    in float32 and rounded once to ``dtype`` on each side (both round to
    nearest even, so the two sides hold identical values)."""
    B, Sq, Sk, H, KV, D = shape
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s, dtype=np.float32)
              for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D))]
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
