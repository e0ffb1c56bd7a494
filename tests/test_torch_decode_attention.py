"""The decode attention kernel's plain version, on the CPU.

``kernels.decode_attention.decode_attention_reference`` (the split-and-
merge the CUDA kernel computes, float32 throughout) must agree with the
model's own decode attention, ``attention_core_naive`` over the
positions ``_decode_k_pos`` gives the cache's slots, at every head dim
the port serves (16 to 256), 1 to 8 query heads a kv head (and 12, taken
in two chunks), linear, windowed and ring caches before and after the
ring wraps, with and without the softcap, per-sequence positions, float32
and bf16, one split and several, at the wrapper's own split count with
int64 positions as with int32.  ``layers.decode_attention`` on CPU
tensors must still run ``attention_core_naive`` and launch nothing, and
the wrapper must refuse what the kernel does not take, CPU tensors
included.  The kernel
itself is held to the plain version on the card
(``tests/test_torch_card.py``).
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as C                      # noqa: E402
from repro_torch.kernels import decode_attention as da    # noqa: E402
from repro_torch.models import layers as L                # noqa: E402

B = 3
HEAD_DIMS = (16, 64, 128, 160, 224, 256)
GROUPS = (1, 2, 4, 8)
#: (kind, slots, window, positions a sequence)
CACHES = {
    "linear": (40, 0, (0, 17, 39)),
    "windowed": (40, 12, (5, 23, 39)),
    "ring": (24, 24, (0, 9, 23)),
    "ring-wrapped": (24, 24, (24, 37, 70)),
}
#: q's scale where the softcap is on, so the cap matters (as on the card)
CAP, CAP_Q_SCALE = 20.0, 24.0


def cases():
    """Every kind of cache at every group size, with one split and with
    several; the head dims, the softcap and the dtypes taken in turn."""
    out = []
    for i, (kind, G, splits) in enumerate(itertools.product(
            CACHES, GROUPS, (1, 3))):
        out.append((kind, G, splits, HEAD_DIMS[i % len(HEAD_DIMS)],
                    bool(i // 2 % 2), ("float32", "bfloat16")[i // 6 % 2]))
    return out


def case_id(case):
    kind, G, splits, D, cap, dtype = case
    return f"{kind}-G{G}-s{splits}-D{D}-{'cap' if cap else 'nocap'}-{dtype}"


def inputs(kind, G, D, dtype, cap, seed, KV=2):
    S, window, pos = CACHES[kind]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, KV * G, D), dtype=np.float32)
    if cap:
        q *= np.float32(CAP_Q_SCALE)
    k, v = (rng.standard_normal((B, S, KV, D), dtype=np.float32)
            for _ in range(2))
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(dt) for x in (q, k, v))
    return q, k, v, torch.tensor(pos, dtype=torch.int32), window, S


def naive(q, k, v, pos, window, cap):
    """The model's decode attention over a cache already written."""
    S = k.shape[1]
    return L.attention_core_naive(
        q, k, v, pos[:, None], L._decode_k_pos(pos, 0, S, S, window),
        causal=True, window=0, cap=cap)


def tolerance(dtype):
    # float32: the same sums in another order; bf16: both round the same
    # float32 result once, so at most one bf16 step apart
    return (dict(rtol=2e-5, atol=2e-6) if dtype == "float32"
            else dict(rtol=2 ** -7, atol=1e-5))


@pytest.mark.parametrize("case", cases(), ids=case_id)
def test_plain_version_matches_the_models_decode_attention(case):
    kind, G, splits, D, cap, dtype = case
    q, k, v, pos, window, S = inputs(kind, G, D, dtype, cap,
                                     seed=len(case_id(case)) + G * D)
    ring = L._is_ring(window, S)
    c = CAP if cap else 0.0
    want = naive(q, k, v, pos, window, c)
    got = da.decode_attention_reference(q, k, v, pos, window=window,
                                        ring=ring, cap=c, splits=splits)
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **tolerance(dtype))
    # at the wrapper's split count, int64 positions read as int32 ones
    splits = da.splits_for(B, k.shape[2], G, S, window)
    at64, at32 = (da.decode_attention_reference(
        q, k, v, p, window=window, ring=ring, cap=c, splits=splits)
        for p in (pos.long(), pos))
    assert torch.equal(at64, at32)
    torch.testing.assert_close(at32.float(), want.float(), **tolerance(dtype))


def test_twelve_heads_a_kv_head_in_two_chunks():
    """starcoder2-3b's 24:2 grouping: the kernel takes 12 heads as two
    blocks of 6; the plain version is the same function."""
    q, k, v, pos, window, S = inputs("linear", 12, 128, "float32", False,
                                     seed=7)
    assert da.head_chunks(12) == (2, 6)
    got = da.decode_attention_reference(q, k, v, pos, splits=2)
    torch.testing.assert_close(got, naive(q, k, v, pos, 0, 0.0),
                               **tolerance("float32"))


def test_split_choice_follows_the_shapes():
    # granite-8b's decode cell: 32 sequences x 8 kv heads, 4224 slots
    assert da.splits_for(32, 8, 4, 4224, 0) == 3
    # whisper-small's decoder (224 slots) and a ring of a few slots: one
    assert da.splits_for(4, 12, 1, 224, 0) == 1
    assert da.splits_for(2, 2, 2, 8, 8) == 1
    # gemma2-9b's 4096-slot ring at batch 1: at most 4096 / 256 splits
    assert da.splits_for(1, 8, 2, 4096, 4096) == 16
    # a window caps the range a split cuts
    assert da.splits_for(1, 8, 2, 8192, 512) == 2
    # more than 4 heads a block (qwen3-moe's 8, starcoder2-3b's 12 as two
    # blocks of 6): two blocks an SM, so two waves are fewer splits
    assert [da.blocks_per_sm(G) for G in (1, 4, 5, 8, 12)] == [3, 3, 2, 2, 2]
    assert da.splits_for(32, 4, 8, 4224, 0) == 4
    assert da.splits_for(32, 2, 12, 4224, 0) == 4


def test_cpu_decode_takes_the_naive_path_and_launches_nothing(monkeypatch):
    cfg = C.get_smoke("granite-8b")
    rng = np.random.default_rng(0)
    p = {name: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * np.float32(std or 0.1))
         for name, (shape, _axes, std) in L.attn_params_layout(cfg).items()}
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    x = torch.from_numpy(rng.standard_normal((2, 1, cfg.d_model),
                                             dtype=np.float32))
    ck = torch.from_numpy(rng.standard_normal((2, 16, KV, hd),
                                              dtype=np.float32))
    cv = torch.from_numpy(rng.standard_normal((2, 16, KV, hd),
                                              dtype=np.float32))
    pos = torch.tensor([3, 15], dtype=torch.int32)
    calls = []
    real = L.attention_core_naive

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    def refuse(*args, **kw):
        raise AssertionError("decode on the CPU reached the kernel's wrapper")

    monkeypatch.setattr(L, "attention_core_naive", spy)
    monkeypatch.setattr(L, "decode_attention_bshd", refuse)
    before = da.launches
    out, k2, v2 = L.decode_attention(p, x, ck, cv, pos, cfg)
    assert calls == [(2, 1, cfg.n_heads, hd)]
    assert da.launches == before
    assert out.shape == (2, 1, cfg.d_model) and k2 is ck and v2 is cv


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v, pos, _, S = inputs("linear", 4, 64, "float32", False, seed=1)
    kw = dict(window=0, ring=False, cap=0.0)
    before = da.launches
    bad = [
        ((q.half(), k, v, pos), kw, TypeError),            # float16
        ((q, k.bfloat16(), v, pos), kw, TypeError),        # mixed caches
        ((q, k, v, pos.float()), kw, TypeError),           # float positions
        ((q, k, v, [3, 4, 5]), kw, TypeError),             # not a tensor
        ((q.expand(B, 2, -1, -1), k, v, pos), kw, ValueError),  # 2 tokens
        ((q[:, :, :7], k, v, pos), kw, ValueError),        # 7 % 2
        ((q, k[:, :, :, :32], v[:, :, :, :32], pos), kw, ValueError),
        ((q, k, v, pos[:2]), kw, ValueError),              # pos per sequence
        ((q, k, v, pos.to("meta")), kw, ValueError),       # another device
        ((q, k, v, pos), dict(kw, window=-1), ValueError),
        ((q, k, v, pos), dict(kw, cap=-1.0), ValueError),
        ((q, k, v, pos), dict(kw, window=S - 1, ring=True), ValueError),
        ((q[..., ::2], k[..., ::2], v[..., ::2], pos), kw, ValueError),
    ]
    big = torch.zeros(B, 4, 2, 264)
    bad.append(((big[:, :1], big, big, pos), kw, ValueError))  # D > 256
    # what the kernel would take, but on the CPU
    bad.append(((q, k, v, pos), kw, ValueError))
    for args, kws, err in bad:
        with pytest.raises(err):
            da.decode_attention_bshd(*args, **kws)
    with pytest.raises(NotImplementedError):                   # needs grad
        da.decode_attention_bshd(q.requires_grad_(), k, v, pos, **kw)
    assert da.launches == before
