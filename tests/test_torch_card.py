"""The kernels on the card.  ``fid_slots_rows`` on CUDA tensors
launches the hand-written routing kernel, which must agree bit for bit
with its plain PyTorch version (integer slots: tolerance 0), count its
launches, and route a small cluster run exactly as routing on the CPU
does.  ``flash_attention_bshd`` on CUDA tensors launches one of the two
attention kernels (``kernel_for``: the wgmma kernel for bf16 with
D % 16 == 0, the CUDA-core kernel otherwise); each kernel must agree
with the plain version within the reference's own tolerances
(``tests/test_kernels.py``: 2e-5 for float32, 2e-2 for bfloat16) at
every case of that file it takes, at the serving shape and at the extra
bf16 cases (pixtral-12b's head_dim 160, whisper-small's non-causal
encoder, and gemma2-9b's and qwen2.5-14b's prefills among them) and at
its own tile edges (every instance of each kernel), with
q scaled where a case has a softcap so that the cap matters, give 0 on
fully masked rows, fail the same comparison when launched without the
case's softcap or window, and refuse what it does not take, inputs that
need a gradient included.  A decode step of gemma2-9b at full width and two
layers, after its local layer's 4096-slot ring has wrapped, must agree
with a prefill one token longer within 0.12 (phase 12a).  The decode
kernel (``decode_attention_bshd`` on CUDA tensors) must agree with its
plain version, at its own split count and at one split, at granite-8b's
decode cell and at the decode shapes of gemma2-9b (its ring wrapped, with
the softcap), qwen3-moe, whisper-small and pixtral-12b, in float32 and
bf16; and a smoke decode step must launch it once a layer, by the
wrapper's count and the kernel's own, its logits within 0.12 of the CPU's.
The activity
consumers of ``chip_smoke.py``'s phase 7 over a cluster routing on the
card must end in the state they reach over one routing on the CPU, so
must phase 7a's elastic scenario and two-filesystem federation (the
same deliveries, stats and cursors, every routing chunk one launch), so
must phase 7b's module chain with tenant groups and a quota that parks
through a shard added and migrated to, a
training step on the card must agree with the same step on the CPU
(phase 8, and phases 8a-8c's families, whisper-small with its frames),
phases 8a-8c's helper must pass its checks at smoke size with no kernel
launched (and, on the CPU, the Trainer must refuse an encoder-decoder,
to which it feeds no frames), and one MoE layer and one SSD layer in
float32 must agree between card and CPU (phases 9, 10 and 10a, each at
its family's width, jamba-v0.1-52b's too: routing equal, outputs within
1e-5 and 1e-4), and so
must one encoder layer and one decoder layer of whisper-small (phase 12:
within 1e-4).  On a one-rank NCCL mesh (phase 13) the sharded path runs
the unsharded operations: a flash prefill and decode steps within 1e-3,
a training step within 1e-4, the wgmma kernel reached once through
``local_map`` and bit-equal, and ``compressed_psum`` exact to its step;
one body of each other family (MoE, SSD, hybrid, VLM, encoder-decoder)
runs its prefill, a decode step and a training step on that mesh as it
runs without one, within the same bounds.

Imports only the port (the card's machine has no JAX and no msgpack),
and skips where there is no CUDA card.  On a card:
``PYTHONPATH=src python -m pytest -q tests/test_torch_card.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import records as T                 # noqa: E402
from repro_torch.core.cluster import LcapCluster          # noqa: E402
from repro_torch.core.llog import Llog                    # noqa: E402
from repro_torch.core.session import connect              # noqa: E402
from repro_torch.kernels import flash_attention as fa     # noqa: E402
from repro_torch.kernels import stream_ops                # noqa: E402

N_SLOTS = (1, 3, 64, 65535, 65536, 1000003, (1 << 31) - 1)
EDGE_FIDS = [(0, 0, 0), (1, 0, 0), ((1 << 64) - 1, (1 << 32) - 1,
                                    (1 << 32) - 1), (1 << 63, 1, 2)]


#: tests/test_kernels.py's cases: (B, Sq, Sk, H, KV, D), dtype, causal,
#: window, cap
FLASH_SHAPES = [(1, 128, 128, 4, 4, 64), (2, 256, 256, 8, 2, 64),
                (1, 100, 100, 4, 2, 80), (2, 64, 192, 4, 1, 32),
                (1, 512, 512, 2, 2, 128)]
FLASH_CASES = (
    [(shape, dtype, True, 0, 0.0) for shape in FLASH_SHAPES
     for dtype in ("float32", "bfloat16")]
    + [((2, 128, 128, 4, 2, 64), "float32", True, window, 0.0)
       for window in (8, 64)]
    + [((1, 128, 128, 4, 4, 64), "float32", True, 0, 20.0),
       ((1, 64, 128, 4, 4, 64), "float32", False, 0, 0.0),
       ((1, 32, 32, 2, 2, 32), "float32", True, 1, 0.0),
       # gemma2-9b's head_dim, and rows with nothing visible (q >= 20)
       ((1, 96, 96, 4, 2, 224), "bfloat16", True, 0, 50.0),
       ((1, 64, 16, 2, 1, 32), "float32", True, 4, 0.0)])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


#: q's scale where a case has a softcap: with N(0, 1) inputs the scores
#: stay near 1 and a cap of 20 or 50 barely moves them; at 24 they reach
#: tens, the cap matters and the softmax is peaked (outputs O(1))
CAP_Q_SCALE = 24.0


def qkv(shape, dtype, seed, device, cap=0.0):
    B, Sq, Sk, H, KV, D = shape
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    q, k, v = (rng.standard_normal(s, dtype=np.float32)
               for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D)))
    if cap:
        q = q * np.float32(CAP_Q_SCALE)
    return tuple(torch.from_numpy(x).to(device=device, dtype=dt)
                 for x in (q, k, v))


def header_rows(n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    hdr = np.zeros(n + len(EDGE_FIDS), dtype=T.HDR_DTYPE)
    hdr["tseq"][:n] = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    hdr["toid"][:n] = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    hdr["tver"][:n] = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    for j, (s, o, v) in enumerate(EDGE_FIDS):
        hdr[n + j]["tseq"], hdr[n + j]["toid"], hdr[n + j]["tver"] = s, o, v
    return torch.from_numpy(hdr.view(np.uint8).reshape(len(hdr), 64).copy())


#: rows the kernel is held at: one row, under one block, the main
#: path's 1024 + the edge FIDs, one routing chunk and one row past it
#: (a second pass of the grid-stride loop), and 2^20 (several rows a
#: thread)
KERNEL_ROWS = (1, 255, 1028, 1 << 16, (1 << 16) + 1, 1 << 20)


@pytest.mark.parametrize("n", KERNEL_ROWS)
@pytest.mark.parametrize("n_slots", N_SLOTS)
def test_kernel_matches_plain_version(card, n_slots, n):
    # the last n rows: the four edge FIDs are always among them
    rows = header_rows(n, seed=n_slots)[-n:]
    want = stream_ops.fid_slots_rows_reference(rows, n_slots)
    on_card = rows.to(card)
    before = stream_ops.launches
    got = stream_ops.fid_slots_rows(on_card, n_slots)
    out = torch.full((n,), -1, dtype=torch.int64, device=card)
    assert stream_ops.fid_slots_rows(on_card, n_slots, out=out) is out
    torch.cuda.synchronize()
    assert stream_ops.launches == before + 2
    assert got.device.type == "cuda" and got.dtype == torch.int64
    assert torch.equal(got.cpu(), want)
    assert torch.equal(out.cpu(), want)


def test_kernel_edge_cases(card):
    before = stream_ops.launches
    empty = stream_ops.fid_slots_rows(
        torch.empty((0, 64), dtype=torch.uint8, device=card), 64)
    assert empty.shape == (0,) and stream_ops.launches == before
    rows = header_rows(100, seed=1).to(card)
    with pytest.raises(ValueError):
        stream_ops.fid_slots_rows(rows.view(-1)[8:8 + 64 * 50].view(50, 64),
                                  64)                   # not 16-byte aligned
    with pytest.raises(ValueError):
        stream_ops.fid_slots_rows(rows, 1 << 31)


def test_cluster_routes_on_the_card_like_on_the_cpu(card):
    def run(device):
        logs = {f"mdt{m}": Llog(f"mdt{m}") for m in range(2)}
        cluster = LcapCluster(logs, n_shards=3, batch_size=64, device=device)
        stream = connect(cluster).subscribe("g", auto_commit=False)
        for m, log in enumerate(logs.values()):
            log.log_batch([T.ChangelogRecord(
                type=T.CL_CREATE, time=1 + i, name=b"f%d" % i,
                tfid=T.Fid(0x200000400 + m, 1 + i % 97, 0))
                for i in range(500)])
        out = []
        for _ in range(50):
            cluster.pump()
            out += [(pid, batch.to_wire(2)) for pid, batch in stream.fetch()]
            stream.commit()
        return out, cluster.routing_launches, cluster.routing_reads
    before = stream_ops.launches
    on_card, launches, reads = run("cuda")
    # the first round hashes all 1000 records in one chunk
    assert stream_ops.launches - before == launches > 0
    assert launches < reads
    assert on_card == run("cpu")[0]


def case_id(c):
    return ("-".join(map(str, c[0])) +
            f"-{c[1]}-causal{int(c[2])}-w{c[3]}-cap{c[4]:g}")


def takes(kernel, case):
    """Whether ``kernel`` takes ``case``: the CUDA-core kernel takes every
    case, the wgmma kernel bf16 with D % 16 == 0."""
    return kernel == fa.SIMT or fa.kernel_for(getattr(torch, case[1]),
                                              case[0][5]) == fa.SM90


def masked_rows(Sq, Sk, causal, window):
    """The query rows that see no key at all."""
    q = np.arange(Sq)
    hi = np.minimum(q, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(Sq, int)
    return q[hi < lo]


def check_against_plain(got, q, k, v, case):
    shape, dtype, causal, window, cap = case
    assert got.shape == q.shape and got.dtype == q.dtype
    want = fa.flash_attention_reference(q, k, v, causal=causal,
                                        window=window, cap=cap)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    empty = torch.as_tensor(masked_rows(shape[1], shape[2], causal, window),
                            device=got.device)
    assert bool((got[:, empty] == 0).all())


#: bf16 at a head_dim that is not a multiple of 16: ``kernel_for`` sends
#: it to the CUDA-core kernel
BF16_ODD = ((2, 129, 129, 4, 2, 72), "bfloat16", True, 0, 0.0)


@pytest.mark.parametrize("case", FLASH_CASES + [BF16_ODD], ids=case_id)
def test_flash_kernel_matches_plain_version(card, case):
    """Through the wrapper: the kernel ``kernel_for`` picks, one launch,
    counted by the wrapper and by the kernel itself on the card."""
    shape, dtype, causal, window, cap = case
    q, k, v = qkv(shape, dtype, seed=sum(shape), device=card, cap=cap)
    kernel = fa.kernel_for(q.dtype, shape[5])
    before = (fa.launches, fa.launches_sm90, fa.launches_simt)
    on_card = {name: fa.device_launches(name) for name in (fa.SM90, fa.SIMT)}
    got = fa.flash_attention_bshd(q, k, v, causal=causal, window=window,
                                  cap=cap)
    torch.cuda.synchronize()
    sm90 = int(kernel == fa.SM90)
    assert (fa.launches, fa.launches_sm90, fa.launches_simt) == (
        before[0] + 1, before[1] + sm90, before[2] + 1 - sm90)
    assert {name: fa.device_launches(name) - n
            for name, n in on_card.items()} == {fa.SM90: sm90,
                                                fa.SIMT: 1 - sm90}
    check_against_plain(got, q, k, v, case)


#: the serving path's shape, and bf16 cases beyond the reference's: the
#: decode check's 2049-token prefill, gemma2-9b's head_dim with its window
#: and softcap, and rows with nothing visible; then pixtral-12b's prefill
#: (head_dim 160, an instance of the wgmma kernel's own), whisper-small's
#: encoder (non-causal over 1500 frames, not a multiple of the 64-row kv
#: tile) and decoder prefill, and small non-causal cases with Sq != Sk and
#: Sk not a multiple of 64
SERVING = ((4, 2048, 2048, 32, 8, 128), "bfloat16", True, 0, 0.0)
EXTRA_CASES = [SERVING,
               ((4, 2049, 2049, 32, 8, 128), "bfloat16", True, 0, 0.0),
               ((1, 96, 96, 4, 2, 224), "bfloat16", True, 16, 50.0),
               ((1, 64, 16, 2, 1, 32), "bfloat16", True, 4, 0.0),
               ((4, 2048, 2048, 32, 8, 160), "bfloat16", True, 0, 0.0),
               ((4, 1500, 1500, 12, 12, 64), "bfloat16", False, 0, 0.0),
               ((4, 224, 224, 12, 12, 64), "bfloat16", True, 0, 0.0),
               ((2, 100, 1500, 4, 4, 64), "bfloat16", False, 0, 0.0),
               ((1, 64, 130, 4, 2, 160), "bfloat16", False, 0, 0.0)]
#: the prefills of phases 12a and 12b: gemma2-9b's 2 x 8192 tokens at
#: head_dim 224 (an instance of the wgmma kernel's own) with its softcap, on
#: a local layer (window 4096) and a global one; qwen2.5-14b's GQA 40:8
DENSE_CASES = [((2, 8192, 8192, 16, 8, 224), "bfloat16", True, 4096, 50.0),
               ((2, 8192, 8192, 16, 8, 224), "bfloat16", True, 0, 50.0),
               ((4, 2048, 2048, 40, 8, 128), "bfloat16", True, 0, 0.0)]
#: the CUDA-core kernel's tile edges, in float32 and bf16: head_dims 1,
#: 4, 36, 100, 200 and 256 (every instance, both staging routes), lengths
#: 1, 63, 65, 129 and 1000 (under, at and past its 64-row kv and 64- or
#: 128-row q tiles), Sq != Sk causal and not, GQA 8:1, windows of 100 and
#: 200 that end inside a kv tile, the softcap (q times CAP_Q_SCALE), and
#: rows with nothing visible (window 5 over 65 keys: q >= 69)
SIMT_GEOMETRY = [((1, 1, 1, 2, 1, 1), True, 0, 0.0),
                 ((2, 63, 65, 8, 1, 4), True, 0, 0.0),
                 ((1, 65, 63, 4, 2, 36), False, 0, 0.0),
                 ((1, 129, 1000, 8, 1, 100), False, 0, 0.0),
                 ((1, 1000, 129, 4, 1, 200), True, 0, 0.0),
                 ((1, 1000, 1000, 2, 1, 256), True, 100, 0.0),
                 ((1, 129, 129, 4, 4, 100), True, 0, 30.0),
                 ((1, 129, 65, 4, 1, 36), True, 5, 0.0),
                 ((1, 1000, 1000, 8, 1, 64), True, 200, 50.0),
                 ((2, 65, 1000, 4, 2, 1), False, 0, 0.0)]
SIMT_EDGE_CASES = [(shape, dtype, causal, window, cap)
                   for shape, causal, window, cap in SIMT_GEOMETRY
                   for dtype in ("float32", "bfloat16")]
#: the wgmma kernel's tile edges, in bf16 (chip_smoke.FLASH_SM90_GEOMETRY):
#: head_dims 16, 48, 64, 96, 128, 144, 160, 192, 208, 224 and 256 (every
#: instance, at its own width and padded up to it), lengths 1, 63, 65,
#: 127, 129, 191, 193, 257 and 1000 (under, at and past its 128- and
#: 192-row q tiles and its 64- to 128-row kv tiles), Sq != Sk causal and
#: not, GQA 8:1, windows of
#: 100, 200 and 300 that end inside a kv tile, the softcap (q times
#: CAP_Q_SCALE), and rows with nothing visible (window 5 over 65 keys,
#: whose last block has no kv tile at all)
SM90_GEOMETRY = [((1, 1, 1, 2, 1, 16), True, 0, 0.0),
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
SM90_EDGE_CASES = [(shape, "bfloat16", causal, window, cap)
                   for shape, causal, window, cap in SM90_GEOMETRY]
KERNEL_CASES = [(kernel, case)
                for case in FLASH_CASES + EXTRA_CASES + DENSE_CASES
                for kernel in (fa.SM90, fa.SIMT) if takes(kernel, case)] + \
    [(fa.SIMT, case) for case in SIMT_EDGE_CASES] + \
    [(fa.SM90, case) for case in SM90_EDGE_CASES]


@pytest.mark.parametrize("kernel,case", KERNEL_CASES,
                         ids=lambda x: x if isinstance(x, str) else
                         case_id(x))
def test_each_flash_kernel_matches_plain_version(card, kernel, case):
    shape, dtype, causal, window, cap = case
    q, k, v = qkv(shape, dtype, seed=sum(shape) + 1, device=card, cap=cap)
    got = fa.launch_kernel(kernel, q, k, v, causal=causal, window=window,
                           cap=cap)
    torch.cuda.synchronize()
    check_against_plain(got, q, k, v, case)


#: each case with a softcap or a window, by kernel, with the one it drops
PLANTED = [(kernel, case, what) for kernel, case in KERNEL_CASES
           for what in ("cap", "window") if case[4 if what == "cap" else 3]]


@pytest.mark.parametrize("kernel,case,what", PLANTED,
                         ids=lambda x: x if isinstance(x, str) else
                         case_id(x))
def test_check_fails_a_kernel_without_its_cap_or_window(card, kernel, case,
                                                        what):
    """A planted fault: the kernel launched without the case's softcap
    (or window) must fail the comparison with the plain version that
    the right launch passes."""
    shape, dtype, causal, window, cap = case
    q, k, v = qkv(shape, dtype, seed=sum(shape) + 1, device=card, cap=cap)
    kw = {"causal": causal, "window": window, "cap": cap,
          **({"cap": 0.0} if what == "cap" else {"window": 0})}
    wrong = fa.launch_kernel(kernel, q, k, v, **kw)
    torch.cuda.synchronize()
    with pytest.raises(AssertionError):
        check_against_plain(wrong, q, k, v, case)


def test_gemma2_decode_after_the_ring_wraps(card):
    """gemma2-9b at full width and two layers (layer 0 local, its window
    of 4096 a ring of 4096 slots; layer 1 global): a prefill of 8192
    tokens fills the ring with positions 4096-8191, and the decode step
    at position 8192 writes slot 0 and attends over positions 4097-8192;
    its logits against the last of an 8193-token prefill within 0.12,
    the reference's prefill/decode tolerance."""
    from repro_torch import configs as C
    from repro_torch.launch import serve as S
    from repro_torch.models import transformer as M
    cfg = C.get_config("gemma2-9b").replace(n_layers=2)
    window, P = cfg.sliding_window, 2 * cfg.sliding_window
    params = M.init_params(cfg, seed=0, device=card)
    ext = S.make_tokens(cfg, 1, P + 1, seed=1, device=card)
    with torch.inference_mode():
        full, _ = M.prefill(params, cfg, ext, impl="flash")
        _, cache = M.prefill(params, cfg, ext[:, :P], max_seq=P + 1,
                             impl="flash")
        assert [c["k"].shape[1] for c in cache] == [window, P + 1]
        slot0 = cache[0]["k"][:, 0].clone()
        pos = torch.full((1,), P, dtype=torch.int32, device=card)
        step, cache = M.decode_step(params, cfg, ext[:, P:], cache, pos)
        assert not torch.equal(cache[0]["k"][:, 0], slot0)
    diff = float((step[:, 0] - full).abs().max())
    print(f"gemma2-9b decode at {P} after the ring wrapped vs a {P + 1}-"
          f"token prefill: max |diff| {diff}")
    assert diff <= 0.12


def test_flash_kernel_refuses_what_it_does_not_take(card):
    q, k, v = qkv((1, 16, 16, 4, 2, 32), "float32", seed=0, device=card)
    before = fa.launches
    with pytest.raises(TypeError):
        fa.flash_attention_bshd(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        fa.flash_attention_bshd(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        fa.flash_attention_bshd(q.transpose(1, 2), k, v)     # not contiguous
    with pytest.raises(ValueError):
        fa.flash_attention_bshd(q[:, :, :3].contiguous(), k, v)  # 3 % 2
    with pytest.raises(ValueError):
        fa.flash_attention_bshd(q, k.cpu(), v)
    big = torch.zeros(1, 4, 2, 264, device=card)
    with pytest.raises(ValueError):
        fa.flash_attention_bshd(big, big, big)
    with pytest.raises(ValueError):                  # fp32 to wgmma
        fa.launch_kernel(fa.SM90, q, k, v)
    with pytest.raises(ValueError):                  # D % 16 != 0
        odd = torch.zeros(1, 16, 2, 40, device=card, dtype=torch.bfloat16)
        fa.launch_kernel(fa.SM90, odd, odd, odd)
    flat = torch.zeros(2 * 16 * 2 * 32 + 1, device=card,
                       dtype=torch.bfloat16)
    off = flat[1:].view(2, 16, 2, 32)                # 2-byte aligned
    with pytest.raises(ValueError):
        fa.flash_attention_bshd(off, off, off)
    assert fa.launches == before


#: the decode kernel's cases: (B, S, KV, G, D), dtype, window, ring, cap,
#: positions.  granite-8b's decode cell (32 x 4224 slots, positions
#: 4096-4223); gemma2-9b's local layer after its 4096-slot ring wrapped,
#: with its softcap (q times CAP_Q_SCALE); qwen3-moe's D 64 at G 8;
#: whisper-small's decoder (224 slots, G 1); pixtral-12b's D 160; then
#: float32 at D 128 and at D 256 with G 5 (qwen2.5-14b's grouping), a
#: window over a linear cache, bf16 rows off 16 bytes (D 20), G 12 in two
#: chunks (starcoder2-3b's grouping), and a ring before it wraps
DECODE_CASES = [
    ((32, 4224, 8, 4, 128), "bfloat16", 0, False, 0.0,
     [4096 + i * 37 % 128 for i in range(32)]),
    ((2, 4096, 8, 2, 224), "bfloat16", 4096, True, 50.0, [8192, 5000]),
    ((4, 2176, 4, 8, 64), "bfloat16", 0, False, 0.0, [2048, 2100, 2175, 7]),
    ((4, 224, 12, 1, 64), "bfloat16", 0, False, 0.0, [223, 100, 0, 57]),
    ((4, 2176, 8, 4, 160), "bfloat16", 0, False, 0.0, [2175, 2048, 1, 999]),
    ((4, 1000, 8, 4, 128), "float32", 0, False, 0.0, [999, 500, 3, 640]),
    ((2, 700, 8, 5, 256), "float32", 0, False, 30.0, [699, 300]),
    ((3, 3000, 2, 4, 128), "bfloat16", 1000, False, 0.0, [2999, 500, 1500]),
    ((2, 300, 2, 2, 20), "bfloat16", 0, False, 0.0, [299, 10]),
    ((2, 600, 2, 12, 128), "bfloat16", 0, False, 0.0, [599, 333]),
    ((3, 8, 2, 2, 16), "bfloat16", 8, True, 0.0, [0, 3, 7]),
]


def decode_case_id(case):
    (B, S, KV, G, D), dtype, window, ring, cap, _ = case
    return (f"B{B}-S{S}-KV{KV}-G{G}-D{D}-{dtype}-w{window}"
            f"{'-ring' if ring else ''}{f'-cap{cap:g}' if cap else ''}")


def check_decode(got, want):
    # float32: the same float32 sums in another order (ex2.approx and tanhf
    # within a few ulp, scores up to the cap of 50); bf16: both round the
    # same float32 result once, so at most one bf16 step apart
    tol = (dict(rtol=5e-5, atol=5e-5) if got.dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-5))
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("case", DECODE_CASES, ids=decode_case_id)
def test_decode_kernel_matches_plain_version(card, case):
    from repro_torch.kernels import decode_attention as da
    (B, S, KV, G, D), dtype, window, ring, cap, pos = case
    rng = np.random.default_rng(S + D)
    q = rng.standard_normal((B, 1, KV * G, D), dtype=np.float32)
    if cap:
        q *= np.float32(CAP_Q_SCALE)
    k, v = (rng.standard_normal((B, S, KV, D), dtype=np.float32)
            for _ in range(2))
    q, k, v = (torch.from_numpy(x).to(device=card, dtype=getattr(torch, dtype))
               for x in (q, k, v))
    pos = torch.tensor(pos, dtype=torch.int32, device=card)
    kw = dict(window=window, ring=ring, cap=cap)
    splits = da.splits_for(B, KV, G, S, window)
    before = da.launches
    got = da.decode_attention_bshd(q, k, v, pos, **kw)
    one = da._launch(q, k, v, pos.long(), window, ring, cap, D ** -0.5, 1)
    torch.cuda.synchronize()
    assert da.launches == before + 2
    check_decode(got, da.decode_attention_reference(q, k, v, pos,
                                                    splits=splits, **kw))
    check_decode(one, da.decode_attention_reference(q, k, v, pos, **kw))


def test_decode_step_launches_the_decode_kernel_once_a_layer(card):
    """A granite-8b smoke decode step on the card: one launch of the
    decode kernel a layer, by the wrapper's count and the kernel's own,
    and logits within 0.12 of the same step on the CPU."""
    from repro_torch import configs as C
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch import serve as S
    from repro_torch.models import transformer as M
    cfg = C.get_smoke("granite-8b")
    params = M.init_params(cfg, seed=0, device="cpu")
    tokens = S.make_tokens(cfg, 2, 8, seed=1, device="cpu")

    def step(device):
        def to(tree):
            if isinstance(tree, dict):
                return {k: to(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [to(v) for v in tree]
            return tree.to(device)
        with torch.inference_mode():
            _, cache = M.prefill(to(params), cfg, tokens[:, :7].to(device),
                                 max_seq=12)
            pos = torch.full((2,), 7, dtype=torch.int32, device=device)
            logits, _ = M.decode_step(to(params), cfg,
                                      tokens[:, 7:].to(device), cache, pos)
        return logits

    want = step("cpu")
    da.device_launches(reset=True)
    before = da.launches
    got = step(card)
    torch.cuda.synchronize()
    assert da.launches - before == cfg.n_layers
    assert da.device_launches() == cfg.n_layers
    diff = float((got.cpu().float() - want.float()).abs().max())
    print(f"granite-8b smoke decode, card vs CPU: max |diff| {diff}")
    assert diff <= 0.12


def test_activity_consumers_on_the_card_like_on_the_cpu(card, tmp_path):
    """chip_smoke.py's phase 7 at 4 x 4096 records: the mirror, policy
    engine, aggregator, audit trail and metrics database over a cluster
    routing on the card end in the same state as over one routing on
    the CPU, every routing chunk is one kernel launch, and each run holds
    against the plain reckoning from the generator's arrays."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    journals = {f"mdt{m}": smoke.make_journal_arrays(m, 4096, 1)
                for m in range(4)}
    states = []
    for device in ("cuda", "cpu"):
        before = stream_ops.launches
        run = smoke.run_activity(journals, device,
                                 str(tmp_path / f"{device}.db"),
                                 batch_size=256)
        launched = stream_ops.launches - before
        smoke.verify_activity(run, journals)
        states.append(smoke.consumer_state(run))
        run["mdb"].close()
        chunks = run["cluster"].routing_launches
        assert launched == (chunks if device == "cuda" else 0)
        assert 0 < chunks < run["cluster"].routing_reads
    assert states[0] == states[1]


def elastic_runs(build, n: int):
    """``build(pkg, records)`` with routing on the card and on the CPU:
    each run and the ``fid_slots`` launches it made."""
    smoke = load_smoke()
    journals = {f"mdt{m}": smoke.make_journal_arrays(m, n, 2)
                for m in range(4)}
    out = []
    for device in ("cuda", "cpu"):
        pkg = smoke.port_modules()
        pkg.kw = {"device": device}
        records = {pid: smoke.journal_records(pkg.R, j, 0, n)
                   for pid, j in journals.items()}
        before = stream_ops.launches
        run = build(smoke, pkg, records)
        out.append((run, stream_ops.launches - before))
    return smoke, journals, out


def test_elastic_run_on_the_card_like_on_the_cpu(card):
    """chip_smoke.py's phase 7a (c) at 4 x 4096 records: migrations under
    backpressure, a split, a migration cancelled by its source's death
    and a replay bootstrap deliver byte for byte the same with routing
    on the card as on the CPU, with the same stats, epoch, owners and
    journal acks; every routing chunk of the card's run, at every call
    site, is one kernel launch."""
    n, cap = 4096, 1024
    smoke, journals, ((gpu, launched), (cpu, none)) = elastic_runs(
        lambda smoke, pkg, recs: smoke.run_elastic(pkg, recs, cap, 256), n)
    for run in (gpu, cpu):
        smoke.verify_elastic(run, journals, cap)
    for key in ("trace", "stats", "routing", "journal_acked", "alive",
                "facts"):
        assert gpu[key] == cpu[key], key
    assert launched == gpu["routing_launches"] > 0 and none == 0
    assert gpu["sites"]["launches"] == gpu["sites"]["chunks"]


def test_federation_on_the_card_like_on_the_cpu(card):
    """chip_smoke.py's phase 7a (d) at 2 x 4096 records a filesystem: the
    two-filesystem federation through a detach and resume, a graceful
    migration in fs0 and a shard killed in fs1 delivers the same records
    and ends at the same cursor with routing on the card as on the
    CPU."""
    smoke, _journals, ((gpu, launched), (cpu, none)) = elastic_runs(
        lambda smoke, pkg, recs: smoke.run_federation(pkg, recs), 4096)
    for run in (gpu, cpu):
        smoke.verify_federation(run)

    def delivered(run):
        return sorted((key, i) for key, idx in run["deliveries"]
                      for i in idx.tolist())
    assert delivered(gpu) == delivered(cpu)
    assert gpu["cursor"] == cpu["cursor"] == gpu["last"]
    assert gpu["stats"] == cpu["stats"]
    assert launched == gpu["routing_launches"] > 0 and none == 0


def test_proxy_chain_on_the_card_like_on_the_cpu(card):
    """chip_smoke.py's phase 7b (a) at 4 x 4096 MDT records and 2 x 1024
    training records: the four stream modules, audit, four tenant groups
    and tenant dd's quota, parked and lifted around a shard added and
    migrated to, deliver byte for byte the same with routing on the card
    as on the CPU, with the same stats, epoch, owners, journal acks and
    facts; every routing chunk of the card's run, at every call site, is
    one kernel launch."""
    smoke = load_smoke()
    journals = smoke.proxy_journals(4096, 1024, 2)
    runs = []
    for device in ("cuda", "cpu"):
        pkg = smoke.port_modules()
        pkg.kw = {"device": device}
        records = {pid: smoke.journal_records(pkg.R, j, 0, len(j[1]))
                   for pid, j in journals.items()}
        before = stream_ops.launches
        run = smoke.run_proxy_chain(pkg, records)
        runs.append((run, stream_ops.launches - before))
    cols = smoke.journal_columns(records)
    (gpu, launched), (cpu, none) = runs
    for run in (gpu, cpu):
        smoke.verify_proxy_chain(run, cols)
    for key in ("trace", "stats", "routing", "journal_acked", "facts"):
        assert gpu[key] == cpu[key], key
    assert launched == gpu["routing_launches"] > 0 and none == 0
    assert gpu["sites"]["launches"] == gpu["sites"]["chunks"]


TRAIN_ARCHS = ["starcoder2-3b", "granite-moe-1b-a400m", "mamba2-780m",
               "whisper-small"]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_the_card_like_on_the_cpu(card, arch):
    """chip_smoke.py's phase 8 (c), and 8a-8c's, at the smoke config: one
    training step on the card and on the CPU from the same weights and
    batch (whisper's with its frames), loss and grad norm within 2e-2
    relative, lr equal."""
    import importlib.util
    from pathlib import Path
    from repro_torch import configs as C
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = C.get_smoke(arch)
    extra = (smoke.frame_extras(cfg, 0)(4, 0) if cfg.is_encoder_decoder
             else None)
    before = (stream_ops.launches, fa.launches)
    out = smoke.train_card_vs_cpu(cfg, 4, 32, 0, extra)
    assert out["cuda"]["lr"] == out["cpu"]["lr"]
    assert (stream_ops.launches, fa.launches) == before


@pytest.mark.parametrize("arch", TRAIN_ARCHS[1:])
def test_train_family_phase_at_smoke_size(card, arch):
    """chip_smoke.py's phases 8a-8c (``train_family_phase``) at the smoke
    config: every check of the phase passes (finite losses and grad
    norms, the schedule's lr, MetricsDB rows and the restart probe but
    for whisper, card vs CPU), and no kernel is launched."""
    from repro_torch import configs as C
    smoke = load_smoke()
    cfg = C.get_smoke(arch)
    tag = {"moe": "moe-train", "ssm": "ssm-train", "audio": "audio-train"}[
        cfg.family]
    out = smoke.train_family_phase(cfg, tag, 0, "test", seq=32)
    assert out["launches_by_kernel"] == {
        "fid_slots": 0, fa.SM90: 0, fa.SIMT: 0}
    assert len(out["step_ms"]) == smoke.TRAIN_TIMED_STEPS
    assert (out["restart"] is None) == cfg.is_encoder_decoder
    assert (out["metricsdb_rows"] is None) == cfg.is_encoder_decoder
    assert ("dropped_share" in out) == bool(cfg.n_experts)


def test_trainer_feeds_no_frames():
    """Why phase 8c drives ``build_train_step`` directly: the Trainer
    feeds only the pipeline's tokens and labels, as the reference's
    does (``src/repro/runtime/train_loop.py:113-116``), so an
    encoder-decoder's first step finds no frames.  Runs on the CPU."""
    import tempfile
    from repro_torch import configs as C
    from repro_torch.runtime.train_loop import Trainer
    with tempfile.TemporaryDirectory() as wd:
        trainer = Trainer(C.get_smoke("whisper-small"), workdir=wd,
                          global_batch=2, seq_len=8, device="cpu")
        try:
            with pytest.raises(ValueError, match="frames"):
                trainer.run(1)
        finally:
            trainer.close()


def test_flash_kernel_refuses_inputs_that_need_grad(card):
    """The kernel writes through a raw pointer with no autograd node: a
    call that would need q, k or v's gradient raises instead of giving
    none."""
    q, k, v = qkv((1, 64, 64, 4, 2, 64), "bfloat16", seed=3, device=card)
    before = fa.launches
    for t in (q, k, v):
        t.requires_grad_(True)
        with pytest.raises(NotImplementedError, match="forward only"):
            fa.flash_attention_bshd(q, k, v)
        t.requires_grad_(False)
    assert fa.launches == before
    with torch.no_grad():
        q.requires_grad_(True)
        assert fa.flash_attention_bshd(q, k, v).shape == q.shape
    assert fa.launches == before + 1


def load_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "qwen3-moe-30b-a3b", "jamba-v0.1-52b"])
def test_moe_layer_on_the_card_like_on_the_cpu(card, arch):
    """chip_smoke.py's phase 9 and 10a layer check at the full config's
    width: the first MoE layer (jamba-v0.1-52b's is layer 1) in float32,
    the same weights and input on both devices; top_e, pos and keep
    equal, the output within 1e-5."""
    from repro_torch import configs as C
    from repro_torch.models import transformer as M
    smoke = load_smoke()
    cfg = C.get_config(arch)
    l = smoke.first_layer(cfg, cfg.layer_is_moe)
    cfg = cfg.replace(n_layers=l + 1)
    params = M.init_params(cfg, seed=0, device="cpu")
    out = smoke.moe_card_vs_cpu(cfg, params["layers"][l]["moe"], 2, 64, 0)
    assert out["ok"], out


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-v0.1-52b"])
def test_ssd_layer_on_the_card_like_on_the_cpu(card, arch):
    """chip_smoke.py's phase 10 and 10a layer check at the full config's
    width (mamba2-780m's 48 heads, jamba-v0.1-52b's 128): one SSD layer
    in float32 over 300 tokens (two chunks, the second cut short), its
    cache and two decode steps within 1e-4."""
    from repro_torch import configs as C
    from repro_torch.models import transformer as M
    smoke = load_smoke()
    cfg = C.get_config(arch).replace(n_layers=1)
    assert cfg.layer_kind(0) == "ssm"
    params = M.init_params(cfg, seed=0, device="cpu")
    out = smoke.ssd_card_vs_cpu(cfg, params["layers"][0]["ssm"], 2, 300, 0)
    assert out["ok"], out


def test_encoder_decoder_layers_on_the_card_like_on_the_cpu(card):
    """chip_smoke.py's phase 12 layer check at whisper-small's width:
    one encoder layer over 1500 frames, then one decoder layer over 224
    positions with its cross attention to it, in float32; both outputs
    and the cross k/v within 1e-4 of the CPU's."""
    from repro_torch import configs as C
    from repro_torch.models import transformer as M
    smoke = load_smoke()
    cfg = C.get_config("whisper-small").replace(n_layers=1,
                                                n_encoder_layers=1)
    params = M.init_params(cfg, seed=0, device="cpu")
    out = smoke.encdec_card_vs_cpu(cfg, params, 2, cfg.n_frames, 224, 0)
    assert out["ok"], out


@pytest.fixture
def nccl_mesh(card, tmp_path):
    """A one-rank NCCL process group (a FileStore under ``tmp_path``, no
    TCP port) and ``make_elastic_mesh(1)``'s (1, 1) ``DeviceMesh`` on the
    card; the group is destroyed afterwards."""
    import torch.distributed as dist
    from repro_torch.runtime.elastic import make_elastic_mesh
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        yield make_elastic_mesh(1, device="cuda")
    finally:
        dist.destroy_process_group()


def test_one_rank_nccl_mesh_runs_the_unsharded_operations(nccl_mesh):
    """chip_smoke.py's phase 13 at the smoke config: granite-8b placed by
    ``prefill_cell``'s placements on the (1, 1) mesh, a flash prefill
    (one wgmma launch a layer, through ``local_map``) and two decode
    steps under the rules equal to the same run without them within
    1e-3, and a training step's loss and grad norm within 1e-4."""
    from repro_torch import configs as C
    from repro_torch.models import transformer as M
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as SH, specs as SP
    from repro_torch.runtime.steps import TrainHParams, build_train_step
    cfg = C.get_smoke("granite-8b")
    assert nccl_mesh.shape == (1, 1)
    rules = SP.cell_rules(cfg, ShapeConfig("p", 32, 2, "prefill"), nccl_mesh)
    params = M.init_params(cfg, seed=0, device="cuda")
    placed = SP.place(rules, params, M.param_axes(cfg))
    _, (p_shard, _), _ = SP.prefill_cell(cfg, ShapeConfig("p", 32, 2,
                                                          "prefill"), rules)
    SP.map_axes(lambda axes, t, want: placed_by(t, want),
                M.param_axes(cfg), placed, p_shard)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(0))
    with torch.inference_mode():
        want, cache = M.prefill(params, cfg, tokens, max_seq=34, impl="flash")
        fa.launches_sm90 = 0
        with SH.use_rules(rules):
            got, cache2 = M.prefill(placed, cfg, tokens, max_seq=34,
                                    impl="flash")
        assert fa.launches_sm90 == cfg.n_layers
        assert float((SH.full(got) - want).abs().max()) <= 1e-3
        tok = torch.argmax(want, -1)[:, None]
        for i in range(2):
            pos = torch.full((2,), 32 + i, dtype=torch.int32, device="cuda")
            want, cache = M.decode_step(params, cfg, tok, cache, pos)
            with SH.use_rules(rules):
                got, cache2 = M.decode_step(placed, cfg, tok, cache2, pos)
            assert float((SH.full(got) - want).abs().max()) <= 1e-3
            tok = torch.argmax(want[:, 0], -1)[:, None]
    # microbatches of two rows: the batch stays sharded (a row of one
    # would be replicated), so the embedding's backward meets a
    # batch-sharded gradient
    hp = TrainHParams(n_micro=2, remat=True, remat_policy="none")
    step = build_train_step(cfg, hp)
    tokens = torch.cat([tokens, tokens.flip(0)])
    batch = {"tokens": tokens.cpu(), "labels": tokens.roll(-1, 1).cpu()}
    p32 = M.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    _, _, want = step(p32, adamw.init(p32), batch)
    p32 = SP.place(rules, M.init_params(cfg, seed=0, device="cuda",
                                        dtype=torch.float32),
                   M.param_axes(cfg))
    with SH.use_rules(rules):
        p32, _, got = step(p32, adamw.init(p32), batch)
    assert SH.is_dtensor(adamw.leaves(p32)[0])
    for k in ("loss", "grad_norm"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-4 * abs(
            float(want[k])), k


def test_wgmma_kernel_through_local_map(nccl_mesh):
    """DTensor q/k/v on the one-rank mesh (sharded by batch and heads)
    reach the wgmma kernel once through ``local_map`` and give what the
    plain call gives, bit for bit."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    q, k, v = qkv((2, 256, 256, 8, 2, 128), "bfloat16", 3, "cuda")
    want = fa.flash_attention_bshd(q, k, v)
    qp = [Shard(0), Shard(2)]
    kp = [Shard(0), Replicate()]
    dq = distribute_tensor(q, nccl_mesh, qp)
    dk, dv = (distribute_tensor(t, nccl_mesh, kp) for t in (k, v))
    fa.launches_sm90 = 0
    fa.device_launches(fa.SM90, reset=True)
    got = fa.flash_attention_bshd(dq, dk, dv)
    assert fa.launches_sm90 == 1 and fa.device_launches(fa.SM90) == 1
    assert list(got.placements) == qp
    assert torch.equal(got.full_tensor(), want)


def test_compressed_psum_over_one_nccl_rank(nccl_mesh):
    """chip_smoke.py's phase 13 (c) at a small size: over one rank the
    mean is the dequantized gradient, within half a quantization step of
    it (and float32 rounding), and the error buffer is exactly what was
    lost."""
    from repro_torch.optim import compress
    from repro_torch.optim.adamw import leaves
    g = {"a": torch.randn(64, 32, device="cuda"),
         "b": [torch.randn(7, device="cuda")]}
    err = {"a": torch.zeros(64, 32, device="cuda"),
           "b": [torch.zeros(7, device="cuda")]}
    mean, new_err = compress.compressed_psum(g, err)
    for gl, ml, el in zip(*(leaves(t) for t in (g, mean, new_err))):
        scale = gl.abs().max() / 127.0 + 1e-12
        # half a step, and room for the float32 rounding of g / scale and
        # q * scale (each under 2^-17 of a step at |q| <= 127)
        assert float((ml - gl).abs().max()) <= float(scale) * (0.5 + 2 ** -15)
        assert torch.equal(el, gl - ml)


def placed_by(t, placements):
    assert list(t.placements) == list(placements)



@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-780m",
                                  "jamba-v0.1-52b", "pixtral-12b",
                                  "whisper-small"])
def test_family_body_on_a_one_rank_nccl_mesh(nccl_mesh, arch):
    """One scan body of each family's smoke config (jamba's eight layers:
    attention, SSD, MoE; whisper's with one encoder layer) placed on the
    (1, 1) NCCL mesh: the MoE router, dispatch and combine, the SSD scan
    and decode step, the image embeddings and the encoder run through
    ``local_map`` and DTensor's rules on the card's torch, and give a
    prefill and a decode step within 1e-3 and a training step's loss
    within 1e-4 of the same run without the mesh."""
    from repro_torch import configs as C
    from repro_torch.launch import serve as S
    from repro_torch.models import transformer as M
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as SH, specs as SP
    from repro_torch.runtime.steps import TrainHParams, build_train_step
    smoke = C.get_smoke(arch)
    cfg = smoke.replace(n_layers=smoke.scan_period, n_encoder_layers=min(
        smoke.n_encoder_layers, 1))
    rules = SP.cell_rules(cfg, ShapeConfig("t", 32, 4, "train"), nccl_mesh)
    batch = S.make_batch(cfg, 4, 32, seed=1, device="cuda")
    tokens = batch.pop("tokens")
    params = M.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    placed = SP.place(rules, params, M.param_axes(cfg))
    with torch.inference_mode():
        want, cache = M.prefill(params, cfg, tokens, max_seq=34, **batch)
        with SH.use_rules(rules):
            got, cache2 = M.prefill(placed, cfg, tokens, max_seq=34,
                                    **batch)
        assert float((SH.full(got) - want).abs().max()) <= 1e-3
        tok = torch.argmax(want, -1)[:, None]
        pos = torch.full((4,), 32, dtype=torch.int32, device="cuda")
        want, _ = M.decode_step(params, cfg, tok, cache, pos)
        with SH.use_rules(rules):
            got, _ = M.decode_step(placed, cfg, tok, cache2, pos)
        assert float((SH.full(got) - want).abs().max()) <= 1e-3
    step = build_train_step(cfg, TrainHParams(n_micro=2, remat=True,
                                              remat_policy="none"))
    train = {"tokens": tokens.cpu(), "labels": tokens.roll(-1, 1).cpu(),
             **{k: v.cpu() for k, v in batch.items()}}
    p32 = M.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    _, _, want = step(p32, adamw.init(p32), train)
    p32 = SP.place(rules, M.init_params(cfg, seed=0, device="cuda",
                                        dtype=torch.float32),
                   M.param_axes(cfg))
    with SH.use_rules(rules):
        _, _, got = step(p32, adamw.init(p32), train)
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-4 * abs(
        float(want["loss"]))
