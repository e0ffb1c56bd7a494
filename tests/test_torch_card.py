"""The kernels on the card.  ``fid_slots_rows`` on CUDA tensors
launches the hand-written routing kernel, which must agree bit for bit
with its plain PyTorch version (integer slots: tolerance 0), count its
launches, and route a small cluster run exactly as routing on the CPU
does.  ``flash_attention_bshd`` on CUDA tensors launches the attention
kernel, which must agree with its plain version within the reference's
own tolerances (``tests/test_kernels.py``: 2e-5 for float32, 2e-2 for
bfloat16) at every case of that file, give 0 on fully masked rows, and
refuse what it does not take.

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

N_SLOTS = (1, 64, 65535, 65536, 1000003)
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


def qkv(shape, dtype, seed, device):
    B, Sq, Sk, H, KV, D = shape
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    return tuple(torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                 .to(device=device, dtype=dt)
                 for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D)))


def header_rows(n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    hdr = np.zeros(n + len(EDGE_FIDS), dtype=T.HDR_DTYPE)
    hdr["tseq"][:n] = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    hdr["toid"][:n] = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    hdr["tver"][:n] = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    for j, (s, o, v) in enumerate(EDGE_FIDS):
        hdr[n + j]["tseq"], hdr[n + j]["toid"], hdr[n + j]["tver"] = s, o, v
    return torch.from_numpy(hdr.view(np.uint8).reshape(len(hdr), 64).copy())


@pytest.mark.parametrize("n_slots", N_SLOTS)
def test_kernel_matches_plain_version(card, n_slots):
    rows = header_rows(1 << 16, seed=n_slots)
    before = stream_ops.launches
    got = stream_ops.fid_slots_rows(rows.to(card), n_slots)
    torch.cuda.synchronize()
    assert stream_ops.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.int64
    assert torch.equal(got.cpu(),
                       stream_ops.fid_slots_rows_reference(rows, n_slots))


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
        return out, cluster.routing_reads
    before = stream_ops.launches
    on_card, reads = run("cuda")
    assert stream_ops.launches - before == reads > 0
    assert on_card == run("cpu")[0]


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "-".join(map(str, c[0])) +
                         f"-{c[1]}-causal{int(c[2])}-w{c[3]}-cap{c[4]:g}")
def test_flash_kernel_matches_plain_version(card, case):
    shape, dtype, causal, window, cap = case
    q, k, v = qkv(shape, dtype, seed=sum(shape), device=card)
    before = fa.launches
    got = fa.flash_attention_bshd(q, k, v, causal=causal, window=window,
                                  cap=cap)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert got.shape == q.shape and got.dtype == q.dtype
    want = fa.flash_attention_reference(q, k, v, causal=causal,
                                        window=window, cap=cap)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if shape == (1, 64, 16, 2, 1, 32):
        assert bool((got[:, 20:] == 0).all())


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
    assert fa.launches == before
