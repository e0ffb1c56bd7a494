"""Decode attention over a KV cache, split over the cache's slots
(PyTorch / CUDA path).

One query token a sequence attends over its cache, as the model's
``layers.decode_attention`` does after it has written the new row.  The
reference has no kernel for it (its decode attention is jnp einsums that
XLA fuses); here it is one CUDA kernel written by hand for Hopper,
``decode_attn_kernel`` (``csrc/decode_attention.cu``), read in the
cache's own ``(B, S, KV, D)`` layout, with ``decode_attn_merge_kernel``
combining the splits when there are several:

- ``decode_attention_bshd(q, cache_k, cache_v, pos, *, window, ring, cap,
  scale)`` is the wrapper: q ``(B, 1, H, D)``, the caches ``(B, S, KV,
  D)`` (float32 or bfloat16, ``H % KV == 0``, ``D <= 256``), ``pos`` the
  ``(B,)`` int32 or int64 position of each sequence's token.  A slot is
  visible by the rule of the model's ``_decode_k_pos``: slots ``0..pos``
  of a linear cache, the last ``window`` of them when ``window`` is set,
  every slot written so far of a ``ring`` buffer of ``window`` slots.
  Scores in float32, the softcap ``cap`` after the scale, P . V with P in
  float32; the result ``(B, 1, H, D)`` in q's type.  It launches the
  kernel (one launch, or two with several splits) on CUDA tensors and
  raises on anything else, or on anything the kernel does not take (the
  model sends CPU tensors to its own ``attention_core_naive``).  Forward
  only.
- ``splits_for(B, KV, G, n_slots, window)`` is the split count, from the
  shapes alone: enough blocks for about two waves of the card's 132 SMs
  at the blocks an SM that G's instance holds, no split under
  ``MIN_SPLIT_SLOTS`` slots.
- ``decode_attention_reference`` is the plain PyTorch version: the same
  splits, each a masked softmax in float32 giving (max, denominator,
  accumulator), merged as the merge kernel merges them; a sequence with
  nothing visible gives 0.
- ``launches`` counts launches of the attention kernel; ``device_launches``
  reads the count the kernel keeps of itself on the card.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use
(``_build``); nothing is compiled or loaded at import time.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

SOURCE = _build.CSRC / "decode_attention.cu"
#: the kernel, by its CUDA name
KERNEL = "decode_attn_kernel"
MAX_HEAD_DIM = 256
#: query heads a block; a kv head with more takes them in chunks
MAX_HEADS_A_BLOCK = 8
#: the H100's SMs
SMS = 132
#: the fewest visible slots a split takes
MIN_SPLIT_SLOTS = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the attention kernel since import (or since the caller last
#: reset it)
launches = 0


def head_chunks(G: int) -> Tuple[int, int]:
    """``(chunks, heads a chunk)`` for G query heads a kv head: at most
    ``MAX_HEADS_A_BLOCK`` heads a block."""
    hc = -(-G // MAX_HEADS_A_BLOCK)
    return hc, -(-G // hc)


def blocks_per_sm(G: int) -> int:
    """The kernel's blocks resident on an SM at G query heads a kv head:
    three fit its shared memory (64 KB a block), and its launch bounds
    hold the 4-head instance to three; the 8-head instance (more than 4
    heads a block) takes the registers of two."""
    return 3 if head_chunks(G)[1] <= 4 else 2


def splits_for(B: int, KV: int, G: int, n_slots: int, window: int) -> int:
    """Splits of each sequence's visible slots: about two waves of blocks
    over the card, each split at least ``MIN_SPLIT_SLOTS`` slots of the
    longest visible range (``window`` slots of a windowed cache, else all
    ``n_slots``)."""
    longest = min(n_slots, window) if window else n_slots
    units = B * KV * head_chunks(G)[0]
    want = round(2 * SMS * blocks_per_sm(G) / units)
    return max(1, min(want, longest // MIN_SPLIT_SLOTS))


def _visible(pos: torch.Tensor, n_slots: int, window: int,
             ring: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first and last visible slot of each sequence, (B,) int64; empty
    where the last is below the first."""
    p = pos.long()
    hi = p.clamp(max=n_slots - 1)
    lo = torch.zeros_like(p)
    if window and not ring:
        lo = (p - window + 1).clamp(min=0)
    return lo, hi


def decode_attention_reference(q: torch.Tensor, cache_k: torch.Tensor,
                               cache_v: torch.Tensor, pos: torch.Tensor, *,
                               window: int = 0, ring: bool = False,
                               cap: float = 0.0,
                               scale: Optional[float] = None,
                               splits: int = 1) -> torch.Tensor:
    """The kernel's function in plain PyTorch, float32 throughout: each
    sequence's visible slots cut into ``splits`` ranges of
    ``ceil(n / splits)`` slots, each range's (max, denominator,
    accumulator), merged.  Returns ``(B, 1, H, D)`` in q's type."""
    B, _, H, D = q.shape
    S, KV = cache_k.shape[1], cache_k.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    lo, hi = _visible(pos, S, window, ring)
    n = (hi - lo + 1).clamp(min=0)
    chunk = (-(-n // splits)).clamp(min=1)
    slot = torch.arange(S, device=q.device)[None, :]
    rel = slot - lo[:, None]
    seen = (rel >= 0) & (slot <= hi[:, None])
    which = torch.where(seen, rel // chunk[:, None], -1)          # (B, S)
    member = which[:, None, :] == \
        torch.arange(splits, device=q.device)[None, :, None]      # (B, N, S)
    s = torch.einsum("bkgd,btkd->bkgt", q.float().reshape(B, KV, G, D),
                     cache_k.float()) * scale
    if cap:
        s = torch.tanh(s / cap) * cap
    s = torch.where(member[:, None, None], s[:, :, :, None, :],
                    float("-inf"))                                # (B,KV,G,N,S)
    m = s.amax(dim=-1)
    e = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None])
    acc = torch.einsum("bkgnt,btkd->bkgnd", e, cache_v.float())
    den = e.sum(dim=-1)
    mb = m.amax(dim=-1, keepdim=True)
    w = torch.exp(m - torch.where(torch.isinf(mb), 0.0, mb))
    num = (w[..., None] * acc).sum(dim=-2)
    den = (w * den).sum(dim=-1)[..., None]
    out = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)
    return out.reshape(B, 1, H, D).to(q.dtype)


def _check(q, cache_k, cache_v, pos, window: int, ring: bool,
           cap: float) -> None:
    for name, t in (("q", q), ("cache_k", cache_k), ("cache_v", cache_v),
                    ("pos", pos)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
    for name, t in (("q", q), ("cache_k", cache_k), ("cache_v", cache_v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d, got {list(t.shape)}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride along D")
    if cache_v.dtype != cache_k.dtype:
        raise TypeError(f"the caches must share a dtype, got "
                        f"{cache_k.dtype}, {cache_v.dtype}")
    if pos.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"pos must be int32 or int64, got {pos.dtype}")
    if any(t.device != q.device for t in (cache_k, cache_v, pos)):
        raise ValueError("q, the caches and pos must lie on one device")
    B, Sq, H, D = q.shape
    if Sq != 1:
        raise ValueError(f"q must hold one token a sequence, got {Sq}")
    S, KV = cache_k.shape[1], cache_k.shape[2]
    if cache_v.shape != cache_k.shape or cache_k.shape[0] != B or \
            cache_k.shape[3] != D:
        raise ValueError(f"the caches must be (B, S, KV, D) = ({B}, S, KV, "
                         f"{D}); got {list(cache_k.shape)}, "
                         f"{list(cache_v.shape)}")
    if S < 1:
        raise ValueError("the caches hold no slot")
    if H % KV:
        raise ValueError(f"q heads {H} must be a multiple of kv heads {KV}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be in [1, {MAX_HEAD_DIM}], got {D}")
    if pos.shape != (B,) or not pos.is_contiguous():
        raise ValueError(f"pos must be a contiguous ({B},) tensor, got "
                         f"{list(pos.shape)}")
    if window < 0 or cap < 0:
        raise ValueError(f"window and cap must be >= 0, got {window}, {cap}")
    if ring and window != S:
        raise ValueError(f"a ring buffer holds window = {window} slots, "
                         f"not {S}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, cache_k, cache_v)):
        # the kernel writes its output through a raw pointer, with no
        # autograd node
        raise NotImplementedError(
            "decode attention is forward only: call it under "
            "torch.no_grad()")


def _bind(lib: ctypes.CDLL) -> None:
    lib.lcap_decode_attention.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.lcap_decode_attention.restype = ctypes.c_int
    lib.lcap_decode_attention_device_launches.argtypes = [
        ctypes.c_int, ctypes.c_int]
    lib.lcap_decode_attention_device_launches.restype = ctypes.c_longlong


def device_launches(*, reset: bool = False, device: int = 0) -> int:
    """Launches of the attention kernel on card ``device`` since its
    library was loaded or the count last reset, as the kernel counted them
    on the card; ``reset`` restarts the count from 0.  It waits for the
    card's work to finish."""
    n = _build.load(SOURCE, _bind).lcap_decode_attention_device_launches(
        int(reset), device)
    if n < 0:
        raise RuntimeError(f"reading {KERNEL}'s launch count failed: "
                           f"cudaError {-n}")
    return n


def decode_attention_bshd(q: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, pos: torch.Tensor, *,
                          window: int, ring: bool, cap: float,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q ``(B, 1, H, D)`` over the caches ``(B, S, KV, D)``
    at positions ``pos`` ``(B,)``, by the kernel at ``splits_for``'s split
    count; raises on anything the kernel does not take, tensors off CUDA
    included."""
    window, ring, cap = int(window), bool(ring), float(cap)
    _check(q, cache_k, cache_v, pos, window, ring, cap)
    B, _, H, D = q.shape
    S, KV = cache_k.shape[1], cache_k.shape[2]
    scale = float(scale) if scale is not None else D ** -0.5
    return _launch(q, cache_k, cache_v, pos, window, ring, cap, scale,
                   splits_for(B, KV, H // KV, S, window))


def _launch(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
            pos: torch.Tensor, window: int, ring: bool, cap: float,
            scale: float, splits: int) -> torch.Tensor:
    """One call of the kernel at a given split count (checks and timings on
    the card take other counts than ``splits_for``'s)."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, not {q.device}")
    B, _, H, D = q.shape
    S, KV = cache_k.shape[1], cache_k.shape[2]
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    part = None
    if splits > 1:
        hc, gs = head_chunks(H // KV)
        part = torch.empty(B * KV * hc * splits * gs * (D + 2),
                           dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 8)(
        q.stride(0), q.stride(2), *cache_k.stride()[:3],
        *cache_v.stride()[:3])
    lib = _build.load(SOURCE, _bind)
    rc = lib.lcap_decode_attention(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        pos.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None, strides, B, H, KV, S,
        D, splits, window, int(ring), scale, cap, _DTYPES[cache_k.dtype],
        _DTYPES[q.dtype], int(pos.dtype == torch.int64),
        q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError {rc}")
    launches += 1
    return out
