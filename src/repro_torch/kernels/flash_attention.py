"""Flash attention, forward only (PyTorch / CUDA path).

In the reference this is the Pallas kernel
``repro/kernels/flash_attention.py::_flash_kernel``; here it is a CUDA
kernel written by hand for Hopper (``csrc/flash_attention.cu``), read in
the model's own ``(B, S, heads, D)`` layout.

- ``flash_attention_bshd(q, k, v, *, causal, window, cap, scale)`` is the
  wrapper: q ``(B, Sq, H, D)``, k and v ``(B, Sk, KV, D)``, float32 or
  bfloat16, ``H % KV == 0``, ``D <= 256``; it returns ``(B, Sq, H, D)`` in
  q's type.  On CUDA tensors it launches the kernel and raises on
  anything the kernel does not take; on CPU tensors it runs
  ``flash_attention_reference``.
- ``flash_attention_reference`` is the plain PyTorch version: a masked
  softmax in fp32 with the kernel's semantics (a fully masked row gives
  0, where ``repro/kernels/ref.py`` gives NaN).
- ``launches`` counts kernel launches, so a run can show its attention
  went through the kernel.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use
(``_build``); nothing is compiled or loaded at import time.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

SOURCE = _build.CSRC / "flash_attention.cu"
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since import (or since the caller last reset it)
launches = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int, cap: float) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d (B, S, heads, D), got "
                             f"{list(t.shape)}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    B, _, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k and v must be (B, Sk, KV, D) = "
                         f"({B}, Sk, KV, {D}); got {list(k.shape)}, "
                         f"{list(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"q heads {H} must be a multiple of kv heads "
                         f"{k.shape[2]}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be in [1, {MAX_HEAD_DIM}], got {D}")
    if window < 0 or cap < 0:
        raise ValueError(f"window and cap must be >= 0, got {window}, {cap}")


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int = 0, cap: float = 0.0,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch attention with the kernel's semantics: scores in
    fp32, softcap after the scale, top-left causal mask, sliding window,
    GQA by head groups; a fully masked row gives 0.  Returns q's type."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    kh = k.float().repeat_interleave(G, dim=2)
    vh = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kh) * scale
    if cap:
        s = torch.tanh(s / cap) * cap
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    s = s.masked_fill(~ok, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    o = torch.einsum("bhqk,bkhd->bqhd", p / denom, vh)
    return o.to(q.dtype)


def _bind(lib: ctypes.CDLL) -> None:
    lib.lcap_flash_attention.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.lcap_flash_attention.restype = ctypes.c_int


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         cap: float = 0.0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q ``(B, Sq, H, D)`` over k, v ``(B, Sk, KV, D)``.
    CUDA tensors go through the kernel (or raise); CPU tensors go
    through ``flash_attention_reference``."""
    global launches
    window, cap = int(window), float(cap)
    _check(q, k, v, window, cap)
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         window=window, cap=cap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"q must live on cuda or cpu, not {q.device}")
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if Sk == 0:
        return out.zero_()
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _build.load(SOURCE, _bind)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.lcap_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        B, H, KV, Sq, Sk, D, int(bool(causal)), window, scale, cap,
        _DTYPES[q.dtype], q.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {rc}")
    launches += 1
    return out
