"""Flash attention, forward only (PyTorch / CUDA path).

In the reference this is the Pallas kernel
``repro/kernels/flash_attention.py::_flash_kernel``; here it is one of two
CUDA kernels written by hand for Hopper, read in the model's own
``(B, S, heads, D)`` layout:

- ``flash_fwd_sm90_kernel`` (``csrc/flash_attention_sm90.cu``): bf16 with
  ``D % 16 == 0``; both products on the tensor cores by ``wgmma``, tiles
  loaded by TMA.  P is rounded to bf16 before P.V.
- ``flash_fwd_kernel`` (``csrc/flash_attention.cu``): float32, and bf16 at
  any other D; both products on the CUDA cores in fp32.

``kernel_for(dtype, head_dim)`` makes that choice, from the dtype and D
alone; the wrapper never falls back from one kernel to the other.

- ``flash_attention_bshd(q, k, v, *, causal, window, cap, scale)`` is the
  wrapper: q ``(B, Sq, H, D)``, k and v ``(B, Sk, KV, D)``, float32 or
  bfloat16, ``H % KV == 0``, ``D <= 256``; it returns ``(B, Sq, H, D)`` in
  q's type.  On CUDA tensors it launches the chosen kernel and raises on
  anything that kernel does not take; on CPU tensors it runs
  ``flash_attention_reference``.  DTensor q, k and v (a model under
  sharding rules) run the same on each rank's local shard of batch and
  heads, through ``local_map``, each rank with the kv heads of its own q
  heads (``runtime.sharding.map_local_heads``).  It is forward only: with
  grad mode on and an input that requires grad it raises on either
  device.
- ``flash_attention_reference`` is the plain PyTorch version: a masked
  softmax in fp32 with the kernels' semantics (a fully masked row gives
  0, where ``repro/kernels/ref.py`` gives NaN).
- ``launches`` counts launches of either kernel, ``launches_sm90`` and
  ``launches_simt`` each kernel's own, so a run can show which kernel
  its attention went through.
- ``device_launches(kernel, reset=...)`` reads the count each kernel keeps
  of itself on the card (block 0 adds one per launch), so a check can hold
  the wrapper's count against the launches that reached the card.

The kernels are compiled with ``nvcc`` for ``sm_90a`` at first use
(``_build``); nothing is compiled or loaded at import time.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..runtime.sharding import is_dtensor, map_local_heads
from . import _build

SOURCE = _build.CSRC / "flash_attention.cu"
SOURCE_SM90 = _build.CSRC / "flash_attention_sm90.cu"
SOURCES = (SOURCE, SOURCE_SM90)
#: the two kernels, by their CUDA names
SM90 = "flash_fwd_sm90_kernel"
SIMT = "flash_fwd_kernel"
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since import (or since the caller last reset them): of
#: either kernel, and of each
launches = 0
launches_sm90 = 0
launches_simt = 0


def kernel_for(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that takes a call: ``SM90`` for bf16 with ``head_dim``
    a multiple of 16, else ``SIMT``."""
    return SM90 if dtype == torch.bfloat16 and head_dim % 16 == 0 else SIMT


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        # the CUDA kernels write their output through a raw pointer, with
        # no autograd node: q, k and v would silently get no gradient
        raise NotImplementedError(
            "flash attention is forward only (neither this kernel nor the "
            "reference's Pallas kernel has a backward pass): call it under "
            "torch.no_grad(), or train with attention 'naive'")


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


def _bind_sm90(lib: ctypes.CDLL) -> None:
    lib.lcap_flash_attention_sm90.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.lcap_flash_attention_sm90.restype = ctypes.c_int
    lib.lcap_flash_attention_sm90_device_launches.argtypes = [
        ctypes.c_int, ctypes.c_int]
    lib.lcap_flash_attention_sm90_device_launches.restype = ctypes.c_longlong


def _bind(lib: ctypes.CDLL) -> None:
    lib.lcap_flash_attention.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.lcap_flash_attention.restype = ctypes.c_int
    lib.lcap_flash_attention_device_launches.argtypes = [
        ctypes.c_int, ctypes.c_int]
    lib.lcap_flash_attention_device_launches.restype = ctypes.c_longlong


def device_launches(kernel: str, *, reset: bool = False,
                    device: int = 0) -> int:
    """Launches of ``kernel`` (``SM90`` or ``SIMT``) on card ``device``
    since its library was loaded or the count last reset, as the kernel
    counted them on the card; ``reset`` restarts the count from 0.  It
    waits for the card's work to finish."""
    if kernel == SM90:
        n = _build.load(SOURCE_SM90, _bind_sm90) \
            .lcap_flash_attention_sm90_device_launches(int(reset), device)
    elif kernel == SIMT:
        n = _build.load(SOURCE, _bind) \
            .lcap_flash_attention_device_launches(int(reset), device)
    else:
        raise ValueError(f"unknown kernel {kernel!r}; {SM90} or {SIMT}")
    if n < 0:
        raise RuntimeError(f"reading {kernel}'s launch count failed: "
                           f"cudaError {-n}")
    return n


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         cap: float = 0.0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q ``(B, Sq, H, D)`` over k, v ``(B, Sk, KV, D)``.
    CUDA tensors go through ``kernel_for``'s kernel (or raise); CPU
    tensors go through ``flash_attention_reference``; DTensors do either
    on each rank's local shard."""
    if is_dtensor(q):
        return map_local_heads(flash_attention_bshd, q, k, v, causal=causal,
                               window=window, cap=cap, scale=scale)
    window, cap = int(window), float(cap)
    _check(q, k, v, window, cap)
    if q.device.type == "cpu":
        scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
        return flash_attention_reference(q, k, v, causal=causal,
                                         window=window, cap=cap, scale=scale)
    return _launch(kernel_for(q.dtype, q.shape[-1]), q, k, v, causal, window,
                   cap, scale)


def launch_kernel(kernel: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, *, causal: bool = True, window: int = 0,
                  cap: float = 0.0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """``flash_attention_bshd`` through a named kernel (``SM90`` or
    ``SIMT``) on CUDA tensors, so a check can hold each kernel against the
    plain version and time the two on the same inputs.  ``SM90`` takes
    only bf16 with D % 16 == 0."""
    window, cap = int(window), float(cap)
    _check(q, k, v, window, cap)
    if kernel not in (SM90, SIMT):
        raise ValueError(f"unknown kernel {kernel!r}; {SM90} or {SIMT}")
    if kernel == SM90 and kernel_for(q.dtype, q.shape[-1]) != SM90:
        raise ValueError(f"{SM90} takes bf16 with D % 16 == 0, not "
                         f"{q.dtype} with D = {q.shape[-1]}")
    return _launch(kernel, q, k, v, causal, window, cap, scale)


def _launch(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: int, cap: float,
            scale: Optional[float]) -> torch.Tensor:
    global launches, launches_sm90, launches_simt
    if q.device.type != "cuda":
        raise ValueError(f"q must live on cuda or cpu, not {q.device}")
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if Sk == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    device = q.device.index or 0
    if kernel == SM90:
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("q, k and v must start at 16-byte aligned "
                             "addresses (tensor maps need it)")
        lib = _build.load(SOURCE_SM90, _bind_sm90)
        rc = lib.lcap_flash_attention_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            KV, Sq, Sk, D, int(bool(causal)), window, scale, cap, device,
            stream)
    else:
        strides = (ctypes.c_longlong * 12)(*(
            s for t in (q, k, v, out) for s in t.stride()[:3]))
        lib = _build.load(SOURCE, _bind)
        rc = lib.lcap_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, B, H, KV, Sq, Sk, D, int(bool(causal)), window, scale,
            cap, _DTYPES[q.dtype], device, stream)
    if rc != 0:
        what = (f"CUresult {-rc} building a tensor map" if rc < 0
                else f"cudaError {rc}")
        raise RuntimeError(f"{kernel} launch failed: {what}")
    launches += 1
    if kernel == SM90:
        launches_sm90 += 1
    else:
        launches_simt += 1
    return out
