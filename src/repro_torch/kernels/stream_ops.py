"""Changelog-stream routing kernel (PyTorch / CUDA path).

The cluster routes every record to a shard by a splitmix64 mix of its
target FID (``core.cluster.fid_slot``).  In the reference that mix is a
Pallas kernel on uint32 limbs (``repro/kernels/stream_ops.py``); here it
is a CUDA kernel written by hand for Hopper (``csrc/fid_slots.cu``) that
reads the FID straight out of the records' 64-byte header rows.

- ``fid_slots_rows(rows, n_slots, out=None)`` is the wrapper: ``rows``
  is a ``uint8 [N, 64]`` header table (``records.HDR_DTYPE`` rows),
  ``out`` an optional int64 ``[N]`` tensor on the same device that
  receives the slots (the cluster's router reuses its own).  On a CUDA
  tensor it launches the kernel, and raises on anything the kernel does
  not take; on a CPU tensor it runs ``fid_slots_rows_reference``.
- ``fid_slots_rows_reference`` is the plain PyTorch version of the same
  function on int64 tensors, used by the CPU tests and as the kernel's
  yardstick on the card.
- ``launches`` counts kernel launches (one per wrapper call that reached
  the card with N > 0), so a run can show its routing went through the
  kernel.

The kernel is compiled with ``nvcc`` for ``sm_90a`` into ``build/`` next
to this file on first use and loaded through ``ctypes`` (``_build``);
nothing is compiled or loaded at import time.  After the first launch
the wrapper keeps the bound C function, so a launch takes no lock.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from ._build import KernelCompileError  # noqa: F401  (importable from here too)

HDR_SIZE = 64
#: byte offset of cr_tfid (seq u64, oid u32, ver u32) within a header row
TFID_OFFSET = 32
MAX_SLOTS = 1 << 31

_C1 = 0xBF58476D1CE4E5B9
_C2 = 0x94D049BB133111EB
_MIX = 0x9E3779B97F4A7C15

SOURCE = _build.CSRC / "fid_slots.cu"

#: kernel launches since import (or since the caller last reset it)
launches = 0


def _signed(c: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= (1 << 63) else c


def _shr(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical ``z >> k`` on int64 bits (torch's int64 ``>>`` is
    arithmetic, so the sign-extended bits are masked off)."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def _check_rows(rows: torch.Tensor, n_slots: int) -> None:
    if not isinstance(rows, torch.Tensor):
        raise TypeError("rows must be a torch.Tensor")
    if rows.dtype != torch.uint8:
        raise TypeError(f"rows must be uint8, got {rows.dtype}")
    if rows.dim() != 2 or rows.shape[1] != HDR_SIZE:
        raise ValueError(f"rows must be [N, {HDR_SIZE}], got "
                         f"{list(rows.shape)}")
    if not rows.is_contiguous():
        raise ValueError("rows must be contiguous")
    if not 1 <= int(n_slots) < MAX_SLOTS:
        raise ValueError(f"n_slots must be in [1, 2^31), got {n_slots}")


def fid_slots_rows_reference(rows: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Plain PyTorch ``fid_slot`` over ``uint8 [N, 64]`` header rows:
    int64 tensors whose wrapping ``*`` is uint64's, masked logical
    shifts, and the unsigned modulus taken through 32-bit halves.
    Returns int64 slots on the rows' device."""
    _check_rows(rows, n_slots)
    n = rows.shape[0]
    if n == 0:
        return torch.empty(0, dtype=torch.int64, device=rows.device)
    tfid = rows[:, TFID_OFFSET:TFID_OFFSET + 16].contiguous()
    seq = tfid[:, 0:8].contiguous().view(torch.int64).reshape(n)
    low32 = 0xFFFFFFFF
    oid = tfid[:, 8:12].contiguous().view(torch.int32).reshape(n) \
        .to(torch.int64) & low32
    ver = tfid[:, 12:16].contiguous().view(torch.int32).reshape(n) \
        .to(torch.int64) & low32
    c1, c2 = _signed(_C1), _signed(_C2)
    z = seq * c1 ^ oid * c2 ^ ver * _signed(_MIX)
    z = (z ^ _shr(z, 30)) * c1
    z = (z ^ _shr(z, 27)) * c2
    z = z ^ _shr(z, 31)
    # z mod n == ((hi mod n) * (2^32 mod n) + lo mod n) mod n; every
    # term stays below 2^62 for n < 2^31, so int64 never overflows
    n_slots = int(n_slots)
    hi = _shr(z, 32)
    lo = z & low32
    return ((hi % n_slots) * ((1 << 32) % n_slots) + lo % n_slots) % n_slots


def _bind(lib: ctypes.CDLL) -> None:
    lib.lcap_fid_slots.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_longlong, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_void_p]
    lib.lcap_fid_slots.restype = ctypes.c_int


def load() -> ctypes.CDLL:
    """The kernel's library, built by nvcc and loaded on first call."""
    global _launch
    lib = _build.load(SOURCE, _bind)
    _launch = lib.lcap_fid_slots
    return lib


#: the library's bound ``lcap_fid_slots``, kept by ``load``
_launch = None


def _check_out(out: torch.Tensor, rows: torch.Tensor) -> None:
    if not isinstance(out, torch.Tensor):
        raise TypeError("out must be a torch.Tensor")
    if out.dtype != torch.int64 or out.shape != (rows.shape[0],):
        raise ValueError(f"out must be int64 [{rows.shape[0]}], got "
                         f"{out.dtype} {list(out.shape)}")
    if out.device != rows.device or not out.is_contiguous():
        raise ValueError("out must be contiguous on the rows' device")


def fid_slots_rows(rows: torch.Tensor, n_slots: int,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Slot of every header row's target FID, as int64 on the rows'
    device, written into ``out`` when it is given.  CUDA rows go through
    the kernel (or raise); CPU rows go through
    ``fid_slots_rows_reference``."""
    global launches
    _check_rows(rows, n_slots)
    if out is not None:
        _check_out(out, rows)
    device = rows.device
    if device.type == "cpu":
        got = fid_slots_rows_reference(rows, n_slots)
        return got if out is None else out.copy_(got)
    if device.type != "cuda":
        raise ValueError(f"rows must live on cuda or cpu, not {device}")
    n = rows.shape[0]
    if out is None:
        out = torch.empty(n, dtype=torch.int64, device=device)
    if n == 0:
        return out
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned")
    if _launch is None:
        load()
    index = device.index
    rc = _launch(rows.data_ptr(), out.data_ptr(), n, int(n_slots), index,
                 torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"fid_slots kernel launch failed: cudaError {rc}")
    launches += 1
    return out
