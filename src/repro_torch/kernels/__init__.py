"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version: ``stream_ops`` (FID-slot routing, CUDA C++),
``flash_attention`` (forward attention, two CUDA C++ kernels: wgmma
and TMA for bf16, CUDA cores otherwise), with ``ops`` holding
the model-facing attention call, and ``decode_attention`` (one token's
attention over a KV cache, split over the cache's slots, CUDA C++).
``_build`` compiles and loads them."""

from . import decode_attention, flash_attention, ops, stream_ops

__all__ = ["decode_attention", "flash_attention", "ops", "stream_ops"]
