"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version: ``stream_ops`` (FID-slot routing, CUDA C++) and
``flash_attention`` (forward attention, two CUDA C++ kernels: wgmma
and TMA for bf16, CUDA cores otherwise), with ``ops`` holding
the model-facing attention call.  ``_build`` compiles and loads them."""

from . import flash_attention, ops, stream_ops

__all__ = ["flash_attention", "ops", "stream_ops"]
