"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version: ``stream_ops`` (FID-slot routing, CUDA C++) and
``flash_attention`` (forward attention, CUDA C++), with ``ops`` holding
the model-facing attention call.  ``_build`` compiles and loads them."""

from . import flash_attention, ops, stream_ops

__all__ = ["flash_attention", "ops", "stream_ops"]
