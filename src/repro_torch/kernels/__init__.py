"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version: ``stream_ops`` (FID-slot routing, CUDA C++)."""

from . import stream_ops

__all__ = ["stream_ops"]
