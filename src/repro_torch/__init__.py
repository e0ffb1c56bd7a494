"""repro_torch — the PyTorch/CUDA port of the activity-tracking system.

A second package beside ``repro`` (the JAX reference, which it never
imports).  It ports the reference slice by slice; this slice is the
sharded changelog pipeline, in process: records, journals, the LCAP
proxy, the FID-hash cluster and the consumer sessions (``core``), with
the cluster's routing hash as a hand-written CUDA kernel
(``kernels.stream_ops``).  See ROADMAP.md for what is still to come.
"""

from . import core, kernels

__all__ = ["core", "kernels"]
