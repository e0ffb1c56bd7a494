"""repro_torch — the PyTorch/CUDA port of the activity-tracking system.

A second package beside ``repro`` (the JAX reference, which it never
imports).  It ports the reference slice by slice:

- the sharded changelog pipeline, in process: records, journals, the
  LCAP proxy, the FID-hash cluster and the consumer sessions (``core``),
  with the cluster's routing hash as a hand-written CUDA kernel
  (``kernels.stream_ops``);
- the dense model serving path: configs, layers, the decoder-only
  transformer's prefill and decode (``configs``, ``models``, ``runtime``),
  the activity tracker and cache invalidator (``track``) and the serving
  launcher (``launch.serve``), with attention as a hand-written CUDA
  kernel (``kernels.flash_attention``).

See ROADMAP.md for what is still to come.
"""

from . import configs, core, kernels, models, runtime, track

__all__ = ["configs", "core", "kernels", "models", "runtime", "track"]
