"""repro_torch — the PyTorch/CUDA port of the activity-tracking system.

A second package beside ``repro`` (the JAX reference, which it never
imports).  It ports the reference slice by slice:

- the sharded changelog pipeline: records, journals, the LCAP proxy,
  the FID-hash cluster, the consumer sessions, the wire and the
  federation (``core``), with the cluster's routing hash as a
  hand-written CUDA kernel (``kernels.stream_ops``);
- the activity consumers: the metrics registry, windowed aggregation,
  Prometheus/Ganglia export and the ``top`` view (``obs``), the
  namespace mirror, policy engine and reconciler (``policy``), and the
  metrics database, checkpoint, straggler, elastic and audit consumers
  (``track``);
- the dense model serving path: configs, layers, the decoder-only
  transformer's prefill and decode (``configs``, ``models``, ``runtime``),
  the activity tracker and cache invalidator (``track``) and the serving
  launcher (``launch.serve``), with attention as a hand-written CUDA
  kernel (``kernels.flash_attention``);
- training on one device with its activity: the loss and per-layer
  remat (``models``), AdamW (``optim``), the token pipeline (``data``),
  checkpoints interchangeable with the reference's (``checkpoint``), the
  training step, straggler mitigation, the one-device elastic mesh and
  the trainer (``runtime``), and the training launcher
  (``launch.train``);
- the sharded path: the reference's logical sharding rules as DTensor
  placements over a ``DeviceMesh`` (``runtime.sharding``,
  ``runtime.specs``, ``launch.mesh``), the int8 error-feedback
  all-reduce (``optim.compress``) and the attention oracle
  (``kernels.ref``).

See ROADMAP.md for what is still to come.
"""

from . import (checkpoint, configs, core, data, kernels, models, obs, optim,
               policy, runtime, track)

__all__ = ["checkpoint", "configs", "core", "data", "kernels", "models",
           "obs", "optim", "policy", "runtime", "track"]
