"""Runtime of the port: step builders (``steps``), elastic meshes on one
device (``elastic``), straggler mitigation (``straggler``) and the
trainer with its activity tracking (``train_loop``)."""

from . import elastic, steps, straggler, train_loop

__all__ = ["elastic", "steps", "straggler", "train_loop"]
