"""Runtime of the port: logical sharding rules over a ``DeviceMesh``
(``sharding``), the input specs of every cell (``specs``), step builders
(``steps``), elastic meshes (``elastic``), straggler mitigation
(``straggler``) and the trainer with its activity tracking
(``train_loop``).

Submodules load on first use: the model code imports ``sharding``, and
the rest import the model code."""

import importlib

__all__ = ["elastic", "sharding", "specs", "steps", "straggler",
           "train_loop"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
