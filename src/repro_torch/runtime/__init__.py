"""Runtime of the port: the serving step builders (``steps``)."""

from . import steps

__all__ = ["steps"]
