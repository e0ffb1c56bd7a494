"""repro_torch.track — LCAP as the framework's activity backbone: the
per-host ``ActivityTracker`` producer and the serving runtime's
``CacheInvalidator`` consumer (the rest of ``repro.track`` comes with a
later slice; ROADMAP.md)."""

from .consumers import CacheInvalidator
from .tracker import ActivityTracker

__all__ = ["ActivityTracker", "CacheInvalidator"]
