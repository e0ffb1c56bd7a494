"""Optimizer of the port: AdamW (``adamw``)."""

from . import adamw
from .adamw import AdamWState, cosine_lr

__all__ = ["adamw", "AdamWState", "cosine_lr"]
