"""Optimizer of the port: AdamW (``adamw``) and the int8 error-feedback
all-reduce of the data-parallel gradients (``compress``)."""

from . import adamw, compress
from .adamw import AdamWState, cosine_lr

__all__ = ["adamw", "compress", "AdamWState", "cosine_lr"]
