"""Data of the port: the sharded synthetic token pipeline."""

from .pipeline import ShardedTokenPipeline

__all__ = ["ShardedTokenPipeline"]
