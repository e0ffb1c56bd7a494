"""Checkpoints of the port, interchangeable with the reference's."""

from .ckpt import (AsyncCheckpointer, latest_step, restore_checkpoint,
                   save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "AsyncCheckpointer",
           "latest_step"]
