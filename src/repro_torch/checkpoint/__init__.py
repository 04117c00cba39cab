"""Atomic, content-verified checkpoints (:mod:`.checkpoint`), the layout
the JAX package writes."""

from .checkpoint import (AsyncCheckpointer, latest_step, read_manifest,
                         restore_checkpoint, save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "read_manifest", "AsyncCheckpointer"]
