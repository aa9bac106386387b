"""Atomic checkpoints in the JAX package's on-disk format."""

from repro_torch.checkpoint.checkpointer import Checkpointer, flatten_with_path, treedef_token

__all__ = ["Checkpointer", "flatten_with_path", "treedef_token"]
