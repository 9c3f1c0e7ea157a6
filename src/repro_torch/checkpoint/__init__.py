"""Pytree checkpointing in the reference's format: MessagePack + zstd (zlib
where ``zstandard`` is missing), round-robin retention."""
from .checkpoint import (CheckpointManager, compressor, load_pytree,
                         save_pytree)

__all__ = ["CheckpointManager", "compressor", "load_pytree", "save_pytree"]
