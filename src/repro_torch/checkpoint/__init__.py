"""Checkpoints in the JAX package's on-disk format (``repro.checkpoint``)."""
from .store import (  # noqa: F401
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
