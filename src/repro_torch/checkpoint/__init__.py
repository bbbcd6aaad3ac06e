"""Checkpoints in the JAX package's on-disk format (``repro.checkpoint``)."""
from .store import latest_step, restore_checkpoint, save_checkpoint  # noqa: F401
