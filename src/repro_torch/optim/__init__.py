"""Optimizers and schedules (counterpart of ``repro.optim``)."""
from .optimizers import OptState, apply_optimizer, init_optimizer  # noqa: F401
from .schedules import warmup_cosine  # noqa: F401
