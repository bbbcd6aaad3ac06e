"""Training (counterpart of ``repro.train``): the chunked loss, the step and
the fault-tolerant trainer."""
from .losses import chunked_cross_entropy  # noqa: F401
from .step import (  # noqa: F401
    TrainState,
    build_train_step,
    init_train_state,
    loss_and_grads,
    loss_fn,
)
from .trainer import Trainer, TrainerReport  # noqa: F401
