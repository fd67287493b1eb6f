"""Training steps: loss, train_step (with microbatch accumulation)."""
from .steps import (  # noqa: F401
    TrainState,
    loss_fn,
    make_train_step,
    prebuild_kron_ops,
    train_state_init,
)
