"""Training and serving steps: loss, train_step (with microbatch
accumulation), prefill_step, serve_step."""
from .steps import (  # noqa: F401
    TrainState,
    loss_fn,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    prebuild_kron_ops,
    train_state_init,
)
