"""Optimizer substrate: AdamW + schedules + gradient compression, and the
Kron-factored Shampoo preconditioner routed through the KronOp engine."""
from .adamw import OptConfig, opt_init, opt_update, lr_at  # noqa: F401
from .shampoo import (  # noqa: F401
    ShampooConfig,
    shampoo_init,
    shampoo_update,
    opt_for,
    state_memory_report,
)
