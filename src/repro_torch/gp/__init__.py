"""Gaussian-process substrate for the paper's §6.4 case study (SKI/KISS-GP)."""
from .ski import (  # noqa: F401
    BatchedKronKernel,
    KronKernel,
    conjugate_gradient,
    gp_train_epoch,
    gp_train_epoch_batched,
    interp_matrix,
    rbf_kernel_1d,
)
