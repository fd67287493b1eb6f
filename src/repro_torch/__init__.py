"""repro_torch — FastKron Kron-Matmul in PyTorch with hand-written CUDA kernels.

The PyTorch/CUDA port of the ``repro`` package, laid out module for module
like it: ``repro.X.Y`` and ``repro_torch.X.Y`` name the same thing.  The port
imports ``torch`` and never ``jax`` or ``repro``.  An op runs where its
tensors are: CUDA tensors go through the kernels in ``kernels/csrc``, CPU
tensors through each kernel's plain PyTorch twin.
"""

__version__ = "0.1.0"
