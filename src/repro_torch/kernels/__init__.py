"""Kernels of the port: hand-written CUDA for Hopper, with plain twins.

emit.py         — StageProgram IR + the executor; ``chain_cuda`` launches
                  the forward chain kernel (csrc/chain_fwd.cu), its plain twin
                  is ``chain_reference``.
kron_sliced.py  — one sliced multiply: ``sliced_multiply_cuda``
                  (csrc/sliced.cu) and ``sliced_multiply_reference``.
ops.py          — sliced-multiply backend dispatch.
ref.py          — plain PyTorch oracles for the tests.
_build.py       — builds csrc/*.cu with nvcc at the first launch; ctypes.
"""
