"""Kernels of the port: hand-written CUDA for Hopper, with plain twins.

emit.py         — StageProgram IR + the executor: ``chain_cuda`` (forward
                  chain, csrc/chain_fwd.cu), ``chain_bwd_cuda`` (transposed
                  chain, csrc/chain_bwd.cu) and ``grad_cuda`` (stage
                  backward, csrc/grad.cu), with plain twins
                  ``chain_reference``, ``chain_bwd_reference``,
                  ``grad_reference``.
kron_sliced.py  — one sliced multiply: ``sliced_multiply_cuda``
                  (csrc/sliced.cu) and ``sliced_multiply_reference``.
kron_sliced_t.py — its transpose: ``sliced_multiply_t_cuda``
                  (csrc/sliced_t.cu) and ``sliced_multiply_t_reference``.
ops.py          — sliced-multiply (and transpose) backend dispatch.
ref.py          — plain PyTorch oracles for the tests.
_build.py       — builds csrc/*.cu with nvcc at the first launch; ctypes.

csrc/kron_async.cuh holds the Hopper pieces all five kernels share (the
cp.async copies, the register-tiled step, the chain kernels' arguments and
walk, the persistent dF accumulator, the bf16 mma.sync step);
csrc/kron_tile.cuh the scalar helpers under it (conversions, vector loads
and stores, div_fast).
"""
