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

csrc/kron_tile.cuh is the block routine of chain_fwd, chain_bwd and sliced;
csrc/kron_async.cuh holds the Hopper pieces of grad and sliced_t (the
cp.async ring, the register-tiled step, the persistent dF accumulator, the
bf16 mma.sync step).
"""
