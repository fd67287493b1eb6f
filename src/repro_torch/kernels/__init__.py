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
cg_update.py    — conjugate gradients' vector updates as three fused passes
                  an iteration: ``FusedCG`` (csrc/cg_update.cu); the eager
                  updates of ``gp.ski.conjugate_gradient`` are its twin.
ops.py          — sliced-multiply (and transpose) backend dispatch, with
                  the reference's ``tiles=`` limit, and the six deprecated
                  ``fused_kron*`` one-instruction shims over emit.
kron_fused.py   — DEPRECATED shims: the reference's fused forward entry
                  points, over emit (no kernel of their own).
kron_fused_t.py — DEPRECATED shims: its transposed/backward entry points.
ref.py          — plain PyTorch oracles for the tests.
_launch.py      — the one boundary with the libraries: ctypes, dtype codes,
                  occupancy queries, the persistent grid, the ``launch``
                  span, the dry-run short-cut and the launch counts.
_build.py       — builds csrc/*.cu with nvcc at the first launch and loads
                  them.

csrc/kron_async.cuh holds the Hopper pieces all five kernels share (the
cp.async copies, the register-tiled step, the chain kernels' arguments and
walk, the persistent dF accumulator, the bf16 mma.sync step);
csrc/kron_tile.cuh the scalar helpers under it (conversions, vector loads
and stores, div_fast).
"""
