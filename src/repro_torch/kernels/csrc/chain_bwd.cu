// Transposed fused chain: the input cotangent dX of one planned stage, one
// launch per stage.
//
// Replaces: src/repro/kernels/emit.py, _chain_kernel with direction="bwd",
// launched by chain_pallas (emit.py:603).  Same function: dY (B, M,
// prod(Q) * S) and per-sample factors (B, P_i, Q_i) in application order give
// dX (B, M, prod(P) * S) in dY's dtype; the factors' transposes are applied
// last-applied factor first, and partial dX of the Q-tiles (t_qs) are summed
// in the accumulator type before dX is rounded once.
//
// What bounds it on an H100: bytes and operations are close, as for the
// forward chain.  A stage reads dY once and writes dX once (3.35 TB/s) and
// does 2*q_i FLOPs per element of each transposed step on the CUDA cores (67
// TFLOP/s f32).
//
// What the design does about it: one block owns one disjoint dX tile
// (t_m', t_k'), so no two blocks write the same element and nothing needs
// atomics.  Pallas sums the Q-tiles over a sequential grid axis; CUDA blocks
// run in any order, so the Q-tile loop runs inside the block: for each digit
// it gathers the dY block from the (B, M, Q_{n-1}..Q_0, S) view (the inverse
// of the forward's final-index store), applies the transposes in shared
// memory and adds the partial dX into a shared-memory sum, in digit order.
// With Q whole (the planned stages here) the last step stores dX straight
// to device memory, as 16-byte vectors when p is a multiple of 4.  The
// block tile is emit.block_tile's for this kernel's shared-memory model
// (kron_tile.cuh, make_args with kBwd).
#include "kron_tile.cuh"

template <typename T, typename Acc>
__global__ void __launch_bounds__(kron::kThreads)
    chain_bwd_kernel(kron::TileArgs a, const T* __restrict__ dy, T* __restrict__ dx) {
  extern __shared__ __align__(16) unsigned char kron_smem[];
  kron::chain_bwd_block<T, Acc>(a, dy, dx, reinterpret_cast<Acc*>(kron_smem));
}

extern "C" {

// fs: host array of n device pointers, each (B, ps[i], qs[i]) contiguous.
// dy (B, M, prod(qs) * K/prod(ps)) -> dx (B, M, K); tqs: the Q-tile of each
// factor.  (t_m, t_k): the block tile, in dX's columns.
int kron_chain_bwd(int dtype, const void* dy, void* dx, const void* const* fs, const int* ps,
                   const int* qs, const int* tqs, int n, long long B, long long M,
                   long long K, int t_m, int t_k, void* stream) {
  kron::TileArgs a;
  const int err = kron::make_args(&a, fs, ps, qs, tqs, n, B, M, K, t_m, t_k, kron::kBwd);
  if (err != cudaSuccess) return err;
  KRON_DISPATCH(dtype, chain_bwd_kernel, a, stream, dy, dx)
}

const char* kron_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
