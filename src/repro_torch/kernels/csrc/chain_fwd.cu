// Forward fused chain: every factor of one planned stage applied to a tile in
// shared memory, one launch per stage.
//
// Replaces: src/repro/kernels/emit.py, _chain_kernel with direction="fwd",
// launched by chain_pallas (emit.py:575).  Same function: x (B, M, K) and
// per-sample factors (B, P_i, Q_i) in application order give
// (B, M, prod(Q) * K / prod(P)) in x's dtype, each element written at its
// final FastKron index; Q is tiled per factor (t_qs), one grid digit each.
//
// What bounds it on an H100: bytes and operations are close.  A stage reads
// x once and writes y once (3.35 TB/s) and does 2*p_i FLOPs per element per
// factor on the CUDA cores (67 TFLOP/s f32; there is no tensor-core path
// here).  For the Figure 9 shape (M=1024, 32^4) two stages move 17.2 GB
// (5.1 ms) and the chain does 2.7e11 FLOPs (4.1 ms).
//
// What the design does about it: the chain's intermediates never leave
// shared memory, so a stage costs one read of x and one write of y however
// many factors it fuses.  The wrapper picks the largest block tile
// (t_m', t_k') inside the planned (t_m, t_k) that fits half of the 227 KB
// a block may hold, so two blocks share an SM and one loads while the other
// computes.  Each thread keeps eight global loads in flight, computes a 4x4
// register tile over a (m, p, s) shared-memory layout that keeps the inner
// loop's reads free of bank conflicts, and reads the factor panel as 16-byte
// vectors (kron_tile.cuh).  Measured on the H100 it runs at about 15% of the
// f32 peak on the Figure 9 shape (PERF.md): the loads of a block are not
// overlapped with its own compute, the inner loop issues five shared-memory
// loads and their address updates for every 16 FMAs, and the tensor cores
// are idle.  Those are the next PRs' work (ROADMAP.md).
#include "kron_tile.cuh"

template <typename T, typename Acc>
__global__ void __launch_bounds__(kron::kThreads)
    chain_fwd_kernel(kron::TileArgs a, const T* __restrict__ x, T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char kron_smem[];
  kron::chain_block<T, Acc>(a, x, y, reinterpret_cast<Acc*>(kron_smem));
}

extern "C" {

// fs: host array of n device pointers, each (B, ps[i], qs[i]) contiguous.
// tqs: the Q-tile of each factor.  (t_m, t_k): the block tile.
int kron_chain_fwd(int dtype, const void* x, void* y, const void* const* fs, const int* ps,
                   const int* qs, const int* tqs, int n, long long B, long long M,
                   long long K, int t_m, int t_k, void* stream) {
  kron::TileArgs a;
  const int err = kron::make_args(&a, fs, ps, qs, tqs, n, B, M, K, t_m, t_k);
  if (err != cudaSuccess) return err;
  KRON_DISPATCH(dtype, chain_fwd_kernel, a, stream, x, y)
}

const char* kron_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
