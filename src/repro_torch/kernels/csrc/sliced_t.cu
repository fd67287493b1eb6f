// One transposed FastKron sliced multiply (the input cotangent of one
// factor): dX[m, s*P + p] = sum_q dY[m, q*S + s] * F[p, q].
//
// Replaces: src/repro/kernels/kron_sliced_t.py, _sliced_t_kernel, launched
// by sliced_multiply_t_pallas (kron_sliced_t.py:78).  It carries the unfused
// baseline's backward (KronOp(plan=None)) and the per-factor fallback of a
// stage backward: one launch per factor.  The Pallas kernel sums its
// Q-tiles in dY's dtype; this one sums them in f32 (f64 for f64) and rounds
// once, so bf16 results differ from it within bf16 rounding.
//
// What bounds it on an H100: bytes.  A launch reads dY (M, Q*S) once, writes
// dX (M, S*P) once (3.35 TB/s) and does 2*Q FLOPs per element of dX (67
// TFLOP/s f32): at P = Q = 32 that is 8 FLOPs per byte moved, against the
// card's 20 for f32, so memory sets the floor.
//
// What the design does about it: the grid is (M/t_m, S/t_s), and the Q
// contraction loops inside the block over Q-tiles of t_q (all of Q when it
// fits, which the wrapper prefers, so dY is read once and there is one
// tile).  A block gathers its (t_m, t_q, t_s) block of the (M, Q, S) view of
// dY, coalesced along s, contracts it against the transposed (t_q, P) panel
// of F in shared memory and writes the contiguous (t_m, t_s*P) block of dX.
// The block routine is the transposed chain's (kron_tile.cuh) with one
// factor.
#include "kron_tile.cuh"

template <typename T, typename Acc>
__global__ void __launch_bounds__(kron::kThreads)
    sliced_t_kernel(kron::TileArgs a, const T* __restrict__ dy, T* __restrict__ dx) {
  extern __shared__ __align__(16) unsigned char kron_smem[];
  kron::chain_bwd_block<T, Acc>(a, dy, dx, reinterpret_cast<Acc*>(kron_smem));
}

extern "C" {

// dy (M, q*S), f (p, q), dx (M, S*p), all contiguous; tiles (t_m, t_s, t_q).
int kron_sliced_t(int dtype, const void* dy, const void* f, void* dx, long long M, long long S,
                  int p, int q, int t_m, int t_s, int t_q, void* stream) {
  kron::TileArgs a;
  const void* fs[1] = {f};
  const int ps[1] = {p}, qs[1] = {q}, tqs[1] = {t_q};
  const int err =
      kron::make_args(&a, fs, ps, qs, tqs, 1, 1, M, S * p, t_m, t_s * p, kron::kBwd);
  if (err != cudaSuccess) return err;
  KRON_DISPATCH(dtype, sliced_t_kernel, a, stream, dy, dx)
}

const char* kron_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
