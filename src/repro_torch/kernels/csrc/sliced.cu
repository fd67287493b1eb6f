// One FastKron sliced multiply: Y[m, q*S + s] = sum_p X[m, s*P + p] * F[p, q].
//
// Replaces: src/repro/kernels/kron_sliced.py, _sliced_kernel, launched by
// sliced_multiply_pallas (kron_sliced.py:83).  It carries the paper's
// unfused baseline (KronOp(plan=None)): one launch per factor.
//
// What bounds it on an H100: bytes.  A launch reads x (M, S*P) once, writes
// y (M, Q*S) once (3.35 TB/s) and does 2*P FLOPs per output element (67
// TFLOP/s f32): at P = Q = 32 that is 8 FLOPs per byte moved, against the
// card's 20 for f32, so memory sets the floor.
//
// What the design does about it: the grid is (M/t_m, S/t_s, Q/t_q), put on
// gridDim.x.  A block stages its (t_m, t_s*P) slab of x and the (P, t_q)
// panel of F in shared memory, so x is read once per Q-tile (once in all
// when t_q = Q, which the wrapper prefers), and writes the (t_m, t_q, t_s)
// block at y[m, q*S + s], coalesced along s.  The wrapper keeps a block
// within half of the 227 KB so two blocks share an SM.  The block routine is
// the chain's (kron_tile.cuh) with one factor: the relayout happens in
// registers on the way out, never as a second pass over device memory.
// Measured on the H100 a Figure 9 launch moves its 8.6 GB at about a third
// of the memory rate (PERF.md): the same load/compute serialization as the
// chain kernel.
#include "kron_tile.cuh"

template <typename T, typename Acc>
__global__ void __launch_bounds__(kron::kThreads)
    sliced_kernel(kron::TileArgs a, const T* __restrict__ x, T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char kron_smem[];
  kron::chain_block<T, Acc>(a, x, y, reinterpret_cast<Acc*>(kron_smem));
}

extern "C" {

// x (M, S*p), f (p, q), y (M, q*S), all contiguous; tiles (t_m, t_s, t_q).
int kron_sliced(int dtype, const void* x, const void* f, void* y, long long M, long long K,
                int p, int q, int t_m, int t_s, int t_q, void* stream) {
  kron::TileArgs a;
  const void* fs[1] = {f};
  const int ps[1] = {p}, qs[1] = {q}, tqs[1] = {t_q};
  const int err = kron::make_args(&a, fs, ps, qs, tqs, 1, 1, M, K, t_m, t_s * p);
  if (err != cudaSuccess) return err;
  KRON_DISPATCH(dtype, sliced_kernel, a, stream, x, y)
}

// Blocks of kron_sliced's kernel that fit one SM at these tiles, into
// *blocks; its shared memory in bytes into *smem.
int kron_sliced_occupancy(int dtype, long long M, long long K, int p, int q, int t_m, int t_s,
                          int t_q, int* blocks, long long* smem) {
  kron::TileArgs a;
  const void* fs[1] = {nullptr};
  const int ps[1] = {p}, qs[1] = {q}, tqs[1] = {t_q};
  const int err = kron::make_args(&a, fs, ps, qs, tqs, 1, 1, M, K, t_m, t_s * p);
  if (err != cudaSuccess) return err;
  KRON_OCCUPANCY(dtype, sliced_kernel, a, blocks, smem)
}

const char* kron_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
