// One-launch stage backward: dX and every factor's dF of one planned stage,
// plus one small launch that sums the per-block dF partials.
//
// Replaces: src/repro/kernels/emit.py, _grad_kernel, launched by grad_pallas
// (emit.py:759).  Same function: the stage input x (B, M, K), the output
// cotangent dY (B, M, prod(Q) * S) and factors (B, P_i, Q_i) in application
// order give dX (B, M, K) in x's dtype and dF_i (B, P_i, Q_i) in the
// accumulator type, dF summed over all M rows and K columns of a sample.
//
// What bounds it on an H100: operations.  Per element of the tile it does
// the stage's forward chain again (the remat of u_1 .. u_{n-1}), then per
// factor the dF contraction and the transposed step, about 2x the forward's
// FLOPs, on the CUDA cores (67 TFLOP/s f32); it reads x and dY once and
// writes dX once.
//
// What the design does about it: a block walks many (t_m', t_k') tiles of
// one sample (grid-stride, a few blocks per SM) and keeps every chain state
// of the current tile in shared memory: the forward states u_i in the
// forward layout, the gradient tile in two ping-pong buffers.  Per factor,
// in reverse, it reads G once for both the dF contraction (split over
// thread groups, each summing a fixed share of the tile's (m, s) pairs) and
// the transposed step.  The groups' partials are summed in a fixed order
// into the block's dF in shared memory, each element by one owner thread;
// the block writes its dF once, at the end, as one partial.  Pallas sums dF
// over a sequential grid; here the second launch sums the partials of a
// sample over its blocks in block order.  No atomics: dX and dF are the same
// bit for bit on every run.  The Figure 9 stage (t_m=1, t_k=8192) would
// need 1 GiB of partials at one per tile; one per block needs 2 MiB.
#include "kron_tile.cuh"

template <typename T, typename Acc>
__global__ void __launch_bounds__(kron::kThreads)
    grad_kernel(kron::TileArgs a, const T* __restrict__ x, const T* __restrict__ dy,
                T* __restrict__ dx, Acc* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char kron_smem[];
  kron::grad_block<T, Acc>(a, x, dy, dx, part, reinterpret_cast<Acc*>(kron_smem));
}

// df[b, e] = sum over the sample's blocks j, in order, of part[b, j, e].
template <typename Acc>
__global__ void grad_reduce_kernel(const Acc* __restrict__ part, Acc* __restrict__ df, int nblk,
                                   int total, long long n_out) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  const long long b = e / total, r = e - b * total;
  const Acc* p = part + b * nblk * static_cast<long long>(total) + r;
  Acc v = Acc(0);
  for (int j = 0; j < nblk; ++j) v += p[static_cast<long long>(j) * total];
  df[e] = v;
}

template <typename T, typename Acc>
int grad_launch(const kron::TileArgs& a, void* stream, const void* x, const void* dy, void* dx,
                void* part, void* df) {
  const int err = kron::launch<Acc>(grad_kernel<T, Acc>, a, stream, x, dy, dx, part);
  if (err != cudaSuccess) return err;
  const long long n_out = a.B * a.df_total;
  const int threads = 256;
  const long long blocks = (n_out + threads - 1) / threads;
  if (blocks == 0) return cudaSuccess;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  grad_reduce_kernel<Acc><<<static_cast<unsigned>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Acc*>(part), static_cast<Acc*>(df), a.nblk, a.df_total, n_out);
  return cudaGetLastError();
}

extern "C" {

// x (B, M, K), dy (B, M, prod(qs) * K/prod(ps)), dx (B, M, K) in the input
// dtype; fs: host array of n device pointers, each (B, ps[i], qs[i]).
// part: B * nblk * sum(p_i q_i) and df: B * sum(p_i q_i) elements of the
// accumulator type; df holds dF_0 .. dF_{n-1} of each sample back to back.
// (t_m, t_k): the block tile; nblk: blocks per sample.
int kron_grad(int dtype, const void* x, const void* dy, void* dx, void* part, void* df,
              const void* const* fs, const int* ps, const int* qs, int n, long long B,
              long long M, long long K, int t_m, int t_k, int nblk, void* stream) {
  kron::TileArgs a;
  const int err = kron::make_args(&a, fs, ps, qs, qs, n, B, M, K, t_m, t_k, kron::kGrad, nblk);
  if (err != cudaSuccess) return err;
  switch (dtype) {
    case 0:
      return grad_launch<float, float>(a, stream, x, dy, dx, part, df);
    case 1:
      return grad_launch<__nv_bfloat16, float>(a, stream, x, dy, dx, part, df);
    case 2:
      return grad_launch<double, double>(a, stream, x, dy, dx, part, df);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* kron_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
