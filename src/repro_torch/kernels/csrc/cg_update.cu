// Conjugate gradients' vector updates, fused: the element-wise work of one
// CG iteration of repro_torch.gp.ski.conjugate_gradient in three passes over
// the rows of the CG block, besides the matrix-vector product (MVM).
//
// Replaces: no TPU kernel.  The reference leaves CG's updates to XLA
// (src/repro/gp/ski.py, conjugate_gradient under lax.scan), which fuses
// them; eager PyTorch makes one pass over memory per operation, about 27
// passes an iteration.  These kernels make 11 and keep every scalar (alpha,
// beta, the residual norms) on the device.
//
// The recurrence, per row, for (A + shift I) x = b with A p = y the MVM:
//   ap    = y + shift * p                 (formed in registers, never stored)
//   alpha = rs / max(p . ap, 1e-20)
//   x    += alpha * p,  r -= alpha * ap,  rs' = r . r
//   beta  = rs' / max(rs, 1e-20),  p = r + beta * p
// Each element rounds as the eager path's operations do (every product and
// sum rounded on its own, no fused multiply-add), so only the order of the
// sums differs from it.  The arrays are f32 or f64 (T below).
//
// What bounds it on an H100: bytes.  Each pass streams its rows once at
// 3.35 TB/s and does a few FLOPs per element.  What the design does about
// it: a row is cut into fixed chunks of `chunk` elements (a multiple of
// 1024, at most 256 chunks a row); one 256-thread block streams one chunk
// with 16-byte loads where the rows allow (vec = 4 floats or 2 doubles),
// four loads of each array in flight per thread.  A row's dot product is the
// fixed-order sum of its chunks' partials (T per thread, f64 across threads
// and chunks), which every block of the next pass reduces itself: no
// atomics, no second launch, and the same bits on every run.
//
//   start      r = b - y0 (x0 = 0, so shift * x0 is exactly 0), p = r,
//              partials of r . r                      b, y0 read; r, p written
//   dot        partials of p . ap                     p, y read
//   step       alpha; x += alpha p; r -= alpha ap;
//              partials of r . r                      p, y, x, r read; x, r written
//   direction  beta; p = r + beta p                   r, p read; p written
//   norm       res = sqrt(r . r) per row              partials only
//
// part holds (3, rows, nc) f64 partials: [0] p . ap, [1 + cur] r . r of the
// current residual, [2 - cur] those of the other one.  `step` reads [1 + cur]
// and writes [2 - cur]; the caller then flips cur, so `direction` reads the
// new residual's at [1 + cur] and the old one's at [2 - cur].  No block
// reads a partial that another block of the same launch writes.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // loads of each array in flight per thread

enum Stage { kStart = 0, kDot = 1, kStep = 2, kDirection = 3, kNorm = 4 };
enum Dtype { kF32 = 0, kF64 = 2 };  // the codes of the other kernels

template <typename T>
struct CgArgs {
  const T* b;  // (rows, k): the right-hand side (start)
  const T* y;  // (rows, k): the MVM's output
  T* x;
  T* r;
  T* p;
  double* part;  // (3, rows, nc)
  T* res;        // (rows,)
  long long rows, k, chunk, nc;
  T shift;
  int cur;
};

// Each operation rounded on its own, as the eager path's are.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// V consecutive elements: one 16-byte access when V * sizeof(T) is 16.
template <typename T, int V>
__device__ __forceinline__ void load(const T* src, T (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (V == 2) {
    const double2 t = *reinterpret_cast<const double2*>(src);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = *src;
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* dst, const T (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<double2*>(dst) = make_double2(v[0], v[1]);
  } else {
    *dst = v[0];
  }
}

// The block's sum of v in a fixed tree order; every thread gets it.
__device__ double block_sum(double v, double* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  const double out = sh[0];
  __syncthreads();  // sh is free again
  return out;
}

// A row's dot product: the sum of its nc partials, in the same order in
// every block.
__device__ double row_total(const double* part, long long nc, double* sh) {
  double v = 0.0;
  for (long long i = threadIdx.x; i < nc; i += kThreads) v += part[i];
  return block_sum(v, sh);
}

// One chunk of one row: the element-wise work of `kStage`, and the chunk's
// partial of the stage's dot product (start, dot, step) into out.
template <int kStage, typename T, int V>
__device__ void chunk_pass(const CgArgs<T>& a, long long row, long long c, T coef, double* out,
                           double* sh) {
  const long long base = row * a.k, lo = c * a.chunk;
  const long long hi = lo + a.chunk < a.k ? lo + a.chunk : a.k;
  const T s = a.shift;
  T acc = 0;
  for (long long i0 = lo + threadIdx.x * V; i0 < hi; i0 += kUnroll * kThreads * V) {
    T u0[kUnroll][V], u1[kUnroll][V], u2[kUnroll][V], u3[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + i0 + u * kThreads * V;
      if (i0 + u * kThreads * V >= hi) continue;
      if constexpr (kStage == kStart) {
        load<T, V>(a.b + i, u0[u]);
        load<T, V>(a.y + i, u1[u]);
      } else if constexpr (kStage == kDot) {
        load<T, V>(a.p + i, u0[u]);
        load<T, V>(a.y + i, u1[u]);
      } else if constexpr (kStage == kStep) {
        load<T, V>(a.p + i, u0[u]);
        load<T, V>(a.y + i, u1[u]);
        load<T, V>(a.x + i, u2[u]);
        load<T, V>(a.r + i, u3[u]);
      } else {
        load<T, V>(a.r + i, u0[u]);
        load<T, V>(a.p + i, u1[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + i0 + u * kThreads * V;
      if (i0 + u * kThreads * V >= hi) continue;
      if constexpr (kStage == kStart) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          u2[u][e] = sub_rn(u0[u][e], u1[u][e]);
          acc += u2[u][e] * u2[u][e];
        }
        store<T, V>(a.r + i, u2[u]);
        store<T, V>(a.p + i, u2[u]);
      } else if constexpr (kStage == kDot) {
#pragma unroll
        for (int e = 0; e < V; ++e) acc += u0[u][e] * add_rn(u1[u][e], mul_rn(s, u0[u][e]));
      } else if constexpr (kStage == kStep) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const T ap = add_rn(u1[u][e], mul_rn(s, u0[u][e]));
          u2[u][e] = add_rn(u2[u][e], mul_rn(coef, u0[u][e]));
          u3[u][e] = sub_rn(u3[u][e], mul_rn(coef, ap));
          acc += u3[u][e] * u3[u][e];
        }
        store<T, V>(a.x + i, u2[u]);
        store<T, V>(a.r + i, u3[u]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) u1[u][e] = add_rn(u0[u][e], mul_rn(coef, u1[u][e]));
        store<T, V>(a.p + i, u1[u]);
      }
    }
  }
  if constexpr (kStage != kDirection) {
    const double total = block_sum(static_cast<double>(acc), sh);
    if (threadIdx.x == 0) out[row * a.nc + c] = total;
  }
}

// Block j streams chunk j % nc of row j / nc.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) cg_start_kernel(CgArgs<T> a) {
  __shared__ double sh[kThreads];
  const long long row = blockIdx.x / a.nc;
  chunk_pass<kStart, T, V>(a, row, blockIdx.x - row * a.nc, T(0), a.part + a.rows * a.nc, sh);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) cg_dot_kernel(CgArgs<T> a) {
  __shared__ double sh[kThreads];
  const long long row = blockIdx.x / a.nc;
  chunk_pass<kDot, T, V>(a, row, blockIdx.x - row * a.nc, T(0), a.part, sh);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) cg_step_kernel(CgArgs<T> a) {
  __shared__ double sh[kThreads];
  const long long row = blockIdx.x / a.nc, n = a.rows * a.nc;
  const double denom = row_total(a.part + row * a.nc, a.nc, sh);
  const double rs = row_total(a.part + (1 + a.cur) * n + row * a.nc, a.nc, sh);
  const T alpha = static_cast<T>(rs / (denom > 1e-20 ? denom : 1e-20));
  chunk_pass<kStep, T, V>(a, row, blockIdx.x - row * a.nc, alpha, a.part + (2 - a.cur) * n, sh);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) cg_direction_kernel(CgArgs<T> a) {
  __shared__ double sh[kThreads];
  const long long row = blockIdx.x / a.nc, n = a.rows * a.nc;
  const double rs_new = row_total(a.part + (1 + a.cur) * n + row * a.nc, a.nc, sh);
  const double rs = row_total(a.part + (2 - a.cur) * n + row * a.nc, a.nc, sh);
  const T beta = static_cast<T>(rs_new / (rs > 1e-20 ? rs : 1e-20));
  chunk_pass<kDirection, T, V>(a, row, blockIdx.x - row * a.nc, beta, nullptr, sh);
}

// One block a row.
template <typename T>
__global__ void __launch_bounds__(kThreads) cg_norm_kernel(CgArgs<T> a) {
  __shared__ double sh[kThreads];
  const long long row = blockIdx.x;
  const double rs = row_total(a.part + (1 + a.cur) * a.rows * a.nc + row * a.nc, a.nc, sh);
  if (threadIdx.x == 0) a.res[row] = static_cast<T>(sqrt(rs));
}

template <typename T, int V>
int launch(int stage, const CgArgs<T>& a, cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>(a.rows * a.nc);
  switch (stage) {
    case kStart:
      cg_start_kernel<T, V><<<grid, kThreads, 0, st>>>(a);
      break;
    case kDot:
      cg_dot_kernel<T, V><<<grid, kThreads, 0, st>>>(a);
      break;
    case kStep:
      cg_step_kernel<T, V><<<grid, kThreads, 0, st>>>(a);
      break;
    case kDirection:
      cg_direction_kernel<T, V><<<grid, kThreads, 0, st>>>(a);
      break;
    default:
      cg_norm_kernel<T><<<static_cast<unsigned>(a.rows), kThreads, 0, st>>>(a);
      break;
  }
  return cudaGetLastError();
}

template <typename T, int kVec>
int run(int stage, const void* b, const void* y, void* x, void* r, void* p, void* part, void* res,
        long long rows, long long k, long long chunk, double shift, int cur, int vec,
        cudaStream_t st) {
  CgArgs<T> a;
  a.b = static_cast<const T*>(b);
  a.y = static_cast<const T*>(y);
  a.x = static_cast<T*>(x);
  a.r = static_cast<T*>(r);
  a.p = static_cast<T*>(p);
  a.part = static_cast<double*>(part);
  a.res = static_cast<T*>(res);
  a.rows = rows;
  a.k = k;
  a.chunk = chunk;
  a.nc = (k + chunk - 1) / chunk;
  a.shift = static_cast<T>(shift);
  a.cur = cur;
  if (a.rows * a.nc > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  return vec == kVec ? launch<T, kVec>(stage, a, st) : launch<T, 1>(stage, a, st);
}

}  // namespace

extern "C" {

// One pass of CG's fused updates (stage: 0 start, 1 dot, 2 step,
// 3 direction, 4 norm) over rows x k contiguous arrays of dtype (0 f32,
// 2 f64); part (3, rows, nc) f64 with nc = ceil(k / chunk); res (rows,) of
// the dtype; cur: which r . r partials belong to the current residual (0 or
// 1); vec: the elements of one 16-byte access (4 for f32, 2 for f64) when k
// is a multiple of it and every array is 16-byte aligned, else 1.  Pointers
// a stage does not use may be null.
int kron_cg_update(int stage, int dtype, const void* b, const void* y, void* x, void* r,
                   void* p, void* part, void* res, long long rows, long long k, long long chunk,
                   double shift, int cur, int vec, void* stream) {
  const int wide = dtype == kF32 ? 4 : 2;  // elements of one 16-byte access
  if (stage < kStart || stage > kNorm || (dtype != kF32 && dtype != kF64) || rows < 1 || k < 1 ||
      chunk < 1 || chunk % 4 || (cur != 0 && cur != 1) || (vec != 1 && vec != wide) || k % vec)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return run<float, 4>(stage, b, y, x, r, p, part, res, rows, k, chunk, shift, cur, vec, st);
  return run<double, 2>(stage, b, y, x, r, p, part, res, rows, k, chunk, shift, cur, vec, st);
}

const char* kron_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
