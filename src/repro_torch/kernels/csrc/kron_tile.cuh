// Block tiles of a FastKron chain for sliced.cu (one block per tile, one
// factor), the helpers every kernel shares (to_acc, store, load4/store4,
// div_fast) and the host code that fills a sliced launch's arguments.  The
// persistent kernels (chain_fwd.cu, chain_bwd.cu, grad.cu, sliced_t.cu)
// build on kron_async.cuh instead.
//
// A block owns one batch sample, t_m rows and a t_k column slab of x (t_k a
// multiple of prod(P)), and keeps every chain state of that tile in shared
// memory.  State i of the forward chain has c_i columns (c_0 = t_k,
// c_{i+1} = tq_i * s_i with s_i = c_i / p_i).
//
// chain_block: the block also owns one Q-tile digit per factor.  It loads
// the slab once, applies every factor, and writes each output element
// straight to its final FastKron index:
//
//   state i lives in shared memory as (m, p, s): element A[m, s*p_i + pp]
//   sits at m*p_i*sstr_i + pp*sstr_i + s.  Keeping the contraction index pp
//   major makes a warp's reads of A contiguous along s, and the odd slice
//   stride sstr_i = s_i | 1 spreads the transposing stores over all 32 banks.
//
//   step i:  B[m, q*s_i + s] = sum_pp A[m, s*p_i + pp] * F_i[pp, q]
//   Each thread computes a kRS x kRQ register tile: kRS slices strided by
//   the number of slice groups (so neighbouring threads read neighbouring
//   addresses) times kRQ = 4 consecutive columns of the factor panel, which
//   is padded with zeros to a multiple of 4 columns and read as one 16-byte
//   vector per row.
//
// Global loads keep kLoadUnroll loads in flight per thread.  Index math
// divides through float reciprocals (div_fast).  Intermediates stay in the
// accumulator type Acc inside the block; only stores to device memory round
// to T.  Every global offset is 64-bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace kron {

constexpr int kMaxFactors = 16;
constexpr int kThreads = 512;
constexpr int kRS = 4;          // slices per thread
constexpr int kRQ = 4;          // factor-panel columns per thread (one vector)
constexpr int kLoadUnroll = 8;  // global loads in flight per thread
constexpr size_t kMaxSmemBytes = 232448;  // 227 KB: one Hopper block's limit

struct TileArgs {
  const void* f[kMaxFactors];  // factor i: (B, p_i, q_i), application order
  int p[kMaxFactors];
  int q[kMaxFactors];
  int tq[kMaxFactors];         // Q-tile of factor i (divides q_i)
  int nq[kMaxFactors];         // q_i / tq_i
  int s[kMaxFactors];          // slices of chain state i inside the tile
  int sstr[kMaxFactors];       // padded slice stride of state i (forward layout)
  int c[kMaxFactors + 1];      // columns of chain state i inside the tile
  float rp[kMaxFactors];       // 1 / p_i
  float rtq[kMaxFactors];      // 1 / tq_i
  long long ostride[kMaxFactors];  // prod_{l<i} q_l * s_out: output radix
  int n;
  long long B, M, K;           // x: (B, M, K)
  long long s_out;             // K / prod(P)
  long long out_cols;          // prod(Q) * s_out
  int t_m, t_k, ts_out;        // block tile; ts_out = t_k / prod(P)
  float rts_out;               // 1 / ts_out
  long long m_tiles, q_tiles, k_tiles;
  long long grid;              // blocks of the launch
  // Shared memory, in elements of Acc, each region rounded to 4 elements
  // (16-byte aligned panels and vectors).
  int buf0, buf1, panel;       // chain-state ping-pong buffers and the panel
  long long smem;              // total elements
};

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
// Four consecutive elements in one (float, double: two) vector store; the
// address is 16-byte aligned for float and double, 8-byte for bfloat16.
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* p, const double (&v)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  reinterpret_cast<__nv_bfloat162*>(p)[0] = __floats2bfloat162_rn(v[0], v[1]);
  reinterpret_cast<__nv_bfloat162*>(p)[1] = __floats2bfloat162_rn(v[2], v[3]);
}

// n / d for 0 <= n < 2^22 and d >= 1, given rd = 1.0f / d.  The float
// estimate is off by at most one and is corrected; a few instructions
// instead of an integer division.
__device__ __forceinline__ int div_fast(int n, int d, float rd) {
  int q = __float2int_rz(__int2float_rn(n) * rd);
  const int r = n - q * d;
  if (r < 0) {
    --q;
  } else if (r >= d) {
    ++q;
  }
  return q;
}

// Q-tile digit of every factor from a composite Q-tile index: mixed radix,
// factor 0 minor.
__device__ __forceinline__ void q_digits(const TileArgs& a, long long jq, int (&qd)[kMaxFactors]) {
  for (int i = 0; i < a.n; ++i) {
    qd[i] = static_cast<int>(jq % a.nq[i]);
    jq /= a.nq[i];
  }
}

// The (t_m, t_k) slab of x at xs (row stride K), transposed to the forward
// (m, p, s) layout of state 0: coalesced, kLoadUnroll loads per thread in
// flight.
template <typename T, typename Acc>
__device__ void load_slab(const TileArgs& a, const T* __restrict__ xs, Acc* dst) {
  const int p0 = a.p[0], st0 = a.sstr[0], ms0 = p0 * st0;
  const float rtk = 1.0f / a.t_k;
  const int total = a.t_m * a.t_k;
  for (int base = threadIdx.x; base < total; base += kLoadUnroll * blockDim.x) {
    T v[kLoadUnroll];
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < total) {
        const int m = div_fast(idx, a.t_k, rtk);
        v[u] = xs[m * a.K + (idx - m * a.t_k)];
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < total) {
        const int m = div_fast(idx, a.t_k, rtk);
        const int c = idx - m * a.t_k;
        const int sp = div_fast(c, p0, a.rp[0]);
        dst[m * ms0 + (c - sp * p0) * st0 + sp] = to_acc(v[u]);
      }
    }
  }
}

// The (p_i, tq_i) panel of factor i of sample b for Q-tile digit qd,
// zero-padded to a multiple of 4 columns: panel[pp * tq4 + q].
template <typename T, typename Acc>
__device__ void load_panel(const TileArgs& a, int i, long long b, int qd, Acc* panel) {
  const int p = a.p[i], tq = a.tq[i];
  const int tq4 = (tq + kRQ - 1) / kRQ * kRQ;
  const T* f = static_cast<const T*>(a.f[i]) + b * p * static_cast<long long>(a.q[i]) +
               static_cast<long long>(qd) * tq;
  const float rtq4 = 1.0f / tq4;
  const int total = p * tq4;
  for (int base = threadIdx.x; base < total; base += kLoadUnroll * blockDim.x) {
    Acc v[kLoadUnroll];
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int idx = base + u * blockDim.x;
      const int r = div_fast(idx, tq4, rtq4);
      const int c = idx - r * tq4;
      v[u] = idx < total && c < tq ? to_acc(f[static_cast<long long>(r) * a.q[i] + c]) : Acc(0);
    }
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < total) panel[idx] = v[u];
    }
  }
}

// Forward step i over state `cur` (forward layout) and the panel: calls
// sink(m, sp, qb, v) with v[c] = B[m, (qb*kRQ + c)*s_i + sp] for every
// valid slice sp (columns past tq_i are the panel's zero padding).
template <typename Acc, typename Sink>
__device__ __forceinline__ void fwd_step(const TileArgs& a, int i, const Acc* cur,
                                         const Acc* panel, Sink sink) {
  const int p = a.p[i], tq = a.tq[i], s = a.s[i], st = a.sstr[i];
  const int tq4 = (tq + kRQ - 1) / kRQ * kRQ;
  const int ms = p * st;
  const int nsb = (s + kRS - 1) / kRS;
  const int nqb = tq4 / kRQ;
  const float rnsb = 1.0f / nsb, rnqb = 1.0f / nqb;
  const int work = a.t_m * nqb * nsb;
  for (int w = threadIdx.x; w < work; w += blockDim.x) {
    const int t = div_fast(w, nsb, rnsb);
    const int sb = w - t * nsb;
    const int m = div_fast(t, nqb, rnqb);
    const int qb = t - m * nqb;
    // Out-of-range slices read slice 0 and are never stored.
    int soff[kRS];
#pragma unroll
    for (int r = 0; r < kRS; ++r) {
      const int sp = sb + r * nsb;
      soff[r] = sp < s ? sp : 0;
    }
    Acc acc[kRS][kRQ];
#pragma unroll
    for (int r = 0; r < kRS; ++r)
#pragma unroll
      for (int c = 0; c < kRQ; ++c) acc[r][c] = Acc(0);
    const Acc* arow = cur + m * ms;
    const Acc* prow = panel + qb * kRQ;
    for (int pp = 0; pp < p; ++pp) {
      Acc av[kRS], fv[kRQ];
#pragma unroll
      for (int r = 0; r < kRS; ++r) av[r] = arow[pp * st + soff[r]];
      load4(prow + pp * tq4, fv);
#pragma unroll
      for (int r = 0; r < kRS; ++r)
#pragma unroll
        for (int c = 0; c < kRQ; ++c) acc[r][c] += av[r] * fv[c];
    }
#pragma unroll
    for (int r = 0; r < kRS; ++r) {
      const int sp = sb + r * nsb;
      if (sp < s) sink(m, sp, qb, acc[r]);
    }
  }
}

// Forward step i from state i into state i+1 (both in the forward layout).
template <typename Acc>
__device__ __forceinline__ void fwd_step_to_state(const TileArgs& a, int i, const Acc* cur,
                                                  Acc* nxt, const Acc* panel) {
  const int tq = a.tq[i], s = a.s[i];
  const int pn = a.p[i + 1], stn = a.sstr[i + 1], msn = pn * stn;
  const float rpn = a.rp[i + 1];
  fwd_step(a, i, cur, panel, [&](int m, int sp, int qb, const Acc(&v)[kRQ]) {
    // Next state's layout: column col -> (col % p', col / p').
#pragma unroll
    for (int c = 0; c < kRQ; ++c) {
      const int ql = qb * kRQ + c;
      if (ql >= tq) continue;
      const int col = ql * s + sp;
      const int j = div_fast(col, pn, rpn);
      nxt[m * msn + (col - j * pn) * stn + j] = v[c];
    }
  });
}

template <typename T, typename Acc>
__device__ void chain_block(const TileArgs& a, const T* __restrict__ x, T* __restrict__ y,
                            Acc* smem) {
  long long blk = blockIdx.x;
  const long long kt = blk % a.k_tiles;
  blk /= a.k_tiles;
  const long long jq = blk % a.q_tiles;
  blk /= a.q_tiles;
  const long long mt = blk % a.m_tiles;
  const long long b = blk / a.m_tiles;
  const long long row0 = b * a.M + mt * a.t_m;  // batch folded into rows

  int qd[kMaxFactors];
  q_digits(a, jq, qd);

  Acc* cur = smem;
  Acc* nxt = smem + a.buf0;
  Acc* panel = nxt + a.buf1;

  load_slab(a, x + row0 * a.K + kt * a.t_k, cur);

  for (int i = 0; i < a.n; ++i) {
    load_panel<T>(a, i, b, qd[i], panel);
    __syncthreads();  // slab/state i and the panel are in place
    if (i + 1 < a.n) {
      fwd_step_to_state(a, i, cur, nxt, panel);
    } else {
      // Tile column (ql, q_{n-2}, ..., q_0, s_local) -> global index.
      T* yrow = y + row0 * a.out_cols + kt * a.ts_out;
      const int tq = a.tq[i];
      fwd_step(a, i, cur, panel, [&](int m, int sp, int qb, const Acc(&v)[kRQ]) {
        int rem = div_fast(sp, a.ts_out, a.rts_out);
        long long off = sp - rem * a.ts_out;
        for (int l = 0; l < i; ++l) {
          const int nr = div_fast(rem, a.tq[l], a.rtq[l]);
          off += static_cast<long long>(qd[l] * a.tq[l] + rem - nr * a.tq[l]) * a.ostride[l];
          rem = nr;
        }
#pragma unroll
        for (int c = 0; c < kRQ; ++c) {
          const int ql = qb * kRQ + c;
          if (ql >= tq) continue;
          store(yrow + m * a.out_cols + off + static_cast<long long>(qd[i] * tq + ql) * a.ostride[i],
                v[c]);
        }
      });
    }
    __syncthreads();  // state i+1 complete; state i and the panel are free
    Acc* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

inline long long round4(long long e) { return (e + 3) / 4 * 4; }

// Host side: fill the arguments of one launch, x (B, M, K) -> y (B, M,
// prod(Q) * K/prod(P)) with tqs tiling Q.  Returns cudaSuccess or
// cudaErrorInvalidValue for a tile the kernel cannot take.  The
// shared-memory regions must match repro_torch.kernels.emit.
// block_smem_bytes(kind="fwd").
inline int make_args(TileArgs* a, const void* const* fs, const int* ps, const int* qs,
                     const int* tqs, int n, long long B, long long M, long long K, int t_m,
                     int t_k) {
  if (n < 1 || n > kMaxFactors || t_m < 1 || t_k < 1) return cudaErrorInvalidValue;
  if (M % t_m || K % t_k) return cudaErrorInvalidValue;
  long long pprod = 1, qprod = 1;
  for (int i = 0; i < n; ++i) {
    if (ps[i] < 1 || qs[i] < 1 || tqs[i] < 1 || qs[i] % tqs[i]) return cudaErrorInvalidValue;
    pprod *= ps[i];
    qprod *= qs[i];
  }
  if (t_k % pprod) return cudaErrorInvalidValue;
  a->n = n;
  a->B = B;
  a->M = M;
  a->K = K;
  a->s_out = K / pprod;
  a->out_cols = qprod * a->s_out;
  a->t_m = t_m;
  a->t_k = t_k;
  a->ts_out = static_cast<int>(t_k / pprod);
  a->rts_out = 1.0f / a->ts_out;
  a->m_tiles = M / t_m;
  a->k_tiles = K / t_k;
  a->q_tiles = 1;
  long long cols = t_k, qstride = 1;
  long long buf[2] = {0, 0}, panel = 0;
  a->c[0] = t_k;
  for (int i = 0; i < n; ++i) {
    a->f[i] = fs[i];
    a->p[i] = ps[i];
    a->q[i] = qs[i];
    a->tq[i] = tqs[i];
    a->nq[i] = qs[i] / tqs[i];
    a->rp[i] = 1.0f / ps[i];
    a->rtq[i] = 1.0f / tqs[i];
    a->q_tiles *= a->nq[i];
    a->ostride[i] = qstride * a->s_out;
    qstride *= qs[i];
    const long long s = cols / ps[i];
    a->s[i] = static_cast<int>(s);
    a->sstr[i] = static_cast<int>(s | 1);
    const long long state = round4(static_cast<long long>(t_m) * ps[i] * (s | 1));
    const long long fwd_panel = static_cast<long long>(ps[i]) * round4(tqs[i]);
    if (state > buf[i % 2]) buf[i % 2] = state;
    if (fwd_panel > panel) panel = fwd_panel;
    cols = s * tqs[i];
    a->c[i + 1] = static_cast<int>(cols);
  }
  a->buf0 = static_cast<int>(buf[0]);
  a->buf1 = static_cast<int>(buf[1]);
  a->panel = static_cast<int>(panel);
  a->smem = buf[0] + buf[1] + panel;
  if (a->smem > (1 << 22)) return cudaErrorInvalidValue;
  a->grid = B * a->m_tiles * a->q_tiles * a->k_tiles;
  return cudaSuccess;
}

// Launch `kernel(a, args...)` on a.grid blocks of kThreads with a.smem
// elements of Acc as dynamic shared memory; each argument is cast to the
// kernel's parameter type.
template <typename Acc, typename... KArgs, typename... Args>
int launch(void (*kernel)(TileArgs, KArgs...), const TileArgs& a, void* stream, Args... args) {
  const size_t smem = sizeof(Acc) * static_cast<size_t>(a.smem);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  if (a.grid > INT_MAX) return cudaErrorInvalidConfiguration;
  if (a.grid == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(a.grid), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<KArgs>(args)...);
  return cudaGetLastError();
}

// Blocks of `kernel` that fit one SM at kThreads threads and a.smem
// elements of Acc (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into
// *blocks; that shared memory in bytes into *smem_bytes.
template <typename Acc, typename... KArgs>
int occupancy(void (*kernel)(TileArgs, KArgs...), const TileArgs& a, int* blocks,
              long long* smem_bytes) {
  const size_t smem = sizeof(Acc) * static_cast<size_t>(a.smem);
  *smem_bytes = static_cast<long long>(smem);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, smem);
}

}  // namespace kron

// dtype codes shared with the Python wrappers: 0 float32, 1 bfloat16, 2 float64.
// KRON_DISPATCH(dtype, KERNEL, a, stream, pointers...) launches
// KERNEL<T, Acc> for the code's (T, Acc).
#define KRON_DISPATCH(dtype, KERNEL, ...)                                      \
  switch (dtype) {                                                             \
    case 0:                                                                    \
      return kron::launch<float>(KERNEL<float, float>, __VA_ARGS__);           \
    case 1:                                                                    \
      return kron::launch<float>(KERNEL<__nv_bfloat16, float>, __VA_ARGS__);   \
    case 2:                                                                    \
      return kron::launch<double>(KERNEL<double, double>, __VA_ARGS__);        \
    default:                                                                   \
      return cudaErrorInvalidValue;                                            \
  }

// KRON_OCCUPANCY(dtype, KERNEL, a, blocks, smem_bytes): kron::occupancy of
// KERNEL<T, Acc> for the code's (T, Acc).
#define KRON_OCCUPANCY(dtype, KERNEL, ...)                                     \
  switch (dtype) {                                                             \
    case 0:                                                                    \
      return kron::occupancy<float>(KERNEL<float, float>, __VA_ARGS__);        \
    case 1:                                                                    \
      return kron::occupancy<float>(KERNEL<__nv_bfloat16, float>, __VA_ARGS__); \
    case 2:                                                                    \
      return kron::occupancy<double>(KERNEL<double, double>, __VA_ARGS__);     \
    default:                                                                   \
      return cudaErrorInvalidValue;                                            \
  }
