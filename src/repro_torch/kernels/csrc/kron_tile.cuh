// One block tile of a FastKron chain: the device code shared by chain_fwd.cu
// and sliced.cu, and the host code that fills a launch's arguments.
//
// A block owns one batch sample, t_m rows, one Q-tile digit per factor and a
// t_k column slab of x (t_k a multiple of prod(P)).  It loads the slab into
// shared memory once, applies every factor of the chain there, and writes
// each output element straight to its final FastKron index:
//
//   state i (i = 0 .. n-1) lives in shared memory as (m, p, s): element
//   A[m, s*p_i + pp] sits at m*p_i*sstr_i + pp*sstr_i + s.  Keeping the
//   contraction index pp major makes a warp's reads of A contiguous along s,
//   and the odd slice stride sstr_i = s_i | 1 spreads the transposing stores
//   over all 32 banks.
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
// accumulator type Acc inside the block; only the last step rounds to T, as
// it stores.  Every global offset is 64-bit.
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
  int sstr[kMaxFactors];       // padded slice stride of state i in smem
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
  int buf0, buf1, panel;       // smem elements: even states, odd states, panel
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

template <typename T, typename Acc>
__device__ void chain_block(const TileArgs& a, const T* __restrict__ x,
                            T* __restrict__ y, Acc* smem) {
  long long blk = blockIdx.x;
  const long long kt = blk % a.k_tiles;
  blk /= a.k_tiles;
  const long long jq = blk % a.q_tiles;
  blk /= a.q_tiles;
  const long long mt = blk % a.m_tiles;
  const long long b = blk / a.m_tiles;
  const long long row0 = b * a.M + mt * a.t_m;  // batch folded into rows

  // Q-tile digit of every factor: mixed radix, factor 0 minor.
  int qd[kMaxFactors];
  {
    long long r = jq;
    for (int i = 0; i < a.n; ++i) {
      qd[i] = static_cast<int>(r % a.nq[i]);
      r /= a.nq[i];
    }
  }

  Acc* cur = smem;
  Acc* nxt = smem + a.buf0;
  Acc* panel = nxt + a.buf1;

  // Load the x slab, transposed to the (m, p, s) state layout: coalesced,
  // kLoadUnroll independent loads per thread in flight.
  {
    const int p0 = a.p[0], st0 = a.sstr[0], ms0 = p0 * st0;
    const float rtk = 1.0f / a.t_k;
    const int total = a.t_m * a.t_k;
    const T* xs = x + row0 * a.K + kt * a.t_k;
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
          cur[m * ms0 + (c - sp * p0) * st0 + sp] = to_acc(v[u]);
        }
      }
    }
  }

  for (int i = 0; i < a.n; ++i) {
    const int p = a.p[i], tq = a.tq[i], s = a.s[i], st = a.sstr[i];
    const int tq4 = (tq + kRQ - 1) / kRQ * kRQ;
    {
      // The (p, tq) panel of factor i for this Q-tile, zero-padded to tq4.
      const T* f = static_cast<const T*>(a.f[i]) + b * p * static_cast<long long>(a.q[i]) +
                   static_cast<long long>(qd[i]) * tq;
      const float rtq4 = 1.0f / tq4;
      const int total = p * tq4;
      for (int base = threadIdx.x; base < total; base += kLoadUnroll * blockDim.x) {
        Acc v[kLoadUnroll];
#pragma unroll
        for (int u = 0; u < kLoadUnroll; ++u) {
          const int idx = base + u * blockDim.x;
          const int r = div_fast(idx, tq4, rtq4);
          const int c = idx - r * tq4;
          v[u] = idx < total && c < tq ? to_acc(f[static_cast<long long>(r) * a.q[i] + c])
                                       : Acc(0);
        }
#pragma unroll
        for (int u = 0; u < kLoadUnroll; ++u) {
          const int idx = base + u * blockDim.x;
          if (idx < total) panel[idx] = v[u];
        }
      }
    }
    __syncthreads();  // slab/state i and the panel are in place

    const bool last = i + 1 == a.n;
    const int ms = p * st;
    const int pn = last ? 1 : a.p[i + 1];
    const float rpn = last ? 1.0f : a.rp[i + 1];
    const int stn = last ? 1 : a.sstr[i + 1];
    const int msn = pn * stn;
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
      if (!last) {
        // Next state's layout: column col -> (col % p', col / p').
#pragma unroll
        for (int r = 0; r < kRS; ++r) {
          const int sp = sb + r * nsb;
          if (sp >= s) continue;
#pragma unroll
          for (int c = 0; c < kRQ; ++c) {
            const int ql = qb * kRQ + c;
            if (ql >= tq) continue;
            const int col = ql * s + sp;
            const int j = div_fast(col, pn, rpn);
            nxt[m * msn + (col - j * pn) * stn + j] = acc[r][c];
          }
        }
      } else {
        // Tile column (ql, q_{n-2}, ..., q_0, s_local) -> global index.
        T* yrow = y + (row0 + m) * a.out_cols + kt * a.ts_out;
#pragma unroll
        for (int r = 0; r < kRS; ++r) {
          const int sp = sb + r * nsb;
          if (sp >= s) continue;
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
            store(yrow + off + static_cast<long long>(qd[i] * tq + ql) * a.ostride[i],
                  acc[r][c]);
          }
        }
      }
    }
    __syncthreads();  // state i+1 complete; state i and the panel are free
    Acc* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

// Host side: fill the arguments of one launch.  Returns cudaSuccess or
// cudaErrorInvalidValue for a tile the kernel cannot take.  The buffer and
// panel sizes must match repro_torch.kernels.emit.block_smem_bytes.
inline int make_args(TileArgs* a, const void* const* fs, const int* ps, const int* qs,
                     const int* tqs, int n, long long B, long long M, long long K,
                     int t_m, int t_k) {
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
    // Buffers are rounded to 4 elements so the panel stays 16-byte aligned.
    const long long elems = (static_cast<long long>(t_m) * ps[i] * (s | 1) + 3) / 4 * 4;
    if (elems > buf[i % 2]) buf[i % 2] = elems;
    const long long pe = static_cast<long long>(ps[i]) * ((tqs[i] + kRQ - 1) / kRQ * kRQ);
    if (pe > panel) panel = pe;
    cols = s * tqs[i];
  }
  if (buf[0] + buf[1] + panel > (1 << 22)) return cudaErrorInvalidValue;
  a->buf0 = static_cast<int>(buf[0]);
  a->buf1 = static_cast<int>(buf[1]);
  a->panel = static_cast<int>(panel);
  return cudaSuccess;
}

template <typename T>
using TileKernel = void (*)(TileArgs, const T*, T*);

template <typename T, typename Acc>
int launch(TileKernel<T> kernel, const TileArgs& a, const void* x, void* y, void* stream) {
  const size_t smem = sizeof(Acc) * (static_cast<size_t>(a.buf0) + a.buf1 + a.panel);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  const long long blocks = a.B * a.m_tiles * a.q_tiles * a.k_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  if (blocks == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel), cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const T*>(x), static_cast<T*>(y));
  return cudaGetLastError();
}

}  // namespace kron

// dtype codes shared with the Python wrappers: 0 float32, 1 bfloat16, 2 float64.
#define KRON_DISPATCH(dtype, KERNEL, ...)                                         \
  switch (dtype) {                                                                \
    case 0:                                                                       \
      return kron::launch<float, float>(KERNEL<float, float>, __VA_ARGS__);       \
    case 1:                                                                       \
      return kron::launch<__nv_bfloat16, float>(KERNEL<__nv_bfloat16, float>,     \
                                                __VA_ARGS__);                     \
    case 2:                                                                       \
      return kron::launch<double, double>(KERNEL<double, double>, __VA_ARGS__);   \
    default:                                                                      \
      return cudaErrorInvalidValue;                                               \
  }
