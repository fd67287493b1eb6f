// Forward fused chain: every factor of one planned stage applied to a tile in
// shared memory, one launch per stage.
//
// Replaces: src/repro/kernels/emit.py, _chain_kernel with direction="fwd",
// launched by chain_pallas (emit.py:575).  Same function: x (B, M, K) and
// per-sample factors (B, P_i, Q_i) in application order give
// (B, M, prod(Q) * K / prod(P)) in x's dtype, each element written at its
// final FastKron index; Q is tiled per factor (t_qs), one Q-tile digit each.
//
// What bounds it on an H100: bytes and operations are close.  A stage reads
// x once and writes y once (3.35 TB/s) and does 2*p_i FLOPs per element per
// factor on the CUDA cores (67 TFLOP/s f32; there is no tensor-core path
// here).  A Figure 9 stage (M=1024, two 32x32 factors) moves 8.6 GB (2.56
// ms) and does 1.4e11 FLOPs (2.05 ms).
//
// What the design does about it (kron_async.cuh holds the shared pieces):
// - Persistent blocks of 256 threads, at most 128 registers each, and a
//   block tile within half of an SM's shared memory, so that two blocks
//   share every SM; the host sizes the grid from the occupancy query
//   (kron_chain_fwd_occupancy).  Block j walks tiles j, j + nblk, ... of the
//   order (sample, Q-tile digits, row tile, column tile), so its tiles share
//   their sample and digits for long runs: the factor panels are loaded once
//   per block and again only when the sample or the digits change.
// - Loads overlap compute.  Each tile's raw x slab (t_m' rows of t_k') comes
//   in by cp.async, in 16-byte chunks where the launch's rows and base
//   allow (8, 4, or element by element otherwise), into one slot; the tile
//   unpacks it into the (m, p, s) layout of chain state 0 at its start, and
//   the next tile's copy goes into the freed slot while the steps run.
// - Each step is a register-tiled contraction (kron::step): 8 panel columns
//   per thread (4 for f64) and 4, 2 or 1 slices, picked so that every thread
//   has work.  The states keep odd slice strides, so a warp's reads and
//   transposing stores fall in distinct banks, and the relayout into the
//   next state divides once per slice, not per element.  The chain's
//   intermediates never leave shared memory.
// - The last step writes every element at its final index through a table
//   of per-slice offsets built once per block; a tile adds one offset for
//   its row, column and digits.
// Measured by chip_smoke.py (phase 4) on an NVIDIA H100 80GB HBM3 at 700 W:
// a Figure 9 stage takes 7.7 ms alone, 33% of its byte bound, a gp16 stage
// (M=16, two 16x16 factors) 1.5 ms, 42%.  The contraction loops take most
// of it: per k a thread issues two panel vectors and four state loads for
// 32 FMAs, and the loops are bound by the loads' latency (a deeper unroll
// was worth 13%), not by the FMA or shared-memory rates.
#include "kron_async.cuh"

namespace {

using kron::ChainArgs;
using kron::kMaxFactors;
using kron::kRQ;

// The copies of one tile's x slab into the slot (rows of t_k).
template <typename T>
__device__ void fetch_slab(const ChainArgs& a, const T* __restrict__ x, long long row0,
                           long long kt, unsigned char* sm) {
  T* sx = reinterpret_cast<T*>(sm + a.slot[0]);
  const int ex = a.t_k / a.nch;
  const T* xs = x + row0 * a.K + kt * a.t_k;
  for (int idx = threadIdx.x; idx < a.t_m * a.nch; idx += blockDim.x) {
    const int m = kron::div_fast(idx, a.nch, a.rnch);
    const int c = (idx - m * a.nch) * ex;
    kron::copy_chunk(sx + m * a.t_k + c, xs + m * a.K + c, a.vec);
  }
}

// The slot's raw slab into chain state 0, (m, p_0, sst_0): four columns at
// a time when p_0 is a multiple of 4 (one slice, one vector read).
template <typename T, typename Acc>
__device__ void unpack_slab(const ChainArgs& a, const unsigned char* sm, Acc* u0) {
  const T* sx = reinterpret_cast<const T*>(sm + a.slot[0]);
  const int p = a.p[0], st = a.sst[0];
  if (p % 4 == 0) {
    const int t4 = a.t_k / 4;
    const float rt4 = 1.0f / t4;
    for (int idx = threadIdx.x; idx < a.t_m * t4; idx += blockDim.x) {
      const int m = kron::div_fast(idx, t4, rt4);
      const int col = (idx - m * t4) * 4;
      const int sl = kron::div_fast(col, p, a.rp[0]);
      Acc v[4];
      kron::load4(sx + m * a.t_k + col, v);
      Acc* d = u0 + (m * p + col - sl * p) * st + sl;
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e * st] = v[e];
    }
    return;
  }
  const float rtk = 1.0f / a.t_k;
  for (int idx = threadIdx.x; idx < a.t_m * a.t_k; idx += blockDim.x) {
    const int m = kron::div_fast(idx, a.t_k, rtk);
    const int col = idx - m * a.t_k;
    const int sl = kron::div_fast(col, p, a.rp[0]);
    u0[(m * p + col - sl * p) * st + sl] = kron::to_acc(sx[idx]);
  }
}

// Step i < n-1: state i into state i+1 (both (m, p, sst) layouts).  The
// output column col = ql * s_i + sl goes to (col % p', col / p') of the
// next state; p' divides s_i, so that is (sl % p', ql * s_i/p' + sl / p'),
// one division per slice.
template <typename Acc>
__device__ __forceinline__ void fwd_step(const ChainArgs& a, int i, const Acc* cur,
                                         const Acc* panel, Acc* nxt) {
  const int p = a.p[i], tq = a.tq[i], s = a.s[i], st = a.sst[i], ld = kron::pad8(tq);
  const int pn = a.p[i + 1], stn = a.sst[i + 1], sdiv = s / pn;
  const float rpn = a.rp[i + 1];
  auto sink = [&](int m, int sl, int qb, const auto& v) {
    constexpr int R = sizeof(v) / sizeof(v[0]);
    const int j = kron::div_fast(sl, pn, rpn);
    Acc* o = nxt + (m * pn + sl - j * pn) * stn + j;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int ql = qb * R + c;
      if (ql < tq) o[ql * sdiv] = v[c];
    }
  };
  if (kron::wide_rq<Acc>(tq)) {
    kron::step<8>(a.t_m, s, ld / 8, cur, p * st, st, panel, ld, p, false, sink);
  } else {
    kron::step<4>(a.t_m, s, kron::pad4(tq) / 4, cur, p * st, st, panel, ld, p, false, sink);
  }
}

// The last step: every element to its final index, yt + m * out_cols +
// table[sl] + ql * ostride_{n-1} (yt: the tile's row, column and digits).
template <typename T, typename Acc>
__device__ __forceinline__ void fwd_last(const ChainArgs& a, const Acc* cur, const Acc* panel,
                                         const int* table, T* yt) {
  const int i = a.n - 1;
  const int p = a.p[i], tq = a.tq[i], s = a.s[i], st = a.sst[i], ld = kron::pad8(tq);
  const long long ostr = a.ostride[i];
  auto sink = [&](int m, int sl, int qb, const auto& v) {
    constexpr int R = sizeof(v) / sizeof(v[0]);
    T* o = yt + m * a.out_cols + table[sl];
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int ql = qb * R + c;
      if (ql < tq) kron::store(o + ql * ostr, v[c]);
    }
  };
  if (kron::wide_rq<Acc>(tq)) {
    kron::step<8>(a.t_m, s, ld / 8, cur, p * st, st, panel, ld, p, false, sink);
  } else {
    kron::step<4>(a.t_m, s, kron::pad4(tq) / 4, cur, p * st, st, panel, ld, p, false, sink);
  }
}

template <typename T, typename Acc>
__global__ void __launch_bounds__(kron::kAsyncThreads, 2)
    chain_fwd_kernel(ChainArgs a, const T* __restrict__ x, T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char kron_smem[];
  unsigned char* sm = kron_smem;
  const int n = a.n, t_m = a.t_m, last = n - 1;
  auto at = [&](int off) { return reinterpret_cast<Acc*>(sm + off); };
  Acc* buf[2] = {at(a.buf[0]), at(a.buf[1])};
  // Slice sl of the last state = (ql_{n-2}, .., ql_0, s_local): its offset
  // in an output row, less the tile's own (row, column, digits) offset.
  int* table = reinterpret_cast<int*>(sm + a.table);
  for (int sl = threadIdx.x; sl < a.s[last]; sl += blockDim.x) {
    const int r = sl / a.ts_out;
    table[sl] = sl - r * a.ts_out + kron::chain_run_offset(a, r, last);
  }
  const long long inner = a.m_tiles * a.k_tiles;
  const long long j0 = blockIdx.x;
  long long group = -1;  // (sample, digits) of the panels in place
  long long dig_off = 0;
  if (j0 < a.tiles) fetch_slab(a, x, j0 / inner / a.q_tiles * a.M + j0 % inner / a.k_tiles * t_m,
                               j0 % a.k_tiles, sm);
  kron::cp_async_commit();
  for (long long tile = j0; tile < a.tiles; tile += a.nblk) {
    const long long g = tile / inner, b = g / a.q_tiles;
    const long long row0 = b * a.M + tile % inner / a.k_tiles * t_m;
    kron::cp_async_wait<0>();
    __syncthreads();  // this tile's slab is in place; the last tile's steps are done
    if (g != group) {
      int qd[kMaxFactors];
      dig_off = kron::chain_digits(a, g % a.q_tiles, qd);
      for (int i = 0; i < n; ++i)
        kron::panel_fwd(kron::chain_factor<T>(a, i, b), a.p[i], a.q[i], qd[i] * a.tq[i], a.tq[i],
                        kron::pad8(a.tq[i]), at(a.pan[i]));
      group = g;
    }
    unpack_slab<T>(a, sm, buf[0]);
    __syncthreads();  // state 0 and the panels are in place; the slot is free
    const long long next = tile + a.nblk;
    if (next < a.tiles)
      fetch_slab(a, x, next / inner / a.q_tiles * a.M + next % inner / a.k_tiles * t_m,
                 next % a.k_tiles, sm);
    kron::cp_async_commit();
    for (int i = 0; i < n; ++i) {
      if (i < last) {
        fwd_step<Acc>(a, i, buf[i & 1], at(a.pan[i]), buf[(i + 1) & 1]);
        __syncthreads();  // state i+1 is complete
      } else {
        fwd_last<T>(a, buf[i & 1], at(a.pan[i]), table,
                    y + row0 * a.out_cols + tile % a.k_tiles * a.ts_out + dig_off);
      }
    }
  }
}

template <typename T, typename Acc>
int occupancy(const ChainArgs& a, int* blocks) {
  const int err = cudaFuncSetAttribute(reinterpret_cast<const void*>(chain_fwd_kernel<T, Acc>),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(a.smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, chain_fwd_kernel<T, Acc>,
                                                       kron::kAsyncThreads,
                                                       static_cast<size_t>(a.smem));
}

template <typename T, typename Acc>
int launch(const ChainArgs& a, void* stream, const void* x, void* y) {
  if (a.tiles == 0) return cudaSuccess;
  const int err = cudaFuncSetAttribute(reinterpret_cast<const void*>(chain_fwd_kernel<T, Acc>),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(a.smem));
  if (err != cudaSuccess) return err;
  chain_fwd_kernel<T, Acc><<<static_cast<unsigned>(a.nblk), kron::kAsyncThreads,
                             static_cast<size_t>(a.smem), static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const T*>(x), static_cast<T*>(y));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// fs: host array of n device pointers, each (B, ps[i], qs[i]) contiguous.
// tqs: the Q-tile of each factor.  (t_m, t_k): the block tile; nblk: blocks
// of the persistent grid.
int kron_chain_fwd(int dtype, const void* x, void* y, const void* const* fs, const int* ps,
                   const int* qs, const int* tqs, int n, long long B, long long M,
                   long long K, int t_m, int t_k, int nblk, void* stream) {
  ChainArgs a;
  const int err = kron::chain_args(&a, kron::kChainFwd, dtype, x, fs, ps, qs, tqs, n, B, M, K,
                                   t_m, t_k, nblk);
  if (err != cudaSuccess) return err;
  switch (dtype) {
    case 0:
      return launch<float, float>(a, stream, x, y);
    case 1:
      return launch<__nv_bfloat16, float>(a, stream, x, y);
    default:
      return launch<double, double>(a, stream, x, y);
  }
}

// Blocks of kron_chain_fwd's kernel that fit one SM at this block tile
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor for its 256 threads and
// shared memory), into *blocks; its shared memory in bytes into *smem.
int kron_chain_fwd_occupancy(int dtype, const int* ps, const int* qs, const int* tqs, int n,
                             long long M, long long K, int t_m, int t_k, int* blocks,
                             long long* smem) {
  ChainArgs a;
  const void* fs[kMaxFactors] = {};
  const int err = kron::chain_args(&a, kron::kChainFwd, dtype, nullptr, fs, ps, qs, tqs, n, 1, M,
                                   K, t_m, t_k, 1);
  if (err != cudaSuccess) return err;
  *smem = a.smem;
  switch (dtype) {
    case 0:
      return occupancy<float, float>(a, blocks);
    case 1:
      return occupancy<__nv_bfloat16, float>(a, blocks);
    default:
      return occupancy<double, double>(a, blocks);
  }
}

const char* kron_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
