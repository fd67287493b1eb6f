// Forward fused chain: every factor of one planned stage applied to a tile in
// shared memory, one launch per stage.
//
// Replaces: src/repro/kernels/emit.py, _chain_kernel with direction="fwd",
// launched by chain_pallas (emit.py:575).  Same function: x (B, M, K) and
// per-sample factors (B, P_i, Q_i) in application order give
// (B, M, prod(Q) * K / prod(P)) in x's dtype, each element written at its
// final FastKron index; Q is tiled per factor (t_qs), one Q-tile digit each.
//
// What bounds it on an H100: bytes, where the tensor cores do the
// contractions.  A stage reads x once and writes y once (3.35 TB/s) and does
// 2*p_i FLOPs per element per factor: 67 TFLOP/s on the CUDA cores in f32,
// 495 TF32 on the tensor cores (a third of that in 3xTF32).  A Figure 9
// stage (M=1024, two 32x32 factors) moves 8.6 GB (2.56 ms) and does 1.4e11
// FLOPs (2.05 ms on the CUDA cores, 0.85 ms in 3xTF32).
//
// What the design does about it (kron_async.cuh holds the shared pieces):
// - Persistent blocks of 256 threads, at most 128 registers each, and a
//   block tile within half of an SM's shared memory, so that two blocks
//   share every SM; the host sizes the grid from the occupancy query
//   (kron_chain_fwd_occupancy).  Block j walks tiles j, j + nblk, ... of the
//   order (sample, Q-tile digits, row tile, column tile), so its tiles share
//   their sample and digits for long runs: the factor panels are loaded once
//   per block and again only when the sample or the digits change.
// - The last step writes every element at its final index through a table
//   of per-slice offsets built once per block; a tile adds one offset for
//   its row, column and digits.  The chain's intermediates never leave
//   shared memory.
//
// float32 stages (chain_tf32_kernel) run every contraction on the tensor
// cores as error-compensated 3xTF32 mma.sync.m16n8k8 products, as grad.cu's
// grad_tf32_kernel does, with the same pieces (kron_async.cuh):
// - Each product is lo*hi + hi*lo + hi*hi, the small terms first, into f32
//   accumulators (hi: v rounded to TF32; lo = v - hi): float32-grade sums.
//   Plain TF32 (hi*hi alone) reads about 500x worse and is not used.
// - The factor panels (the stage's Q-tile of each) are split once per
//   sample and digits, outside the tile loop, in fragment order.
// - The states are row-major, row m * s_i + sl holding slice sl's p_i
//   elements at stride pad16(p_i) + 4 (a warp's fragment loads fall in
//   distinct banks), so the mma's M is rows times slices (t_m' s_i): one-row
//   and 4-row calls fill its tiles as M = 1024 does.  x lands in state 0
//   straight from the copies, with no unpack.
// - Two buffers hold the states in turn; while the last step writes y, the
//   copies of the next tile's slab land in the buffer it does not read, so
//   a tile's loads overlap its last step (the whole tile for one factor)
//   and the other block's work on the SM.
// - Where p_i is not a multiple of 8, the columns p_i .. pad8(p_i) - 1 that
//   the last k-chunk reads are zeroed with the state (the panel's rows there
//   are zero too).
// - The walk advances by whole-number carries (TcWalk) and every state and
//   panel pointer is formed from the shared base where it is used: the
//   per-tile 64-bit divisions, and the generic loads a pointer picked from
//   a local array compiles to, had cost a fifth of the time.
// Measured by chip_smoke.py (phase 4) on an NVIDIA H100 80GB HBM3 at 700 W:
// a Figure 9 stage takes 4.6-4.7 ms alone (7.7-7.8 on the CUDA cores), 55%
// of its byte bound, a gp16 stage 1.2 ms (1.5).  No one unit bounds it: the
// tensor cores, shared memory and issue each read a third busy or less, and
// without its loads a stage still takes 4.1 ms; a warp's chunk waits on its
// fragment loads, the split and the three mma passes in turn.  Neither a
// third buffer (the next slab landing during the whole tile, in an XOR
// layout that drops the padding) nor loading the next chunk's fragments
// ahead (registers at the 128 cap) was faster.
// Stages with a factor or Q-tile under 8 wide, or whose layout does not
// leave room for a second block, stay on the CUDA cores.
//
// bfloat16 and float64 stages, and those float32 ones, run on the CUDA
// cores (chain_fwd_kernel):
// - Loads overlap compute.  Each tile's raw x slab (t_m' rows of t_k') comes
//   in by cp.async, in 16-byte chunks where the launch's rows and base
//   allow (8, 4, or element by element otherwise), into one slot; the tile
//   unpacks it into the (m, p, s) layout of chain state 0 at its start, and
//   the next tile's copy goes into the freed slot while the steps run.
// - Each step is a register-tiled contraction (kron::step): 8 panel columns
//   per thread (4 for f64) and 4, 2 or 1 slices, picked so that every thread
//   has work.  The states keep odd slice strides, so a warp's reads and
//   transposing stores fall in distinct banks, and the relayout into the
//   next state divides once per slice, not per element.
// - The contraction loops are bound by the loads' latency: per k a thread
//   issues two panel vectors and four state loads for 32 FMAs (a deeper
//   unroll was worth 13%), not by the FMA or shared-memory rates.  Measured
//   by chip_smoke.py (phase 4) on an NVIDIA H100 80GB HBM3 at 700 W: a
//   Figure 9 stage took 7.7 ms alone on this path, 33% of its byte bound, a
//   gp16 stage (M=16, two 16x16 factors) 1.5 ms, 42%.
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

template <typename T>
using ChainKernel = void (*)(ChainArgs, const T*, T*);

// ---------------------------------------------------------------------------
// float32 on the tensor cores (3xTF32)
// ---------------------------------------------------------------------------

// Zeros into the columns p .. pad8(p) - 1 of a row-major state's `rows`
// rows (stride ld), which the last k-chunk of its step reads.
__device__ __forceinline__ void tc_zero_pads(float* u, int rows, int p, int ld) {
  const int w = kron::pad8(p) - p;
  if (!w) return;
  for (int idx = threadIdx.x; idx < rows * w; idx += blockDim.x) {
    const int r = idx / w;
    u[r * ld + p + idx - r * w] = 0.f;
  }
}

// A block's place in the persistent walk, advanced by nblk tiles without a
// 64-bit division: tile = g * m_tiles * k_tiles + mt * k_tiles + kt, g the
// (sample, Q-tile digits) group.  The divisions run once per block.
struct TcWalk {
  long long tile, g;
  int mt, kt;
  long long dg;
  int dm, dk;
  __device__ explicit TcWalk(const ChainArgs& a) {
    const long long inner = a.m_tiles * a.k_tiles, t0 = blockIdx.x;
    tile = t0;
    g = t0 / inner;
    mt = static_cast<int>(t0 % inner / a.k_tiles);
    kt = static_cast<int>(t0 % a.k_tiles);
    dg = a.nblk / inner;
    dm = static_cast<int>(a.nblk % inner / a.k_tiles);
    dk = static_cast<int>(a.nblk % a.k_tiles);
  }
  __device__ __forceinline__ void advance(const ChainArgs& a) {
    tile += a.nblk;
    kt += dk;
    const int ck = kt >= a.k_tiles;
    kt -= ck * static_cast<int>(a.k_tiles);
    mt += dm + ck;
    const int cm = mt >= a.m_tiles;
    mt -= cm * static_cast<int>(a.m_tiles);
    g += dg + cm;
  }
};

// The copies of one tile's x slab (rows row0.., column tile kt) straight
// into state 0: row m * s_0 + sl holds slice sl's p_0 elements at stride
// ldu_0; a chunk never crosses a slice.
__device__ __forceinline__ void tc_fetch_slab(const ChainArgs& a, const float* __restrict__ x,
                                              long long row0, int kt, float* u0) {
  const int ex = a.t_k / a.nch, p = a.p[0], s = a.s[0], ld = a.ldu[0];
  const float* xs = x + row0 * a.K + static_cast<long long>(kt) * a.t_k;
  for (int idx = threadIdx.x; idx < a.t_m * a.nch; idx += blockDim.x) {
    const int m = kron::div_fast(idx, a.nch, a.rnch);
    const int c = (idx - m * a.nch) * ex;
    const int sl = kron::div_fast(c, p, a.rp[0]);
    kron::copy_chunk(u0 + (m * s + sl) * ld + c - sl * p, xs + m * a.K + c, a.vec);
  }
  tc_zero_pads(u0, a.t_m * s, p, ld);
}

// The last step's sink: output row r = m * s + sl, column c (the Q-tile
// local q of the last factor) to y + m * out_cols + table[sl] + c * ostride
// (y: the tile's row, column and digits).
struct TcOutSink {
  float* y;
  const int* table;
  long long cols, ostr;
  int s;
  float rs;
  __device__ __forceinline__ kron::TcRow row(int r) const {
    const int m = kron::div_fast(r, s, rs), sl = r - m * s;
    return {m * cols + table[sl], m, sl};
  }
  __device__ __forceinline__ void put(const kron::TcRow& w, int c, float v0, float v1,
                                      bool both) const {
    float* o = y + w.base + c * ostr;
    o[0] = v0;
    if (both) o[ostr] = v1;
  }
};

__global__ void __launch_bounds__(kron::kAsyncThreads, 2)
    chain_tf32_kernel(ChainArgs a, const float* __restrict__ x, float* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char kron_smem[];
  unsigned char* sm = kron_smem;
  const int n = a.n, last = n - 1;
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);  // uniform across the warp
  // Buffer j and panel i, formed from the shared base at each use so that
  // the compiler keeps their accesses in the shared window.
  auto state = [&](int j) { return reinterpret_cast<float*>(sm + a.buf[j]); };
  auto panel = [&](int i) { return reinterpret_cast<float4*>(sm + a.pan[i]); };
  int* table = reinterpret_cast<int*>(sm + a.table);
  for (int sl = threadIdx.x; sl < a.s[last]; sl += blockDim.x) {
    const int r = sl / a.ts_out;
    table[sl] = sl - r * a.ts_out + kron::chain_run_offset(a, r, last);
  }
  TcWalk w(a);
  long long group = -1;  // (sample, digits) of the panels in place
  long long dig_off = 0;
  // The group and sample of the walk's next slab (at the loop's top, this tile's).
  long long ng = w.g, nb = ng / a.q_tiles;
  int cur = 0;  // the buffer that holds this tile's state 0
  if (w.tile < a.tiles)
    tc_fetch_slab(a, x, nb * a.M + static_cast<long long>(w.mt) * a.t_m, w.kt, state(0));
  kron::cp_async_commit();
  while (w.tile < a.tiles) {
    const long long tile_g = w.g;
    const int kt = w.kt;
    const long long row0 = nb * a.M + static_cast<long long>(w.mt) * a.t_m;
    kron::cp_async_wait<0>();
    __syncthreads();  // this tile's slab is in place; the last tile's steps are done
    if (tile_g != group) {
      int qd[kMaxFactors];
      dig_off = kron::chain_digits(a, tile_g % a.q_tiles, qd);
      for (int i = 0; i < n; ++i)
        kron::tc_panel(kron::chain_factor<float>(a, i, nb), a.p[i], a.q[i], qd[i] * a.tq[i],
                       a.tq[i], false, panel(i));
      group = tile_g;
      __syncthreads();  // the panels are in place
    }
    // State i lies in buffer (cur + i) & 1.
    for (int i = 0; i < last; ++i) {
      float* un = state((cur + i + 1) & 1);
      const kron::TcFwdSink sink{un, a.s[i], a.p[i + 1], a.s[i + 1], a.ldu[i + 1], a.csf[i],
                                 a.rs[i], a.rp[i + 1]};
      kron::tc_step(warp, kron::kWarps, state((cur + i) & 1), a.ldu[i], 1, a.t_m * a.s[i],
                    a.p[i], panel(i), a.tq[i], sink);
      tc_zero_pads(un, a.t_m * a.s[i + 1], a.p[i + 1], a.ldu[i + 1]);
      __syncthreads();  // state i+1 is complete; state i's buffer is free
    }
    // The buffer the last step does not read takes the next tile's slab.
    w.advance(a);
    if (w.tile < a.tiles) {
      if (w.g != ng) {
        ng = w.g;
        nb = ng / a.q_tiles;
      }
      tc_fetch_slab(a, x, nb * a.M + static_cast<long long>(w.mt) * a.t_m, w.kt,
                    state((cur + n) & 1));
    }
    kron::cp_async_commit();
    const TcOutSink sink{y + row0 * a.out_cols + static_cast<long long>(kt) * a.ts_out + dig_off,
                         table, a.out_cols, a.ostride[last], a.s[last], a.rs[last]};
    kron::tc_step(warp, kron::kWarps, state((cur + last) & 1), a.ldu[last], 1,
                  a.t_m * a.s[last], a.p[last], panel(last), a.tq[last], sink);
    cur = (cur + n) & 1;
  }
}

// The launch's kernel: chain_tf32_kernel for a.tc (float32 only).
template <typename T, typename Acc>
ChainKernel<T> chain_kernel_for(const ChainArgs&) {
  return chain_fwd_kernel<T, Acc>;
}
template <>
ChainKernel<float> chain_kernel_for<float, float>(const ChainArgs& a) {
  return a.tc ? chain_tf32_kernel : chain_fwd_kernel<float, float>;
}

template <typename T, typename Acc>
int occupancy(const ChainArgs& a, int* blocks) {
  const ChainKernel<T> kernel = chain_kernel_for<T, Acc>(a);
  const int err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(a.smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kron::kAsyncThreads,
                                                       static_cast<size_t>(a.smem));
}

template <typename T, typename Acc>
int launch(const ChainArgs& a, void* stream, const void* x, void* y) {
  if (a.tiles == 0) return cudaSuccess;
  const ChainKernel<T> kernel = chain_kernel_for<T, Acc>(a);
  const int err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(a.smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(a.nblk), kron::kAsyncThreads, static_cast<size_t>(a.smem),
           static_cast<cudaStream_t>(stream)>>>(a, static_cast<const T*>(x), static_cast<T*>(y));
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
