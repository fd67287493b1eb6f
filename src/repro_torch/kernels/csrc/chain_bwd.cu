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
// TFLOP/s f32).  A Figure 9 stage moves 8.6 GB (2.56 ms) and does 1.4e11
// FLOPs (2.05 ms).
//
// What the design does about it (kron_async.cuh holds the shared pieces):
// - Persistent blocks of 256 threads, at most 128 registers each, and a
//   block tile within half of an SM's shared memory, so that two blocks
//   share every SM; the host sizes the grid from the occupancy query
//   (kron_chain_bwd_occupancy).  Block j walks dX tiles j, j + nblk, ... of
//   the order (sample, row tile, column tile); the transposed factor panels
//   are loaded once per block, again only when the sample (or, with Q
//   tiled, the Q-tile digits) change.
// - Loads overlap compute.  A tile's dY block (runs of ts_out elements of
//   the (B, M, Q_{n-1}..Q_0, S) view, their offsets from a table built once
//   per block) comes in by cp.async straight into the flat state G_n, in
//   16-byte chunks where the runs and base allow, and the first transposed
//   step reads it there in dY's dtype.  G_n has two slots: the next tile's
//   block lands in one while the steps run on the other.
// - Pallas sums the Q-tiles over a sequential grid axis; here one block owns
//   each dX tile and loops over its Q-tile digits in order, adding partial
//   dX into a shared-memory sum that the last digit stores.  No atomics: two
//   runs are equal bit for bit.  With Q whole (the planned stages) the last
//   step stores dX straight from registers, as 16-byte vectors when p is a
//   multiple of 4.
// - Each step is a register-tiled contraction (kron::step): 8 columns of p
//   per thread (4 for f64) and 4, 2 or 1 slices, picked so that every thread
//   has work; the flat states need no index arithmetic between steps.
// Measured by chip_smoke.py (phase 4) on an NVIDIA H100 80GB HBM3 at 700 W:
// a Figure 9 stage takes 7.6 ms alone, 34% of its byte bound; as in the
// forward chain, the contraction loops' load latency is what is left.
#include "kron_async.cuh"

namespace {

using kron::ChainArgs;
using kron::kMaxFactors;
using kron::kRQ;

// The copies of one dY block (rows row0.., column tile kt, Q-tile digits
// at output offset dig_off) into the flat G_n at dst: run r of row m lands
// at m * c_n + r * ts_out.
template <typename T>
__device__ void fetch_dy(const ChainArgs& a, const T* __restrict__ dy, long long row0,
                         long long kt, long long dig_off, const int* table, T* dst) {
  const int ed = a.ts_out / a.nch, per_row = a.runs * a.nch, cn = a.c[a.n];
  const float rper_row = 1.0f / per_row;
  const T* src = dy + row0 * a.out_cols + kt * a.ts_out + dig_off;
  for (int idx = threadIdx.x; idx < a.t_m * per_row; idx += blockDim.x) {
    const int m = kron::div_fast(idx, per_row, rper_row);
    const int rem = idx - m * per_row;
    const int r = kron::div_fast(rem, a.nch, a.rnch);
    const int c = (rem - r * a.nch) * ed;
    kron::copy_chunk(dst + m * cn + r * a.ts_out + c, src + m * a.out_cols + table[r] + c, a.vec);
  }
}

// Transposed step i over G_{i+1} at g (t_m rows of am elements; row m holds
// G_{i+1}[m, q * s_i + sl]) and the transposed panel: into the flat G_i at
// o for i > 0; for i = 0 into dX at dxt, through the Q-tile sum accb when
// Q is tiled (digit jq of q_tiles).
template <typename TA, typename T, typename Acc>
__device__ __forceinline__ void t_step(const ChainArgs& a, int i, const TA* g, int am,
                                       const Acc* panel, Acc* o, T* dxt, Acc* accb,
                                       long long jq) {
  const int p = a.p[i];
  const bool first = jq == 0, last = jq == a.q_tiles - 1;
  auto sink = [&](int m, int sl, int pb, const auto& v) {
    constexpr int R = sizeof(v) / sizeof(v[0]);
    if (i > 0) {
      kron::put_row(o, a.c[i], p, m, sl, pb, v);
    } else if (a.q_tiles == 1) {
      kron::put_row(dxt, a.K, p, m, sl, pb, v);
    } else {
      // The same thread owns these elements for every digit.
      Acc* sum = accb + m * a.t_k + sl * p + pb * R;
      T* d = dxt + m * a.K + sl * p + pb * R;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        if (pb * R + c >= p) continue;
        const Acc t = first ? v[c] : sum[c] + v[c];
        if (last) {
          kron::store(d + c, t);
        } else {
          sum[c] = t;
        }
      }
    }
  };
  const int s = a.s[i], tq = a.tq[i], ld = kron::pad8(p);
  if (kron::wide_rq<Acc>(p)) {
    kron::step<8>(a.t_m, s, ld / 8, g, am, s, panel, ld, tq, true, sink);
  } else {
    kron::step<4>(a.t_m, s, kron::pad4(p) / 4, g, am, s, panel, ld, tq, true, sink);
  }
}

template <typename T, typename Acc>
__global__ void __launch_bounds__(kron::kAsyncThreads, 2)
    chain_bwd_kernel(ChainArgs a, const T* __restrict__ dy, T* __restrict__ dx) {
  extern __shared__ __align__(16) unsigned char kron_smem[];
  unsigned char* sm = kron_smem;
  const int n = a.n;
  auto at = [&](int off) { return reinterpret_cast<Acc*>(sm + off); };
  T* slot[2] = {reinterpret_cast<T*>(sm + a.slot[0]), reinterpret_cast<T*>(sm + a.slot[1])};
  Acc* gbuf[2] = {at(a.buf[0]), at(a.buf[1])};
  Acc* accb = at(a.acc);
  // Run r of a dY block = (ql_{n-1}, .., ql_0): its offset in an output row.
  int* table = reinterpret_cast<int*>(sm + a.table);
  for (int r = threadIdx.x; r < a.runs; r += blockDim.x) table[r] = kron::chain_run_offset(a, r, n);
  __syncthreads();  // the copies read the table
  const long long inner = a.m_tiles * a.k_tiles, j0 = blockIdx.x;
  const long long mine = j0 < a.tiles ? (a.tiles - j0 + a.nblk - 1) / a.nblk : 0;
  const long long nst = mine * a.q_tiles;  // stages: (tile, Q-tile digit)
  auto fetch = [&](long long st) {
    const long long tile = j0 + st / a.q_tiles * a.nblk;
    int qd[kMaxFactors];
    const long long dig_off = kron::chain_digits(a, st % a.q_tiles, qd);
    fetch_dy(a, dy, tile / inner * a.M + tile % inner / a.k_tiles * a.t_m, tile % a.k_tiles,
             dig_off, table, slot[st & 1]);
  };
  if (nst > 0) fetch(0);
  kron::cp_async_commit();
  long long group = -1;  // (sample, digits) of the panels in place
  for (long long st = 0; st < nst; ++st) {
    const long long tile = j0 + st / a.q_tiles * a.nblk, jq = st % a.q_tiles;
    const long long b = tile / inner;
    const long long row0 = b * a.M + tile % inner / a.k_tiles * a.t_m;
    kron::cp_async_wait<0>();
    __syncthreads();  // this stage's dY is in place; the last stage is done
    if (st + 1 < nst) fetch(st + 1);
    kron::cp_async_commit();
    if (b * a.q_tiles + jq != group) {
      int qd[kMaxFactors];
      kron::chain_digits(a, jq, qd);
      for (int i = 0; i < n; ++i)
        kron::panel_t(kron::chain_factor<T>(a, i, b), a.p[i], a.q[i], qd[i] * a.tq[i], a.tq[i],
                      kron::pad8(a.p[i]), at(a.pan[i]));
      group = b * a.q_tiles + jq;
      __syncthreads();  // the panels are in place
    }
    T* dxt = dx + row0 * a.K + tile % a.k_tiles * a.t_k;
    for (int j = 0; j < n; ++j) {
      const int i = n - 1 - j;
      if (j == 0) {
        t_step(a, i, slot[st & 1], a.c[n], at(a.pan[i]), gbuf[0], dxt, accb, jq);
      } else {
        t_step(a, i, gbuf[(j - 1) & 1], a.c[i + 1], at(a.pan[i]), gbuf[j & 1], dxt, accb, jq);
      }
      if (i > 0) __syncthreads();  // G_i is complete
    }
  }
}

template <typename T, typename Acc>
int occupancy(const ChainArgs& a, int* blocks) {
  const int err = cudaFuncSetAttribute(reinterpret_cast<const void*>(chain_bwd_kernel<T, Acc>),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(a.smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, chain_bwd_kernel<T, Acc>,
                                                       kron::kAsyncThreads,
                                                       static_cast<size_t>(a.smem));
}

template <typename T, typename Acc>
int launch(const ChainArgs& a, void* stream, const void* dy, void* dx) {
  if (a.tiles == 0) return cudaSuccess;
  const int err = cudaFuncSetAttribute(reinterpret_cast<const void*>(chain_bwd_kernel<T, Acc>),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(a.smem));
  if (err != cudaSuccess) return err;
  chain_bwd_kernel<T, Acc><<<static_cast<unsigned>(a.nblk), kron::kAsyncThreads,
                             static_cast<size_t>(a.smem), static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const T*>(dy), static_cast<T*>(dx));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// fs: host array of n device pointers, each (B, ps[i], qs[i]) contiguous.
// dy (B, M, prod(qs) * K/prod(ps)) -> dx (B, M, K); tqs: the Q-tile of each
// factor.  (t_m, t_k): the block tile, in dX's columns; nblk: blocks of the
// persistent grid.
int kron_chain_bwd(int dtype, const void* dy, void* dx, const void* const* fs, const int* ps,
                   const int* qs, const int* tqs, int n, long long B, long long M,
                   long long K, int t_m, int t_k, int nblk, void* stream) {
  ChainArgs a;
  const int err = kron::chain_args(&a, kron::kChainBwd, dtype, dy, fs, ps, qs, tqs, n, B, M, K,
                                   t_m, t_k, nblk);
  if (err != cudaSuccess) return err;
  switch (dtype) {
    case 0:
      return launch<float, float>(a, stream, dy, dx);
    case 1:
      return launch<__nv_bfloat16, float>(a, stream, dy, dx);
    default:
      return launch<double, double>(a, stream, dy, dx);
  }
}

// Blocks of kron_chain_bwd's kernel that fit one SM at this block tile
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor for its 256 threads and
// shared memory), into *blocks; its shared memory in bytes into *smem.
int kron_chain_bwd_occupancy(int dtype, const int* ps, const int* qs, const int* tqs, int n,
                             long long M, long long K, int t_m, int t_k, int* blocks,
                             long long* smem) {
  ChainArgs a;
  const void* fs[kMaxFactors] = {};
  const int err = kron::chain_args(&a, kron::kChainBwd, dtype, nullptr, fs, ps, qs, tqs, n, 1, M,
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
