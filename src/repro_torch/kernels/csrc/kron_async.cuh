// Hopper pieces of the persistent kernels (chain_fwd.cu, chain_bwd.cu,
// grad.cu, sliced.cu, sliced_t.cu): the asynchronous copies of the next tile, the
// register-tiled contraction step, the chain kernels' launch arguments and
// walk, the persistent per-thread dF accumulator, the bf16 tensor-core step,
// and the 3xTF32 split of float32 operands with the chain step built on it
// (split factor panels, warp-tiled mma.sync, the row-major forward sink),
// which the f32 forward chain and the f32 stage backward share.
//
// Every piece of inline PTX sits behind one small device function below
// (cp_async16/8/4, cp_async_commit, cp_async_wait, mma_bf16_16816,
// ldmatrix_x4_trans, mma_tf32_1688).  A host build that defines
// KRON_PTX_STUB supplies scalar bodies for them instead, so that the index
// math of the kernels can be rehearsed on a CPU.
//
// The copies: a block walks its tiles in a fixed order and keeps the next
// tile's operands in flight with cp.async while it computes on the current
// one.  Copies are chunks of 16, 8 or 4 bytes (the widest that every run,
// offset and base pointer of the launch allows, chosen on the host); an
// input whose runs allow no 4-byte chunk (bfloat16 at an odd offset) is
// copied element by element with ordinary loads.
//
// The contraction step: acc[r][c] += sum_k A[k*lda + soff[r]] * B[k*ldb + c]
// for RS slices r of one thread and RQ = 4 or 8 consecutive panel columns c
// (one or two 16-byte vectors).  Both the forward step (A = a chain state in the (m, p,
// s) layout, B = the (p, q) panel) and the transposed step (A = a gradient
// state in the (m, q, s) layout, flat or padded, B = the transposed (q, p)
// panel) are this loop; RS is picked per step so that every thread of the
// block has work.
//
// The chain kernels (ChainArgs, chain_args): a persistent grid walks the
// tiles of one stage, each block every nblk-th tile in an order that keeps
// a block on one sample and one set of Q-tile digits for long runs, so the
// factor panels stay in shared memory between tiles.
//
// The dF accumulator: each thread owns a fixed set of (group, 4x4 tile)
// items of every factor's dF for the whole tile loop and keeps their sums
// in its own slice of shared memory (element-major, so a warp's accesses
// fall in distinct banks).  Nothing else reads a slice until the block's
// tiles are done; then the groups are summed once, in group order.
#pragma once

#include <initializer_list>

#include "kron_tile.cuh"

namespace kron {

constexpr int kAsyncThreads = 256;           // threads of a persistent kernel's block
constexpr int kWarps = kAsyncThreads / 32;

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------
#ifndef KRON_PTX_STUB
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// d += A * B for one 16x8x16 tile: A (16x16, row-major) bf16, B (16x8,
// column-major) bf16, d f32; the fragments hold the PTX ISA's per-lane
// elements (two bf16 per 32-bit register, the lower index in the low half).
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4],
                                               const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// Four 8x8 bf16 matrices, transposed, from shared memory: lane l gives the
// address of row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned); r[i]
// receives this lane's elements of the transpose of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}
// d += A * B for one 16x8x8 tile: A (16x8, row-major) and B (8x8,
// column-major) TF32, d f32.  Lane l (g = l / 4, t = l % 4) holds a = {A[g][t],
// A[g+8][t], A[g][t+4], A[g+8][t+4]}, b = {B[t][g], B[t+4][g]} and d = {C[g][2t],
// C[g][2t+1], C[g+8][2t], C[g+8][2t+1]}.
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const unsigned (&a)[4],
                                              const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

// The 3xTF32 split: hi is v rounded to TF32 (10 explicit mantissa bits), to
// nearest with ties away from zero, as cvt.rna.tf32.f32 rounds a finite v
// (an integer add and mask, where cvt.rna compiles to three instructions;
// an infinite or NaN v leaves lo non-finite); lo = v - hi is exact and under
// 2^-11 of |v|, and the mma reads its top 19 bits, so the pair is v to 2^-21
// of |v| (rounding lo too would gain nothing measurable: the f32 sums round
// more).
__device__ __forceinline__ void split_tf32(float v, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// One chunk of a run from device to shared memory: `vbytes` of 16, 8 or 4
// go through cp.async; 0 copies one element with ordinary loads.
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, int vbytes) {
  if (vbytes == 16) {
    cp_async16(dst, src);
  } else if (vbytes == 8) {
    cp_async8(dst, src);
  } else if (vbytes == 4) {
    cp_async4(dst, src);
  } else {
    *dst = *src;
  }
}

// Host side: the widest chunk (16, 8 or 4 bytes; 0 = element by element)
// that divides every run length, run offset and base address, all given in
// bytes.
inline int chunk_bytes(std::initializer_list<long long> bytes) {
  for (int v : {16, 8, 4}) {
    bool ok = true;
    for (long long b : bytes) ok = ok && b % v == 0;
    if (ok) return v;
  }
  return 0;
}

inline long long round16(long long bytes) { return (bytes + 15) / 16 * 16; }
__host__ __device__ inline int pad4(int e) { return (e + 3) / 4 * 4; }
__host__ __device__ inline int pad8(int e) { return (e + 7) / 8 * 8; }
__host__ __device__ inline int pad16(int e) { return (e + 15) / 16 * 16; }

// Four consecutive bfloat16 (8-byte aligned) as floats.
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const __nv_bfloat162 a = reinterpret_cast<const __nv_bfloat162*>(p)[0];
  const __nv_bfloat162 b = reinterpret_cast<const __nv_bfloat162*>(p)[1];
  v[0] = __bfloat162float(a.x);
  v[1] = __bfloat162float(a.y);
  v[2] = __bfloat162float(b.x);
  v[3] = __bfloat162float(b.y);
}

// ---------------------------------------------------------------------------
// Panels, loaded once per block
// ---------------------------------------------------------------------------

// Columns [q0, q0 + tq) of f (p, q) row-major into dst[pp * ld + c]
// (forward orientation); columns tq..ld-1 are zero.
template <typename T, typename Acc>
__device__ void panel_fwd(const T* __restrict__ f, int p, int q, int q0, int tq, int ld,
                          Acc* dst) {
  const int total = p * ld;
  const float rld = 1.0f / ld;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int r = div_fast(idx, ld, rld);
    const int c = idx - r * ld;
    dst[idx] = c < tq ? to_acc(f[static_cast<long long>(r) * q + q0 + c]) : Acc(0);
  }
}

// Columns [q0, q0 + tq) of f (p, q) transposed: dst[c * ld + pp] for
// c < tq (ld >= p, padding zero).  Reads run along f's rows.
template <typename T, typename Acc>
__device__ void panel_t(const T* __restrict__ f, int p, int q, int q0, int tq, int ld, Acc* dst) {
  const int total = ld * tq;
  const float rtq = 1.0f / tq;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int pp = div_fast(idx, tq, rtq);
    const int c = idx - pp * tq;
    dst[c * ld + pp] = pp < p ? to_acc(f[static_cast<long long>(pp) * q + q0 + c]) : Acc(0);
  }
}

// ---------------------------------------------------------------------------
// The register-tiled contraction step
// ---------------------------------------------------------------------------

// acc[r][c] += sum_{k < nk} A[k * lda + soff[r]] * B[k * ldb + c], for RQ
// (4 or 8) consecutive panel columns c read as 16-byte vectors.
template <int RS, int RQ, typename TA, typename Acc>
__device__ __forceinline__ void contract(Acc (&acc)[RS][RQ], const TA* __restrict__ A, int lda,
                                         const int (&soff)[RS], const Acc* __restrict__ B,
                                         int ldb, int nk) {
  constexpr int kUnroll = sizeof(Acc) == 8 ? 2 : 4;  // f64 would spill at 4
#pragma unroll(kUnroll)
  for (int k = 0; k < nk; ++k) {
    Acc bv[RQ];
#pragma unroll
    for (int h = 0; h < RQ / 4; ++h) {
      Acc t[4];
      load4(B + k * ldb + 4 * h, t);
#pragma unroll
      for (int e = 0; e < 4; ++e) bv[4 * h + e] = t[e];
    }
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      const Acc av = to_acc(A[k * lda + soff[r]]);
#pragma unroll
      for (int c = 0; c < RQ; ++c) acc[r][c] += av * bv[c];
    }
  }
}

// The largest RS of {4, 2, 1} at which `rows * ceil(s / RS)` work items
// still give every thread of the block one (1 when none does).
__device__ __forceinline__ int pick_rs(int rows, int s) {
  const int threads = blockDim.x;
  if (rows * ((s + 3) / 4) >= threads) return 4;
  if (rows * ((s + 1) / 2) >= threads) return 2;
  return 1;
}

// One step over a state of t_m rows: for every row m, slice sl < s and
// column block xb < nxb, v[c] = sum_k A[m*am + k*lda + sl] * B[k*ldb +
// xb*RQ + c] (c < RQ) is handed to sink(m, sl, xb, v).  Lanes take
// neighbouring xb first when xb_fast (neighbouring output vectors), else
// neighbouring slices.  A thread's RS slices are strided by ceil(s / RS).
template <int RS, int RQ, typename TA, typename Acc, typename Sink>
__device__ __forceinline__ void step_rs(int t_m, int s, int nxb, const TA* A, int am, int lda,
                                        const Acc* B, int ldb, int nk, bool xb_fast, Sink sink) {
  const int nsb = (s + RS - 1) / RS;
  const float rnsb = 1.0f / nsb, rnxb = 1.0f / nxb;
  const int work = t_m * nsb * nxb;
  for (int w = threadIdx.x; w < work; w += blockDim.x) {
    int m, sb, xb;
    if (xb_fast) {
      const int t = div_fast(w, nxb, rnxb);
      xb = w - t * nxb;
      m = div_fast(t, nsb, rnsb);
      sb = t - m * nsb;
    } else {
      const int t = div_fast(w, nsb, rnsb);
      sb = w - t * nsb;
      m = div_fast(t, nxb, rnxb);
      xb = t - m * nxb;
    }
    int soff[RS];
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      const int sl = sb + r * nsb;
      soff[r] = sl < s ? sl : 0;  // out-of-range slices read slice 0, never stored
    }
    Acc acc[RS][RQ];
#pragma unroll
    for (int r = 0; r < RS; ++r)
#pragma unroll
      for (int c = 0; c < RQ; ++c) acc[r][c] = Acc(0);
    contract<RS, RQ>(acc, A + m * am, lda, soff, B + xb * RQ, ldb, nk);
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      const int sl = sb + r * nsb;
      if (sl < s) sink(m, sl, xb, acc[r]);
    }
  }
}

template <int RQ = kRQ, typename TA, typename Acc, typename Sink>
__device__ __forceinline__ void step(int t_m, int s, int nxb, const TA* A, int am, int lda,
                                     const Acc* B, int ldb, int nk, bool xb_fast, Sink sink) {
  const int rs = pick_rs(t_m * nxb, s);
  if (rs == 4) {
    step_rs<4, RQ>(t_m, s, nxb, A, am, lda, B, ldb, nk, xb_fast, sink);
  } else if (rs == 2) {
    step_rs<2, RQ>(t_m, s, nxb, A, am, lda, B, ldb, nk, xb_fast, sink);
  } else {
    step_rs<1, RQ>(t_m, s, nxb, A, am, lda, B, ldb, nk, xb_fast, sink);
  }
}

// The panel width (columns per thread) of a chain step: 8 for a f32
// accumulator and panels wider than 4, else 4.  Panels are padded to a
// multiple of 8 either way.
template <typename Acc>
__device__ __forceinline__ bool wide_rq(int width) {
  return sizeof(Acc) == 4 && width > kRQ;
}

// Sink of a transposed step: G'[m, sp*p + pb*R + c] (c < R, R = 4 or 8)
// into a row-major buffer with row stride ld (shared memory in Acc, or dX in
// device memory in T).  p % 4 == 0 stores vectors of 4; else element by
// element.
template <typename D, typename Acc, int R>
__device__ __forceinline__ void put_row(D* dst, long long ld, int p, int m, int sp, int pb,
                                        const Acc (&v)[R]) {
  D* o = dst + m * ld + sp * p + pb * R;
  if (p % 4 == 0) {
#pragma unroll
    for (int h = 0; h < R / 4; ++h) {
      if (pb * R + 4 * h >= p) continue;
      const Acc t[4] = {v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]};
      store4(o + 4 * h, t);
    }
  } else {
#pragma unroll
    for (int c = 0; c < R; ++c)
      if (pb * R + c < p) store(o + c, v[c]);
  }
}

// ---------------------------------------------------------------------------
// The persistent chain kernels (chain_fwd.cu, chain_bwd.cu)
// ---------------------------------------------------------------------------

enum ChainKind { kChainFwd = 0, kChainBwd = 1 };

// One launch of a chain kernel.  The walk: tile t = ((b * q_tiles + jq) *
// m_tiles + mt) * k_tiles + kt (forward; the transposed chain has no jq
// and loops over the Q-tiles of each tile itself), block j taking tiles j,
// j + nblk, ... in order, so that the tiles of a block share their sample
// and Q-tile digits for as long as the walk allows and the factor panels
// are reloaded only when those change.
struct ChainArgs {
  const void* f[kMaxFactors];  // factor i: (B, p_i, q_i), application order
  int n;
  int p[kMaxFactors], q[kMaxFactors], tq[kMaxFactors], nq[kMaxFactors];
  int s[kMaxFactors];          // slices of state i inside the tile
  int sst[kMaxFactors];        // s_i | 1: slice stride of forward state i
  int c[kMaxFactors + 1];      // columns of state i inside the tile
  float rp[kMaxFactors];
  long long ostride[kMaxFactors];  // prod_{l<i} q_l * s_out: output radix
  long long B, M, K, s_out, out_cols, m_tiles, k_tiles, q_tiles, tiles;
  int t_m, t_k, ts_out, runs, nblk;  // runs = c_n / ts_out = prod(tq)
  int vec;                     // chunk bytes of the copies (0: element-wise)
  int nch;                     // chunks per copied row (forward) or run (transposed)
  float rnch, rruns;
  // Shared memory, byte offsets from the base.
  int slot[2];                 // raw x slab (forward, one) or dY blocks (transposed, two)
  int buf[2];                  // chain states in turn
  int pan[kMaxFactors];        // factor panels of the current sample and digits
  int table;                   // final-index offsets (forward) or dY run offsets
  int acc;                     // transposed, Q tiled: the (t_m, t_k) sum of dX
  long long smem;              // bytes
  // The float32 forward on the tensor cores (3xTF32, chain_tf32_kernel):
  // row-major states in the two buffers, split panels, no slot.
  int tc;
  int ldu[kMaxFactors];        // row stride of state i: pad16(p_i) + 4
  int csf[kMaxFactors];        // s_i / p_{i+1} where p_{i+1} divides s_i, else 0
  float rs[kMaxFactors];       // 1 / s_i
};

constexpr int kTcMinDim = 8;  // the smallest p and Q-tile of a factor on the tensor cores

// The float32 forward chain's layout on the tensor cores at block tile
// (t_m, t_k), every region rounded to 16 bytes: two buffers, each as large
// as the largest row-major state i (pad16(t_m s_i) rows of pad16(p_i) + 4
// floats: x lands in state 0 straight from the copies, and a warp's
// fragment loads fall in distinct banks); the split panel of every factor's
// Q-tile, hi and lo (2 pad8(p_i) pad8(tq_i) floats); the final-index table
// (one int per slice of the last state).  Fills the offsets and strides of
// `a` when given; returns bytes.
inline long long tc_chain_layout(ChainArgs* a, const int* ps, const int* tqs, int n, int t_m,
                                 int t_k) {
  long long cols = t_k, state = 0, s = 0;
  for (int i = 0; i < n; ++i) {
    s = cols / ps[i];
    const long long st = round16(4LL * pad16(static_cast<int>(t_m * s)) * (pad16(ps[i]) + 4));
    if (st > state) state = st;
    if (a) a->ldu[i] = pad16(ps[i]) + 4;
    cols = s * tqs[i];
  }
  long long off = 2 * state;
  if (a) {
    a->buf[0] = 0;
    a->buf[1] = static_cast<int>(state);
  }
  for (int i = 0; i < n; ++i) {
    if (a) a->pan[i] = static_cast<int>(off);
    off += round16(8LL * pad8(ps[i]) * pad8(tqs[i]));
  }
  if (a) a->table = static_cast<int>(off);
  return off + round16(4 * s);
}

// Host side: fill the arguments of one launch of the given kind.  Returns
// cudaSuccess or cudaErrorInvalidValue for a tile the kernel cannot take.
// The shared-memory layout must match repro_torch.kernels.emit.
// block_smem_bytes(kind="chain_fwd" / "chain_bwd").  `io` is x (forward) or
// dY (transposed): its address sets the copies' chunk width.
//   fwd: x (B, M, K) -> y (B, M, prod(Q) * K/prod(P)); tqs tile Q.
//   bwd: dY (B, M, prod(Q) * K/prod(P)) -> dX (B, M, K); tqs tile Q.
inline int chain_args(ChainArgs* a, int kind, int dtype, const void* io, const void* const* fs,
                      const int* ps, const int* qs, const int* tqs, int n, long long B,
                      long long M, long long K, int t_m, int t_k, int nblk) {
  if (n < 1 || n > kMaxFactors || t_m < 1 || t_k < 1 || nblk < 1) return cudaErrorInvalidValue;
  if (dtype < 0 || dtype > 2 || M % t_m || K % t_k) return cudaErrorInvalidValue;
  const int isz = dtype == 0 ? 4 : dtype == 1 ? 2 : 8;
  const int acc = dtype == 2 ? 8 : 4;
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
  if (a->out_cols > INT_MAX) return cudaErrorInvalidValue;  // offsets tables hold ints
  a->t_m = t_m;
  a->t_k = t_k;
  a->ts_out = static_cast<int>(t_k / pprod);
  a->m_tiles = M / t_m;
  a->k_tiles = K / t_k;
  a->q_tiles = 1;
  a->nblk = nblk;
  long long cols = t_k, qstride = 1;
  a->c[0] = t_k;
  for (int i = 0; i < n; ++i) {
    a->f[i] = fs[i];
    a->p[i] = ps[i];
    a->q[i] = qs[i];
    a->tq[i] = tqs[i];
    a->nq[i] = qs[i] / tqs[i];
    a->rp[i] = 1.0f / ps[i];
    a->q_tiles *= a->nq[i];
    a->ostride[i] = qstride * a->s_out;
    qstride *= qs[i];
    const long long s = cols / ps[i];
    a->s[i] = static_cast<int>(s);
    a->sst[i] = static_cast<int>(s | 1);
    cols = s * tqs[i];
    a->c[i + 1] = static_cast<int>(cols);
  }
  const int cn = a->c[n];
  a->runs = cn / a->ts_out;
  a->rruns = 1.0f / a->runs;
  a->tiles = B * a->m_tiles * a->k_tiles * (kind == kChainFwd ? a->q_tiles : 1);
  long long off = 0;
  auto region = [&](long long bytes) {
    const int at = static_cast<int>(off);
    off += round16(bytes);
    return at;
  };
  // float32 forward chains whose factors and Q-tiles are at least 8 wide
  // (below that the mma tiles' padding loses to the CUDA cores) and whose
  // layout leaves room for a second block at the smallest tile run on the
  // tensor cores (the split panels take twice the CUDA cores' room, so a
  // stage of wide factors keeps its two blocks an SM there).
  bool small = false;
  for (int i = 0; i < n; ++i) small = small || ps[i] < kTcMinDim || tqs[i] < kTcMinDim;
  a->tc = kind == kChainFwd && dtype == 0 && !small &&
          tc_chain_layout(nullptr, ps, tqs, n, 1, static_cast<int>(pprod)) <=
              static_cast<long long>(kTwoBlockSmemBytes);
  if (a->tc) {
    // The slab's rows of t_k at row * K + kt * t_k, in chunks that stay
    // inside one slice (p_0): each lands in its own row of state 0.
    a->vec = chunk_bytes({K * isz, static_cast<long long>(t_k) * isz,
                          static_cast<long long>(ps[0]) * isz, reinterpret_cast<long long>(io)});
    a->nch = t_k / (a->vec ? a->vec / isz : 1);
    off = tc_chain_layout(a, ps, tqs, n, t_m, t_k);
    for (int i = 0; i < n; ++i) {
      a->csf[i] = i + 1 < n && a->s[i] % ps[i + 1] == 0 ? a->s[i] / ps[i + 1] : 0;
      a->rs[i] = 1.0f / a->s[i];
    }
    a->acc = 0;
  } else if (kind == kChainFwd) {
    // The slab's rows of t_k at row * K + kt * t_k.
    a->vec = chunk_bytes({K * isz, static_cast<long long>(t_k) * isz, reinterpret_cast<long long>(io)});
    a->nch = t_k / (a->vec ? a->vec / isz : 1);
    a->slot[0] = a->slot[1] = region(static_cast<long long>(t_m) * t_k * isz);
    long long size[2] = {0, 0};
    for (int i = 0; i < n; ++i) {  // state i: (t_m, p_i, sst_i)
      const long long st = round16(static_cast<long long>(t_m) * ps[i] * a->sst[i] * acc);
      if (st > size[i % 2]) size[i % 2] = st;
    }
    a->buf[0] = static_cast<int>(off);
    a->buf[1] = static_cast<int>(off + size[0]);
    off += size[0] + size[1];
    for (int i = 0; i < n; ++i)
      a->pan[i] = region(static_cast<long long>(ps[i]) * pad8(tqs[i]) * acc);
    a->table = region(4LL * a->s[n - 1]);
    a->acc = 0;
  } else {
    // dY runs of ts_out at row * out_cols + kt * ts_out + sum_l ql_l * ostride_l.
    a->vec = chunk_bytes({a->out_cols * isz, static_cast<long long>(a->ts_out) * isz,
                          a->s_out * isz, reinterpret_cast<long long>(io)});
    a->nch = a->ts_out / (a->vec ? a->vec / isz : 1);
    a->slot[0] = region(static_cast<long long>(t_m) * cn * isz);
    a->slot[1] = region(static_cast<long long>(t_m) * cn * isz);
    long long size[2] = {0, 0};
    for (int j = 0; j + 1 < n; ++j) {  // step j writes G_{n-1-j}: (t_m, c_{n-1-j}) flat
      const long long st = round16(static_cast<long long>(t_m) * a->c[n - 1 - j] * acc);
      if (st > size[j % 2]) size[j % 2] = st;
    }
    a->buf[0] = static_cast<int>(off);
    a->buf[1] = static_cast<int>(off + size[0]);
    off += size[0] + size[1];
    for (int i = 0; i < n; ++i)
      a->pan[i] = region(static_cast<long long>(tqs[i]) * pad8(ps[i]) * acc);
    a->table = region(4LL * a->runs);
    a->acc = a->q_tiles > 1 ? region(static_cast<long long>(t_m) * t_k * acc) : 0;
  }
  a->rnch = 1.0f / a->nch;
  a->smem = off;
  if (off > static_cast<long long>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  if (nblk > INT_MAX) return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

// Mixed-radix Q-tile digits (factor 0 minor) of a composite Q-tile index,
// and the output offset they select: sum_i qd_i * tq_i * ostride_i.
__device__ __forceinline__ long long chain_digits(const ChainArgs& a, long long jq,
                                                  int (&qd)[kMaxFactors]) {
  long long off = 0;
  for (int i = 0; i < a.n; ++i) {
    qd[i] = static_cast<int>(jq % a.nq[i]);
    jq /= a.nq[i];
    off += static_cast<long long>(qd[i]) * a.tq[i] * a.ostride[i];
  }
  return off;
}

// Offset, inside a row of the (B, M, Q_{n-1}..Q_0, S) view, of the `nd`
// Q-tile-local digits packed in r (factor 0 minor, radices tq_0 ..):
// sum_l ql_l * ostride_l.
__device__ __forceinline__ int chain_run_offset(const ChainArgs& a, int r, int nd) {
  long long off = 0;
  for (int l = 0; l < nd; ++l) {
    const int nr = r / a.tq[l];
    off += static_cast<long long>(r - nr * a.tq[l]) * a.ostride[l];
    r = nr;
  }
  return static_cast<int>(off);
}

template <typename T>
__device__ __forceinline__ const T* chain_factor(const ChainArgs& a, int i, long long b) {
  return static_cast<const T*>(a.f[i]) + b * a.p[i] * static_cast<long long>(a.q[i]);
}

// ---------------------------------------------------------------------------
// The persistent dF accumulator
// ---------------------------------------------------------------------------

// The dF items of one (p, q) factor: `tiles` 4x4 register tiles, each
// split over `groups` shares of the contraction; items w = grp * tiles + t,
// thread threadIdx.x owning w = threadIdx.x + j * blockDim.x.
__host__ __device__ inline int df_tiles(int p, int q) { return ((p + 3) / 4) * ((q + 3) / 4); }
__host__ __device__ inline int df_groups(int p, int q, int threads) {
  const int t = df_tiles(p, q);
  return t >= threads ? 1 : threads / t;
}

// acc[c][d] of item w over the tile's contraction (every slice sl = grp +
// j * groups < s of every row m, rows in order):
//   dF[pp, qq] += sum U[m*um + pp*ust + sl] * G[m*gm + qq*gst + sl]
// for pp = pb + c * npb and qq = qb * 4 + d.  The sums live in
// dfp[e * W + w] between tiles (e = c * 4 + d).
template <typename Acc>
__device__ __forceinline__ void df_accumulate(int p, int q, int s, int t_m, const Acc* U, int um,
                                              int ust, const Acc* G, int gm, int gst, Acc* dfp) {
  const int npb = (p + 3) / 4, tiles = df_tiles(p, q);
  const int groups = df_groups(p, q, blockDim.x), W = tiles * groups;
  const float rtiles = 1.0f / tiles, rnpb = 1.0f / npb;
  constexpr int kUnroll = sizeof(Acc) == 8 ? 1 : 4;  // f64 would spill at 4
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const int grp = div_fast(w, tiles, rtiles);
    const int t = w - grp * tiles;
    const int qb = div_fast(t, npb, rnpb);
    const int pb = t - qb * npb;
    int poff[kRQ], qoff[kRQ];
#pragma unroll
    for (int c = 0; c < kRQ; ++c) {
      const int pp = pb + c * npb, qq = qb * kRQ + c;
      poff[c] = (pp < p ? pp : 0) * ust;
      qoff[c] = (qq < q ? qq : 0) * gst;
    }
    Acc acc[kRQ][kRQ];
#pragma unroll
    for (int c = 0; c < kRQ; ++c)
#pragma unroll
      for (int d = 0; d < kRQ; ++d) acc[c][d] = dfp[(c * kRQ + d) * W + w];
    for (int m = 0; m < t_m; ++m) {
      const Acc* ur = U + m * um;
      const Acc* gr = G + m * gm;
#pragma unroll(kUnroll)
      for (int sl = grp; sl < s; sl += groups) {
        Acc uv[kRQ], gv[kRQ];
#pragma unroll
        for (int c = 0; c < kRQ; ++c) {
          uv[c] = ur[poff[c] + sl];
          gv[c] = gr[qoff[c] + sl];
        }
#pragma unroll
        for (int c = 0; c < kRQ; ++c)
#pragma unroll
          for (int d = 0; d < kRQ; ++d) acc[c][d] += uv[c] * gv[d];
      }
    }
#pragma unroll
    for (int c = 0; c < kRQ; ++c)
#pragma unroll
      for (int d = 0; d < kRQ; ++d) dfp[(c * kRQ + d) * W + w] = acc[c][d];
  }
}

// dF[pp * q + qq] = sum over groups, in group order, of the items' sums.
template <typename Acc>
__device__ void df_finish(int p, int q, const Acc* dfp, Acc* out) {
  const int npb = (p + 3) / 4, tiles = df_tiles(p, q);
  const int groups = df_groups(p, q, blockDim.x), W = tiles * groups;
  const float rq = 1.0f / q, rnpb = 1.0f / npb;
  for (int e = threadIdx.x; e < p * q; e += blockDim.x) {
    const int pp = div_fast(e, q, rq), qq = e - pp * q;
    const int c = div_fast(pp, npb, rnpb), pb = pp - c * npb;
    const int qb = qq / kRQ, d = qq - qb * kRQ;
    const int t = qb * npb + pb;
    const Acc* src = dfp + (c * kRQ + d) * W + t;
    Acc v = Acc(0);
    for (int grp = 0; grp < groups; ++grp) v += src[grp * tiles];
    out[e] = v;
  }
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core step
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// Fragments of m16n8k16 from K-contiguous bf16 tiles in shared memory:
// A rows (16) at base + row * ld, B columns (8) at base + col * ld, both
// starting at the chunk's first k.
__device__ __forceinline__ void frag_a(unsigned (&a)[4], const __nv_bfloat16* base, int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = (lane & 3) * 2;
  a[0] = ld_pair(base + g * ld + t);
  a[1] = ld_pair(base + (g + 8) * ld + t);
  a[2] = ld_pair(base + g * ld + t + 8);
  a[3] = ld_pair(base + (g + 8) * ld + t + 8);
}
__device__ __forceinline__ void frag_b(unsigned (&b)[2], const __nv_bfloat16* base, int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = (lane & 3) * 2;
  b[0] = ld_pair(base + g * ld + t);
  b[1] = ld_pair(base + g * ld + t + 8);
}

// The A fragment of a 16x16 tile stored transposed: A[r][c] = base[c * ld
// + r] (K-major rows of 16 bytes, ld a multiple of 8 elements).
__device__ __forceinline__ void frag_a_t(unsigned (&a)[4], const __nv_bfloat16* base, int ld) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
  // Matrices 0..3 are A's (rows 0-7, cols 0-7), (rows 8-15, cols 0-7),
  // (rows 0-7, cols 8-15), (rows 8-15, cols 8-15): stored rows c, columns r.
  ldmatrix_x4_trans(a, base + ((i >> 1) * 8 + (lane & 7)) * ld + (i & 1) * 8);
}

// d += sum over the chunks kc = kc0, kc0 + kc_step, .. < nk16 of A[16
// rows, 16 k] * B[16 k, 8 cols]; A at a (row stride lda), B stored as 8
// rows of k at b (row stride ldb).
__device__ __forceinline__ void mma_tile(float (&d)[4], const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* b, int ldb, int kc0, int kc_step,
                                         int nk16) {
  for (int kc = kc0; kc < nk16; kc += kc_step) {
    unsigned af[4], bf[2];
    frag_a(af, a + kc * 16, lda);
    frag_b(bf, b + kc * 16, ldb);
    mma_bf16_16816(d, af, bf);
  }
}

// The same with A stored transposed (A[r][k] = a[k * lda + r]).
__device__ __forceinline__ void mma_tile_t(float (&d)[4], const __nv_bfloat16* a, int lda,
                                           const __nv_bfloat16* b, int ldb, int nk16) {
  for (int kc = 0; kc < nk16; ++kc) {
    unsigned af[4], bf[2];
    frag_a_t(af, a + kc * 16 * lda, lda);
    frag_b(bf, b + kc * 16, ldb);
    mma_bf16_16816(d, af, bf);
  }
}

// ---------------------------------------------------------------------------
// The 3xTF32 tensor-core step (chain_fwd.cu's chain_tf32_kernel, grad.cu's
// grad_tf32_kernel)
// ---------------------------------------------------------------------------

// Columns [q0, q0 + nq) of a factor F (p x q) as the B operand (K x N) of a
// chain step, split once: B[k][n] = F[k][q0 + n] (forward: K = p, N = nq) or
// F[n][q0 + k] (transposed: K = nq, N = p), zero outside.  Fragment order:
// for k-chunk kc and n-tile nt, lane l holds {hi B[k][n], hi B[k+4][n], lo
// B[k][n], lo B[k+4][n]} (k = 8 kc + l % 4, n = 8 nt + l / 4) at
// dst[(kc * pad8(N) / 8 + nt) * 32 + l].
__device__ inline void tc_panel(const float* __restrict__ f, int p, int q, int q0, int nq,
                                bool transposed, float4* dst) {
  const int kd = transposed ? nq : p, nd = transposed ? p : nq;
  const int nts = pad8(nd) / 8, total = pad8(kd) / 8 * nts * 32;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int lane = idx & 31, frag = idx >> 5;
    const int kc = frag / nts, nt = frag - kc * nts;
    const int k = kc * 8 + (lane & 3), nn = nt * 8 + (lane >> 2);
    float v[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = k + 4 * h;
      if (nn < nd && kk < kd) v[h] = transposed ? f[nn * q + q0 + kk] : f[kk * q + q0 + nn];
    }
    unsigned hi[2], lo[2];
    split_tf32(v[0], hi[0], lo[0]);
    split_tf32(v[1], hi[1], lo[1]);
    dst[idx] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                           __uint_as_float(lo[0]), __uint_as_float(lo[1]));
  }
}

// Sinks of a chain step's output (r = m * s + sl, column c).  row(r) works
// out a row's target once; put(row, c, v0, v1, both) stores the pair (c, c +
// 1), the second only when `both`.  Where the shapes allow (cs), a column's
// address is the row's base plus a multiple of c.
struct TcRow {
  long long base;
  int m, sl;
};

// The forward step, out = u_i F_i into the row-major u_{i+1} (the forward
// chain's states, and grad.cu's remat): col = c * s + sl, (j, f) =
// divmod(col, pn), at (m * sn + j) * ld + f (cs = s / pn where pn divides s:
// then a column's address is the row's plus c * cs * ld).
struct TcFwdSink {
  float* u;
  int s, pn, sn, ld, cs;
  float rs, rpn;
  __device__ __forceinline__ TcRow row(int r) const {
    const int m = div_fast(r, s, rs), sl = r - m * s;
    if (!cs) return {0, m, sl};
    const int h = div_fast(sl, pn, rpn);
    return {static_cast<long long>((m * sn + h) * ld + sl - h * pn), m, sl};
  }
  __device__ __forceinline__ void put1(const TcRow& w, int c, float v) const {
    if (cs) {
      u[static_cast<int>(w.base) + c * cs * ld] = v;
    } else {
      const int col = c * s + w.sl, j = div_fast(col, pn, rpn);
      u[(w.m * sn + j) * ld + col - j * pn] = v;
    }
  }
  __device__ __forceinline__ void put(const TcRow& w, int c, float v0, float v1, bool both) const {
    put1(w, c, v0);
    if (both) put1(w, c + 1, v1);
  }
};

// One chain step on the tensor cores with warp tiles of WM x WN mma tiles:
// out[r][c] = sum_{k < depth} A[r][k] B[k][c] for r < rows, c < cols.  A is
// a state in shared memory (element (r, k) at A[r * ars + k * aks]), split
// as its fragments load; B a split panel of pad8(cols) columns.  A warp tile
// at the ragged edge repeats the last mma tile instead of skipping it, so
// that every mma runs under warp-uniform control; the products go out in
// three passes over the warp tile (lo*hi, hi*lo, hi*hi: the small products
// first; the lo*lo product, under 2^-22 of the whole, is left out).  The
// step runs on nw warps; `warp` (< nw) is the warp's index among them,
// uniform across its lanes.
template <int WM, int WN, typename Sink>
__device__ __forceinline__ void tc_step_wt(int warp, int nw, const float* A, int ars, int aks,
                                           int rows, int depth, const float4* B, int cols,
                                           const Sink& sink) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mtiles = (rows + 15) >> 4, ntiles = (cols + 7) >> 3, kcs = (depth + 7) >> 3;
  const int wn = (ntiles + WN - 1) / WN, work = (mtiles + WM - 1) / WM * wn;
  for (int w = warp; w < work; w += nw) {
    const int mi = w / wn, ni = w - mi * wn;
    const float* pa[WM];
    int nt[WN];
#pragma unroll
    for (int x = 0; x < WM; ++x) pa[x] = A + (min(mi * WM + x, mtiles - 1) * 16 + g) * ars + t * aks;
#pragma unroll
    for (int y = 0; y < WN; ++y) nt[y] = min(ni * WN + y, ntiles - 1);
    float acc[WM][WN][4];
#pragma unroll
    for (int x = 0; x < WM; ++x)
#pragma unroll
      for (int y = 0; y < WN; ++y)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[x][y][e] = 0.f;
    for (int kc = 0; kc < kcs; ++kc) {
      const int ko = kc * 8 * aks;
      unsigned ah[WM][4], al[WM][4], bh[WN][2], bl[WN][2];
#pragma unroll
      for (int x = 0; x < WM; ++x) {
        const float* a = pa[x] + ko;
        split_tf32(a[0], ah[x][0], al[x][0]);
        split_tf32(a[8 * ars], ah[x][1], al[x][1]);
        split_tf32(a[4 * aks], ah[x][2], al[x][2]);
        split_tf32(a[8 * ars + 4 * aks], ah[x][3], al[x][3]);
      }
#pragma unroll
      for (int y = 0; y < WN; ++y) {
        const float4 v = B[(kc * ntiles + nt[y]) * 32 + lane];
        bh[y][0] = __float_as_uint(v.x);
        bh[y][1] = __float_as_uint(v.y);
        bl[y][0] = __float_as_uint(v.z);
        bl[y][1] = __float_as_uint(v.w);
      }
#pragma unroll
      for (int x = 0; x < WM; ++x)
#pragma unroll
        for (int y = 0; y < WN; ++y) mma_tf32_1688(acc[x][y], al[x], bh[y]);
#pragma unroll
      for (int x = 0; x < WM; ++x)
#pragma unroll
        for (int y = 0; y < WN; ++y) mma_tf32_1688(acc[x][y], ah[x], bl[y]);
#pragma unroll
      for (int x = 0; x < WM; ++x)
#pragma unroll
        for (int y = 0; y < WN; ++y) mma_tf32_1688(acc[x][y], ah[x], bh[y]);
    }
#pragma unroll
    for (int x = 0; x < WM; ++x) {
      if (mi * WM + x >= mtiles) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (mi * WM + x) * 16 + g + 8 * h;
        if (r >= rows) continue;
        const TcRow row = sink.row(r);
#pragma unroll
        for (int y = 0; y < WN; ++y) {
          const int c = (ni * WN + y) * 8 + 2 * t;
          if (ni * WN + y < ntiles && c < cols)
            sink.put(row, c, acc[x][y][2 * h], acc[x][y][2 * h + 1], c + 1 < cols);
        }
      }
    }
  }
}

// The largest warp tile, no larger than the step, that still gives each of
// the nw warps work: 2x4, 2x2, 1x2, else 1x1.
template <typename Sink>
__device__ __forceinline__ void tc_step(int warp, int nw, const float* A, int ars, int aks,
                                        int rows, int depth, const float4* B, int cols,
                                        const Sink& sink) {
  const int mt = (rows + 15) >> 4, nt = (cols + 7) >> 3;
  if (mt >= 2 && nt >= 4 && (mt + 1) / 2 * ((nt + 3) / 4) >= nw) {
    tc_step_wt<2, 4>(warp, nw, A, ars, aks, rows, depth, B, cols, sink);
  } else if (mt >= 2 && nt >= 2 && (mt + 1) / 2 * ((nt + 1) / 2) >= nw) {
    tc_step_wt<2, 2>(warp, nw, A, ars, aks, rows, depth, B, cols, sink);
  } else if (nt >= 2 && mt * ((nt + 1) / 2) >= nw) {
    tc_step_wt<1, 2>(warp, nw, A, ars, aks, rows, depth, B, cols, sink);
  } else {
    tc_step_wt<1, 1>(warp, nw, A, ars, aks, rows, depth, B, cols, sink);
  }
}

}  // namespace kron
