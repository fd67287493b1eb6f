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
// factor the dF contraction and the transposed step: about 2.5x the
// forward's FLOPs, while it reads x and dY once and writes dX once.
//
// float32 stages (grad_tf32_kernel) run every contraction on the tensor
// cores as error-compensated 3xTF32 mma.sync.m16n8k8 products, the one
// route to float32-grade work above the CUDA cores' 67 TFLOP/s:
// - The split: hi = v rounded to TF32 as cvt.rna.tf32.f32 rounds it, lo =
//   v - hi, which the mma reads to its top 19 bits; each product is lo*hi +
//   hi*lo + hi*hi, the small terms first, into f32 accumulators.  The pair
//   keeps v to 2^-21 and a dot product reads as plain f32 does.  Plain TF32
//   (hi*hi alone) keeps 11 significant bits, a lower precision: its sums
//   read about 500x worse, so it is not used.
// - The factor panels are split once per block, outside the tile loop, and
//   kept in fragment order (one 16-byte load per lane per 8x8 fragment, hi
//   and lo together); chain states are split as their fragments load.  The
//   split, the panels and the warp-tiled step live in kron_async.cuh, which
//   chain_fwd.cu's f32 forward chain shares.
// - Layouts whose fragment loads fall in distinct banks: the chain states
//   u_i row-major (stride r16(p_i) + 4, so x lands in u_0 straight from the
//   copies), the gradient states G_i feature-major (stride 8 mod 16, so dY
//   lands in G_n in whole runs); the dF fragments read contraction pairs
//   (lane t takes k = 2t, 2t + 1 of every 8, in A and B alike).
// - Per tile the two halves of the warps run the remat chain u_1 .. u_{n-1}
//   and the transposed chain G_{n-1} .. G_1 side by side (they do not meet),
//   then each factor's dF on the half that owns it, then dX on every warp.
// - The dF sums live in the warps' registers for the whole tile loop, 16x16
//   regions a warp (warps split a region's contraction where a factor has
//   fewer regions than warps).  Each tile's sum starts from zero in the mma
//   accumulators and joins the persistent sum through an f32 add: the tensor
//   cores round their own accumulation toward zero, which over a whole walk
//   would bias the sum.  The warps' sums meet in shared memory, in order,
//   when the block ends.
// - What bounds it now (fig9's stage, 12.3 ms against 32.7 on the CUDA
//   cores, H100 80GB HBM3 at 700 W): no one unit.  The tensor cores are
//   about a third busy; the split, the fragment loads and the stores into
//   the next state take more issue slots than the mma, and the next tile's
//   copies (4-element dY runs at a 4 KB stride) cost about a fifth.
//   Factors under 8 x 8 pad the mma tiles more than the tensor cores gain.

// What the design does about it on every path:
// - Persistent blocks of 256 threads, at most 128 registers each and a
//   block tile that fits half of an SM's shared memory, so that two blocks
//   share every SM; the host sizes the grid from the occupancy query
//   (kron_grad_occupancy).  A block keeps one sample and walks its tiles in
//   a fixed order (j0, j0 + nblk, ...).
// - Loads overlap compute.  While tile t runs its steps, cp.async brings
//   tile t+1's x slab (t_m' rows of t_k' elements) and dY block (runs of
//   ts_out elements of the (B, M, Q_{n-1}..Q_0, S) view) into shared
//   memory.  In multi-factor f32 and f64 stages dY lands directly in its
//   gradient state G_n, and the next tile's dY starts as soon as G_n has
//   been read; the f32 path double-buffers x (and dY for one factor).
// - Fixed work leaves the tile loop: every factor panel of the stage, in
//   both orientations, is loaded once per block.
// - One dF partial per block; the second launch sums the partials of a
//   sample in block order.  No atomics: two runs are equal bit for bit.
//
// The other paths:
// - bf16 single-factor stages run on the tensor cores (mma.sync m16n8k16,
//   f32 accumulate) in grad_mma_kernel: every operand of dF = x^T dY and
//   dX = dY F^T is a kernel input, so keeping them in bf16 in shared memory
//   is exact.  dX reads the stored dY^T through ldmatrix.trans, and each
//   warp keeps its dF tiles in registers (up to kMmaItems; larger factors
//   take the CUDA-core path).
// - bf16 multi-factor and f64 stages, and f32 stages with a factor under
//   8 x 8 (kTcMinDim), whose dF regions overflow the warps' registers (more
//   than kTcItems a warp) or whose layout does not fit one block, run on the
//   CUDA cores (grad_simt): each step is a register-tiled contraction
//   (kron_async.cuh) on states padded to odd slice strides; each thread owns
//   fixed (group, 4x4) dF items in its own shared-memory slice for the whole
//   tile loop.  Intermediates of multi-factor bf16 stages stay f32, as the
//   Pallas kernel keeps them.
#include "kron_async.cuh"

namespace {

using kron::kMaxFactors;
using kron::kRQ;
using kron::kTcMinDim;
using kron::tc_panel;
using kron::tc_step;
using kron::TcFwdSink;
using kron::TcRow;
constexpr int kMmaItems = 8;  // dF output tiles per warp held in registers
constexpr int kTcItems = 4;   // f32 path: 16x16 dF regions per warp held in registers

struct GradArgs {
  const void* f[kMaxFactors];  // factor i: (B, p_i, q_i), application order
  int n;
  int p[kMaxFactors], q[kMaxFactors];
  int s[kMaxFactors];          // slices of state i inside the tile
  int sst[kMaxFactors];        // s_i | 1: slice stride of u_i and G_{i+1}
  int c[kMaxFactors + 1];      // columns of state i inside the tile
  float rp[kMaxFactors], rq[kMaxFactors], rs[kMaxFactors];
  long long ostride[kMaxFactors];  // prod_{l<i} q_l * s_out
  long long B, M, K, s_out, out_cols, m_tiles, k_tiles;
  int t_m, t_k, ts_out, nblk;
  int vec_x, vec_dy;           // chunk bytes of the ring's copies (0: element-wise)
  float rxch, rdych, rrch;     // reciprocals of the chunk counts below
  int xch, dych, rch;          // x chunks per row, dY chunks per row, per run
  // Shared memory, byte offsets from the base.
  int slot_dy;                 // raw dY's offset inside the slot (at 0)
  int dy_direct;               // dY lands in G_n, not in the slot
  int u[kMaxFactors];          // forward states (t_m, p_i, sst_i)
  int gn;                      // G_n (t_m, q_{n-1}, sst_{n-1})
  int gbuf[2];                 // G_{n-1} .. G_1 (t_m, q_i, sst_i), ping-pong
  int fpan[kMaxFactors];       // forward panels (p_i, round4(q_i)), i < n-1
  int tpan[kMaxFactors];       // transposed panels (q_i, round4(p_i))
  int dfp[kMaxFactors];        // persistent dF items (16 x W_i)
  int df_off[kMaxFactors];     // offset of dF_i in a sample's packed dF
  int df_total;
  // The bf16 single-factor path (tensor cores, grad_mma_kernel).
  int mma;
  int kc, kld, qld, p16, p8, q8, q16, ct, mgroups;
  int xt, gt, fp, mend;        // operand regions; end of the last one
  // The f32 path (tensor cores, 3xTF32, grad_tf32_kernel).
  int tc;
  int titems;                  // dF regions a warp holds over all factors
  int downer[kMaxFactors];     // warps of dF_i: first half 0, second half 1, all 2
  int dfirst[kMaxFactors];     // first of factor i's register items on its warps
  int ld[kMaxFactors];         // feature stride of G_{i+1}: r16(t_m * s_i) + 8
  int ldu[kMaxFactors];        // row stride of u_i (row-major): r16(p_i) + 4
  int ubuf[2];                 // u_0, two buffers in turn
  int gnbuf[2];                // G_n (two buffers in turn for one factor)
  int gst[kMaxFactors];        // G_{i+1}, i < n - 1
  int zend;                    // end of the states (zeroed once)
  int csf[kMaxFactors];        // s_i / p_{i+1} where p_{i+1} divides s_i, else 0
  int cst[kMaxFactors];        // s_{i-1} / p_i where p_i divides s_{i-1}, else 0
  float rcst[kMaxFactors];
  int dx2;                     // dX stores in pairs
  long long smem;              // bytes
};

__host__ __device__ inline int r4(int e) { return (e + 3) / 4 * 4; }
__host__ __device__ inline int r8(int e) { return (e + 7) / 8 * 8; }
__host__ __device__ inline int r16(int e) { return (e + 15) / 16 * 16; }

// The f32 path's dF work for one (p, q) factor on nw warps: 16x16 output
// regions, each warp owning `tc_items` of them; when a factor has fewer
// regions than warps, `tc_groups` warps split each region's contraction.
__host__ __device__ inline int tc_regions(int p, int q) { return (r16(p) / 16) * (r16(q) / 16); }
__host__ __device__ inline int tc_groups(int p, int q, int nw) {
  const int r = tc_regions(p, q);
  return r >= nw ? 1 : nw / r;
}
__host__ __device__ inline int tc_items(int p, int q, int nw) {
  return (tc_regions(p, q) + nw - 1) / nw;
}
// Which warps run each factor's dF (downer): the first half (0), the second
// half (1) or all of them (2).  Two factors a pair: with an even number of
// factors, dF_i goes to half (i + 1) % 2, so that the halves share the dF
// phase evenly; one factor goes to the second half while the first runs dX;
// any other stage, or one whose regions do not fit the halves' registers,
// puts every dF on every warp.  Returns the dF regions a warp holds.
inline int tc_owners(const int* ps, const int* qs, int n, int* owner) {
  constexpr int kHalf = kron::kWarps / 2;
  int half[2] = {0, 0}, all = 0;
  for (int i = 0; i < n; ++i) {
    half[n == 1 ? 1 : (i + 1) % 2] += tc_items(ps[i], qs[i], kHalf);
    all += tc_items(ps[i], qs[i], kron::kWarps);
  }
  const bool split = n % 2 == 0 || n == 1;
  const bool fits = half[0] <= kTcItems && half[1] <= kTcItems;
  for (int i = 0; i < n; ++i) owner[i] = split && fits ? (n == 1 ? 1 : (i + 1) % 2) : 2;
  return split && fits ? (half[0] > half[1] ? half[0] : half[1]) : all;
}
__host__ __device__ inline int tc_owner_warps(int owner) {
  return owner == 2 ? kron::kWarps : kron::kWarps / 2;
}

// The f32 path's shared memory at block tile (t_m, t_k), every region
// rounded to 16 bytes: u_0 twice and u_1 .. u_{n-1} (r16(t_m s_i) rows of
// ldu_i), G_n (r16(q_{n-1}) features of ld_{n-1}; twice for one factor),
// G_1 .. G_{n-1} (r16(q_i) features of ld_i), the split
// forward panels of F_0 .. F_{n-2} and transposed panels of every factor
// (r8(K) x r8(N) x 2); at least the warps' dF sums when they meet (256
// floats per region and group of the warps that own each dF).  Fills the
// offsets of `a`; returns bytes.
long long tc_layout(GradArgs* a, const int* ps, const int* qs, int n, int t_m, int t_k) {
  int s[kMaxFactors];
  long long cols = t_k;
  for (int i = 0; i < n; ++i) {
    s[i] = static_cast<int>(cols / ps[i]);
    cols = static_cast<long long>(s[i]) * qs[i];
  }
  long long off = 0;
  auto region = [&](long long floats) {
    const int at = static_cast<int>(off);
    off += kron::round16(floats * 4);
    return at;
  };
  for (int i = 0; i < n; ++i) {
    a->ldu[i] = r16(ps[i]) + 4;
    a->ld[i] = r16(t_m * s[i]) + 8;
  }
  const long long u0 = static_cast<long long>(r16(t_m * s[0])) * a->ldu[0];
  a->ubuf[0] = region(u0);
  a->ubuf[1] = region(u0);
  const long long gn = static_cast<long long>(r16(qs[n - 1])) * a->ld[n - 1];
  a->gnbuf[0] = region(gn);
  a->gnbuf[1] = n == 1 ? region(gn) : a->gnbuf[0];
  for (int i = 1; i < n; ++i) a->u[i] = region(static_cast<long long>(r16(t_m * s[i])) * a->ldu[i]);
  for (int i = 0; i + 1 < n; ++i)
    a->gst[i] = region(static_cast<long long>(r16(qs[i])) * a->ld[i]);
  a->zend = static_cast<int>(off);
  for (int i = 0; i + 1 < n; ++i) a->fpan[i] = region(2LL * r8(ps[i]) * r8(qs[i]));
  for (int i = 0; i < n; ++i) a->tpan[i] = region(2LL * r8(qs[i]) * r8(ps[i]));
  int owner[kMaxFactors];
  tc_owners(ps, qs, n, owner);
  long long dump = 0;
  for (int i = 0; i < n; ++i)
    dump += 256LL * 4 * tc_regions(ps[i], qs[i]) * tc_groups(ps[i], qs[i], tc_owner_warps(owner[i]));
  return off > dump ? off : dump;
}

// Host side: fill the arguments of one launch.  Returns cudaSuccess or
// cudaErrorInvalidValue for a tile the kernel cannot take.  The shared-memory
// layout must match repro_torch.kernels.emit.block_smem_bytes(kind="grad").
int grad_args(GradArgs* a, int dtype, const void* x, const void* dy, const void* const* fs,
              const int* ps, const int* qs, int n, long long B, long long M, long long K,
              int t_m, int t_k, int nblk) {
  if (n < 1 || n > kMaxFactors || t_m < 1 || t_k < 1 || nblk < 1) return cudaErrorInvalidValue;
  if (dtype < 0 || dtype > 2 || M % t_m || K % t_k) return cudaErrorInvalidValue;
  const int isz = dtype == 0 ? 4 : dtype == 1 ? 2 : 8;
  const int acc = dtype == 2 ? 8 : 4;
  long long pprod = 1, qprod = 1;
  for (int i = 0; i < n; ++i) {
    if (ps[i] < 1 || qs[i] < 1) return cudaErrorInvalidValue;
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
  a->m_tiles = M / t_m;
  a->k_tiles = K / t_k;
  a->nblk = nblk;
  long long cols = t_k, qstride = 1;
  a->c[0] = t_k;
  for (int i = 0; i < n; ++i) {
    a->f[i] = fs[i];
    a->p[i] = ps[i];
    a->q[i] = qs[i];
    a->rp[i] = 1.0f / ps[i];
    a->rq[i] = 1.0f / qs[i];
    a->ostride[i] = qstride * a->s_out;
    qstride *= qs[i];
    const long long s = cols / ps[i];
    a->s[i] = static_cast<int>(s);
    a->sst[i] = static_cast<int>(s | 1);
    a->rs[i] = 1.0f / s;
    cols = s * qs[i];
    a->c[i + 1] = static_cast<int>(cols);
  }
  const int cn = a->c[n];
  // f32 stages whose factors are at least 8 x 8 (below that the mma tiles'
  // padding loses to the CUDA cores), whose dF regions fit the warps'
  // registers and whose layout fits one block at the smallest tile run on
  // the tensor cores.
  a->titems = tc_owners(ps, qs, n, a->downer);
  int next[3] = {0, 0, 0};  // the next free register item of each owner
  bool small = false;
  for (int i = 0; i < n; ++i) {
    const int o = a->downer[i];
    a->dfirst[i] = o == 2 ? next[2] : next[o];
    next[o] += tc_items(ps[i], qs[i], tc_owner_warps(o));
    small = small || ps[i] < kTcMinDim || qs[i] < kTcMinDim;
  }
  a->tc = dtype == 0 && !small && a->titems <= kTcItems;
  if (a->tc) {
    GradArgs probe;
    a->tc = tc_layout(&probe, ps, qs, n, 1, static_cast<int>(pprod)) <=
            static_cast<long long>(kron::kMaxSmemBytes);
  }
  // The ring's chunks: x rows of t_k at row * K + kt * t_k; dY runs of
  // ts_out at row * out_cols + kt * ts_out + sum_l ql_l * ostride_l.  On the
  // f32 path a chunk of x stays inside one slice (p_0) and a chunk of dY
  // lands at m * s_{n-1} in G_n.
  a->vec_x = kron::chunk_bytes({K * isz, t_k * isz, a->tc ? ps[0] * isz : 0LL,
                                reinterpret_cast<long long>(x)});
  a->vec_dy = kron::chunk_bytes({a->out_cols * isz, a->ts_out * static_cast<long long>(isz),
                                 a->s_out * isz, a->tc ? a->s[n - 1] * isz : 0LL,
                                 reinterpret_cast<long long>(dy)});
  const int ex = a->vec_x ? a->vec_x / isz : 1, ed = a->vec_dy ? a->vec_dy / isz : 1;
  a->xch = t_k / ex;
  a->rch = a->ts_out / ed;
  a->dych = cn / ed;
  a->rxch = 1.0f / a->xch;
  a->rrch = 1.0f / a->rch;
  a->rdych = 1.0f / a->dych;
  a->dx2 = 0;
  long long df_total = 0;
  for (int i = 0; i < n; ++i) {
    a->df_off[i] = static_cast<int>(df_total);
    df_total += static_cast<long long>(ps[i]) * qs[i];
  }
  a->df_total = static_cast<int>(df_total);

  // bf16 single-factor stages whose dF fits the warps' registers
  // (kMmaItems output tiles of 16 x 8 per warp) run on the tensor cores.
  a->ct = (r16(ps[0]) / 16) * (r8(qs[0]) / 8);
  a->mgroups = a->ct >= kron::kWarps ? 1 : kron::kWarps / a->ct;
  a->mma = dtype == 1 && n == 1 && a->ct <= kMmaItems * kron::kWarps;
  a->dy_direct = isz == acc && n > 1;
  const long long slot_x = kron::round16(static_cast<long long>(t_m) * t_k * isz);
  a->slot_dy = static_cast<int>(slot_x);
  long long off = slot_x + (a->dy_direct ? 0 : kron::round16(static_cast<long long>(t_m) * cn * isz));
  if (a->tc) {  // the copies land in u_0 and G_n: no slot
    off = tc_layout(a, ps, qs, n, t_m, t_k);
    for (int i = 0; i < n; ++i) {
      a->csf[i] = i + 1 < n && a->s[i] % ps[i + 1] == 0 ? a->s[i] / ps[i + 1] : 0;
      a->cst[i] = i > 0 && a->s[i - 1] % ps[i] == 0 ? a->s[i - 1] / ps[i] : 0;
      a->rcst[i] = a->cst[i] ? 1.0f / a->cst[i] : 0.0f;
    }
  } else if (a->mma) {
    const int p = ps[0], q = qs[0];
    a->kc = t_m * a->s[0];
    const int k16 = r16(a->kc);
    a->kld = k16 + 8;
    a->p16 = r16(p);
    a->p8 = r8(p);
    a->q8 = r8(q);
    a->q16 = r16(q);
    a->qld = a->q16 + 8;
    auto region = [&](long long bytes) {
      const int at = static_cast<int>(off);
      off += kron::round16(bytes);
      return at;
    };
    a->xt = region(2LL * a->p16 * a->kld);
    a->gt = region(2LL * a->q16 * a->kld);
    a->fp = region(2LL * a->p8 * a->qld);
    a->mend = static_cast<int>(off);
    // With several groups per output tile, the warps' sums meet in shared
    // memory at the end (over the then free operands).
    const long long dump = a->mgroups > 1 ? 512LL * a->ct * a->mgroups : 0;
    if (dump > off) off = dump;
  } else {
    auto region = [&](long long elems) {
      const int at = static_cast<int>(off);
      off += kron::round16(elems * acc);
      return at;
    };
    for (int i = 0; i < n; ++i) a->u[i] = region(static_cast<long long>(t_m) * ps[i] * a->sst[i]);
    a->gn = region(static_cast<long long>(t_m) * qs[n - 1] * a->sst[n - 1]);
    long long gsize[2] = {0, 0};
    for (int i = 0; i + 1 < n; ++i) {  // G_{i+1}, i = n-2 .. 0
      const long long g = kron::round16(static_cast<long long>(t_m) * qs[i] * a->sst[i] * acc);
      long long& size = gsize[(n - 2 - i) % 2];
      if (g > size) size = g;
    }
    a->gbuf[0] = static_cast<int>(off);
    a->gbuf[1] = static_cast<int>(off + gsize[0]);
    off += gsize[0] + gsize[1];
    for (int i = 0; i + 1 < n; ++i) a->fpan[i] = region(static_cast<long long>(ps[i]) * r4(qs[i]));
    for (int i = 0; i < n; ++i) a->tpan[i] = region(static_cast<long long>(qs[i]) * r4(ps[i]));
    for (int i = 0; i < n; ++i) {
      const long long w = static_cast<long long>(kron::df_tiles(ps[i], qs[i])) *
                          kron::df_groups(ps[i], qs[i], kron::kAsyncThreads);
      a->dfp[i] = region(16 * w);
    }
  }
  a->smem = off;
  if (off > static_cast<long long>(kron::kMaxSmemBytes)) return cudaErrorInvalidValue;
  if (B * nblk > INT_MAX) return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

// The copies of one tile's x slab into the slot (rows of t_k).
template <typename T>
__device__ void fetch_x(const GradArgs& a, const T* __restrict__ x, long long b, long long tile,
                        unsigned char* sm) {
  const long long kt = tile % a.k_tiles;
  const long long row0 = b * a.M + (tile / a.k_tiles) * a.t_m;
  T* sx = reinterpret_cast<T*>(sm);
  const int ex = a.t_k / a.xch;
  const T* xs = x + row0 * a.K + kt * a.t_k;
  for (int idx = threadIdx.x; idx < a.t_m * a.xch; idx += blockDim.x) {
    const int m = kron::div_fast(idx, a.xch, a.rxch);
    const int c = (idx - m * a.xch) * ex;
    kron::copy_chunk(sx + m * a.t_k + c, xs + m * a.K + c, a.vec_x);
  }
}

// Offset in dY, from the tile's first row and column, of tile column `col`
// = (run r, element e) of row m: the mixed-radix digits of r (factor 0
// minor) index the Q_i axes of the (B, M, Q_{n-1}..Q_0, S) view.
__device__ __forceinline__ long long dy_offset(const GradArgs& a, int m, int r, int e) {
  long long off = m * a.out_cols + e;
  for (int l = 0; l < a.n; ++l) {
    const int nr = kron::div_fast(r, a.q[l], a.rq[l]);
    off += static_cast<long long>(r - nr * a.q[l]) * a.ostride[l];
    r = nr;
  }
  return off;
}

// The copies of one tile's dY block: raw (tile column order) into the slot,
// in chunks; or, with a.dy_direct, element by element into G_n's padded
// (m, q_{n-1}, sst_{n-1}) layout.
template <typename T>
__device__ void fetch_dy(const GradArgs& a, const T* __restrict__ dy, long long b, long long tile,
                         unsigned char* slot, unsigned char* sm) {
  const long long kt = tile % a.k_tiles;
  const long long row0 = b * a.M + (tile / a.k_tiles) * a.t_m;
  const T* dys = dy + row0 * a.out_cols + kt * a.ts_out;
  const int cn = a.c[a.n];
  if (a.dy_direct) {  // one run per item: its offset is worked out once
    const int n1 = a.n - 1, s = a.s[n1], st = a.sst[n1], q = a.q[n1];
    const int runs = cn / a.ts_out;
    const float rruns = 1.0f / runs;
    T* gn = reinterpret_cast<T*>(sm + a.gn);
    for (int idx = threadIdx.x; idx < a.t_m * runs; idx += blockDim.x) {
      const int m = kron::div_fast(idx, runs, rruns);
      const int r = idx - m * runs;
      const int col = r * a.ts_out;  // a run never crosses a q row of G_n
      const int qq = kron::div_fast(col, s, a.rs[n1]);
      T* dst = gn + (m * q + qq) * st + col - qq * s;
      const T* src = dys + dy_offset(a, m, r, 0);
      for (int e = 0; e < a.ts_out; ++e) kron::copy_chunk(dst + e, src + e, sizeof(T));
    }
    return;
  }
  T* sdy = reinterpret_cast<T*>(slot + a.slot_dy);
  const int ed = a.ts_out / a.rch;
  for (int idx = threadIdx.x; idx < a.t_m * a.dych; idx += blockDim.x) {
    const int m = kron::div_fast(idx, a.dych, a.rdych);
    const int rem = idx - m * a.dych;
    const int r = kron::div_fast(rem, a.rch, a.rrch);
    const int c = (rem - r * a.rch) * ed;
    kron::copy_chunk(sdy + m * cn + r * a.ts_out + c, dys + dy_offset(a, m, r, c), a.vec_dy);
  }
}

template <typename T>
__device__ __forceinline__ const T* factor(const GradArgs& a, int i, long long b) {
  return static_cast<const T*>(a.f[i]) + b * a.p[i] * static_cast<long long>(a.q[i]);
}

// The stage backward on the CUDA cores (any dtype, any number of factors).
template <typename T, typename Acc>
__device__ void grad_simt(const GradArgs& a, const T* __restrict__ x, const T* __restrict__ dy,
                          T* __restrict__ dx, Acc* __restrict__ part, unsigned char* sm,
                          long long b, long long j0) {
  const int n = a.n, t_m = a.t_m;
  auto at = [&](int off) { return reinterpret_cast<Acc*>(sm + off); };
  for (int i = 0; i + 1 < n; ++i)
    kron::panel_fwd(factor<T>(a, i, b), a.p[i], a.q[i], 0, a.q[i], r4(a.q[i]), at(a.fpan[i]));
  for (int i = 0; i < n; ++i)
    kron::panel_t(factor<T>(a, i, b), a.p[i], a.q[i], 0, a.q[i], r4(a.p[i]), at(a.tpan[i]));
  for (int i = 0; i < n; ++i) {
    const int w = kron::df_tiles(a.p[i], a.q[i]) * kron::df_groups(a.p[i], a.q[i], blockDim.x);
    Acc* d = at(a.dfp[i]);
    for (int e = threadIdx.x; e < 16 * w; e += blockDim.x) d[e] = Acc(0);
  }
  Acc* gn = at(a.gn);
  Acc* gbuf[2] = {at(a.gbuf[0]), at(a.gbuf[1])};
  const long long tiles = a.m_tiles * a.k_tiles;
  if (j0 < tiles) {
    fetch_x(a, x, b, j0, sm);
    fetch_dy(a, dy, b, j0, sm, sm);
  }
  kron::cp_async_commit();
  for (long long tile = j0; tile < tiles; tile += a.nblk) {
    const bool more = tile + a.nblk < tiles;
    kron::cp_async_wait<0>();
    __syncthreads();  // this tile's copies are in place; the last tile's states are free
    const T* sx = reinterpret_cast<const T*>(sm);
    const T* sdy = reinterpret_cast<const T*>(sm + a.slot_dy);
    {  // x -> u_0 in the (m, p, s) layout
      const int p = a.p[0], st = a.sst[0];
      const float rtk = 1.0f / a.t_k;
      Acc* u0 = at(a.u[0]);
      for (int idx = threadIdx.x; idx < t_m * a.t_k; idx += blockDim.x) {
        const int m = kron::div_fast(idx, a.t_k, rtk);
        const int col = idx - m * a.t_k;
        const int sl = kron::div_fast(col, p, a.rp[0]);
        u0[(m * p + col - sl * p) * st + sl] = kron::to_acc(sx[idx]);
      }
    }
    if (!a.dy_direct) {  // dY -> G_n in the (m, q, s) layout
      const int s = a.s[n - 1], st = a.sst[n - 1], q = a.q[n - 1], cn = a.c[n];
      const float rcn = 1.0f / cn;
      for (int idx = threadIdx.x; idx < t_m * cn; idx += blockDim.x) {
        const int m = kron::div_fast(idx, cn, rcn);
        const int col = idx - m * cn;
        const int qq = kron::div_fast(col, s, a.rs[n - 1]);
        gn[(m * q + qq) * st + col - qq * s] = kron::to_acc(sdy[idx]);
      }
    }
    __syncthreads();  // the slot is unpacked: the next tile's copies may land
    if (more) {
      fetch_x(a, x, b, tile + a.nblk, sm);
      if (!a.dy_direct) fetch_dy(a, dy, b, tile + a.nblk, sm, sm);
    }
    kron::cp_async_commit();
    // Rematerialize u_1 .. u_{n-1}.
    for (int i = 0; i + 1 < n; ++i) {
      const int p = a.p[i], q = a.q[i], s = a.s[i], st = a.sst[i];
      const int pn = a.p[i + 1], stn = a.sst[i + 1];
      const float rpn = a.rp[i + 1];
      Acc* un = at(a.u[i + 1]);
      kron::step(t_m, s, r4(q) / kRQ, at(a.u[i]), p * st, st, at(a.fpan[i]), r4(q), p, false,
                 [&](int m, int sl, int qb, const Acc(&v)[kRQ]) {
#pragma unroll
                   for (int c = 0; c < kRQ; ++c) {
                     const int ql = qb * kRQ + c;
                     if (ql >= q) continue;
                     const int col = ql * s + sl;
                     const int j = kron::div_fast(col, pn, rpn);
                     un[(m * pn + col - j * pn) * stn + j] = v[c];
                   }
                 });
      __syncthreads();
    }
    const long long kt = tile % a.k_tiles;
    T* dxt = dx + (b * a.M + (tile / a.k_tiles) * t_m) * a.K + kt * a.t_k;
    for (int j = 0; j < n; ++j) {
      const int i = n - 1 - j;
      const int p = a.p[i], q = a.q[i], s = a.s[i], st = a.sst[i];
      const Acc* g = j == 0 ? gn : gbuf[(j - 1) & 1];
      kron::df_accumulate(p, q, s, t_m, at(a.u[i]), p * st, st, g, q * st, st, at(a.dfp[i]));
      if (i > 0) {
        const int sp = a.s[i - 1], stp = a.sst[i - 1], qp = a.q[i - 1];
        const float rsp = a.rs[i - 1];
        Acc* o = gbuf[j & 1];
        kron::step(t_m, s, r4(p) / kRQ, g, q * st, st, at(a.tpan[i]), r4(p), q, true,
                   [&](int m, int sl, int pb, const Acc(&v)[kRQ]) {
#pragma unroll
                     for (int c = 0; c < kRQ; ++c) {
                       const int pp = pb * kRQ + c;
                       if (pp >= p) continue;
                       const int col = sl * p + pp;
                       const int qq = kron::div_fast(col, sp, rsp);
                       o[(m * qp + qq) * stp + col - qq * sp] = v[c];
                     }
                   });
        __syncthreads();  // G_i is complete; G_{i+1} is free
        if (j == 0 && a.dy_direct) {
          if (more) fetch_dy(a, dy, b, tile + a.nblk, sm, sm);
          kron::cp_async_commit();
        }
      } else {
        kron::step(t_m, s, r4(p) / kRQ, g, q * st, st, at(a.tpan[i]), r4(p), q, true,
                   [&](int m, int sl, int pb, const Acc(&v)[kRQ]) {
                     kron::put_row(dxt, a.K, p, m, sl, pb, v);
                   });
      }
    }
  }
  __syncthreads();  // every thread's dF items are final
  Acc* out = part + static_cast<long long>(blockIdx.x) * a.df_total;
  for (int i = 0; i < n; ++i) kron::df_finish(a.p[i], a.q[i], at(a.dfp[i]), out + a.df_off[i]);
}

// The single-factor bf16 stage on the tensor cores:
//   dF[pp, q] += sum_k Xt[pp, k] * Gt[q, k]     (k = m * s + sl, the tile)
//   dX[k, pp]  = sum_q Gt[q, k] * Fp[pp, q]     (Gt read transposed)
// Every operand is bf16 in shared memory, K-contiguous and zero-padded to
// the mma tile (rows padded by 8 elements so that fragment loads and
// ldmatrix rows fall in distinct banks).  A warp owns whole 16x8 output
// tiles; its dF sums stay in registers for the whole tile loop.
__global__ void __launch_bounds__(kron::kAsyncThreads, 2)
    grad_mma_kernel(GradArgs a, const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ dy, __nv_bfloat16* __restrict__ dx,
                    float* __restrict__ part) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char kron_smem[];
  unsigned char* sm = kron_smem;
  const long long b = blockIdx.x / a.nblk, j0 = blockIdx.x % a.nblk;
  const int p = a.p[0], q = a.q[0], s = a.s[0], t_m = a.t_m, kc = a.kc;
  const int kld = a.kld, qld = a.qld, k16 = (kc + 15) / 16 * 16;
  bf16* xt = reinterpret_cast<bf16*>(sm + a.xt);
  bf16* gt = reinterpret_cast<bf16*>(sm + a.gt);
  bf16* fp = reinterpret_cast<bf16*>(sm + a.fp);
  {  // zero the padded operands: the pads are never written again
    unsigned* z = reinterpret_cast<unsigned*>(sm + a.xt);
    for (int e = threadIdx.x; e < (a.mend - a.xt) / 4; e += blockDim.x) z[e] = 0u;
  }
  __syncthreads();
  const bf16* f = factor<bf16>(a, 0, b);
  for (int e = threadIdx.x; e < p * q; e += blockDim.x) {
    const int pp = kron::div_fast(e, q, a.rq[0]);
    fp[pp * qld + e - pp * q] = f[e];
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nn = a.q8 / 8, wdf = a.ct * a.mgroups;
  const int mtiles = k16 / 16, ntiles = a.p8 / 8;
  float dacc[kMmaItems][4];
#pragma unroll
  for (int j = 0; j < kMmaItems; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) dacc[j][r] = 0.f;
  const long long tiles = a.m_tiles * a.k_tiles;
  if (j0 < tiles) {
    fetch_x(a, x, b, j0, sm);
    fetch_dy(a, dy, b, j0, sm, sm);
  }
  kron::cp_async_commit();
  for (long long tile = j0; tile < tiles; tile += a.nblk) {
    kron::cp_async_wait<0>();
    __syncthreads();
    const bf16* sx = reinterpret_cast<const bf16*>(sm);
    const bf16* sdy = reinterpret_cast<const bf16*>(sm + a.slot_dy);
    const float rtk = 1.0f / a.t_k;
    for (int idx = threadIdx.x; idx < t_m * a.t_k; idx += blockDim.x) {
      const int m = kron::div_fast(idx, a.t_k, rtk);
      const int col = idx - m * a.t_k;
      const int sl = kron::div_fast(col, p, a.rp[0]);
      xt[(col - sl * p) * kld + m * s + sl] = sx[idx];
    }
    const int cn = a.c[1];
    const float rcn = 1.0f / cn;
    for (int idx = threadIdx.x; idx < t_m * cn; idx += blockDim.x) {
      const int m = kron::div_fast(idx, cn, rcn);
      const int col = idx - m * cn;
      const int qq = kron::div_fast(col, s, a.rs[0]);
      gt[qq * kld + m * s + col - qq * s] = sdy[idx];
    }
    __syncthreads();  // the slot is unpacked: the next tile's copies may land
    if (tile + a.nblk < tiles) {
      fetch_x(a, x, b, tile + a.nblk, sm);
      fetch_dy(a, dy, b, tile + a.nblk, sm, sm);
    }
    kron::cp_async_commit();
#pragma unroll
    for (int j = 0; j < kMmaItems; ++j) {
      const int w = warp + j * kron::kWarps;
      if (w >= wdf) continue;
      const int ctile = w % a.ct, grp = w / a.ct;
      const int mt = ctile / nn, nt = ctile - mt * nn;
      kron::mma_tile(dacc[j], xt + mt * 16 * kld, kld, gt + nt * 8 * kld, kld, grp, a.mgroups,
                     k16 / 16);
    }
    const long long kt = tile % a.k_tiles;
    bf16* dxt = dx + (b * a.M + (tile / a.k_tiles) * t_m) * a.K + kt * a.t_k;
    for (int w = warp; w < mtiles * ntiles; w += kron::kWarps) {
      const int mt = w / ntiles, nt = w - mt * ntiles;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      kron::mma_tile_t(d, gt + mt * 16, kld, fp + nt * 8 * qld, qld, a.q16 / 16);
      const int g = lane >> 2, c0 = nt * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + g + 8 * h;
        if (r >= kc) continue;
        const int m = kron::div_fast(r, s, a.rs[0]);
        bf16* o = dxt + m * a.K + (r - m * s) * p;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c0 + e < p) o[c0 + e] = __float2bfloat16(d[2 * h + e]);
      }
    }
  }
  float* out = part + static_cast<long long>(blockIdx.x) * a.df_total;
  const int g = lane >> 2, c = (lane & 3) * 2;
  if (a.mgroups == 1) {  // one warp per output tile: straight out
#pragma unroll
    for (int j = 0; j < kMmaItems; ++j) {
      const int w = warp + j * kron::kWarps;
      if (w >= wdf) continue;
      const int mt = w / nn, nt = w - mt * nn;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int pp = mt * 16 + g + 8 * (r >> 1), qq = nt * 8 + c + (r & 1);
        if (pp < p && qq < q) out[pp * q + qq] = dacc[j][r];
      }
    }
    return;
  }
  __syncthreads();  // every warp is done with the operands: reuse them
  float* dump = reinterpret_cast<float*>(sm);
#pragma unroll
  for (int j = 0; j < kMmaItems; ++j) {
    const int w = warp + j * kron::kWarps;
    if (w >= wdf) continue;
#pragma unroll
    for (int r = 0; r < 4; ++r) dump[(w * 4 + r) * 32 + lane] = dacc[j][r];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < p * q; e += blockDim.x) {
    const int pp = kron::div_fast(e, q, a.rq[0]), qq = e - pp * q;
    const int ctile = (pp >> 4) * nn + (qq >> 3);
    const int lane_e = (pp & 7) * 4 + ((qq & 7) >> 1);
    const int r = ((pp >> 3) & 1) * 2 + (qq & 1);
    float v = 0.f;
    for (int grp = 0; grp < a.mgroups; ++grp)
      v += dump[((grp * a.ct + ctile) * 4 + r) * 32 + lane_e];
    out[e] = v;
  }
}

// ---------------------------------------------------------------------------
// The f32 stage backward on the tensor cores (3xTF32)
// ---------------------------------------------------------------------------

// The copies of one tile's x slab into u_0: row r = m * s_0 + sl holds the
// p_0 elements of slice sl at stride ldu_0.
__device__ void tc_fetch_x(const GradArgs& a, const float* __restrict__ x, long long b,
                           long long tile, float* u0) {
  const long long kt = tile % a.k_tiles;
  const long long row0 = b * a.M + (tile / a.k_tiles) * a.t_m;
  const int ex = a.t_k / a.xch, p = a.p[0], s = a.s[0];
  const float* xs = x + row0 * a.K + kt * a.t_k;
  for (int idx = threadIdx.x; idx < a.t_m * a.xch; idx += blockDim.x) {
    const int m = kron::div_fast(idx, a.xch, a.rxch);
    const int c = (idx - m * a.xch) * ex;
    const int sl = kron::div_fast(c, p, a.rp[0]);
    kron::copy_chunk(u0 + (m * s + sl) * a.ldu[0] + c - sl * p, xs + m * a.K + c, a.vec_x);
  }
}

// The copies of one tile's dY block into G_n, feature-major: tile column
// col = qq * s_{n-1} + j of row m at qq * ld_{n-1} + m * s_{n-1} + j.  A run
// never crosses a q row, and its elements stay consecutive.
__device__ void tc_fetch_dy(const GradArgs& a, const float* __restrict__ dy, long long b,
                            long long tile, float* gn) {
  const long long kt = tile % a.k_tiles;
  const long long row0 = b * a.M + (tile / a.k_tiles) * a.t_m;
  const float* dys = dy + row0 * a.out_cols + kt * a.ts_out;
  const int n1 = a.n - 1, s = a.s[n1], ld = a.ld[n1];
  const int ed = a.ts_out / a.rch;
  for (int idx = threadIdx.x; idx < a.t_m * a.dych; idx += blockDim.x) {
    const int m = kron::div_fast(idx, a.dych, a.rdych);
    const int rem = idx - m * a.dych;
    const int r = kron::div_fast(rem, a.rch, a.rrch);
    const int c = (rem - r * a.rch) * ed;
    const int col = r * a.ts_out + c;
    const int qq = kron::div_fast(col, s, a.rs[n1]);
    kron::copy_chunk(gn + qq * ld + m * s + col - qq * s, dys + dy_offset(a, m, r, c), a.vec_dy);
  }
}

// The transposed step, out = G_{i+1} F_i^T into G_i: col = sl * p + c, (qq,
// j) = divmod(col, sp), at qq * ld + m * sp + j (cs = sp / p where p
// divides sp: then a row's columns are consecutive).
struct TcBwdSink {
  float* g;
  int s, p, sp, ld, cs;
  float rcs, rs, rsp;
  __device__ __forceinline__ TcRow row(int r) const {
    const int m = kron::div_fast(r, s, rs), sl = r - m * s;
    if (!cs) return {0, m, sl};
    const int qq = kron::div_fast(sl, cs, rcs);
    return {static_cast<long long>(qq * ld + m * sp + (sl - qq * cs) * p), m, sl};
  }
  __device__ __forceinline__ void put(const TcRow& w, int c, float v0, float v1, bool both) const {
    if (cs) {
      float* o = g + w.base + c;
      o[0] = v0;
      if (both) o[1] = v1;
      return;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (e && !both) break;
      const int col = w.sl * p + c + e, qq = kron::div_fast(col, sp, rsp);
      g[qq * ld + w.m * sp + col - qq * sp] = e ? v1 : v0;
    }
  }
};

// The last transposed step, dX = G_1 F_0^T: row m, column sl * p + c of the
// tile's dX, in pairs where p, K and the base allow (vec2).
struct TcDxSink {
  float* dx;
  long long k;
  int s, p, vec2;
  float rs;
  __device__ __forceinline__ TcRow row(int r) const {
    const int m = kron::div_fast(r, s, rs), sl = r - m * s;
    return {m * k + sl * p, m, sl};
  }
  __device__ __forceinline__ void put(const TcRow& w, int c, float v0, float v1, bool both) const {
    float* o = dx + w.base + c;
    if (both && vec2) {
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    } else {
      o[0] = v0;
      if (both) o[1] = v1;
    }
  }
};

// One tile's dF_i += u_i^T G_{i+1} over its `rows` contraction rows, for the
// warp's 16x16 regions (items first .. first + tc_items - 1 of dacc).  u_i
// is row-major (element (pp, r) at r * uld + pp), G_{i+1} feature-major.  Lane t takes the contraction pair
// (2t, 2t + 1) of every 8 in A and B alike.  A region's rows and columns
// past p and q read the zeroed pads.  The regions are shared among nw
// warps; `warp` (< nw) is the warp's index among them.  The tile's sum starts at zero in the
// mma accumulators and joins dacc through an f32 add.
template <int kItems>
__device__ __forceinline__ void tc_df(int warp, int nw, const float* U, int uld, const float* G,
                                      int gld, int p, int q, int rows, int first,
                                      float (&dacc)[kItems][2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nc = r16(q) / 16, regions = r16(p) / 16 * nc;
  const int groups = tc_groups(p, q, nw), items = tc_items(p, q, nw), kcs = (rows + 7) >> 3;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (j < first || j >= first + items) continue;
    int region, grp;
    if (groups == 1) {
      region = warp + (j - first) * nw;
      grp = 0;
      if (region >= regions) continue;
    } else {
      if (warp >= regions * groups) continue;
      grp = warp / regions;
      region = warp - grp * regions;
    }
    const int pr = region / nc, qc = region - pr * nc;
    // Lane bases at k-chunk 0: A rows pp and pp + 8, B columns qq and qq + 8.
    const float* pu = U + 2 * t * uld + pr * 16 + g;
    const float* pg = G + (qc * 16 + g) * gld + 2 * t;
    // Two sets of sums, for alternate k-chunks, so that two chains of
    // products are in flight.
    float acc[2][2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int y = 0; y < 2; ++y)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][y][e] = 0.f;
    for (int kc0 = grp; kc0 < kcs; kc0 += 2 * groups) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kc = kc0 + h * groups;
        if (h && kc >= kcs) break;
        unsigned ah[4], al[4], bh[2][2], bl[2][2];
        const float* u = pu + kc * 8 * uld;
        kron::split_tf32(u[0], ah[0], al[0]);
        kron::split_tf32(u[8], ah[1], al[1]);
        kron::split_tf32(u[uld], ah[2], al[2]);
        kron::split_tf32(u[uld + 8], ah[3], al[3]);
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const float2 v = *reinterpret_cast<const float2*>(pg + kc * 8 + 8 * y * gld);
          kron::split_tf32(v.x, bh[y][0], bl[y][0]);
          kron::split_tf32(v.y, bh[y][1], bl[y][1]);
        }
#pragma unroll
        for (int y = 0; y < 2; ++y) kron::mma_tf32_1688(acc[h][y], al, bh[y]);
#pragma unroll
        for (int y = 0; y < 2; ++y) kron::mma_tf32_1688(acc[h][y], ah, bl[y]);
#pragma unroll
        for (int y = 0; y < 2; ++y) kron::mma_tf32_1688(acc[h][y], ah, bh[y]);
      }
    }
#pragma unroll
    for (int y = 0; y < 2; ++y)
#pragma unroll
      for (int e = 0; e < 4; ++e) dacc[j][y][e] += acc[0][y][e] + acc[1][y][e];
  }
}

// The f32 stage backward on the tensor cores (any number of factors whose
// dF regions fit kItems a warp).  Per tile, with the warps in two halves:
// the remat of u_{k+1} on the first half beside the transposed step
// G_{n-k} -> G_{n-1-k} on the second (k = 0 .. n-2; the two chains do not
// meet); then every dF_i on the warps that own it (downer); then dX = G_1
// F_0^T on every warp (on the first half, beside dF_0, for one factor).
template <int kItems>
__global__ void __launch_bounds__(kron::kAsyncThreads, 2)
    grad_tf32_kernel(GradArgs a, const float* __restrict__ x, const float* __restrict__ dy,
                     float* __restrict__ dx, float* __restrict__ part) {
  constexpr int kHalf = kron::kWarps / 2;
  extern __shared__ __align__(16) unsigned char kron_smem[];
  unsigned char* sm = kron_smem;
  const long long b = blockIdx.x / a.nblk, j0 = blockIdx.x % a.nblk;
  const int n = a.n, t_m = a.t_m;
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);  // uniform across the warp
  const int half = warp / kHalf, hw = warp % kHalf;
  // A warp's index among the warps that own dF_i, or -1.
  auto df_warp = [&](int i) { return a.downer[i] == 2 ? warp : a.downer[i] == half ? hw : -1; };
  auto at = [&](int off) { return reinterpret_cast<float*>(sm + off); };
  auto panel = [&](int off) { return reinterpret_cast<float4*>(sm + off); };
  {  // zero the states: their pads are never written again
    float4* z = panel(0);
    for (int e = threadIdx.x; e < a.zend / 16; e += blockDim.x) z[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = 0; i + 1 < n; ++i)
    tc_panel(factor<float>(a, i, b), a.p[i], a.q[i], 0, a.q[i], false, panel(a.fpan[i]));
  for (int i = 0; i < n; ++i)
    tc_panel(factor<float>(a, i, b), a.p[i], a.q[i], 0, a.q[i], true, panel(a.tpan[i]));
  __syncthreads();  // the zeros and panels are in place before any copy lands
  float dacc[kItems][2][4];
#pragma unroll
  for (int j = 0; j < kItems; ++j)
#pragma unroll
    for (int y = 0; y < 2; ++y)
#pragma unroll
      for (int e = 0; e < 4; ++e) dacc[j][y][e] = 0.f;
  const long long tiles = a.m_tiles * a.k_tiles;
  if (j0 < tiles) {
    tc_fetch_x(a, x, b, j0, at(a.ubuf[0]));
    tc_fetch_dy(a, dy, b, j0, at(a.gnbuf[0]));
  }
  kron::cp_async_commit();
  int par = 0;
  for (long long tile = j0; tile < tiles; tile += a.nblk, par ^= 1) {
    const bool more = tile + a.nblk < tiles;
    kron::cp_async_wait<0>();
    __syncthreads();  // this tile's copies are in place; the last tile's states are free
    const float* u0 = at(a.ubuf[par]);
    float* gn = at(a.gnbuf[par]);
    if (more) {
      tc_fetch_x(a, x, b, tile + a.nblk, at(a.ubuf[par ^ 1]));
      if (n == 1) tc_fetch_dy(a, dy, b, tile + a.nblk, at(a.gnbuf[par ^ 1]));
    }
    kron::cp_async_commit();
    auto u = [&](int i) { return i == 0 ? u0 : at(a.u[i]); };
    auto gs = [&](int i) { return i == n ? gn : at(a.gst[i - 1]); };  // G_i, 1 <= i <= n
    for (int k = 0; k + 1 < n; ++k) {
      if (half == 0) {  // u_{k+1} = u_k F_k
        const TcFwdSink sink{at(a.u[k + 1]), a.s[k], a.p[k + 1], a.s[k + 1], a.ldu[k + 1],
                             a.csf[k], a.rs[k], a.rp[k + 1]};
        tc_step(hw, kHalf, u(k), a.ldu[k], 1, t_m * a.s[k], a.p[k], panel(a.fpan[k]), a.q[k],
                sink);
      } else {  // G_i = G_{i+1} F_i^T, i = n - 1 - k
        const int i = n - 1 - k;
        const TcBwdSink sink{gs(i), a.s[i], a.p[i], a.s[i - 1], a.ld[i - 1], a.cst[i],
                             a.rcst[i], a.rs[i], a.rs[i - 1]};
        tc_step(hw, kHalf, gs(i + 1), 1, a.ld[i], t_m * a.s[i], a.q[i], panel(a.tpan[i]), a.p[i],
                sink);
      }
      __syncthreads();  // u_{k+1} and G_{n-1-k} are complete
    }
    for (int i = 0; i < n; ++i) {
      const int w = df_warp(i);
      if (w >= 0)
        tc_df<kItems>(w, tc_owner_warps(a.downer[i]), u(i), a.ldu[i], gs(i + 1), a.ld[i], a.p[i],
                      a.q[i], t_m * a.s[i], a.dfirst[i], dacc);
    }
    const long long kt = tile % a.k_tiles;
    const TcDxSink sink{dx + (b * a.M + (tile / a.k_tiles) * t_m) * a.K + kt * a.t_k, a.K, a.s[0],
                        a.p[0], a.dx2, a.rs[0]};
    if (n == 1 && a.downer[0] == 1) {  // dX on the first half, beside dF_0
      if (half == 0)
        tc_step(hw, kHalf, gn, 1, a.ld[0], t_m * a.s[0], a.q[0], panel(a.tpan[0]), a.p[0], sink);
    } else {
      if (n > 1) {
        __syncthreads();  // every dF has read G_n
        if (more) tc_fetch_dy(a, dy, b, tile + a.nblk, at(a.gnbuf[0]));
        kron::cp_async_commit();
      }
      tc_step(warp, kron::kWarps, gs(1), 1, a.ld[0], t_m * a.s[0], a.q[0], panel(a.tpan[0]),
              a.p[0], sink);
    }
  }
  // The warps' sums meet in shared memory: factor i's region rg of group
  // grp at slot base_i + grp * regions_i + rg, 256 floats (d[y][e] of lane
  // l at (y * 4 + e) * 32 + l); then every dF element sums its groups in
  // order.
  __syncthreads();  // every warp is done with the states
  float* dump = at(0);
  const int lane = threadIdx.x & 31;
  int base = 0;
  for (int i = 0; i < n; ++i) {
    const int nw = tc_owner_warps(a.downer[i]), w = df_warp(i);
    const int regions = tc_regions(a.p[i], a.q[i]), groups = tc_groups(a.p[i], a.q[i], nw);
    const int first = a.dfirst[i], items = tc_items(a.p[i], a.q[i], nw);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (j < first || j >= first + items) continue;
      // groups == 1: region w + nw (j - first); else group w / regions,
      // region w % regions: slot w either way for the first item.
      const int slot = w + (j - first) * nw;
      if (w < 0 || slot >= regions * groups) continue;
      float* d = dump + (base + slot) * 256;
#pragma unroll
      for (int y = 0; y < 2; ++y)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[(y * 4 + e) * 32 + lane] = dacc[j][y][e];
    }
    base += regions * groups;
  }
  __syncthreads();
  float* out = part + static_cast<long long>(blockIdx.x) * a.df_total;
  base = 0;
  for (int i = 0; i < n; ++i) {
    const int p = a.p[i], q = a.q[i], nc = r16(q) / 16;
    const int regions = tc_regions(p, q), groups = tc_groups(p, q, tc_owner_warps(a.downer[i]));
    for (int e = threadIdx.x; e < p * q; e += blockDim.x) {
      const int pp = kron::div_fast(e, q, a.rq[i]), qq = e - pp * q;
      const int rg = (pp >> 4) * nc + (qq >> 4);
      const int idx = ((((qq >> 3) & 1) * 4 + ((pp >> 3) & 1) * 2 + (qq & 1)) * 32 +
                       (pp & 7) * 4 + ((qq & 7) >> 1));
      float v = 0.f;
      for (int grp = 0; grp < groups; ++grp) v += dump[(base + grp * regions + rg) * 256 + idx];
      out[a.df_off[i] + e] = v;
    }
    base += regions * groups;
  }
}

template <typename T, typename Acc>
__global__ void __launch_bounds__(kron::kAsyncThreads, 2)
    grad_kernel(GradArgs a, const T* __restrict__ x, const T* __restrict__ dy,
                T* __restrict__ dx, Acc* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char kron_smem[];
  const long long b = blockIdx.x / a.nblk, j0 = blockIdx.x % a.nblk;
  grad_simt<T, Acc>(a, x, dy, dx, part, kron_smem, b, j0);
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
#pragma unroll 8
  for (int j = 0; j < nblk; ++j) v += p[static_cast<long long>(j) * total];
  df[e] = v;
}

template <typename T, typename Acc>
using GradKernel = void (*)(GradArgs, const T*, const T*, T*, Acc*);

// The launch's kernel: the tensor-core ones for a.mma (bf16) and a.tc (f32).
template <typename T, typename Acc>
GradKernel<T, Acc> grad_kernel_for(const GradArgs&) {
  return grad_kernel<T, Acc>;
}
template <>
GradKernel<float, float> grad_kernel_for<float, float>(const GradArgs& a) {
  if (!a.tc) return grad_kernel<float, float>;
  return a.titems <= 1 ? grad_tf32_kernel<1> : grad_tf32_kernel<kTcItems>;
}
template <>
GradKernel<__nv_bfloat16, float> grad_kernel_for<__nv_bfloat16, float>(const GradArgs& a) {
  return a.mma ? grad_mma_kernel : grad_kernel<__nv_bfloat16, float>;
}

template <typename T, typename Acc>
int grad_occupancy(const GradArgs& a, int* blocks) {
  const GradKernel<T, Acc> kernel = grad_kernel_for<T, Acc>(a);
  const int err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(a.smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kron::kAsyncThreads,
                                                       static_cast<size_t>(a.smem));
}

template <typename T, typename Acc>
int grad_launch(const GradArgs& a, void* stream, const void* x, const void* dy, void* dx,
                void* part, void* df) {
  const long long grid = a.B * a.nblk;
  if (grid == 0) return cudaSuccess;
  const GradKernel<T, Acc> kernel = grad_kernel_for<T, Acc>(a);
  int err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(a.smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(grid), kron::kAsyncThreads, static_cast<size_t>(a.smem),
           static_cast<cudaStream_t>(stream)>>>(a, static_cast<const T*>(x),
                                                static_cast<const T*>(dy), static_cast<T*>(dx),
                                                static_cast<Acc*>(part));
  err = cudaGetLastError();
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

}  // namespace

extern "C" {

// x (B, M, K), dy (B, M, prod(qs) * K/prod(ps)), dx (B, M, K) in the input
// dtype; fs: host array of n device pointers, each (B, ps[i], qs[i]).
// part: B * nblk * sum(p_i q_i) and df: B * sum(p_i q_i) elements of the
// accumulator type; df holds dF_0 .. dF_{n-1} of each sample back to back.
// (t_m, t_k): the block tile; nblk: blocks per sample.
int kron_grad(int dtype, const void* x, const void* dy, void* dx, void* part, void* df,
              const void* const* fs, const int* ps, const int* qs, int n, long long B,
              long long M, long long K, int t_m, int t_k, int nblk, void* stream) {
  GradArgs a;
  const int err = grad_args(&a, dtype, x, dy, fs, ps, qs, n, B, M, K, t_m, t_k, nblk);
  if (err != cudaSuccess) return err;
  a.dx2 = a.tc && ps[0] % 2 == 0 && K % 2 == 0 && reinterpret_cast<unsigned long long>(dx) % 8 == 0;
  switch (dtype) {
    case 0:
      return grad_launch<float, float>(a, stream, x, dy, dx, part, df);
    case 1:
      return grad_launch<__nv_bfloat16, float>(a, stream, x, dy, dx, part, df);
    default:
      return grad_launch<double, double>(a, stream, x, dy, dx, part, df);
  }
}

// Blocks of kron_grad's kernel that fit one SM at this stage's block tile
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor for its 256 threads and
// shared memory), into *blocks; its shared memory in bytes into *smem.  The
// pointers x and dy only set the alignment of the ring's copies.
int kron_grad_occupancy(int dtype, const void* x, const void* dy, const int* ps, const int* qs,
                        int n, long long M, long long K, int t_m, int t_k, int* blocks,
                        long long* smem) {
  GradArgs a;
  const void* fs[kMaxFactors] = {};
  const int err = grad_args(&a, dtype, x, dy, fs, ps, qs, n, 1, M, K, t_m, t_k, 1);
  if (err != cudaSuccess) return err;
  *smem = a.smem;
  switch (dtype) {
    case 0:
      return grad_occupancy<float, float>(a, blocks);
    case 1:
      return grad_occupancy<__nv_bfloat16, float>(a, blocks);
    default:
      return grad_occupancy<double, double>(a, blocks);
  }
}

const char* kron_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
