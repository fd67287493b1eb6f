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
// writes dX once.  A single-factor bf16 stage (the kron_ffn layers) does
// little work per byte and is bound by bytes.
//
// What the design does about it:
// - Persistent blocks of 256 threads, at most 128 registers each and a
//   block tile that fits half of an SM's shared memory, so that two blocks
//   share every SM; the host sizes the grid from the occupancy query
//   (kron_grad_occupancy).  A block keeps one sample and walks its tiles in
//   a fixed order (j0, j0 + nblk, ...).
// - Loads overlap compute.  While tile t runs its steps, cp.async brings
//   tile t+1's x slab (t_m' rows of t_k' elements) and dY block (runs of
//   ts_out elements of the (B, M, Q_{n-1}..Q_0, S) view) into shared
//   memory; one wait and one barrier hand them over.  One slot is enough:
//   a tile's raw x (and raw dY) are unpacked into the compute layouts at its
//   start, so the next tile's copies start right after that unpack.
//   In f32 and f64 multi-factor stages dY skips the slot: it lands directly
//   in its padded gradient state G_n, and the next tile's dY starts as
//   soon as step n-1 has read G_n.
// - Fixed work leaves the tile loop: every factor panel of the stage, in
//   both orientations, is loaded once per block.
// - dF partials persist: each thread owns fixed (group, 4x4) items of every
//   factor's dF for the whole tile loop, in its own shared-memory slice.
//   The groups are summed once, in group order, when the block ends; the
//   block writes one partial, and the second launch sums the partials of a
//   sample in block order.  No atomics: two runs are equal bit for bit.
// - Each step is a register-tiled contraction (kron_async.cuh); the chain
//   states are padded to odd slice strides so that a warp's reads fall in
//   distinct banks.  Barriers per tile: 2n.
// - bf16 single-factor stages run on the tensor cores (mma.sync m16n8k16,
//   f32 accumulate) in a kernel of their own, grad_mma_kernel: every operand
//   of dF = x^T dY and dX = dY F^T is a kernel input, so keeping them in
//   bf16 in shared memory is exact.  dX reads the stored dY^T through
//   ldmatrix.trans, and each warp keeps its dF tiles in registers (up to
//   kMmaItems; larger factors take the CUDA-core path).  Intermediates of
//   multi-factor stages stay f32 on the CUDA cores, as the Pallas kernel
//   keeps them.
#include "kron_async.cuh"

namespace {

using kron::kMaxFactors;
using kron::kRQ;
constexpr int kMmaItems = 8;  // dF output tiles per warp held in registers

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
  long long smem;              // bytes
};

__host__ __device__ inline int r4(int e) { return (e + 3) / 4 * 4; }
__host__ __device__ inline int r8(int e) { return (e + 7) / 8 * 8; }
__host__ __device__ inline int r16(int e) { return (e + 15) / 16 * 16; }

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
  // The ring's chunks: x rows of t_k at row * K + kt * t_k; dY runs of
  // ts_out at row * out_cols + kt * ts_out + sum_l ql_l * ostride_l.
  a->vec_x = kron::chunk_bytes({K * isz, t_k * isz, reinterpret_cast<long long>(x)});
  a->vec_dy = kron::chunk_bytes({a->out_cols * isz, a->ts_out * static_cast<long long>(isz),
                                 a->s_out * isz, reinterpret_cast<long long>(dy)});
  const int ex = a->vec_x ? a->vec_x / isz : 1, ed = a->vec_dy ? a->vec_dy / isz : 1;
  a->xch = t_k / ex;
  a->rch = a->ts_out / ed;
  a->dych = cn / ed;
  a->rxch = 1.0f / a->xch;
  a->rrch = 1.0f / a->rch;
  a->rdych = 1.0f / a->dych;

  // bf16 single-factor stages whose dF fits the warps' registers
  // (kMmaItems output tiles of 16 x 8 per warp) run on the tensor cores.
  a->ct = (r16(ps[0]) / 16) * (r8(qs[0]) / 8);
  a->mgroups = a->ct >= kron::kWarps ? 1 : kron::kWarps / a->ct;
  a->mma = dtype == 1 && n == 1 && a->ct <= kMmaItems * kron::kWarps;
  a->dy_direct = isz == acc && n > 1;
  const long long slot_x = kron::round16(static_cast<long long>(t_m) * t_k * isz);
  a->slot_dy = static_cast<int>(slot_x);
  long long off = slot_x + (a->dy_direct ? 0 : kron::round16(static_cast<long long>(t_m) * cn * isz));
  long long df_total = 0;
  for (int i = 0; i < n; ++i) {
    a->df_off[i] = static_cast<int>(df_total);
    df_total += static_cast<long long>(ps[i]) * qs[i];
  }
  a->df_total = static_cast<int>(df_total);
  if (a->mma) {
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

// The launch's kernel: the tensor-core one for a.mma (bf16 only).
template <typename T, typename Acc>
GradKernel<T, Acc> grad_kernel_for(const GradArgs&) {
  return grad_kernel<T, Acc>;
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
