// One FastKron sliced multiply: Y[m, q*S + s] = sum_p X[m, s*P + p] * F[p, q].
//
// Replaces: src/repro/kernels/kron_sliced.py, _sliced_kernel, launched by
// sliced_multiply_pallas (kron_sliced.py:83).  It carries the paper's
// unfused baseline (KronOp(plan=None)): one launch per factor.  Output in
// x's dtype, summed in f32 (f64 for f64) and rounded once.
//
// What bounds it on an H100: bytes.  A launch reads x (M, S*P) once, writes
// y (M, Q*S) once (3.35 TB/s) and does 2*P FLOPs per output element (67
// TFLOP/s f32): a Figure 9 launch (M=1024, P=Q=32, S=32768) moves 8.6 GB
// (2.56 ms) and does 6.9e10 FLOPs (1.03 ms), so the CUDA cores keep up only
// if the contraction runs near their rate while the copies stream.
//
// What the design does about it (kron_async.cuh holds the shared pieces):
// - A persistent grid of 256-thread blocks, at least two per SM (the host
//   sizes it from kron_sliced_occupancy).  Block j walks tiles j, j + nblk,
//   ... of the order (Q-tile, row tile, slice tile), so the (P, t_q) panel
//   is loaded once per block and again only when the Q-tile changes (never
//   when t_q = Q, which the tile rule prefers).
// - Loads overlap compute: a three-slot ring receives the (t_m, t_s*P) x
//   slabs by cp.async, two tiles ahead of the one being computed, in chunks
//   of 16, 8 or 4 bytes as the launch's runs and base allow.
// - No unpack: the contraction reads the raw slab.  Each slice's P values
//   stay contiguous, padded to whole 16-byte chunks with zeros written once
//   at the start (so a read past P meets zero, never a neighbour's value).
// - CUDA cores (f32, f64, and bf16 factors too large for the tensor cores):
//   a thread owns 4 consecutive slices x 8 panel columns (4 for f64) and
//   reads, per 16-byte chunk of P, one vector per slice and one or two
//   panel vectors per p: 12 loads per 128 FMAs in f32.  Slices sit at
//   chunk offset sl*cps + sl/4 (cps: chunks per slice): the 8 threads of a
//   16-byte load phase read slices 4g+r of 8 consecutive groups g, whose
//   chunks g*(4*cps + 1) + const are distinct mod 8 since 4*cps + 1 is odd,
//   so every bank is hit once.  The 4 slices of a (row, column) leave
//   registers as one 16-byte vector (f32) where S and the tile allow.
// - bf16 on the tensor cores, when the transposed panel fits: mma.sync
//   m16n8k16 with f32 sums computes Y^T tile (Q x slices) = F^T (Q x P) *
//   slab^T, so the B operand is the raw slab, P-contiguous per slice.  P
//   and Q are padded to 16 with zeros; a slice row takes P16/8 + 1 chunks
//   (an odd count, so the 8 slices of a fragment load fall in distinct
//   banks, as do the rows of the panel at P16 + 8).  Results are staged in
//   shared memory as bf16 and leave as 16-byte runs where the runs allow.
// - Deterministic: every output element is one thread's (or one mma
//   tile's) sum in a fixed order; no atomics.
// Measured by chip_smoke.py (phase 4) on an NVIDIA H100 80GB HBM3 at 700 W:
// a Figure 9 launch takes 3.6 ms by CUDA events around the call, 71% of its
// byte bound, against 4.3 ms for one einsum.  ffn's bf16 stages on the
// tensor cores lose to einsum: their tiles of 76-128 slices leave each
// block a chain of copy wait, mma and staged stores per tile (PERF.md,
// sliced row).
#include "kron_async.cuh"

namespace {

constexpr int kStages = 3;  // ring slots
constexpr int kSlices = 4;  // consecutive slices of a thread's register tile (CUDA cores)

struct SlicedArgs {
  const void* f;               // (p, q)
  long long K, S, ycols;       // ycols = q * S
  long long m_tiles, s_tiles, tiles;  // tiles of the walk: (Q-tile, row tile, slice tile)
  int p, q, t_m, t_s, t_q, nblk;
  int cps, gp, rs;             // chunks per slice, skew chunks per 4 slices, chunks per row
  int ld;                      // panel row: pad8(t_q) columns (CUDA cores), p16 + 8 (mma)
  int p16, q16, ldo;           // mma: padded P and Q, staging row length (elements)
  int vec, chp;                // copy chunk bytes (0: element-wise), copies per slice
  int out4;                    // CUDA cores: a 4-slice run leaves as one vector
  int ovec, och;               // mma: output chunk bytes (0: element-wise), chunks per run
  float rchp, rts, rtm, rng, rtq, roch;
  int slot, pan, stage;        // bytes of one slot; offsets of the panel and the staging
  long long smem;              // bytes
};

// Host side: fill the arguments of one launch.  The shared-memory layout
// must match repro_torch.kernels.kron_sliced.sliced_smem_bytes.  x and y
// set the chunk widths of the copies and of the output; either may be null
// (occupancy query).
int sliced_args(SlicedArgs* a, int dtype, int mma, const void* x, const void* y, const void* f,
                long long M, long long K, int p, int q, int t_m, int t_s, int t_q, int nblk) {
  if (dtype < 0 || dtype > 2 || p < 1 || q < 1 || t_m < 1 || t_s < 1 || t_q < 1 || nblk < 1)
    return cudaErrorInvalidValue;
  if (K % p || M % t_m || (K / p) % t_s || q % t_q) return cudaErrorInvalidValue;
  if (mma && (dtype != 1 || t_q != q)) return cudaErrorInvalidValue;
  const int isz = dtype == 0 ? 4 : dtype == 1 ? 2 : 8;
  const int acc = dtype == 2 ? 8 : 4;
  const int ech = 16 / isz;  // elements of one 16-byte chunk
  a->f = f;
  a->K = K;
  a->S = K / p;
  a->ycols = q * a->S;
  a->p = p;
  a->q = q;
  a->t_m = t_m;
  a->t_s = t_s;
  a->t_q = t_q;
  a->nblk = nblk;
  a->m_tiles = M / t_m;
  a->s_tiles = a->S / t_s;
  a->tiles = (q / t_q) * a->m_tiles * a->s_tiles;
  // Each slice of x is a run of p elements at row * K + s * p.
  a->vec = kron::chunk_bytes({K * isz, static_cast<long long>(p) * isz,
                              reinterpret_cast<long long>(x)});
  a->chp = a->vec ? p * isz / a->vec : p;
  a->rchp = 1.0f / a->chp;
  a->rts = 1.0f / t_s;
  a->rtm = 1.0f / t_m;
  a->rtq = 1.0f / t_q;
  const int ns = t_m * t_s;  // slices of a tile
  long long slot, panel, stage = 0;
  if (mma) {
    a->p16 = (p + 15) / 16 * 16;
    a->q16 = (q + 15) / 16 * 16;
    a->cps = a->p16 / 8 + 1;   // odd
    a->gp = 0;
    a->rs = t_s * a->cps;      // slice j = m * t_s + sl at chunk j * cps
    a->ld = a->p16 + 8;
    const int n8 = kron::pad8(ns);
    a->ldo = n8 % 16 ? n8 : n8 + 8;  // an odd number of chunks
    slot = static_cast<long long>(n8) * a->cps * 16;
    panel = static_cast<long long>(a->q16) * a->ld * 2;
    stage = static_cast<long long>(t_q) * a->ldo * 2;
    a->ovec = kron::chunk_bytes({a->S * isz, static_cast<long long>(t_s) * isz,
                                 reinterpret_cast<long long>(y)});
    a->och = a->ovec ? t_s * isz / a->ovec : t_s;
    a->out4 = 0;
  } else {
    a->p16 = a->q16 = a->ldo = 0;
    a->cps = (p + ech - 1) / ech;
    a->gp = 1;
    a->rs = t_s * a->cps + (t_s + kSlices - 1) / kSlices;
    a->ld = kron::pad8(t_q);
    slot = static_cast<long long>(t_m) * a->rs * 16;
    panel = static_cast<long long>(a->cps) * ech * a->ld * acc;
    a->out4 = a->S % kSlices == 0 && t_s % kSlices == 0 &&
              reinterpret_cast<long long>(y) % (kSlices * isz) == 0;
    a->ovec = a->och = 0;
  }
  a->roch = a->och ? 1.0f / a->och : 0.f;
  a->rng = 1.0f / ((t_s + kSlices - 1) / kSlices);
  a->slot = static_cast<int>(kron::round16(slot));
  a->pan = kStages * a->slot;
  a->stage = a->pan + static_cast<int>(kron::round16(panel));
  a->smem = a->stage + kron::round16(stage);
  if (a->smem > static_cast<long long>(kron::kMaxSmemBytes)) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Element offset, in a slot, of slice sl of tile row m.
__device__ __forceinline__ int slice_at(const SlicedArgs& a, int m, int sl, int ech) {
  return (m * a.rs + sl * a.cps + (sl >> 2) * a.gp) * ech;
}

// The copies of the x slab of `tile` into `slot`.
template <typename T>
__device__ void sliced_fetch(const SlicedArgs& a, const T* __restrict__ x, long long tile,
                             unsigned char* slot) {
  constexpr int ech = 16 / sizeof(T);
  const long long rem = tile % (a.m_tiles * a.s_tiles);
  const T* src = x + rem / a.s_tiles * a.t_m * a.K + rem % a.s_tiles * a.t_s * a.p;
  T* dst = reinterpret_cast<T*>(slot);
  const int ev = a.vec ? a.vec / static_cast<int>(sizeof(T)) : 1;
  const int total = a.t_m * a.t_s * a.chp;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int run = kron::div_fast(idx, a.chp, a.rchp);  // m * t_s + sl
    const int c = (idx - run * a.chp) * ev;
    const int m = kron::div_fast(run, a.t_s, a.rts);
    const int sl = run - m * a.t_s;
    kron::copy_chunk(dst + slice_at(a, m, sl, ech) + c, src + m * a.K + sl * a.p + c, a.vec);
  }
}

// One 16-byte chunk of a slice, as accumulator values.
__device__ __forceinline__ void load_chunk(const float* s, float (&v)[4]) { kron::load4(s, v); }
__device__ __forceinline__ void load_chunk(const double* s, double (&v)[2]) {
  const double2 t = *reinterpret_cast<const double2*>(s);
  v[0] = t.x;
  v[1] = t.y;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* s, float (&v)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(s);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __bfloat162float(h[i].x);
    v[2 * i + 1] = __bfloat162float(h[i].y);
  }
}

// A tile on the CUDA cores: item (g, m, qb), g fastest, is slices 4g..4g+3
// of row m times panel columns qb*RQ .. qb*RQ + RQ - 1; results go straight
// to y (yt: the tile's first element).
template <typename T, typename Acc>
__device__ __forceinline__ void tile_cores(const SlicedArgs& a, const T* slab, const Acc* panel,
                                           T* yt) {
  constexpr int RQ = sizeof(Acc) == 8 ? 4 : 8;
  constexpr int ech = 16 / sizeof(T);
  constexpr int kUnroll = sizeof(T) == 4 ? 2 : 1;
  const int ng = (a.t_s + kSlices - 1) / kSlices, nqb = a.ld / RQ;
  const int items = ng * a.t_m * nqb;
  for (int w = threadIdx.x; w < items; w += blockDim.x) {
    const int t = kron::div_fast(w, ng, a.rng);
    const int g = w - t * ng;
    const int qb = kron::div_fast(t, a.t_m, a.rtm);
    const int m = t - qb * a.t_m;
    int soff[kSlices];
#pragma unroll
    for (int r = 0; r < kSlices; ++r) {
      const int sl = kSlices * g + r;
      soff[r] = slice_at(a, m, sl < a.t_s ? sl : a.t_s - 1, ech);  // past t_s: never stored
    }
    Acc acc[kSlices][RQ];
#pragma unroll
    for (int r = 0; r < kSlices; ++r)
#pragma unroll
      for (int c = 0; c < RQ; ++c) acc[r][c] = Acc(0);
    const Acc* pb = panel + qb * RQ;
#pragma unroll(kUnroll)
    for (int ch = 0; ch < a.cps; ++ch) {
      Acc av[kSlices][ech];
#pragma unroll
      for (int r = 0; r < kSlices; ++r) load_chunk(slab + soff[r] + ch * ech, av[r]);
#pragma unroll
      for (int e = 0; e < ech; ++e) {
        Acc bv[RQ];
#pragma unroll
        for (int h = 0; h < RQ / 4; ++h) {
          Acc t4[4];
          kron::load4(pb + (ch * ech + e) * a.ld + 4 * h, t4);
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[4 * h + c] = t4[c];
        }
#pragma unroll
        for (int r = 0; r < kSlices; ++r)
#pragma unroll
          for (int c = 0; c < RQ; ++c) acc[r][c] += av[r][e] * bv[c];
      }
    }
    T* yr = yt + m * a.ycols + kSlices * g;
#pragma unroll
    for (int c = 0; c < RQ; ++c) {
      const int qq = qb * RQ + c;
      if (qq >= a.t_q) continue;
      T* o = yr + qq * a.S;
      if (a.out4) {
        const Acc v[kSlices] = {acc[0][c], acc[1][c], acc[2][c], acc[3][c]};
        kron::store4(o, v);
      } else {
#pragma unroll
        for (int r = 0; r < kSlices; ++r)
          if (kSlices * g + r < a.t_s) kron::store(o + r, acc[r][c]);
      }
    }
  }
}

// One output chunk from shared to device memory: 16, 8 or 4 bytes, or one
// element (0).
template <typename T>
__device__ __forceinline__ void put_chunk(T* dst, const T* src, int bytes) {
  if (bytes == 16) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else if (bytes == 8) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  } else if (bytes == 4) {
    *reinterpret_cast<unsigned*>(dst) = *reinterpret_cast<const unsigned*>(src);
  } else {
    *dst = *src;
  }
}

// A bf16 tile on the tensor cores: warp item (qt, ng) is the 16 x 8 tiles
// of Y^T at panel rows qt*16.. and tile slices (ng*kNG + i)*8.. (i < kNG),
// kNG independent sums sharing each A fragment; the tile is staged as
// stage[q * ldo + j] (j = m * t_s + sl) and leaves as runs of t_s.
constexpr int kNG = 4;  // 8-slice n-tiles of one warp item

__device__ __forceinline__ void tile_mma(const SlicedArgs& a, const __nv_bfloat16* slab,
                                         const __nv_bfloat16* panel, __nv_bfloat16* stage,
                                         __nv_bfloat16* yt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntiles = (a.t_m * a.t_s + 7) / 8, sst = a.cps * 8;
  const int ngroups = (ntiles + kNG - 1) / kNG;
  for (int w = warp; w < (a.q16 / 16) * ngroups; w += kron::kWarps) {
    const int qt = w / ngroups, n0 = (w - qt * ngroups) * kNG;
    float d[kNG][4] = {};
    for (int kc = 0; kc < a.p16 / 16; ++kc) {
      unsigned af[4];
      kron::frag_a(af, panel + qt * 16 * a.ld + kc * 16, a.ld);
#pragma unroll
      for (int i = 0; i < kNG; ++i) {
        if (n0 + i >= ntiles) continue;  // uniform across the warp
        unsigned bf[2];
        kron::frag_b(bf, slab + (n0 + i) * 8 * sst + kc * 16, sst);
        kron::mma_bf16_16816(d[i], af, bf);
      }
    }
    const int g = lane >> 2;
#pragma unroll
    for (int i = 0; i < kNG; ++i) {
      if (n0 + i >= ntiles) continue;
      const int j = (n0 + i) * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qq = qt * 16 + g + 8 * h;
        if (qq < a.t_q)
          *reinterpret_cast<__nv_bfloat162*>(stage + qq * a.ldo + j) =
              __floats2bfloat162_rn(d[i][2 * h], d[i][2 * h + 1]);
      }
    }
  }
  __syncthreads();  // the staged tile is complete
  const int ev = a.ovec ? a.ovec / 2 : 1;
  const int total = a.t_m * a.t_q * a.och;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int run = kron::div_fast(idx, a.och, a.roch);  // m * t_q + qq
    const int c = (idx - run * a.och) * ev;
    const int m = kron::div_fast(run, a.t_q, a.rtq);
    const int qq = run - m * a.t_q;
    put_chunk(yt + m * a.ycols + qq * a.S + c, stage + qq * a.ldo + m * a.t_s + c, a.ovec);
  }
}

template <typename T, typename Acc, bool kMma>
__global__ void __launch_bounds__(kron::kAsyncThreads, 2)
    sliced_kernel(SlicedArgs a, const T* __restrict__ x, T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char kron_smem[];
  unsigned char* sm = kron_smem;
  {  // zeros once: the pads of every slice and panel row are never written again
    uint4* z = reinterpret_cast<uint4*>(sm);
    for (int e = threadIdx.x; e < a.smem / 16; e += blockDim.x) z[e] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  const long long j0 = blockIdx.x, inner = a.m_tiles * a.s_tiles;
  const long long mine = j0 < a.tiles ? (a.tiles - j0 + a.nblk - 1) / a.nblk : 0;
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < mine) sliced_fetch(a, x, j0 + st * a.nblk, sm + st * a.slot);
    kron::cp_async_commit();
  }
  long long jq_in = -1;  // the Q-tile of the panel in place
  for (long long i = 0; i < mine; ++i) {
    kron::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i is in place; tile i-1 is done with its slot and the panel
    const long long ahead = i + kStages - 1;
    if (ahead < mine) sliced_fetch(a, x, j0 + ahead * a.nblk, sm + (ahead % kStages) * a.slot);
    kron::cp_async_commit();
    const long long tile = j0 + i * a.nblk;
    const long long jq = tile / inner, rem = tile - jq * inner;
    const T* f = static_cast<const T*>(a.f);
    if (jq != jq_in) {
      if constexpr (kMma) {  // F^T (q16, p16 + 8), pads zero
        T* pt = reinterpret_cast<T*>(sm + a.pan);
        constexpr int kU = 8;  // loads in flight per thread
        const int n = a.p * a.q;
        for (int e0 = threadIdx.x; e0 < n; e0 += kU * blockDim.x) {
          T v[kU];
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const int e = e0 + u * blockDim.x;
            if (e < n) v[u] = f[e];
          }
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const int e = e0 + u * blockDim.x;
            if (e >= n) continue;
            const int pp = kron::div_fast(e, a.q, a.rtq);  // t_q = q
            pt[(e - pp * a.q) * a.ld + pp] = v[u];
          }
        }
      } else {
        kron::panel_fwd(f, a.p, a.q, static_cast<int>(jq) * a.t_q, a.t_q, a.ld,
                        reinterpret_cast<Acc*>(sm + a.pan));
      }
      __syncthreads();
      jq_in = jq;
    }
    T* yt = y + rem / a.s_tiles * a.t_m * a.ycols + jq * a.t_q * a.S + rem % a.s_tiles * a.t_s;
    const T* slab = reinterpret_cast<const T*>(sm + (i % kStages) * a.slot);
    if constexpr (kMma) {
      tile_mma(a, slab, reinterpret_cast<const T*>(sm + a.pan), reinterpret_cast<T*>(sm + a.stage),
               yt);
    } else {
      tile_cores<T>(a, slab, reinterpret_cast<const Acc*>(sm + a.pan), yt);
    }
  }
}

template <typename T, typename Acc, bool kMma>
int prepare(const SlicedArgs& a) {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(sliced_kernel<T, Acc, kMma>),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(a.smem));
}

template <typename T, typename Acc, bool kMma>
int launch(const SlicedArgs& a, void* stream, const void* x, void* y) {
  if (a.tiles == 0) return cudaSuccess;
  const int err = prepare<T, Acc, kMma>(a);
  if (err != cudaSuccess) return err;
  sliced_kernel<T, Acc, kMma><<<static_cast<unsigned>(a.nblk), kron::kAsyncThreads,
                                static_cast<size_t>(a.smem), static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const T*>(x), static_cast<T*>(y));
  return cudaGetLastError();
}

template <typename T, typename Acc, bool kMma>
int occupancy(const SlicedArgs& a, int* blocks) {
  const int err = prepare<T, Acc, kMma>(a);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, sliced_kernel<T, Acc, kMma>, kron::kAsyncThreads, static_cast<size_t>(a.smem));
}

}  // namespace

extern "C" {

// x (M, K = S*p), f (p, q), y (M, q*S), all contiguous; tiles (t_m, t_s,
// t_q); mma: the bf16 tensor-core path (t_q = q); nblk: blocks of the
// persistent grid.
int kron_sliced(int dtype, int mma, const void* x, const void* f, void* y, long long M,
                long long K, int p, int q, int t_m, int t_s, int t_q, int nblk, void* stream) {
  SlicedArgs a;
  const int err = sliced_args(&a, dtype, mma, x, y, f, M, K, p, q, t_m, t_s, t_q, nblk);
  if (err != cudaSuccess) return err;
  if (mma) return launch<__nv_bfloat16, float, true>(a, stream, x, y);
  switch (dtype) {
    case 0:
      return launch<float, float, false>(a, stream, x, y);
    case 1:
      return launch<__nv_bfloat16, float, false>(a, stream, x, y);
    default:
      return launch<double, double, false>(a, stream, x, y);
  }
}

// Blocks of kron_sliced's kernel that fit one SM at these tiles, into
// *blocks; its shared memory in bytes into *smem.
int kron_sliced_occupancy(int dtype, int mma, long long M, long long K, int p, int q, int t_m,
                          int t_s, int t_q, int* blocks, long long* smem) {
  SlicedArgs a;
  const int err = sliced_args(&a, dtype, mma, nullptr, nullptr, nullptr, M, K, p, q, t_m, t_s,
                              t_q, 1);
  if (err != cudaSuccess) return err;
  *smem = a.smem;
  if (mma) return occupancy<__nv_bfloat16, float, true>(a, blocks);
  switch (dtype) {
    case 0:
      return occupancy<float, float, false>(a, blocks);
    case 1:
      return occupancy<__nv_bfloat16, float, false>(a, blocks);
    default:
      return occupancy<double, double, false>(a, blocks);
  }
}

const char* kron_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
