// One transposed FastKron sliced multiply (the input cotangent of one
// factor): dX[m, s*P + p] = sum_q dY[m, q*S + s] * F[p, q].
//
// Replaces: src/repro/kernels/kron_sliced_t.py, _sliced_t_kernel, launched
// by sliced_multiply_t_pallas (kron_sliced_t.py:78).  It carries the unfused
// baseline's backward (KronOp(plan=None)) and the per-factor fallback of a
// stage backward: one launch per factor.  The Pallas kernel sums its
// Q-tiles in dY's dtype; this one sums them in f32 (f64 for f64) and rounds
// once, so bf16 results differ from it within bf16 rounding.
//
// What bounds it on an H100: bytes.  A launch reads dY (M, Q*S) once, writes
// dX (M, S*P) once (3.35 TB/s) and does 2*Q FLOPs per element of dX (67
// TFLOP/s f32): at P = Q = 32 that is 8 FLOPs per byte moved, against the
// card's 20 for f32, so memory sets the floor.
//
// What the design does about it: keep device-memory reads in flight all the
// time.  A persistent grid, sized on the host from the occupancy query
// (kron_sliced_t_occupancy, at least two blocks of 256 threads per SM),
// walks (t_m, t_s) tiles in a fixed order; each tile is t_q-wide Q-tiles
// (one when the panel fits, which the tile rule prefers).  A three-slot
// cp.async ring holds the (t_m, t_q, t_s) boxes of the (M, Q, S) view of
// dY, contiguous along s, two stages ahead of the one being computed.  The
// transposed (Q, P) panel of F is loaded once per block; when Q is tiled,
// each ring slot carries its Q-tile's slice of the panel instead.  Every
// thread owns one (row, 4 slices, 4 columns of P) register tile of the
// tile's dX, sums the Q-tiles into it in order (f32, f64 for f64, no
// atomics) and stores it straight from registers to the contiguous
// (t_m, t_s*P) block of dX, as 16-byte vectors when P is a multiple of 4.
#include "kron_async.cuh"

namespace {

constexpr int kStages = 3;  // ring slots
constexpr int kSlices = 4;  // slices of a thread's register tile

struct SlicedTArgs {
  const void* f;               // (p, q)
  long long M, S, s_tiles, tiles;
  int p, q, t_m, t_s, t_q, nq, p4, nblk;
  int vec;                     // chunk bytes of the ring's copies (0: element-wise)
  int chs, box_chunks;         // chunks per run of t_s, per box
  float rchs, rtq;
  int slot, pan;               // bytes of one slot; offset of the panel (slice)
  long long smem;              // bytes
};

// Host side: fill the arguments of one launch.  The shared-memory layout
// must match repro_torch.kernels.kron_sliced.sliced_t_smem_bytes.
int sliced_t_args(SlicedTArgs* a, int dtype, const void* dy, const void* f, long long M,
                  long long S, int p, int q, int t_m, int t_s, int t_q, int nblk) {
  if (dtype < 0 || dtype > 2 || p < 1 || q < 1 || t_m < 1 || t_s < 1 || t_q < 1 || nblk < 1)
    return cudaErrorInvalidValue;
  if (M % t_m || S % t_s || q % t_q) return cudaErrorInvalidValue;
  const int isz = dtype == 0 ? 4 : dtype == 1 ? 2 : 8;
  const int acc = dtype == 2 ? 8 : 4;
  a->f = f;
  a->M = M;
  a->S = S;
  a->p = p;
  a->q = q;
  a->t_m = t_m;
  a->t_s = t_s;
  a->t_q = t_q;
  a->nq = q / t_q;
  a->p4 = (p + 3) / 4 * 4;
  a->nblk = nblk;
  a->s_tiles = S / t_s;
  a->tiles = M / t_m * a->s_tiles;
  if (t_m * ((t_s + kSlices - 1) / kSlices) * (a->p4 / 4) > kron::kAsyncThreads)
    return cudaErrorInvalidValue;  // one register tile per thread
  a->vec = kron::chunk_bytes({S * isz, static_cast<long long>(t_s) * isz,
                              reinterpret_cast<long long>(dy)});
  const int ech = a->vec ? a->vec / isz : 1;
  a->chs = t_s / ech;
  a->box_chunks = t_m * t_q * a->chs;
  a->rchs = 1.0f / a->chs;
  a->rtq = 1.0f / t_q;
  const long long box = kron::round16(static_cast<long long>(t_m) * t_q * t_s * isz);
  const long long panel = kron::round16(static_cast<long long>(t_q) * a->p4 * acc);
  if (a->nq > 1) {
    a->slot = static_cast<int>(box + panel);
    a->pan = static_cast<int>(box);  // inside each slot
    a->smem = kStages * (box + panel);
  } else {
    a->slot = static_cast<int>(box);
    a->pan = static_cast<int>(kStages * box);  // one, after the ring
    a->smem = kStages * box + panel;
  }
  if (a->smem > static_cast<long long>(kron::kMaxSmemBytes)) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Stage st of this block: Q-tile jq of its (st / nq)-th tile, into its slot.
template <typename T, typename Acc>
__device__ void sliced_t_fetch(const SlicedTArgs& a, const T* __restrict__ dy, long long j0,
                               int st, unsigned char* sm) {
  const long long tile = j0 + static_cast<long long>(st / a.nq) * a.nblk;
  const int jq = st % a.nq;
  const long long m0 = tile / a.s_tiles * a.t_m, s0 = tile % a.s_tiles * a.t_s;
  unsigned char* slot = sm + (st % kStages) * a.slot;
  T* box = reinterpret_cast<T*>(slot);
  const int ech = a.t_s / a.chs;
  const T* src = dy + (m0 * a.q + static_cast<long long>(jq) * a.t_q) * a.S + s0;
  for (int idx = threadIdx.x; idx < a.box_chunks; idx += blockDim.x) {
    const int run = kron::div_fast(idx, a.chs, a.rchs);  // (m, qq) row-major
    const int c = (idx - run * a.chs) * ech;
    const int m = kron::div_fast(run, a.t_q, a.rtq);
    kron::copy_chunk(box + run * a.t_s + c,
                     src + (m * static_cast<long long>(a.q) + run - m * a.t_q) * a.S + c, a.vec);
  }
  if (a.nq > 1)
    kron::panel_t(static_cast<const T*>(a.f), a.p, a.q, jq * a.t_q, a.t_q, a.p4,
                  reinterpret_cast<Acc*>(slot + a.pan));
}

template <typename T, typename Acc>
__global__ void __launch_bounds__(kron::kAsyncThreads, 2)
    sliced_t_kernel(SlicedTArgs a, const T* __restrict__ dy, T* __restrict__ dx) {
  extern __shared__ __align__(16) unsigned char kron_smem[];
  const long long j0 = blockIdx.x;
  const long long mine = j0 < a.tiles ? (a.tiles - j0 + a.nblk - 1) / a.nblk : 0;
  const int nst = static_cast<int>(mine * a.nq);
  if (a.nq == 1)
    kron::panel_t(static_cast<const T*>(a.f), a.p, a.q, 0, a.q, a.p4,
                  reinterpret_cast<Acc*>(kron_smem + a.pan));
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nst) sliced_t_fetch<T, Acc>(a, dy, j0, st, kron_smem);
    kron::cp_async_commit();
  }
  // This thread's register tile: pb fastest, so that a warp's stores fill
  // whole rows of dX and its panel reads are one 128-byte line.
  const int npb = a.p4 / 4, nsb = (a.t_s + kSlices - 1) / kSlices;
  const int pb = threadIdx.x % npb, t = threadIdx.x / npb;
  const int m = t / nsb, sb = t - m * nsb;
  const bool active = m < a.t_m;
  int soff[kSlices];
#pragma unroll
  for (int r = 0; r < kSlices; ++r) {
    const int sl = sb + r * nsb;
    soff[r] = sl < a.t_s ? sl : 0;
  }
  Acc acc[kSlices][kron::kRQ];
  for (int st = 0; st < nst; ++st) {
    kron::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage st is in place; stage st-1's slot is free
    if (st + kStages - 1 < nst) sliced_t_fetch<T, Acc>(a, dy, j0, st + kStages - 1, kron_smem);
    kron::cp_async_commit();
    const int jq = st % a.nq;
    if (jq == 0) {
#pragma unroll
      for (int r = 0; r < kSlices; ++r)
#pragma unroll
        for (int c = 0; c < kron::kRQ; ++c) acc[r][c] = Acc(0);
    }
    if (!active) continue;
    const unsigned char* slot = kron_smem + (st % kStages) * a.slot;
    const T* box = reinterpret_cast<const T*>(slot) + m * a.t_q * a.t_s;
    const Acc* panel = reinterpret_cast<const Acc*>(a.nq > 1 ? slot + a.pan : kron_smem + a.pan);
    kron::contract<kSlices>(acc, box, a.t_s, soff, panel + pb * kron::kRQ, a.p4, a.t_q);
    if (jq == a.nq - 1) {
      const long long tile = j0 + static_cast<long long>(st / a.nq) * a.nblk;
      const long long m0 = tile / a.s_tiles * a.t_m, s0 = tile % a.s_tiles * a.t_s;
      T* dxt = dx + (m0 * a.S + s0) * a.p;
#pragma unroll
      for (int r = 0; r < kSlices; ++r) {
        const int sl = sb + r * nsb;
        if (sl < a.t_s) kron::put_row(dxt, a.S * a.p, a.p, m, sl, pb, acc[r]);
      }
    }
  }
}

template <typename T, typename Acc>
int sliced_t_prepare(const SlicedTArgs& a) {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(sliced_t_kernel<T, Acc>),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(a.smem));
}

template <typename T, typename Acc>
int sliced_t_launch(const SlicedTArgs& a, void* stream, const void* dy, void* dx) {
  if (a.tiles == 0) return cudaSuccess;
  const int err = sliced_t_prepare<T, Acc>(a);
  if (err != cudaSuccess) return err;
  sliced_t_kernel<T, Acc><<<static_cast<unsigned>(a.nblk), kron::kAsyncThreads,
                            static_cast<size_t>(a.smem), static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const T*>(dy), static_cast<T*>(dx));
  return cudaGetLastError();
}

template <typename T, typename Acc>
int sliced_t_occupancy(const SlicedTArgs& a, int* blocks) {
  const int err = sliced_t_prepare<T, Acc>(a);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, sliced_t_kernel<T, Acc>, kron::kAsyncThreads, static_cast<size_t>(a.smem));
}

}  // namespace

extern "C" {

// dy (M, q*S), f (p, q), dx (M, S*p), all contiguous; tiles (t_m, t_s, t_q);
// nblk: blocks of the persistent grid.
int kron_sliced_t(int dtype, const void* dy, const void* f, void* dx, long long M, long long S,
                  int p, int q, int t_m, int t_s, int t_q, int nblk, void* stream) {
  SlicedTArgs a;
  const int err = sliced_t_args(&a, dtype, dy, f, M, S, p, q, t_m, t_s, t_q, nblk);
  if (err != cudaSuccess) return err;
  switch (dtype) {
    case 0:
      return sliced_t_launch<float, float>(a, stream, dy, dx);
    case 1:
      return sliced_t_launch<__nv_bfloat16, float>(a, stream, dy, dx);
    default:
      return sliced_t_launch<double, double>(a, stream, dy, dx);
  }
}

// Blocks of kron_sliced_t's kernel that fit one SM at these tiles, into
// *blocks; its shared memory in bytes into *smem.  dy only sets the
// alignment of the ring's copies.
int kron_sliced_t_occupancy(int dtype, const void* dy, long long M, long long S, int p, int q,
                            int t_m, int t_s, int t_q, int* blocks, long long* smem) {
  SlicedTArgs a;
  const int err = sliced_t_args(&a, dtype, dy, nullptr, M, S, p, q, t_m, t_s, t_q, 1);
  if (err != cudaSuccess) return err;
  *smem = a.smem;
  switch (dtype) {
    case 0:
      return sliced_t_occupancy<float, float>(a, blocks);
    case 1:
      return sliced_t_occupancy<__nv_bfloat16, float>(a, blocks);
    default:
      return sliced_t_occupancy<double, double>(a, blocks);
  }
}

const char* kron_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
