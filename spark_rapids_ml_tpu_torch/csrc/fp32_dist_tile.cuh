// The pipelined fp32 distance-tile main loop that the nearest-center kernel
// (B1, csrc/min_dist_argmin.cu), the exact-kNN candidate pool (B5/B6) and
// the audit count kernel (B8, both csrc/knn_topm.cu) share, for Hopper
// (sm_90a).
//
// For one block it computes, for each of n_tiles consecutive (BM x BN)
// tiles of two row-major operands A (na, d) and B (nb, d), d contiguous,
//
//     acc[i][j] = A[a0 + row_of(i)] . B[b0 + BN*t + col_of(j)]
//
// and hands acc to an epilogue functor after each tile t.  The kernels
// form d2 = (||a||^2 - 2 a.b) + ||b||^2 in their epilogue; no epilogue
// cares how the tile is blocked.
//
// Arithmetic (a contract, not a detail): every acc[i][j] is one fmaf chain
// over k = 0, 1, ..., d-1 in ascending order, starting from 0.0f: no split
// K, no second accumulator, no TF32 or tensor-core product.  Rows, items and
// features past the ragged edges read as 0, and fmaf(0, 0, acc) == acc, so
// the result does not depend on the tiling.  That is what makes B8's -d2
// (one 128-item tile a block) bitwise equal to B5/B6's (a 1024-item group of
// 8 tiles a block), the property the kNN audit rests on.
//
// What bounds it: 2 * rows * cols * d fp32 FMAs on the CUDA cores (67
// TFLOP/s on an H100 SXM) against 4 * (rows + cols) * d bytes of input; at
// d in the hundreds or more it is bound by operations.  Next to the FMA
// pipe, the limit is the shared-memory read path: a warp-wide LDS.128
// delivers 512 bytes, four cycles of the SM's 128 bytes a cycle.  The
// design:
//
//   - 128 threads, 4 warps as 2 (M) x 2 (N); a warp owns a 64 x 64 piece
//     of the 128 x 128 tile, a lane (8 x 4 lanes) an 8 x 16 micro-tile made
//     of two 4-row and four 4-column groups, so a k step reads its A and B
//     fragments as 2 + 4 float4 (LDS.128) for 128 FMAs: 0.19 bytes of
//     shared memory per FMA.  An 8 x 8 micro-tile (2 + 2 LDS.128 for 64
//     FMAs, 0.25 bytes per FMA) keeps both pipes busy together: it reached
//     43-52% of the fp32 peak at the KMeans shape on an H100 SXM, 8 x 16
//     67% (PERF.md).  The 8 lanes that read different A groups cover 128
//     contiguous bytes, the others broadcast: no bank conflicts;
//   - stages are k-major in shared memory (stage[k][row], padded to
//     LD = BM + 4 floats), so those fragments are contiguous;
//   - loads are pipelined through registers: the global loads of slice s+1
//     (two 16-byte LDG.128 per operand and thread, or eight 4-byte loads)
//     are issued before the FMAs of slice s and stored, transposed, into
//     the other of two shared-memory stages after them; one __syncthreads
//     a slice.  The pipeline runs on across tile boundaries, so B1's loop
//     over center tiles and B5's over a group's item tiles do not drain it.  Register prefetch rather than
//     cp.async: 16-byte cp.async copies bytes as they lie and cannot
//     transpose (an [m][k] stage would need float4 reads along k and four
//     times the fragment registers), and 4-byte cp.async copies straight
//     into k-major stages were slower on aligned rows; the register path
//     transposes for free in the store and keeps one code path for both
//     copy widths;
//   - BK = 8 features a slice: 2 x 2 x 8 x 132 floats = 16.9 KB of static
//     shared memory; 128 accumulators, 24 fragment and 16 prefetch
//     registers a thread, so two 128-thread blocks an SM under
//     __launch_bounds__(128, 2) (<= 255 registers, no spills);
//   - VEC = 4 copies 16 bytes (needs a 16-byte-aligned row start: both
//     base pointers and d * 4 multiples of 16); VEC = 1 copies 4 bytes and
//     takes any pointer and any d.  copy_width() picks one.
//
// Every element offset is 64-bit.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fp32_dist_tile {

constexpr int WARPS_M = 2;  // warps down the tile
constexpr int WARPS_N = 2;  // warps across it
constexpr int NG = 4;       // 4-column groups of a lane's micro-tile
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int TM = 8, TN = 4 * NG;
constexpr int BM = WARPS_M * 64;      // rows of A in a tile
constexpr int BN = WARPS_N * 16 * NG; // rows of B in a tile
constexpr int BK = 8;        // features a slice
constexpr int LD = BM + 4;   // padded stage row: conflict-free transposed stores
constexpr int STAGE_FLOATS = BK * LD;          // one operand, one stage
constexpr int SMEM_FLOATS = 2 * 2 * STAGE_FLOATS;  // A and B, two stages each
constexpr int CHUNKS = BM * BK / (4 * THREADS);  // float4s of an operand a thread brings a slice
static_assert(BM == BN, "one loader geometry serves both operands");
static_assert(CHUNKS * 4 * THREADS == BM * BK, "the slice splits evenly");

// 4 (16-byte copies) when the row starts of both operands are 16-byte
// aligned, else 1 (4-byte copies).
inline int copy_width(const void* a, const void* b, long long d) {
  const unsigned long long bits = reinterpret_cast<unsigned long long>(a) |
                                  reinterpret_cast<unsigned long long>(b) |
                                  static_cast<unsigned long long>(d) * 4ull;
  return bits % 16 == 0 ? 4 : 1;
}

// The thread layout: warp (wm, wn) in WARPS_M x WARPS_N, lane (lm, ln) in 8 x 4.
__device__ __forceinline__ int warp_m() { return (threadIdx.x >> 5) / WARPS_N; }
__device__ __forceinline__ int warp_n() { return (threadIdx.x >> 5) % WARPS_N; }
__device__ __forceinline__ int lane_m() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_n() { return threadIdx.x & 3; }
// The lanes that share a row are the 4 lanes lane_m() * 4 + 0..3 of each
// of the WARPS_N warps warp_m() * WARPS_N + 0..WARPS_N-1.
__device__ __forceinline__ int row_of(int i) {
  return warp_m() * 64 + lane_m() * 4 + (i & 3) + 32 * (i >> 2);
}
__device__ __forceinline__ int col_of(int j) {
  return warp_n() * 16 * NG + lane_n() * 4 + (j & 3) + 16 * (j >> 2);
}

// One operand's slice loader: thread t brings features kc .. kc+3 (kc =
// 4 * (t % 2)) of tile rows t / 2 + (THREADS / 2) * l, l < CHUNKS.
template <int VEC>
struct Loader {
  static constexpr int ROW_STEP = THREADS / 2;
  const float* src;  // the thread's first row, at feature kc
  int64_t step;      // ROW_STEP rows
  int rows_left;     // rows of the operand from the thread's first row on (capped)
  float v[CHUNKS][4];

  __device__ __forceinline__ void seek(const float* base, int64_t rows, int64_t row0, int64_t d) {
    const int64_t r = row0 + (threadIdx.x >> 1);
    const int64_t left = rows - r;
    rows_left = left < 0 ? 0 : (left > BM ? BM : static_cast<int>(left));
    src = base + (rows_left > 0 ? r * d : 0) + 4 * (threadIdx.x & 1);
    step = ROW_STEP * d;
  }

  __device__ __forceinline__ void load(int k0, int d) {
    const int kc = k0 + 4 * (threadIdx.x & 1);
#pragma unroll
    for (int l = 0; l < CHUNKS; ++l) {
      const bool row_ok = ROW_STEP * l < rows_left;
      const float* p = src + l * step + k0;
      if (VEC == 4) {
        float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (row_ok && kc < d) x = __ldg(reinterpret_cast<const float4*>(p));
        v[l][0] = x.x;
        v[l][1] = x.y;
        v[l][2] = x.z;
        v[l][3] = x.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[l][e] = (row_ok && kc + e < d) ? __ldg(p + e) : 0.0f;
      }
    }
  }

  // transposed into the k-major stage
  __device__ __forceinline__ void store(float* stage) const {
    float* dst = stage + 4 * (threadIdx.x & 1) * LD + (threadIdx.x >> 1);
#pragma unroll
    for (int l = 0; l < CHUNKS; ++l)
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e * LD + ROW_STEP * l] = v[l][e];
  }
};

// The FMAs of one slice: BK k steps in ascending order.
__device__ __forceinline__ void fma_slice(const float* As, const float* Bs, float (&acc)[TM][TN]) {
  const float* ap = As + warp_m() * 64 + lane_m() * 4;
  const float* bp = Bs + warp_n() * 16 * NG + lane_n() * 4;
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float a[TM], b[TN];
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(ap + kk * LD + 32 * g);
      a[4 * g] = x.x;
      a[4 * g + 1] = x.y;
      a[4 * g + 2] = x.z;
      a[4 * g + 3] = x.w;
    }
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(bp + kk * LD + 16 * g);
      b[4 * g] = x.x;
      b[4 * g + 1] = x.y;
      b[4 * g + 2] = x.z;
      b[4 * g + 3] = x.w;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The main loop.  `smem` holds SMEM_FLOATS floats, 16-byte aligned.  Calls
// epi(acc, t) for t = 0 .. n_tiles-1, each right after a barrier: shared
// memory outside the stages that was written before run() may be read in
// it, and after the last call every thread is done with the stages, so the
// caller may reuse them (after a barrier of its own if the epilogue wrote
// shared memory).  Every thread makes every call, so an epilogue may hold
// barriers of its own, and the next tile's barriers order one call's
// shared-memory reads before the next call's writes.
// 1 <= d < 2^31 - BK.
template <int VEC, class Epilogue>
__device__ __forceinline__ void run(const float* __restrict__ A, int64_t na, int64_t a0,
                                    const float* __restrict__ B, int64_t nb, int64_t b0,
                                    int n_tiles, int64_t d, float* smem, Epilogue& epi) {
  float* As = smem;                     // [2][BK][LD]
  float* Bs = smem + 2 * STAGE_FLOATS;  // [2][BK][LD]
  const int slices = static_cast<int>((d + BK - 1) / BK);
  const int dk = static_cast<int>(d);
  Loader<VEC> la, lb;
  la.seek(A, na, a0, d);
  lb.seek(B, nb, b0, d);
  la.load(0, dk);
  lb.load(0, dk);
  la.store(As);
  lb.store(Bs);
  __syncthreads();

  int buf = 0;
  for (int t = 0; t < n_tiles; ++t) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
    for (int s = 0; s < slices; ++s) {
      // issue the next slice's loads: s + 1 of tile t, or 0 of tile t + 1
      const bool last = s + 1 == slices;
      const bool more = !last || t + 1 < n_tiles;
      if (more) {
        if (last) lb.seek(B, nb, b0 + static_cast<int64_t>(BN) * (t + 1), d);
        const int k0 = last ? 0 : BK * (s + 1);
        la.load(k0, dk);
        lb.load(k0, dk);
      }
      fma_slice(As + buf * STAGE_FLOATS, Bs + buf * STAGE_FLOATS, acc);
      if (more) {
        la.store(As + (buf ^ 1) * STAGE_FLOATS);
        lb.store(Bs + (buf ^ 1) * STAGE_FLOATS);
      }
      __syncthreads();
      buf ^= 1;
    }
    epi(acc, t);
  }
}

}  // namespace fp32_dist_tile
