// Exact-kNN candidate pool and audit count for Hopper (sm_90a):
//
//     -d2[q, x] = -((||q||^2 - 2 q . x) + ||x||^2)
//
//   srml_knn_topm_f32   per query and per group of G = 1024 consecutive items,
//                       the top m of -d2 by (value descending, position
//                       ascending): the candidate pool (Q, ng, m)
//   srml_knn_count_f32  per query, #{x : -d2[q, x] > thresh[q]}
//
// Replaces the TPU kernels of spark_rapids_ml_tpu/ops/pallas_knn.py:
// _knn_topm_kernel_qres (the main path's candidates), _knn_topm_kernel (the
// same pool on the legacy K-blocked grid, launched by the audit route; both
// are one function, so both are this kernel) and _knn_count_kernel.  The two
// TPU grids are two VMEM schedules of one computation; on the card one
// schedule serves both.  Invalid items arrive with a +inf norm and columns
// past n give -inf, as there.  Selection is position-masked, so duplicated
// items stay distinct candidates, and a slot that finds only -inf left takes
// the group's first column (the TPU kernel's first-occurrence argmax over a
// tile masked to -inf).
//
// What bounds it on the card: 2*Q*n*d fp32 operations against 4*(Q + n)*d
// bytes of input; at the kNN flagship (Q = 8192 per block, n = 400,000,
// d = 3000) far above the fp32 ridge (~20 operations per byte), so it is
// bound by fp32 FMAs on the CUDA cores.  Products are exact fp32 FMA, no
// TF32 (the TPU kernel runs a 3-pass bf16 dot for the same reason: the norm
// expansion cancels near the nearest neighbours).
//
// Both kernels run the pipelined main loop of fp32_dist_tile.cuh (128 x 128
// tiles, 128 threads, two blocks an SM), with their own epilogues.  Their
// -d2 is bitwise the same (the property the audit rests on): the loop sums
// each dot product as one fmaf chain over d in ascending order from 0.0f,
// with zeros past the ragged edges, which gives the same bits whatever the
// tiling, and both form -d2 with neg_d2().
//   - The pool: a block takes 128 queries and one 1024-item group, and the
//     loop runs over the group's 8 item tiles (fewer in a ragged last group)
//     without draining its pipeline.  After each tile the epilogue stages
//     the tile's -d2 in shared memory, half a tile at a time (the 64 columns
//     of one warp column: 34 KB instead of 68), and thread r, the owner of
//     query row r, scans its row's columns in ascending position into the
//     row's sorted list of at most m (value, position) pairs in shared
//     memory.  Columns arrive in ascending position, so a candidate enters a
//     full list only if it beats the list's m-th value strictly (a tie loses
//     on position); before the list is full every value above -inf enters.
//     -inf never enters: the slots a list did not fill are written as (-inf,
//     the group's first position), which is what m first-occurrence argmax
//     passes give once every column is -inf.  After the first tile a row's
//     m-th value rejects almost every column at one compare, so the scan
//     costs ~0.1% of the tile's FMAs.  Shared memory: 16.9 KB of stages,
//     34 KB of half tile, 8 * 128 * m bytes of lists: 60 KB at m = 9, 84 KB
//     at m = 32, so two blocks an SM at every m.  The blocks walk
//     TILE_GROUP query tiles at a time with the item groups inside, so the
//     blocks in flight share a few query tiles (1.5 MB each at d = 3000) and
//     each group's 12 MB of items in the 50-MB L2.  One 1-D grid, launched
//     in chunks of at most 2^31 - 1 blocks.  450 ms at the flagship block
//     against a 293-ms bound; the first design (32 queries x one group a
//     block, synchronous scalar loads) took 751 ms (PERF.md).
//   - The count: one 128 x 128 tile a block; the epilogue reduces its
//     compares per row over the 4 lanes and then the 2 warps that share the
//     row, then adds one atomic per row and block (none where the block
//     counted 0).  The blocks run the (query tile, item tile) pairs in the
//     same grouped order, with item tiles in place of groups.
// Both take 16-byte copies where queries, items and d * 4 are 16-byte
// aligned and 4-byte copies otherwise (fp32_dist_tile::copy_width).
// Ragged edges of Q, n and d are masked in the kernels; offsets are 64-bit.
// No wgmma, TMA or tensor cores: products are exact fp32 FMA.

#include <cstdint>
#include <cuda_runtime.h>

#include "fp32_dist_tile.cuh"

namespace {

constexpr int G = 1024;            // items per group (the TPU kernel's tile_i)
constexpr int MAX_M = 32;
constexpr long long MAX_GRID_X = 2147483647;  // blocks per launch
constexpr int TILE_GROUP = 8;   // query tiles the blocks of either kernel walk together

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// -((||q||^2 - 2 q.x) + ||x||^2), rounded exactly as the plain version
// rounds it (2 q.x is exact, so the FMA equals the separate subtract); the
// explicit intrinsics keep the compiler from contracting it differently in
// the two kernels.
__device__ __forceinline__ float neg_d2(float dot, float qn, float xn) {
  return -__fadd_rn(__fmaf_rn(-2.0f, dot, qn), xn);
}

// Block b of a grouped walk over (query tile, column tile) pairs: `group`
// query tiles at a time, the column tiles inside.
__device__ __forceinline__ void grouped_tile(int64_t b, int64_t n_qt, int64_t n_ct, int group,
                                             int64_t& qt, int64_t& ct) {
  const int64_t run = b / (group * n_ct);
  const int64_t first_qt = run * group;
  const int64_t gq = n_qt - first_qt < group ? n_qt - first_qt : group;
  const int64_t within = b - run * group * n_ct;
  qt = first_qt + within % gq;
  ct = within / gq;
}

namespace tile = fp32_dist_tile;

constexpr int GROUP_TILES = G / tile::BN;       // item tiles a group
constexpr int HALF = tile::BN / tile::WARPS_N;  // columns of one warp column: half a tile
constexpr int HALF_LD = HALF + 4;               // padded row: conflict-free float4 stores and loads
constexpr int HALF_FLOATS = tile::BM * HALF_LD;
static_assert(G % tile::BN == 0, "a group is whole tiles");
static_assert(tile::THREADS == tile::BM, "one list owner a query row");

// The pool kernel's dynamic shared memory at m: the half tile, then the
// lists' values and positions.
constexpr int pool_smem_bytes(int m) { return 4 * HALF_FLOATS + 8 * tile::BM * m; }

// The pool's epilogue: each row's running top m of the group, in shared
// memory, owned by thread r = the row's index in the block.
struct TopM {
  const float* inorm;
  const float* qnorm;
  float* part;  // [BM][HALF_LD]: -d2 of the 64 columns of one warp column
  float* lv;    // [m][BM]: list values, best first
  int32_t* lp;  // [m][BM]: list positions
  int64_t n, nq, q0, i0;
  int m;
  int cnt;    // entries in this thread's row list
  float thr;  // what a candidate must beat: -inf until the list is full, then its m-th value

  // v enters the row's list if it beats thr; equal values keep the earlier
  // (lower) position first
  __device__ __forceinline__ void offer(float v, int32_t p) {
    if (!(v > thr)) return;
    const int r = threadIdx.x;
    int s = cnt < m ? cnt++ : m - 1;
    for (; s > 0; --s) {
      const float u = lv[(s - 1) * tile::BM + r];
      if (!(u < v)) break;
      lv[s * tile::BM + r] = u;
      lp[s * tile::BM + r] = lp[(s - 1) * tile::BM + r];
    }
    lv[s * tile::BM + r] = v;
    lp[s * tile::BM + r] = p;
    if (cnt == m) thr = lv[(m - 1) * tile::BM + r];
  }

  __device__ __forceinline__ void operator()(const float (&acc)[tile::TM][tile::TN], int t) {
    const int64_t c0 = i0 + static_cast<int64_t>(t) * tile::BN;
    float qn[tile::TM], xn[tile::TN];
    bool ok[tile::TN];
#pragma unroll
    for (int i = 0; i < tile::TM; ++i) {
      const int64_t r = q0 + tile::row_of(i);
      qn[i] = r < nq ? __ldg(qnorm + r) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < tile::TN; ++j) {
      const int64_t c = c0 + tile::col_of(j);
      ok[j] = c < n;
      xn[j] = ok[j] ? __ldg(inorm + c) : 0.0f;
    }
    const bool owner = q0 + threadIdx.x < nq;
    const float* row = part + threadIdx.x * HALF_LD;
#pragma unroll
    for (int h = 0; h < tile::WARPS_N; ++h) {
      // warp column h stages its 64 columns ...
      if (tile::warp_n() == h) {
#pragma unroll
        for (int i = 0; i < tile::TM; ++i)
#pragma unroll
          for (int g = 0; g < tile::NG; ++g) {
            float e[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int j = 4 * g + q;
              e[q] = ok[j] ? neg_d2(acc[i][j], qn[i], xn[j]) : neg_inf();
            }
            *reinterpret_cast<float4*>(part + tile::row_of(i) * HALF_LD + tile::lane_n() * 4 + 16 * g) =
                make_float4(e[0], e[1], e[2], e[3]);
          }
      }
      __syncthreads();
      // ... and each row's owner offers them in ascending position
      if (owner) {
        const int32_t p0 = static_cast<int32_t>(c0 + h * HALF);
        for (int c = 0; c < HALF; c += 4) {
          const float4 v = *reinterpret_cast<const float4*>(row + c);
          if (v.x > thr || v.y > thr || v.z > thr || v.w > thr) {
            offer(v.x, p0 + c);
            offer(v.y, p0 + c + 1);
            offer(v.z, p0 + c + 2);
            offer(v.w, p0 + c + 3);
          }
        }
      }
      // the next half overwrites the stage; the next tile's stores come
      // after the main loop's barriers
      if (h + 1 < tile::WARPS_N) __syncthreads();
    }
  }

  // the row's m slots: the list, then (-inf, the group's first position)
  __device__ __forceinline__ void store(float* out_v, int32_t* out_p, int64_t ng, int64_t g) const {
    const int r = threadIdx.x;
    if (q0 + r >= nq) return;
    const int64_t base = ((q0 + r) * ng + g) * m;
    for (int s = 0; s < m; ++s) {
      out_v[base + s] = s < cnt ? lv[s * tile::BM + r] : neg_inf();
      out_p[base + s] = s < cnt ? lp[s * tile::BM + r] : static_cast<int32_t>(i0);
    }
  }
};

template <int VEC>
__global__ void __launch_bounds__(tile::THREADS, 2)
knn_topm_tile_kernel(const float* __restrict__ items, const float* __restrict__ inorm,
                     const float* __restrict__ queries, const float* __restrict__ qnorm,
                     float* __restrict__ out_v, int32_t* __restrict__ out_p,
                     int64_t n, int64_t nq, int64_t d, int64_t ng, int m, int64_t block0) {
  __shared__ __align__(16) float smem[tile::SMEM_FLOATS];
  extern __shared__ __align__(16) float lists[];
  int64_t qt, g;
  grouped_tile(block0 + blockIdx.x, (nq + tile::BM - 1) / tile::BM, ng, TILE_GROUP, qt, g);
  const int64_t q0 = qt * tile::BM, i0 = g * G;
  const int64_t left = n - i0;
  const int n_tiles = left >= G ? GROUP_TILES : static_cast<int>((left + tile::BN - 1) / tile::BN);
  float* lv = lists + HALF_FLOATS;
  TopM epi{inorm, qnorm, lists, lv, reinterpret_cast<int32_t*>(lv + tile::BM * m), n, nq, q0, i0, m, 0,
           neg_inf()};
  tile::run<VEC>(queries, nq, q0, items, n, i0, n_tiles, d, smem, epi);
  epi.store(out_v, out_p, ng, g);  // each thread reads only its own row's list
}

// The count's epilogue: per query row, the items of the tile whose -d2
// beats thresh[q], summed into the block's row counts in shared memory.
struct CountAbove {
  const float* inorm;
  const float* qnorm;
  const float* thresh;
  int* counts;  // [BM], in shared memory
  int64_t n, nq, q0, i0;

  __device__ __forceinline__ void operator()(const float (&acc)[tile::TM][tile::TN], int) {
    float xn[tile::TN];
    bool ok[tile::TN];
#pragma unroll
    for (int j = 0; j < tile::TN; ++j) {
      const int64_t c = i0 + tile::col_of(j);
      ok[j] = c < n;
      xn[j] = ok[j] ? __ldg(inorm + c) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < tile::TM; ++i) {
      const int64_t r = q0 + tile::row_of(i);
      const float qn = r < nq ? __ldg(qnorm + r) : 0.0f;
      const float t = r < nq ? __ldg(thresh + r) : 0.0f;
      int c = 0;
#pragma unroll
      for (int j = 0; j < tile::TN; ++j) c += (ok[j] && neg_d2(acc[i][j], qn, xn[j]) > t) ? 1 : 0;
      // the row's 4 lanes in this warp are lanes 4 * lane_m() + 0..3
      c += __shfl_xor_sync(0xffffffffu, c, 1);
      c += __shfl_xor_sync(0xffffffffu, c, 2);
      if (tile::lane_n() == 0 && c) atomicAdd(&counts[tile::row_of(i)], c);
    }
  }
};

template <int VEC>
__global__ void __launch_bounds__(tile::THREADS, 2)
knn_count_tile_kernel(const float* __restrict__ items, const float* __restrict__ inorm,
                      const float* __restrict__ queries, const float* __restrict__ qnorm,
                      const float* __restrict__ thresh, int32_t* __restrict__ out,
                      int64_t n, int64_t nq, int64_t d, int64_t tile0) {
  __shared__ __align__(16) float smem[tile::SMEM_FLOATS];
  __shared__ int counts[tile::BM];
  const int tid = threadIdx.x;
  if (tid < tile::BM) counts[tid] = 0;  // ordered before use by run()'s barriers
  int64_t qt, it;
  grouped_tile(tile0 + blockIdx.x, (nq + tile::BM - 1) / tile::BM, (n + tile::BN - 1) / tile::BN, TILE_GROUP,
               qt, it);
  const int64_t q0 = qt * tile::BM, i0 = it * tile::BN;
  CountAbove epi{inorm, qnorm, thresh, counts, n, nq, q0, i0};
  tile::run<VEC>(queries, nq, q0, items, n, i0, 1, d, smem, epi);
  __syncthreads();
  if (tid < tile::BM && q0 + tid < nq && counts[tid]) atomicAdd(&out[q0 + tid], counts[tid]);
}

// The pool kernel for these operands, with its shared memory set up for m.
template <class Kernel>
cudaError_t pool_configure(Kernel kernel, long long m) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         pool_smem_bytes(static_cast<int>(m)));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Plain C entry points, bound with ctypes.  They launch on `stream`, do not
// synchronise, allocate nothing, and return a CUDA error code (0 on success).
// Both kernels take 16-byte copies when items, queries and d * 4 are
// 16-byte aligned, else 4-byte copies, and need d < 2^31 - 8.

// out_v, out_p: (nq, ceil(n / 1024), m); 1 <= m <= 32.
extern "C" int srml_knn_topm_f32(const void* items, const void* inorm,
                                 const void* queries, const void* qnorm,
                                 void* out_v, void* out_p, long long n, long long nq,
                                 long long d, long long m, void* stream) {
  if (m < 1 || m > MAX_M || d > 2147483647LL - tile::BK) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || nq <= 0) return 0;
  const long long ng = (n + G - 1) / G;
  const long long blocks = ((nq + tile::BM - 1) / tile::BM) * ng;
  auto kernel = tile::copy_width(items, queries, d) == 4 ? knn_topm_tile_kernel<4> : knn_topm_tile_kernel<1>;
  cudaError_t err = pool_configure(kernel, m);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = pool_smem_bytes(static_cast<int>(m));
  for (long long b0 = 0; b0 < blocks; b0 += MAX_GRID_X) {
    const long long chunk = blocks - b0 < MAX_GRID_X ? blocks - b0 : MAX_GRID_X;
    kernel<<<static_cast<unsigned int>(chunk), tile::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(items), static_cast<const float*>(inorm),
        static_cast<const float*>(queries), static_cast<const float*>(qnorm),
        static_cast<float*>(out_v), static_cast<int32_t*>(out_p), n, nq, d, ng, static_cast<int>(m), b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The pool kernel's resident blocks an SM at m, for copy width `vec` (4 or
// 1), into *blocks, and its dynamic shared memory bytes into *smem_bytes.
extern "C" int srml_knn_topm_occupancy(long long m, int vec, int* blocks, int* smem_bytes) {
  if (m < 1 || m > MAX_M) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = vec == 4 ? knn_topm_tile_kernel<4> : knn_topm_tile_kernel<1>;
  cudaError_t err = pool_configure(kernel, m);
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = pool_smem_bytes(static_cast<int>(m));
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, tile::THREADS, *smem_bytes));
}

// `out` must hold zeros: blocks add their counts into it.
extern "C" int srml_knn_count_f32(const void* items, const void* inorm,
                                  const void* queries, const void* qnorm,
                                  const void* thresh, void* out, long long n,
                                  long long nq, long long d, void* stream) {
  if (d > 2147483647LL - tile::BK) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || nq <= 0) return 0;
  const long long tiles = ((nq + tile::BM - 1) / tile::BM) * ((n + tile::BN - 1) / tile::BN);
  auto kernel = tile::copy_width(items, queries, d) == 4 ? knn_count_tile_kernel<4> : knn_count_tile_kernel<1>;
  for (long long t0 = 0; t0 < tiles; t0 += MAX_GRID_X) {
    const long long blocks = tiles - t0 < MAX_GRID_X ? tiles - t0 : MAX_GRID_X;
    kernel<<<static_cast<unsigned int>(blocks), tile::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(items), static_cast<const float*>(inorm),
        static_cast<const float*>(queries), static_cast<const float*>(qnorm),
        static_cast<const float*>(thresh), static_cast<int32_t*>(out), n, nq, d, t0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
