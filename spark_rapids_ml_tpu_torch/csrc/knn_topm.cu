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
// the lowest such column of its group (the TPU kernel's first-occurrence
// argmax over a masked tile).
//
// What bounds it on the card: 2*Q*n*d fp32 operations against 4*(Q + n)*d
// bytes of input; at the kNN flagship (Q = 8192 per block, n = 400,000,
// d = 3000) far above the fp32 ridge (~20 operations per byte), so it is
// bound by fp32 FMAs on the CUDA cores.  Products are exact fp32 FMA, no
// TF32 (the TPU kernel runs a 3-pass bf16 dot for the same reason: the norm
// expansion cancels near the nearest neighbours).
//
// Design, simple first:
//   - one block per (32 queries, one 1024-item group); blockIdx.x walks the
//     query tiles fastest, so the blocks in flight share one group's 12 MB of
//     items in L2; more than 65,535 groups take one launch per 65,535, each
//     with its first group g0 (the entry points loop);
//   - 512 threads each keep an 8 x 8 register micro-tile of dot products,
//     staged through shared memory in slices of BK = 16 features (the tiled
//     FMA loop of csrc/min_dist_argmin.cu);
//   - the (32 x 1024) tile of -d2 then goes to shared memory (aliasing the
//     staging buffers) and each warp selects the top m of two query rows by
//     m lexicographic argmax passes: each lane keeps the best of its 32
//     columns, the warp reduces with shuffles, and only the winner's lane
//     masks its column and rescans;
//   - the count kernel does not need the 1024-item group: it runs the
//     pipelined main loop of fp32_dist_tile.cuh on 128-query x 128-item
//     tiles, one a block, two 128-thread blocks an SM.  Its -d2 is still
//     bitwise the pool's (the property the audit rests on): both loops sum
//     each dot product as one fmaf chain over d in ascending order from
//     0.0f, with zeros past the ragged edges, which gives the same bits
//     whatever the tiling, and both form -d2 with neg_d2().  The count
//     reduces its compares per row over the 4 lanes and then the 2 warps
//     that share the row, then adds one atomic per row and block (none
//     where the block counted 0).  The blocks run the (query tile, item
//     tile) pairs in a grouped order: COUNT_GROUP query tiles at a time,
//     the item tiles inside, so the blocks in flight share a few query
//     tiles (12 MB at d = 3000) and each item tile, in the 50-MB L2.
// Ragged edges of Q, n and d are masked in the kernels; offsets are 64-bit.
// No wgmma, TMA or tensor cores: products are exact fp32 FMA.

#include <cstdint>
#include <cuda_runtime.h>

#include "fp32_dist_tile.cuh"

namespace {

constexpr int TQ = 32;             // queries per block
constexpr int G = 1024;            // items per group (the TPU kernel's tile_i)
constexpr int BK = 16;             // features per shared-memory slice
constexpr int TM = 8, TN = 8;      // micro-tile: 8 queries x 8 items a thread
constexpr int TY = TQ / TM;        // 4 thread rows
constexpr int TX = G / TN;         // 128 thread columns
constexpr int THREADS = TY * TX;   // 512
constexpr int IS_LD = G + 2;       // padded leading dims: conflict-free stores
constexpr int QS_LD = TQ + 2;
constexpr int STAGE_FLOATS = BK * IS_LD + BK * QS_LD;
constexpr int D2_FLOATS = TQ * G;
constexpr int TOPM_SMEM_BYTES =
    4 * (D2_FLOATS > STAGE_FLOATS ? D2_FLOATS : STAGE_FLOATS);
constexpr int MAX_M = 32;
constexpr long long MAX_GRID_Y = 65535;  // groups per launch
constexpr long long MAX_GRID_X = 2147483647;  // count tiles per launch
constexpr int COUNT_GROUP = 8;  // query tiles the count's blocks walk together
static_assert(TQ * BK == THREADS, "one query element per thread and slice");
static_assert(G * BK % THREADS == 0, "item slice splits evenly");

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Dot products of one (TQ x G) tile: acc[i][j] = q_r . x_c for query row
// r = q0 + ty + TY*i and item c = i0 + tx + TX*j, each one fp32 FMA chain
// over d in increasing order.  Out-of-range rows, items and features read
// as 0.  Ends with __syncthreads(): the caller may reuse smem.
__device__ __forceinline__ void dot_tile(const float* __restrict__ items,
                                         const float* __restrict__ queries,
                                         int64_t n, int64_t nq, int64_t d,
                                         int64_t i0, int64_t q0, float* smem,
                                         float (&acc)[TM][TN]) {
  float* Is = smem;
  float* Qs = smem + BK * IS_LD;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  // Loads: thread tid reads feature lc = tid % BK of rows lr = tid / BK +
  // ROW_STEP * l, so one base pointer and one stride serve all of them (32
  // separate 64-bit addresses would not fit the register budget).
  constexpr int ROW_STEP = THREADS / BK;  // 32
  const int lr = tid / BK;
  const int lc = tid % BK;
  const int64_t rows_left = n - i0 - lr;  // loads with ROW_STEP * l < rows_left are in range
  const bool q_ok = q0 + lr < nq;
  const float* item_src = items + (i0 + lr) * d + lc;
  const float* query_src = queries + (q0 + lr) * d + lc;
  const int64_t item_step = static_cast<int64_t>(ROW_STEP) * d;
  float* is_dst = Is + lc * IS_LD + lr;
  float* qs_dst = Qs + lc * QS_LD + lr;

  for (int64_t k0 = 0; k0 < d; k0 += BK) {
    const bool c_ok = k0 + lc < d;
    const float* src = item_src + k0;
#pragma unroll
    for (int l = 0; l < G / ROW_STEP; ++l, src += item_step)
      is_dst[ROW_STEP * l] = (c_ok && ROW_STEP * l < rows_left) ? *src : 0.0f;
    *qs_dst = (c_ok && q_ok) ? query_src[k0] : 0.0f;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = Qs[kk * QS_LD + ty + TY * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Is[kk * IS_LD + tx + TX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// -((||q||^2 - 2 q.x) + ||x||^2), rounded exactly as the plain version
// rounds it (2 q.x is exact, so the FMA equals the separate subtract); the
// explicit intrinsics keep the compiler from contracting it differently in
// the two kernels.
__device__ __forceinline__ float neg_d2(float dot, float qn, float xn) {
  return -__fadd_rn(__fmaf_rn(-2.0f, dot, qn), xn);
}

// The best (value, column) of the columns lane, lane + 32, ... of one row:
// the first column on ties.
__device__ __forceinline__ void lane_best(const float* row, int lane, float& bv, int& bc) {
  bv = row[lane];
  bc = lane;
#pragma unroll 4
  for (int c = lane + 32; c < G; c += 32) {
    const float x = row[c];
    if (x > bv) {
      bv = x;
      bc = c;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
knn_topm_kernel(const float* __restrict__ items, const float* __restrict__ inorm,
                const float* __restrict__ queries, const float* __restrict__ qnorm,
                float* __restrict__ out_v, int32_t* __restrict__ out_p,
                int64_t n, int64_t nq, int64_t d, int64_t ng, int64_t g0, int m) {
  extern __shared__ float smem[];
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * TQ;
  const int64_t g = g0 + blockIdx.y;
  const int64_t i0 = g * G;
  float acc[TM][TN];
  dot_tile(items, queries, n, nq, d, i0, q0, smem, acc);

  // the group's -d2 tile into shared memory (the staging buffers are dead)
  float* D2 = smem;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  float qn[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t r = q0 + ty + TY * i;
    qn[i] = r < nq ? qnorm[r] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = tx + TX * j;
    const bool ok = i0 + col < n;
    const float xn = ok ? inorm[i0 + col] : 0.0f;
#pragma unroll
    for (int i = 0; i < TM; ++i)
      D2[(ty + TY * i) * G + col] = ok ? neg_d2(acc[i][j], qn[i], xn) : neg_inf();
  }
  __syncthreads();

  // m lexicographic argmax passes per row; warp w takes rows w, w + 16
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int r = warp; r < TQ; r += THREADS / 32) {
    const int64_t row = q0 + r;
    if (row >= nq) break;  // rows rise with r; the test is warp-uniform
    float* v = D2 + r * G;
    float bv;
    int bc;
    lane_best(v, lane, bv, bc);
    const int64_t base = (row * ng + g) * m;
    for (int s = 0; s < m; ++s) {
      float wv = bv;
      int wc = bc;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        const float ov = __shfl_xor_sync(0xffffffffu, wv, off);
        const int oc = __shfl_xor_sync(0xffffffffu, wc, off);
        if (ov > wv || (ov == wv && oc < wc)) {
          wv = ov;
          wc = oc;
        }
      }
      if (lane == 0) {
        out_v[base + s] = wv;
        out_p[base + s] = static_cast<int32_t>(i0 + wc);
      }
      if ((wc & 31) == lane) {
        v[wc] = neg_inf();
        lane_best(v, lane, bv, bc);
      }
      __syncwarp();
    }
  }
}

namespace tile = fp32_dist_tile;

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

  // grouped order: COUNT_GROUP query tiles at a time, item tiles inside
  const int64_t n_qt = (nq + tile::BM - 1) / tile::BM;
  const int64_t n_it = (n + tile::BN - 1) / tile::BN;
  const int64_t tt = tile0 + blockIdx.x;
  const int64_t group = tt / (COUNT_GROUP * n_it);
  const int64_t first_qt = group * COUNT_GROUP;
  const int64_t gq = n_qt - first_qt < COUNT_GROUP ? n_qt - first_qt : COUNT_GROUP;
  const int64_t within = tt - group * COUNT_GROUP * n_it;
  const int64_t q0 = (first_qt + within % gq) * tile::BM;
  const int64_t i0 = (within / gq) * tile::BN;

  CountAbove epi{inorm, qnorm, thresh, counts, n, nq, q0, i0};
  tile::run<VEC>(queries, nq, q0, items, n, i0, 1, d, smem, epi);
  __syncthreads();
  if (tid < tile::BM && q0 + tid < nq && counts[tid]) atomicAdd(&out[q0 + tid], counts[tid]);
}

}  // namespace

// Plain C entry points, bound with ctypes.  They launch on `stream`, do not
// synchronise, allocate nothing, and return a CUDA error code (0 on success).
// The caller has checked shapes: 1 <= m <= 32, ceil(nq / 32) < 2^31.
extern "C" int srml_knn_topm_f32(const void* items, const void* inorm,
                                 const void* queries, const void* qnorm,
                                 void* out_v, void* out_p, long long n, long long nq,
                                 long long d, long long m, void* stream) {
  if (m < 1 || m > MAX_M) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || nq <= 0) return 0;
  const long long ng = (n + G - 1) / G;
  cudaError_t err = cudaFuncSetAttribute(
      knn_topm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TOPM_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (long long g0 = 0; g0 < ng; g0 += MAX_GRID_Y) {
    const long long groups = ng - g0 < MAX_GRID_Y ? ng - g0 : MAX_GRID_Y;
    const dim3 grid(static_cast<unsigned int>((nq + TQ - 1) / TQ), static_cast<unsigned int>(groups));
    knn_topm_kernel<<<grid, THREADS, TOPM_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(items), static_cast<const float*>(inorm),
        static_cast<const float*>(queries), static_cast<const float*>(qnorm),
        static_cast<float*>(out_v), static_cast<int32_t*>(out_p), n, nq, d, ng, g0,
        static_cast<int>(m));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// `out` must hold zeros: blocks add their counts into it.  16-byte copies
// when items, queries and d * 4 are 16-byte aligned, else 4-byte copies.
// d < 2^31 - 8.
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
