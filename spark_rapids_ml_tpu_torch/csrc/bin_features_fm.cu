// Feature-major quantile binning for Hopper (sm_90a):
//
//     out[f, r] = #{ e : edges[f, e] < X[r, f] }   for r < n
//     out[f, r] = 0                                for n <= r < n_pad
//
// as int8 (at most 127 edges).  Replaces the TPU kernel
// spark_rapids_ml_tpu/ops/pallas_tpu.py::_bin_kernel (wrapper
// bin_features_fm_pallas), which counts the edges with x > edge in a
// compare loop over all edges.
//
// What bounds it on the card: memory.  Each X element is read once (4 bytes)
// and each bin written once (1 byte); at the RandomForest flagship shape
// (1,000,000 x 3000, 127 edges) that is 12 GB + 3 GB, ~4.5 ms at 3.35 TB/s.
// A compare loop over 127 edges would issue ~3.8e11 compares, more than the
// memory time, so the count is a binary search (7 steps).  The search gives
// the compare loop's count when the predicate "edge < x" is true on a prefix
// of the edges and false after it: edges non-decreasing, with NaN edges (if
// any) only at the end.  The wrapper checks that.  A NaN x fails every
// "edge < x", so it gets bin 0, as in the compare loop.
//
// Design: keep enough loads in flight, and keep the search off the
// shared-memory banks' conflicts.
//   - a block owns a strip of TD = 32 features and walks row tiles of TR =
//     128 rows (the grid is about one wave: the SMs times the blocks an SM
//     holds, over the strips).  It stages its strip's edges once, as an
//     Eytzinger tree of 127 nodes a feature (node n's children at 2n + 1
//     and 2n + 2), the missing edges +inf: "inf < x" is false for every x,
//     so the padding leaves every count unchanged.  The staging maps a
//     node to its sorted position with shifts, no divide;
//   - X is copied into shared memory with cp.async, STAGES - 1 tiles ahead
//     of the search, 4 bytes a copy: a warp copies one row's 32 features
//     (128 contiguous bytes) and writes them transposed, [feature][row ^
//     (feature >> 3)] at a row stride of TR + 4 floats: 32 distinct banks,
//     and the XOR only permutes the 4 rows of an aligned 16-byte word.
//     4-byte copies need no alignment, so every d and every row offset
//     takes the same path;
//   - a warp bins one feature at a time, each lane 4 consecutive rows (one
//     conflict-free 16-byte read of the transposed tile).  All lanes walk
//     the same tree: levels 0-1 come from registers, levels 2-5 (at most 32
//     nodes, on distinct banks) read shared memory without conflicts and
//     level 6 (64 nodes) with at most 2-way conflicts.  Seven fixed steps,
//     no divergent branch, the lane's four walks interleaved, each step one
//     compare, one select and one shift-add on the node's shared address;
//   - a lane stores its 4 bins as one 32-bit word of the feature-major
//     output (a warp writes 128 contiguous bytes of one feature), byte by
//     byte only where n_pad is not a multiple of 4;
//   - X is not padded: rows >= n and features >= d are masked here, and the
//     rows n..n_pad-1 of the output are written 0 without reading X.
// What still limits it (PERF.md): the copies alone take ~5.4 ms at the
// flagship shape and the search alone ~6 ms; they overlap only in part.
// Offsets are 64-bit: the flagship X has 3.0e9 elements.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TR = 128;               // rows a tile: 32 lanes x 4 rows
constexpr int TD = 32;                // features a strip
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 3;             // tiles in shared memory: STAGES - 1 in flight during a search
constexpr int ROW_STRIDE = TR + 4;    // floats a feature row of a staged tile
constexpr int NODES = 128;            // 127 tree nodes a feature, one unused
constexpr int MAX_EDGES = 127;
constexpr long long MAX_GRID_Y = 65535;
constexpr size_t SMEM_BYTES = sizeof(float) * (STAGES * TD * ROW_STRIDE + TD * NODES);

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One tile's copies: rows r0 .. r0 + TR - 1 of the strip's features into
// tile[feature][row ^ (feature >> 3)]; rows >= n and features >= d are not
// read.  A warp copies one row's 32 features at a time (128 contiguous
// bytes); the row index XOR puts the 32 writes on 32 distinct banks and
// only permutes the 4 rows of an aligned 16-byte word.
__device__ __forceinline__ void copy_tile(float* tile, const float* __restrict__ X, int64_t r0, int64_t f0,
                                          int64_t n, int64_t d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool live = f0 + lane < d;
  float* dst = tile + lane * ROW_STRIDE;
  const int flip = lane >> 3;
#pragma unroll 1  // unrolled, the copies ran slower on an H100 (PERF.md)
  for (int i = 0; i < TR / WARPS; ++i) {
    const int rl = i * WARPS + warp;
    const int64_t r = r0 + rl;
    if (live && r < n) cp_async4(dst + (rl ^ flip), X + r * d + f0 + lane);
  }
}

__device__ __forceinline__ float shared_at(uint32_t address) {
  float v;
  asm("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(address));
  return v;
}

// The counts of a feature's edges below x[0..3]: seven steps down its
// tree each, the four walks interleaved, the first two levels from
// registers (e0 the root, e1 / e2 its children).  A walk carries its
// node's shared-memory byte address A = base + 4 node, so a step is one
// compare, one select and one shift-add: the child is at 2 A + 4 - base,
// + 4 on the right.
__device__ __forceinline__ void bins_of(const float (&x)[4], int (&bin)[4], const float* tree, float e0, float e1,
                                        float e2) {
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(tree));
  const uint32_t left = 4u - base, right = 8u - base;
  uint32_t at[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool c0 = e0 < x[j];
    const bool c1 = (c0 ? e2 : e1) < x[j];
    at[j] = base + 4u * (3u + 2u * c0 + c1);
  }
#pragma unroll
  for (int s = 0; s < 5; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) at[j] = 2u * at[j] + (shared_at(at[j]) < x[j] ? right : left);
#pragma unroll
  for (int j = 0; j < 4; ++j) bin[j] = static_cast<int>((at[j] - base) >> 2) - (NODES - 1);  // leaf - 127
}

__global__ void __launch_bounds__(THREADS)
bin_features_fm_kernel(const float* __restrict__ X, const float* __restrict__ edges,
                       int8_t* __restrict__ out, int64_t n, int64_t d, int64_t n_pad,
                       int n_edges, int64_t strip0) {
  extern __shared__ float smem[];
  float* tiles = smem;                               // [STAGES][TD][ROW_STRIDE]
  float* trees = smem + STAGES * TD * ROW_STRIDE;    // [TD][NODES]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t f0 = (strip0 + blockIdx.y) * TD;
  const int64_t ntiles = (n_pad + TR - 1) / TR;
  const int64_t mine = blockIdx.x < ntiles ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const auto tile_row = [&](int64_t k) { return (static_cast<int64_t>(blockIdx.x) + k * gridDim.x) * TR; };

  // the first STAGES - 1 tiles in flight while the trees are staged
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < mine) copy_tile(tiles + s * TD * ROW_STRIDE, X, tile_row(s), f0, n, d);
    cp_async_commit();
  }
  for (int i = threadIdx.x; i < TD * NODES; i += THREADS) {
    const int fl = i / NODES, node = i % NODES;  // powers of two: shifts
    float e = __int_as_float(0x7f800000);
    if (node < NODES - 1 && f0 + fl < d) {
      const int level = 31 - __clz(node + 1);
      const int sorted = ((2 * (node + 1 - (1 << level)) + 1) << (6 - level)) - 1;
      if (sorted < n_edges) e = edges[(f0 + fl) * n_edges + sorted];
    }
    trees[i] = e;
  }
  __syncthreads();
  // this warp's features: warp, warp + 8, warp + 16, warp + 24
  float e0[TD / WARPS], e1[TD / WARPS], e2[TD / WARPS];
#pragma unroll
  for (int i = 0; i < TD / WARPS; ++i) {
    const float* tree = trees + (warp + i * WARPS) * NODES;
    e0[i] = tree[0];
    e1[i] = tree[1];
    e2[i] = tree[2];
  }
  const bool words = n_pad % 4 == 0;

  for (int64_t k = 0; k < mine; ++k) {
    if (k + STAGES - 1 < mine)
      copy_tile(tiles + ((k + STAGES - 1) % STAGES) * TD * ROW_STRIDE, X, tile_row(k + STAGES - 1), f0, n, d);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const float* tile = tiles + (k % STAGES) * TD * ROW_STRIDE;
    const int64_t r = tile_row(k) + 4 * lane;  // this lane's first row
#pragma unroll
    for (int i = 0; i < TD / WARPS; ++i) {
      const int fl = warp + i * WARPS;
      if (f0 + fl >= d) break;  // uniform over the warp
      // rows 4 lane .. 4 lane + 3, stored at row ^ i (fl >> 3 == i)
      const float4 v = *reinterpret_cast<const float4*>(tile + fl * ROW_STRIDE + 4 * lane);
      const float w[4] = {v.x, v.y, v.z, v.w};
      const float x[4] = {w[0 ^ i], w[1 ^ i], w[2 ^ i], w[3 ^ i]};
      int bin[4];
      bins_of(x, bin, trees + fl * NODES, e0[i], e1[i], e2[i]);
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)  // rows >= n get 0
        word |= static_cast<uint32_t>(r + j < n ? bin[j] : 0) << (8 * j);
      int8_t* o = out + (f0 + fl) * n_pad + r;
      if (words) {
        if (r < n_pad) *reinterpret_cast<uint32_t*>(o) = word;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (r + j < n_pad) o[j] = static_cast<int8_t>(word >> (8 * j));
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();
}

}  // namespace

// Plain C entry point, bound with ctypes.  Launches on `stream`, does not
// synchronise, allocates nothing, and returns a CUDA error code (the
// launch's cudaGetLastError()).  The grid is about one wave: the row blocks
// a strip are the blocks the card holds at once over the strips.
extern "C" int srml_bin_features_fm(const void* X, const void* edges, void* out,
                                    long long n, long long d, long long n_pad,
                                    int n_edges, void* stream) {
  if (n < 0 || d < 0 || n_pad < n || n_edges < 0 || n_edges > MAX_EDGES)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pad == 0 || d == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(bin_features_fm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_BYTES));
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bin_features_fm_kernel, THREADS, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long strips = (d + TD - 1) / TD;
  const long long ntiles = (n_pad + TR - 1) / TR;
  long long gx = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1) / strips;
  gx = gx < 1 ? 1 : (gx > ntiles ? ntiles : gx);
  for (long long s0 = 0; s0 < strips; s0 += MAX_GRID_Y) {
    const dim3 grid(static_cast<unsigned int>(gx),
                    static_cast<unsigned int>(strips - s0 < MAX_GRID_Y ? strips - s0 : MAX_GRID_Y));
    bin_features_fm_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(X), static_cast<const float*>(edges), static_cast<int8_t*>(out), n, d, n_pad,
        n_edges, s0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
