// Random-forest node histograms for Hopper (sm_90a):
//
//     H[f, slot, b] = sum_r bf16(stat[t*S + s, r]) * [node[t, r] == c] * [bin[f, r] == b]
//     slot = (t * nodes + c) * S + s,  summed in fp32
//
// Two kernels, three entry points:
//   srml_node_histograms_mma       replaces spark_rapids_ml_tpu/ops/forest_hist.py::_hist_kernel
//                                  (wrapper node_histograms_mma) at the shallow levels:
//                                  the one-hot product on the tensor cores, output
//                                  (F_pad, 128, B)
//   srml_node_histograms           the same function with shared-memory atomics
//                                  (wrapper node_histograms_atomic), for the levels
//                                  where the product's work, which grows with the
//                                  nodes, costs more than one add per term
//   srml_node_histograms_bucketed  replaces ::_hist_kernel_bucketed (wrapper
//                                  node_histograms_bucketed): the atomic kernel per
//                                  contiguous bucket of `cap` rows, one tree, bucket-
//                                  local node ids, output (n_buckets, F_pad, slots_pad, B)
// Rows whose node id is outside [0, nodes) and bins outside [0, B) add
// nothing, as in the one-hot formulation of the TPU kernels.
//
// Rounding: the TPU kernels feed the stat operand to the matrix unit in
// bf16 and accumulate in fp32.  Each stat is rounded the same way here
// (__float2bfloat16_rn), so integer stats (bootstrap counts x one-hot
// classes) give the same exact sums on both routes, and float stats
// (regression w*y) differ only by the order of the fp32 additions.
//
// The tensor-core route (hist_mask_stats_kernel, hist_mma_kernel,
// hist_split_sum_kernel) computes the transpose of H as a product with
// M = (feature, bin), N = slots (rounded up to 16), K = rows:
//   - A, the one-hot of the int8 bins, is built in registers and never
//     stored: for each 16-row k-step a thread loads the bins of its four
//     fragment rows of its warp's feature from shared memory, compares them
//     bytewise with its two bin indices (__vcmpeq4) and spreads the matches
//     into bf16 1.0s (__byte_perm); that one A fragment feeds one
//     mma.sync.m16n8k16 bf16 per 8-slot n-tile, up to 16.  The n-tile
//     count is a template parameter: with it a run-time count, each
//     ldmatrix -> mma pair sat in its own branch and waited out the
//     ldmatrix latency (21.4 ms at the classifier's level 0, 8% of the
//     bf16 peak).
//   - B, the masked stats [node[t,r] == c] ? bf16(stat[t*S+s, r]) : 0, is
//     built once per launch by hist_mask_stats_kernel as (row tile, slot,
//     128 rows) bf16.  Building it inside each block instead would repeat
//     the masking for every feature group (64 to 1024 times a launch), about
//     two instructions per mma, and read the node ids and fp32 stats (600
//     bytes a row at the classifier's level 0) where the built tile is 208.
//     hist_mma_kernel brings each 128-row tile of B and of the bins into
//     shared memory with cp.async, double-buffered, and every warp reads B
//     with ldmatrix (slot rows skewed by 16 bytes: no bank conflicts).
//   - A block is 8 warps over a few features x all bins; a warp owns one
//     16-bin m-tile x all n-tiles.  The mma accumulates one row tile (8
//     k-steps) from zero; its sum is then added to fp32 totals in registers
//     with ordinary FADDs.  The tensor cores' own accumulation truncates,
//     and over a million rows that bias grows past 1e-4 relative; over 128
//     rows it does not.
//   - Rows are split across blocks when the feature groups alone do not
//     fill the card.  Each split writes its own fp32 partial histogram and
//     hist_split_sum_kernel adds the partials in split order: no atomics,
//     the same bits on every run, float stats included.
// What bounds it: the tensor cores (slots_pad * bins_pad MACs per row and
// feature, ~1.7e12 FLOP at the classifier's level 0) and, beside them,
// shared-memory reads of B (each warp reads the whole tile).
//
// The atomic route (hist_kernel): one shared-memory fp32 atomic add per
// (row, feature, tree) with a non-zero stat, which the compiler emits as a
// compare-and-swap loop (cuobjdump -sass of this library for sm_90a: seven
// ATOMS.CAST.SPIN retried in a loop, no native shared fp32 add); its work
// grows with the trees packed, not with the nodes, so it wins at the deep
// end of the shallow phase:
//   - a block owns FB features (as many (slots x B) fp32 histograms as fit
//     96 KB of shared memory, so two blocks share an SM) and a range of rows
//     of one bucket (the geometry: ops/forest_hist._atomic_geometry);
//   - each thread walks rows and adds each non-zero bf16-rounded stat into
//     its (slot, bin) cell with a shared-memory atomic (adding 0 changes no
//     fp32 sum, so zero stats are skipped).  Where the rows allow it (the
//     main path's always do), a thread takes 4 consecutive rows at a time:
//     one 16-byte load of their node ids, one of each stat, one 4-byte load
//     of each feature's bins, all issued before the quad's atomics.  At two
//     256-thread blocks an SM a thread that waits on each row's loads in
//     turn leaves the kernel bound by load latency (2.1-2.3x slower at the
//     shallow levels, PERF.md);
//   - integer stats: a caller that knows every stat is an integer (a
//     classifier fit without weightCol: bootstrap counts x one-hot
//     classes) says so, and the histograms are int32 cells added with the
//     native shared integer atomic, converted to fp32 at the flush: the
//     same sums, bit for bit, while a cell stays below 2^24.  An fp32 add
//     retries its compare-and-swap once for each lane of the warp that hits
//     the same cell, and the fit's padded features (bin 0 on every row) and
//     its deep levels' few nodes make such lanes common;
//   - the flush: where the (feature group, bucket) blocks fill the card
//     alone (B4 at the deep levels: one split), each block owns its output
//     slice and writes every cell of it, zeros and padded slots included,
//     with coalesced 16-byte stores: no global atomics, and nothing for the
//     wrapper to zero.  Where they do not (B3's atomic route, small B4
//     launches), several blocks share one bucket's rows, the C entry zeroes
//     the output, and each block adds its non-zero cells with global
//     atomics.  The caller's geometry (ops/forest_hist._atomic_geometry)
//     cuts a launch by features before rows: in the classifier flagship's
//     fit 5 of the 56 B4 launches a level split rows (PERF.md).
// The wrapper picks the route per launch from the shape alone
// (ops/forest_hist._hist_route: the tensor cores while slots_pad x bins_pad
// <= 512 useful adds per row and feature, i.e. up to 4 nodes a tree at
// 2 stats and 128 bins).  Measured on an H100 (chip_smoke.py,
// kernels_forest; ms per launch, tensor cores / atomics reading rows 4 at
// a time): classifier (F_pad 64) levels 0-6: 8.0 / 24.0, 8.8 / 15.4,
// 8.9 / 8.0, 8.9 / 4.3, 8.8 / 2.1, 8.8 / 1.1, 8.6 / 0.63; regressor
// (F_pad 1024) levels 0-5: 78 / 170, 122 / 230, 122 / 126, 122 / 63,
// 122 / 32, 122 / 17.  (The atomic kernel reading one row at a time took
// 54.4, 34.5, 17.4, 8.9, 4.5, 2.5 and 1.3 ms at the classifier's levels.)
// Offsets are 64-bit.

#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_LIMIT = 227 * 1024;  // shared memory a block can have

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One term into a shared histogram cell.  INT: the caller declared every
// stat an integer, so the cells hold int32 sums added with the native
// shared integer atomic; an fp32 add is a compare-and-swap loop that
// retries once for each lane of the warp that hits the same cell (the
// padded features' bin 0 takes every row).  Integer sums below 2^24 give
// the fp32 sums' bits.
template <bool INT>
__device__ __forceinline__ void add_term(float* h, int i, float v) {
  if (INT)
    atomicAdd(reinterpret_cast<int*>(h) + i, __float2int_rn(v));
  else
    atomicAdd(h + i, v);
}

template <bool INT>
__device__ __forceinline__ float cell(const float* h, int i) {
  return INT ? __int2float_rn(reinterpret_cast<const int*>(h)[i]) : h[i];
}

// Adds row r's terms: for every tree t with node c in range and every
// non-zero bf16-rounded stat, one shared atomic per feature with a bin in
// range.
template <bool INT>
__device__ __forceinline__ void add_row(float* h, const int8_t* __restrict__ bins,
                                        const int32_t* __restrict__ node,
                                        const float* __restrict__ stats, int64_t ld, int64_t r,
                                        int f0, int nf, int t_pack, int nodes, int s_dim, int n_bins,
                                        int cells) {
  for (int t = 0; t < t_pack; ++t) {
    const int c = node[t * ld + r];
    if (static_cast<unsigned>(c) >= static_cast<unsigned>(nodes)) continue;
    for (int s = 0; s < s_dim; ++s) {
      const float v = round_bf16(stats[static_cast<int64_t>(t * s_dim + s) * ld + r]);
      if (v == 0.0f) continue;
      const int slot = (t * nodes + c) * s_dim + s;
      for (int fl = 0; fl < nf; ++fl) {
        const int b = bins[static_cast<int64_t>(f0 + fl) * ld + r];
        if (static_cast<unsigned>(b) < static_cast<unsigned>(n_bins))
          add_term<INT>(h, fl * cells + slot * n_bins + b, v);
      }
    }
  }
}

// The same for the 4 rows r .. r+3 (r % 4 == 0, ld % 4 == 0, node and
// stats 16-byte and bins 4-byte aligned): every load of a (tree, stat) is
// one 16- or 4-byte load issued before any of the quad's atomics, so a
// thread keeps several loads in flight where add_row waits on each in turn.
template <bool INT>
__device__ __forceinline__ void add_quad(float* h, const int8_t* __restrict__ bins,
                                         const int32_t* __restrict__ node,
                                         const float* __restrict__ stats, int64_t ld, int64_t r,
                                         int f0, int nf, int t_pack, int nodes, int s_dim, int n_bins,
                                         int cells) {
  for (int t = 0; t < t_pack; ++t) {
    const int4 c4 = __ldg(reinterpret_cast<const int4*>(node + t * ld + r));
    const int c[4] = {c4.x, c4.y, c4.z, c4.w};
    for (int s = 0; s < s_dim; ++s) {
      const float4 v4 = __ldg(reinterpret_cast<const float4*>(stats + static_cast<int64_t>(t * s_dim + s) * ld + r));
      const float v[4] = {round_bf16(v4.x), round_bf16(v4.y), round_bf16(v4.z), round_bf16(v4.w)};
      int slot[4];
      bool ok[4], any = false;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ok[q] = static_cast<unsigned>(c[q]) < static_cast<unsigned>(nodes) && v[q] != 0.0f;
        slot[q] = ok[q] ? ((t * nodes + c[q]) * s_dim + s) * n_bins : 0;
        any |= ok[q];
      }
      if (!any) continue;
      for (int fl0 = 0; fl0 < nf; fl0 += 4) {
        unsigned w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          w[k] = fl0 + k < nf ? __ldg(reinterpret_cast<const unsigned*>(bins + static_cast<int64_t>(f0 + fl0 + k) * ld + r))
                              : 0xffffffffu;
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int b = static_cast<int8_t>(w[k] >> (8 * q));
            if (ok[q] && static_cast<unsigned>(b) < static_cast<unsigned>(n_bins))
              add_term<INT>(h, (fl0 + k) * cells + slot[q] + b, v[q]);
          }
      }
    }
  }
}

// One block: features [f0, f0 + nf) x rows [r0, r1) of the bucket at `out`,
// whose slice of those features is nf * out_slots * n_bins contiguous floats.
// quad: the rows go 4 at a time (add_quad's alignment holds and r1 - r0 is a
// multiple of 4).  owner: the block is the only one with rows of its
// (bucket, feature group) and writes every cell of its slice, zeros and
// slots past `slots` included, with 16-byte stores; otherwise it adds its
// non-zero cells into an output that holds zeros.
template <bool INT>
__global__ void __launch_bounds__(THREADS)
hist_kernel(const int8_t* __restrict__ bins, const int32_t* __restrict__ node,
            const float* __restrict__ stats, float* __restrict__ out,
            int64_t ld, int f_pad, int fb, int t_pack, int nodes, int s_dim,
            int n_bins, int out_slots, int64_t seg_len, int64_t rows_per_block, int quad, int owner) {
  extern __shared__ float h[];
  const int tid = threadIdx.x;
  const int slots = t_pack * nodes * s_dim;
  const int f0 = blockIdx.x * fb;
  const int nf = fb < f_pad - f0 ? fb : f_pad - f0;
  const int64_t base = static_cast<int64_t>(blockIdx.z) * seg_len;
  const int64_t r0 = base + static_cast<int64_t>(blockIdx.y) * rows_per_block;
  const int64_t r1 = base + seg_len < r0 + rows_per_block ? base + seg_len : r0 + rows_per_block;
  const int cells = slots * n_bins;
  const int hsize = nf * cells;

  for (int i = tid; i < hsize; i += THREADS) h[i] = 0.0f;  // the same bits as int 0
  __syncthreads();

  if (quad) {
#pragma unroll 2
    for (int64_t r = r0 + 4 * tid; r < r1; r += 4 * THREADS)
      add_quad<INT>(h, bins, node, stats, ld, r, f0, nf, t_pack, nodes, s_dim, n_bins, cells);
  } else {
    for (int64_t r = r0 + tid; r < r1; r += THREADS)
      add_row<INT>(h, bins, node, stats, ld, r, f0, nf, t_pack, nodes, s_dim, n_bins, cells);
  }
  __syncthreads();

  const int feature_stride = out_slots * n_bins;  // a multiple of 4
  float* dst = out + (static_cast<int64_t>(blockIdx.z) * f_pad + f0) * feature_stride;
  if (owner) {
    for (int fl = 0; fl < nf; ++fl) {
      float4* row = reinterpret_cast<float4*>(dst + static_cast<int64_t>(fl) * feature_stride);
      for (int i = tid; i < feature_stride / 4; i += THREADS) {
        float e[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) e[q] = 4 * i + q < cells ? cell<INT>(h, fl * cells + 4 * i + q) : 0.0f;
        row[i] = make_float4(e[0], e[1], e[2], e[3]);
      }
    }
  } else {
    for (int i = tid; i < hsize; i += THREADS) {
      const float v = cell<INT>(h, i);
      if (v != 0.0f) {
        const int fl = i / cells;
        atomicAdd(&dst[static_cast<int64_t>(fl) * feature_stride + (i - fl * cells)], v);
      }
    }
  }
}

// The geometry (fb, splits, rows_per_block) comes from the caller
// (ops/forest_hist._atomic_geometry); with one split every block owns its
// slice, with more the output is zeroed here first.
int launch(const void* bins, const void* node, const void* stats, void* out,
           long long ld, int f_pad, int t_pack, int nodes, int s_dim, int n_bins,
           long long n_buckets, long long seg_len, int out_slots, int fb, long long splits,
           long long rows_per_block, int integer_stats, void* stream) {
  const int slots = t_pack * nodes * s_dim;
  if (f_pad <= 0 || seg_len <= 0 || n_buckets <= 0 || slots <= 0 || n_bins <= 0)
    return static_cast<int>(cudaGetLastError());
  const long long smem = static_cast<long long>(fb) * slots * n_bins * sizeof(float);
  if (fb < 1 || smem > SMEM_LIMIT || slots > out_slots || out_slots * n_bins % 4 ||
      reinterpret_cast<unsigned long long>(out) % 16 || splits < 1 || splits > 65535 ||
      n_buckets > 65535 || splits * rows_per_block < seg_len || (splits - 1) * rows_per_block >= seg_len)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int owner = splits == 1;
  const int quad = ld % 4 == 0 && seg_len % 4 == 0 && rows_per_block % 4 == 0 &&
                   (reinterpret_cast<unsigned long long>(node) | reinterpret_cast<unsigned long long>(stats)) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(bins) % 4 == 0;
  cudaError_t err;
  if (!owner) {
    err = cudaMemsetAsync(out, 0, n_buckets * f_pad * out_slots * n_bins * sizeof(float), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto kernel = integer_stats ? hist_kernel<true> : hist_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>((f_pad + fb - 1) / fb), static_cast<unsigned int>(splits),
                  static_cast<unsigned int>(n_buckets));
  kernel<<<grid, THREADS, static_cast<int>(smem), st>>>(
      static_cast<const int8_t*>(bins), static_cast<const int32_t*>(node),
      static_cast<const float*>(stats), static_cast<float*>(out), ld, f_pad, fb,
      t_pack, nodes, s_dim, n_bins, out_slots, seg_len, rows_per_block, quad, owner);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The tensor-core route
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 8;
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int ROWS_TILE = 128;              // rows per tile: 8 k-steps of 16
constexpr int ROW_PITCH = ROWS_TILE + 8;    // bf16 per slot row in shared memory
constexpr int MAX_N_TILES = 16;             // 128 slots / 8
constexpr unsigned BF16_ONES = 0x3F803F80u; // two bf16 1.0s

// B: (tiles, ns, ROWS_TILE) bf16, one thread per pair of rows of one slot.
__global__ void __launch_bounds__(256)
hist_mask_stats_kernel(const int32_t* __restrict__ node, const float* __restrict__ stats,
                       __nv_bfloat162* __restrict__ bmat, int64_t n, int nodes, int s_dim,
                       int slots, int ns, int64_t pairs) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  const int64_t rest = i / (ROWS_TILE / 2);
  const int slot = static_cast<int>(rest % ns);
  const int64_t r = (rest / ns) * ROWS_TILE + 2 * (i % (ROWS_TILE / 2));
  float v0 = 0.0f, v1 = 0.0f;
  if (slot < slots) {
    const int t = slot / (nodes * s_dim);
    const int c = (slot / s_dim) % nodes;
    const int32_t* nd = node + static_cast<int64_t>(t) * n;
    const float* st = stats + static_cast<int64_t>(slot % s_dim + t * s_dim) * n;
    if (r < n && nd[r] == c) v0 = st[r];
    if (r + 1 < n && nd[r + 1] == c) v1 = st[r + 1];
  }
  bmat[i] = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes past `src_bytes` are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// d = a * b + c, m16n8k16, bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1, float c0, float c1, float c2, float c3) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c0), "f"(c1), "f"(c2), "f"(c3));
}

__device__ __forceinline__ void mma_step(float (&acc)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1, bool first) {
  if (first)
    mma_bf16(acc, a, b0, b1, 0.0f, 0.0f, 0.0f, 0.0f);
  else
    mma_bf16(acc, a, b0, b1, acc[0], acc[1], acc[2], acc[3]);
}

// One block: features [f0, f0 + fb) x row tiles [tile0, tile0 + tiles_per_split)
// of split blockIdx.y.  Warp w owns feature f0 + w / m_tiles, bins
// [16 * (w % m_tiles), +16) and all NT n-tiles.  NT is a template
// parameter (even, 2..16) so that the k-step has no branches and the
// compiler can issue every ldmatrix of a k-step ahead of its mmas.
template <int NT>
__global__ void __launch_bounds__(MMA_THREADS, 1)
hist_mma_kernel(const int8_t* __restrict__ bins, const __nv_bfloat16* __restrict__ bmat,
                float* __restrict__ out, int64_t n, int f_pad, int fb, int m_tiles, int n_bins,
                int tiles_per_split, int64_t total_tiles, int64_t out_feature_stride,
                int out_slot_stride, int64_t out_split_stride, int aligned16) {
  constexpr int ns = NT * 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem);          // [2][ns][ROW_PITCH]
  int8_t* sBins = reinterpret_cast<int8_t*>(smem + 2 * ns * ROW_PITCH * 2);  // [2][fb][ROWS_TILE]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int f0 = blockIdx.x * fb;
  const int nf = fb < f_pad - f0 ? fb : f_pad - f0;
  const int fl = warp / m_tiles, mt = warp % m_tiles;
  const bool active = fl < nf;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.y) * tiles_per_split;
  const int tiles = static_cast<int>(
      tiles_per_split < total_tiles - tile0 ? tiles_per_split : total_tiles - tile0);

  auto issue = [&](int i, int buf) {
    const int64_t tile = tile0 + i;
    const __nv_bfloat16* src = bmat + tile * ns * ROWS_TILE;
    __nv_bfloat16* dst = sB + buf * ns * ROW_PITCH;
    for (int c = tid; c < ns * (ROWS_TILE / 8); c += MMA_THREADS) {
      const int row = c / (ROWS_TILE / 8), ch = c % (ROWS_TILE / 8);
      cp_async16(dst + row * ROW_PITCH + ch * 8, src + row * ROWS_TILE + ch * 8, 16);
    }
    const int64_t r0 = tile * ROWS_TILE;
    int8_t* bdst = sBins + buf * fb * ROWS_TILE;
    if (aligned16) {
      for (int c = tid; c < nf * (ROWS_TILE / 16); c += MMA_THREADS) {
        const int f = c / (ROWS_TILE / 16), ch = c % (ROWS_TILE / 16);
        const int64_t r = r0 + ch * 16;
        const int bytes = n - r >= 16 ? 16 : (n > r ? static_cast<int>(n - r) : 0);
        cp_async16(bdst + f * ROWS_TILE + ch * 16,
                   bins + static_cast<int64_t>(f0 + f) * n + (bytes > 0 ? r : 0), bytes);
      }
    } else {
      // rows not 16-byte aligned: plain loads (the buffer is not read until
      // the barrier after the next wait)
      for (int c = tid; c < nf * ROWS_TILE; c += MMA_THREADS) {
        const int f = c / ROWS_TILE, j = c % ROWS_TILE;
        bdst[c] = r0 + j < n ? bins[static_cast<int64_t>(f0 + f) * n + r0 + j] : int8_t(0);
      }
    }
  };

  float tot[NT][4];
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) tot[j][q] = acc[j][q] = 0.0f;
  // this thread's two bins of the A fragment, repeated in each byte
  const unsigned lo4 = static_cast<unsigned>(mt * 16 + g) * 0x01010101u;
  const unsigned hi4 = static_cast<unsigned>(mt * 16 + g + 8) * 0x01010101u;
  // ldmatrix: lane l gives row l % 8 of matrix l / 8, the matrices being
  // (n-tile j, k 0-7), (j, k 8-15), (j + 1, k 0-7), (j + 1, k 8-15)
  const int ld_off = (((lane >> 4) << 3) + (lane & 7)) * ROW_PITCH + (((lane >> 3) & 1) << 3);

  if (tiles > 0) issue(0, 0);
  cp_async_commit();
  for (int i = 0; i < tiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < tiles) issue(i + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if (active) {
      const __nv_bfloat16* bt = sB + buf * ns * ROW_PITCH + ld_off;
      const int8_t* bb = sBins + (buf * fb + fl) * ROWS_TILE + 2 * tig;
#pragma unroll
      for (int ks = 0; ks < ROWS_TILE / 16; ++ks) {
        const int k0 = ks * 16;
        unsigned b[NT][2];
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          unsigned r[4];
          ldmatrix_x4(r, bt + j * 8 * ROW_PITCH + k0);
          b[j][0] = r[0], b[j][1] = r[1], b[j + 1][0] = r[2], b[j + 1][1] = r[3];
        }
        // bins of rows k0 + 2 tig + {0, 1} (bytes 0, 1) and + {8, 9} (bytes 2, 3)
        const unsigned w = *reinterpret_cast<const unsigned short*>(bb + k0) |
                           (static_cast<unsigned>(*reinterpret_cast<const unsigned short*>(bb + k0 + 8))
                            << 16);
        const unsigned mlo = __vcmpeq4(w, lo4), mhi = __vcmpeq4(w, hi4);
        unsigned a[4];
        a[0] = __byte_perm(mlo, 0u, 0x1100) & BF16_ONES;  // (bin lo, k 2tig..+1)
        a[1] = __byte_perm(mhi, 0u, 0x1100) & BF16_ONES;  // (bin hi, k 2tig..+1)
        a[2] = __byte_perm(mlo, 0u, 0x3322) & BF16_ONES;  // (bin lo, k 2tig+8..+9)
        a[3] = __byte_perm(mhi, 0u, 0x3322) & BF16_ONES;  // (bin hi, k 2tig+8..+9)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_step(acc[j], a, b[j][0], b[j][1], ks == 0);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) tot[j][q] += acc[j][q];
    }
    __syncthreads();
  }

  if (active) {
    float* dst = out + blockIdx.y * out_split_stride + (f0 + fl) * out_feature_stride;
    const int b_lo = mt * 16 + g, b_hi = b_lo + 8;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int s0 = j * 8 + 2 * tig;
      if (b_lo < n_bins) {
        dst[static_cast<int64_t>(s0) * out_slot_stride + b_lo] = tot[j][0];
        dst[static_cast<int64_t>(s0 + 1) * out_slot_stride + b_lo] = tot[j][1];
      }
      if (b_hi < n_bins) {
        dst[static_cast<int64_t>(s0) * out_slot_stride + b_hi] = tot[j][2];
        dst[static_cast<int64_t>(s0 + 1) * out_slot_stride + b_hi] = tot[j][3];
      }
    }
  }
}

template <int NT>
cudaError_t launch_mma_nt(dim3 grid, int smem, cudaStream_t st, const int8_t* bins,
                          const __nv_bfloat16* bmat, float* dst, long long n, int f_pad, int fb,
                          int m_tiles, int n_bins, int tiles_per_split, long long total_tiles,
                          long long feature_stride, long long split_stride, int aligned16) {
  cudaError_t err = cudaFuncSetAttribute(hist_mma_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  hist_mma_kernel<NT><<<grid, MMA_THREADS, smem, st>>>(
      bins, bmat, dst, n, f_pad, fb, m_tiles, n_bins, tiles_per_split, total_tiles,
      feature_stride, n_bins, split_stride, aligned16);
  return cudaGetLastError();
}

// out[f, :ns, :] = sum over splits, in split order, of part[split, f, :ns, :]
__global__ void __launch_bounds__(256)
hist_split_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int splits,
                      int64_t per_split, int64_t per_feature, int64_t out_feature_stride) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= per_split) return;
  float s = part[i];
  for (int sp = 1; sp < splits; ++sp) s += part[sp * per_split + i];
  out[(i / per_feature) * out_feature_stride + i % per_feature] = s;
}

int launch_mma(const void* bins, const void* node, const void* stats, void* out, void* part,
               void* bmat, long long n, int f_pad, int t_pack, int nodes, int s_dim, int n_bins,
               int m_slots, int splits, int tiles_per_split, int aligned16, void* stream) {
  const int slots = t_pack * nodes * s_dim;
  if (f_pad <= 0 || n <= 0 || slots <= 0 || n_bins <= 0) return static_cast<int>(cudaGetLastError());
  if (slots > MAX_N_TILES * 8 || slots > m_slots || n_bins > 128 || splits < 1 || tiles_per_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total_tiles = (n + ROWS_TILE - 1) / ROWS_TILE;
  if (static_cast<long long>(splits) * tiles_per_split < total_tiles ||
      static_cast<long long>(splits - 1) * tiles_per_split >= total_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = 2 * ((slots + 15) / 16), ns = n_tiles * 8;
  const int m_tiles = (n_bins + 15) / 16;
  const int fb = std::max(1, MMA_WARPS / m_tiles);
  const int f_groups = (f_pad + fb - 1) / fb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  const long long pairs = total_tiles * ns * (ROWS_TILE / 2);
  hist_mask_stats_kernel<<<static_cast<unsigned int>((pairs + 255) / 256), 256, 0, st>>>(
      static_cast<const int32_t*>(node), static_cast<const float*>(stats),
      static_cast<__nv_bfloat162*>(bmat), n, nodes, s_dim, slots, ns, pairs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int smem = 2 * ns * ROW_PITCH * 2 + 2 * fb * ROWS_TILE;
  const long long feature_stride = splits == 1 ? static_cast<long long>(m_slots) * n_bins
                                               : static_cast<long long>(ns) * n_bins;
  const long long split_stride = feature_stride * f_pad;
  const dim3 grid(static_cast<unsigned int>(f_groups), static_cast<unsigned int>(splits));
  const int8_t* b8 = static_cast<const int8_t*>(bins);
  const __nv_bfloat16* bm = static_cast<const __nv_bfloat16*>(bmat);
  float* dst = static_cast<float*>(splits == 1 ? out : part);
#define SRML_MMA_CASE(NT)                                                                   \
  case NT:                                                                                  \
    err = launch_mma_nt<NT>(grid, smem, st, b8, bm, dst, n, f_pad, fb, m_tiles, n_bins,     \
                            tiles_per_split, total_tiles, feature_stride, split_stride,     \
                            aligned16);                                                     \
    break;
  switch (n_tiles) {
    SRML_MMA_CASE(2)
    SRML_MMA_CASE(4)
    SRML_MMA_CASE(6)
    SRML_MMA_CASE(8)
    SRML_MMA_CASE(10)
    SRML_MMA_CASE(12)
    SRML_MMA_CASE(14)
    SRML_MMA_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SRML_MMA_CASE
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);

  const long long per_split = split_stride;
  hist_split_sum_kernel<<<static_cast<unsigned int>((per_split + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(out), splits, per_split,
      static_cast<long long>(ns) * n_bins, static_cast<long long>(m_slots) * n_bins);
  return static_cast<int>(cudaGetLastError());
}


}  // namespace

// Plain C entry points, bound with ctypes.  They launch on `stream`, do not
// synchronise, allocate nothing, and return the first CUDA error.
//
// The atomic route.  bins (f_pad, n) int8, node (t_pack, n) int32, stats
// (t_pack * s_dim, n) fp32 -> out (f_pad, m_slots, n_bins) fp32, every cell
// written.  fb, splits, rows_per_block: ops/forest_hist._atomic_geometry.
// integer_stats: the caller knows every stat is an integer.
extern "C" int srml_node_histograms(const void* bins, const void* node, const void* stats,
                                    void* out, long long n, int f_pad, int t_pack,
                                    int nodes, int s_dim, int n_bins, int m_slots,
                                    int fb, long long splits, long long rows_per_block,
                                    int integer_stats, void* stream) {
  return launch(bins, node, stats, out, n, f_pad, t_pack, nodes, s_dim, n_bins, 1, n, m_slots, fb,
                splits, rows_per_block, integer_stats, stream);
}

// bins (f_pad, n_buckets * cap) int8, node (n_buckets * cap) int32 bucket-
// local ids, stats (s_dim, n_buckets * cap) fp32 ->
// out (n_buckets, f_pad, slots_pad, n_bins) fp32, every cell written; the
// rest as srml_node_histograms.
extern "C" int srml_node_histograms_bucketed(const void* bins, const void* node,
                                             const void* stats, void* out,
                                             long long n_buckets, long long cap,
                                             int f_pad, int nodes, int s_dim,
                                             int slots_pad, int n_bins, int fb,
                                             long long splits, long long rows_per_block,
                                             int integer_stats, void* stream) {
  return launch(bins, node, stats, out, n_buckets * cap, f_pad, 1, nodes, s_dim, n_bins,
                n_buckets, cap, slots_pad, fb, splits, rows_per_block, integer_stats, stream);
}

// The tensor-core route.  bins (f_pad, n) int8, node (t_pack, n) int32,
// stats (t_pack * s_dim, n) fp32 -> out (f_pad, m_slots, n_bins) fp32; the
// slots at and past round_up(t_pack * nodes * s_dim, 16) are left as the
// caller set them.  Scratch from the caller: bmat, ceil(n / 128) * ns * 128
// bf16 (ns = that rounded slot count), and, when splits > 1, part,
// splits * f_pad * ns * n_bins fp32.  Rows are cut into ceil(n / 128) tiles
// of 128, tiles_per_split to a split (the last split may hold fewer, none
// may be empty).  aligned16: n and bins are 16-byte aligned.
extern "C" int srml_node_histograms_mma(const void* bins, const void* node, const void* stats,
                                        void* out, void* part, void* bmat, long long n,
                                        int f_pad, int t_pack, int nodes, int s_dim,
                                        int n_bins, int m_slots, int splits,
                                        int tiles_per_split, int aligned16, void* stream) {
  return launch_mma(bins, node, stats, out, part, bmat, n, f_pad, t_pack, nodes, s_dim, n_bins,
                    m_slots, splits, tiles_per_split, aligned16, stream);
}
