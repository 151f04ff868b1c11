// Random-forest node histograms for Hopper (sm_90a):
//
//     H[f, slot, b] = sum_r bf16(stat[t*S + s, r]) * [node[t, r] == c] * [bin[f, r] == b]
//     slot = (t * nodes + c) * S + s,  summed in fp32
//
// Two entry points over one kernel:
//   srml_node_histograms           replaces spark_rapids_ml_tpu/ops/forest_hist.py::_hist_kernel
//                                  (wrapper node_histograms): all rows, t_pack trees,
//                                  output (F_pad, 128, B)
//   srml_node_histograms_bucketed  replaces ::_hist_kernel_bucketed (wrapper
//                                  node_histograms_bucketed): the same sum per
//                                  contiguous bucket of `cap` rows, one tree, bucket-
//                                  local node ids, output (n_buckets, F_pad, slots_pad, B)
// Rows whose node id is outside [0, nodes) and bins outside [0, B) add
// nothing, as in the one-hot formulation of the TPU kernels.
//
// Rounding: the TPU kernels feed the stat operand to the matrix unit in
// bf16 and accumulate in fp32.  Each stat is rounded the same way here
// (__float2bfloat16_rn) before it is added in fp32, so integer stats
// (bootstrap counts x one-hot classes) give the same exact sums, and float
// stats (regression w*y) differ only by the order of the fp32 additions.
//
// What bounds it on the card: the shared-memory atomic adds, one per
// (row, feature, tree) with a non-zero stat — ~2e9 per level of the
// RandomForest flagship (1M rows x 64 subset features x 50 trees x ~0.63
// non-zero bootstrap weights).  The bytes it must move are small beside
// them (the int8 bins, the node ids and the stats, each read once).  The
// MXU one-hot matmul of the TPU kernels is the TPU's way to build a
// histogram; on this card the natural form is the one cuML uses:
//   - a block owns FB features (as many (slots x B) fp32 histograms as fit
//     96 KB of shared memory, so two blocks share an SM) and a range of rows
//     of one bucket;
//   - each thread walks rows (consecutive rows per warp: coalesced loads of
//     node ids, stats and int8 bins) and adds each non-zero bf16-rounded
//     stat into its (slot, bin) cell with a shared-memory atomic (adding 0
//     changes no fp32 sum, so zero stats are skipped);
//   - the block then adds its non-zero cells into the output with global
//     atomics (the wrapper zeroes the output), which lets several blocks
//     share one bucket's rows when the buckets are too few to fill the card.
// Offsets are 64-bit.  No tensor cores.

#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_BUDGET = 96 * 1024;   // two blocks per SM
constexpr int TARGET_BLOCKS = 132 * 8;   // ~4 waves of two blocks on each of 132 SMs

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One block: features [f0, f0 + nf) x rows [r0, r1) of the bucket at `out`.
__global__ void __launch_bounds__(THREADS)
hist_kernel(const int8_t* __restrict__ bins, const int32_t* __restrict__ node,
            const float* __restrict__ stats, float* __restrict__ out,
            int64_t ld, int f_pad, int fb, int t_pack, int nodes, int s_dim,
            int n_bins, int64_t seg_len, int64_t rows_per_block,
            int64_t out_feature_stride, int64_t out_bucket_stride) {
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

  for (int i = tid; i < hsize; i += THREADS) h[i] = 0.0f;
  __syncthreads();

  for (int64_t r = r0 + tid; r < r1; r += THREADS) {
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
            atomicAdd(&h[fl * cells + slot * n_bins + b], v);
        }
      }
    }
  }
  __syncthreads();

  float* dst = out + static_cast<int64_t>(blockIdx.z) * out_bucket_stride;
  for (int i = tid; i < hsize; i += THREADS) {
    const float v = h[i];
    if (v != 0.0f) {
      const int fl = i / cells;
      atomicAdd(&dst[(f0 + fl) * out_feature_stride + (i - fl * cells)], v);
    }
  }
}

int launch(const void* bins, const void* node, const void* stats, void* out,
           long long ld, int f_pad, int t_pack, int nodes, int s_dim, int n_bins,
           long long n_buckets, long long seg_len, long long out_feature_stride,
           long long out_bucket_stride, void* stream) {
  const int slots = t_pack * nodes * s_dim;
  if (f_pad <= 0 || seg_len <= 0 || n_buckets <= 0 || slots <= 0 || n_bins <= 0)
    return static_cast<int>(cudaGetLastError());
  const int cell_bytes = slots * n_bins * static_cast<int>(sizeof(float));
  const int fb = std::max(1, std::min(f_pad, SMEM_BUDGET / cell_bytes));
  const int f_groups = (f_pad + fb - 1) / fb;
  const long long per_split = static_cast<long long>(f_groups) * n_buckets;
  long long splits = (TARGET_BLOCKS + per_split - 1) / per_split;
  splits = std::max(1LL, std::min(splits, (seg_len + 1023) / 1024));
  const long long rows_per_block = (seg_len + splits - 1) / splits;
  splits = (seg_len + rows_per_block - 1) / rows_per_block;
  const int smem = fb * cell_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(f_groups), static_cast<unsigned int>(splits),
                  static_cast<unsigned int>(n_buckets));
  hist_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(bins), static_cast<const int32_t*>(node),
      static_cast<const float*>(stats), static_cast<float*>(out), ld, f_pad, fb,
      t_pack, nodes, s_dim, n_bins, seg_len, rows_per_block, out_feature_stride,
      out_bucket_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes.  They launch on `stream`, do not
// synchronise, allocate nothing, add into `out` (which the caller zeroes),
// and return the first CUDA error.
//
// bins (f_pad, n) int8, node (t_pack, n) int32, stats (t_pack * s_dim, n)
// fp32 -> out (f_pad, m_slots, n_bins) fp32.
extern "C" int srml_node_histograms(const void* bins, const void* node, const void* stats,
                                    void* out, long long n, int f_pad, int t_pack,
                                    int nodes, int s_dim, int n_bins, int m_slots,
                                    void* stream) {
  return launch(bins, node, stats, out, n, f_pad, t_pack, nodes, s_dim, n_bins, 1, n,
                static_cast<long long>(m_slots) * n_bins, 0, stream);
}

// bins (f_pad, n_buckets * cap) int8, node (n_buckets * cap) int32 bucket-
// local ids, stats (s_dim, n_buckets * cap) fp32 ->
// out (n_buckets, f_pad, slots_pad, n_bins) fp32.
extern "C" int srml_node_histograms_bucketed(const void* bins, const void* node,
                                             const void* stats, void* out,
                                             long long n_buckets, long long cap,
                                             int f_pad, int nodes, int s_dim,
                                             int slots_pad, int n_bins, void* stream) {
  const long long feature_stride = static_cast<long long>(slots_pad) * n_bins;
  return launch(bins, node, stats, out, n_buckets * cap, f_pad, 1, nodes, s_dim, n_bins,
                n_buckets, cap, feature_stride, feature_stride * f_pad, stream);
}
