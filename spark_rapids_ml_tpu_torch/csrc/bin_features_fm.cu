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
// memory time, so the count is a binary search (7 steps for 127 edges).  The
// search gives the compare loop's count when the predicate "edge < x" is
// true on a prefix of the edges and false after it: edges non-decreasing,
// with NaN edges (if any) only at the end.  The wrapper checks that.  A NaN
// x fails every "edge < x", so it gets bin 0, as in the compare loop.
//
// Design, simple first:
//   - a block owns a tile of TR = 256 rows x TD = 32 features; the 32 edge
//     rows of its features sit in shared memory;
//   - loads walk the tile row by row (32 consecutive floats of a row per
//     warp: 128-byte coalesced reads), each thread bins its value and puts
//     the byte into a transposed shared tile;
//   - stores walk the shared tile feature by feature (consecutive rows of
//     one feature per warp: coalesced int8 writes of the feature-major
//     output);
//   - X is not padded: rows >= n and features >= d are masked here, and the
//     rows n..n_pad-1 of the output are written 0 without reading X.
// Offsets are 64-bit: the flagship X has 3.0e9 elements.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TR = 256;   // rows per block
constexpr int TD = 32;    // features per block
constexpr int THREADS = 256;
constexpr int MAX_EDGES = 127;

__global__ void __launch_bounds__(THREADS)
bin_features_fm_kernel(const float* __restrict__ X, const float* __restrict__ edges,
                       int8_t* __restrict__ out, int64_t n, int64_t d,
                       int64_t n_pad, int n_edges) {
  // a row stride of 129 floats puts the 32 features of a warp on 32 banks
  __shared__ float es[TD][MAX_EDGES + 2];
  __shared__ int8_t tile[TD][TR + 4];

  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * TR;
  const int64_t f0 = static_cast<int64_t>(blockIdx.y) * TD;

  for (int i = tid; i < TD * n_edges; i += THREADS) {
    const int fl = i / n_edges;
    const int e = i % n_edges;
    const int64_t f = f0 + fl;
    es[fl][e] = f < d ? edges[f * n_edges + e] : 0.0f;
  }
  __syncthreads();

  for (int i = tid; i < TR * TD; i += THREADS) {
    const int rl = i / TD;
    const int fl = i % TD;
    const int64_t r = row0 + rl;
    const int64_t f = f0 + fl;
    int bin = 0;
    if (r < n && f < d) {
      const float x = X[r * d + f];
      int lo = 0, hi = n_edges;
      while (lo < hi) {  // first edge that is not < x
        const int mid = (lo + hi) >> 1;
        if (es[fl][mid] < x) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      bin = lo;
    }
    tile[fl][rl] = static_cast<int8_t>(bin);
  }
  __syncthreads();

  for (int i = tid; i < TR * TD; i += THREADS) {
    const int fl = i / TR;
    const int rl = i % TR;
    const int64_t r = row0 + rl;
    const int64_t f = f0 + fl;
    if (r < n_pad && f < d) out[f * n_pad + r] = tile[fl][rl];
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
extern "C" int srml_bin_features_fm(const void* X, const void* edges, void* out,
                                    long long n, long long d, long long n_pad,
                                    int n_edges, void* stream) {
  if (n_pad > 0 && d > 0) {
    const dim3 grid(static_cast<unsigned int>((n_pad + TR - 1) / TR),
                    static_cast<unsigned int>((d + TD - 1) / TD));
    bin_features_fm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(X), static_cast<const float*>(edges),
        static_cast<int8_t*>(out), n, d, n_pad, n_edges);
  }
  return static_cast<int>(cudaGetLastError());
}
