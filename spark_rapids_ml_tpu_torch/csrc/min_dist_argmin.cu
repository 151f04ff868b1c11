// Fused nearest-center search for Hopper (sm_90a):
//
//     d2[r, c] = ||x_r||^2 - 2 x_r . c + ||c||^2
//     out_min[r] = min_c d2[r, c],  out_arg[r] = first c attaining it
//
// Replaces the TPU kernel spark_rapids_ml_tpu/ops/pallas_tpu.py::_min_dist_kernel
// (wrapper _min_dist_argmin_pallas).  The norms are computed by the caller and
// passed in, as there.  The (n, k) distance matrix never leaves registers.
//
// What bounds it on the card: 2*n*k*d floating-point operations against
// 4*(n + k)*d bytes of input.  At KMeans widths (k = 1000, d = 3000) that is
// ~500 operations per byte, far above the H100's fp32 ridge of ~20
// (67 TFLOP/s over 3.35 TB/s), so the kernel is bound by fp32 operations on
// the CUDA cores.  It accumulates in fp32 (or fp64) FMA on purpose: the
// norm-expansion form cancels, and TF32 tensor-core products flip
// assignments between nearly equidistant centers.
//
// Two kernels:
//   - min_dist_tile_kernel<VEC> (srml_min_dist_argmin_f32): the pipelined
//     fp32 main loop of fp32_dist_tile.cuh.  A block takes BM = 128 rows
//     and runs over every center tile of BN = 128 without draining the
//     pipeline (the TPU kernel's sequential center-tile grid axis with its
//     VMEM running min becomes that loop); after each tile its epilogue
//     folds d2 into a per-row running (min, index) in registers.  At the end the 4 lanes of a warp
//     that share a row merge with shuffles, and the 2 warps that share it
//     through shared memory.  VEC = 4 takes 16-byte copies, VEC = 1 4-byte
//     copies (a row start that is not 16-byte aligned: d % 4 != 0, or a
//     view that starts inside a row).  It is faster than the first design
//     at every shape the port gives B1, d = 8 included (PERF.md);
//   - min_dist_argmin_kernel<double> (srml_min_dist_argmin_f64): the first
//     design, kept for fp64: loads synchronous, one element a thread,
//     staged transposed in shared memory in slices of BK = 16 behind two
//     barriers; each of 256 threads keeps a 4 x 4 register micro-tile read
//     by scalar loads, and the 16 threads of a row merge with shuffles.
// Every comparison is lexicographic on (value, index), so ties resolve to the
// lowest center index, as jnp.argmin does.  The ragged edges of n, k and d are
// masked here (nothing is padded in device memory) and every element offset
// is 64-bit: the KMeans flagship input has 3.0e9 elements.
// No wgmma, TMA or tensor cores: the fp32 contract above.

#include <cstdint>
#include <cuda_runtime.h>

#include "fp32_dist_tile.cuh"

namespace {

// Tile shapes of the first design: 16 x 16 = 256 threads, a 4 x 4 fp64
// micro-tile so the accumulators stay in registers.
template <typename T> struct Tiles;
template <> struct Tiles<double> {
  static constexpr int BM = 64, BN = 64, TM = 4, TN = 4, BK = 16;
};
constexpr int TY = 16;  // thread rows: BM / TM
constexpr int TX = 16;  // thread columns: BN / TN
constexpr int THREADS = TY * TX;

template <typename T> __device__ __forceinline__ T inf_value();
template <> __device__ __forceinline__ float inf_value<float>() {
  return __int_as_float(0x7f800000);
}
template <> __device__ __forceinline__ double inf_value<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

template <typename T>
__device__ __forceinline__ bool lex_less(T v, int i, T best, int best_i) {
  return v < best || (v == best && i < best_i);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
min_dist_argmin_kernel(const T* __restrict__ X, const T* __restrict__ C,
                       const T* __restrict__ x_norm, const T* __restrict__ c_norm,
                       T* __restrict__ out_min, int32_t* __restrict__ out_arg,
                       int64_t n, int64_t k, int64_t d) {
  constexpr int BM = Tiles<T>::BM, BN = Tiles<T>::BN, BK = Tiles<T>::BK;
  constexpr int TM = Tiles<T>::TM, TN = Tiles<T>::TN;
  static_assert(BM / TM == TY && BN / TN == TX && BM == BN, "tile shape");
  constexpr int LOADS = BM * BK / THREADS;  // elements of each tile per thread
  __shared__ T Xs[BK][BM + 1];
  __shared__ T Cs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;

  T best[TM];
  int best_i[TM];
  T xn[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t r = row0 + ty + TY * i;
    best[i] = inf_value<T>();
    best_i[i] = 0;
    xn[i] = r < n ? x_norm[r] : T(0);
  }

  for (int64_t c0 = 0; c0 < k; c0 += BN) {
    T acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

    for (int64_t k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
      for (int l = 0; l < LOADS; ++l) {
        const int e = tid + THREADS * l;
        const int lr = e / BK;  // row of the tile
        const int lc = e % BK;  // feature within the slice
        const int64_t col = k0 + lc;
        const int64_t xr = row0 + lr;
        const int64_t cr = c0 + lr;
        Xs[lc][lr] = (xr < n && col < d) ? X[xr * d + col] : T(0);
        Cs[lc][lr] = (cr < k && col < d) ? C[cr * d + col] : T(0);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        T a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = Xs[kk][ty + TY * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Cs[kk][tx + TX * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // epilogue: d2 in the order (||x||^2 - 2 x.c) + ||c||^2, as the plain
    // version and the JAX package compute it; centers rise with j, and the
    // comparison is lexicographic all the same
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t c = c0 + tx + TX * j;
      if (c < k) {
        const T cn = c_norm[c];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const T v = (xn[i] - T(2) * acc[i][j]) + cn;
          if (lex_less(v, static_cast<int>(c), best[i], best_i[i])) {
            best[i] = v;
            best_i[i] = static_cast<int>(c);
          }
        }
      }
    }
  }

  // the TX = 16 threads of a row are 16 consecutive lanes of one warp
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = TX / 2; off > 0; off /= 2) {
      const T ov = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i[i], off);
      if (lex_less(ov, oi, best[i], best_i[i])) {
        best[i] = ov;
        best_i[i] = oi;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t r = row0 + ty + TY * i;
      if (r < n) {
        out_min[r] = best[i];
        out_arg[r] = best_i[i];
      }
    }
  }
}

template <typename T>
int launch(const void* X, const void* C, const void* x_norm, const void* c_norm,
           void* out_min, void* out_arg, long long n, long long k, long long d,
           void* stream) {
  if (n > 0) {
    const long long blocks = (n + Tiles<T>::BM - 1) / Tiles<T>::BM;
    min_dist_argmin_kernel<T><<<static_cast<unsigned int>(blocks), THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(X), static_cast<const T*>(C),
        static_cast<const T*>(x_norm), static_cast<const T*>(c_norm),
        static_cast<T*>(out_min), static_cast<int32_t*>(out_arg), n, k, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The pipelined float32 kernel
// ---------------------------------------------------------------------------

namespace tile = fp32_dist_tile;

// The epilogue: d2 in the order (||x||^2 - 2 x.c) + ||c||^2, as the plain
// version and the JAX package compute it, folded into each row's running
// lexicographic (min, index).  A thread sees its centers in rising order.
struct MinArgmin {
  const float* c_norm;
  const float* xn;  // the block's 128 row norms, in shared memory
  int64_t k;
  float best[tile::TM];
  int best_i[tile::TM];

  __device__ __forceinline__ void operator()(const float (&acc)[tile::TM][tile::TN], int t) {
    const int64_t c0 = static_cast<int64_t>(t) * tile::BN;
    float x[tile::TM];
#pragma unroll
    for (int i = 0; i < tile::TM; ++i) x[i] = xn[tile::row_of(i)];
#pragma unroll
    for (int j = 0; j < tile::TN; ++j) {
      const int64_t c = c0 + tile::col_of(j);
      if (c < k) {
        const float cn = __ldg(c_norm + c);
#pragma unroll
        for (int i = 0; i < tile::TM; ++i) {
          const float v = (x[i] - 2.0f * acc[i][j]) + cn;
          if (lex_less(v, static_cast<int>(c), best[i], best_i[i])) {
            best[i] = v;
            best_i[i] = static_cast<int>(c);
          }
        }
      }
    }
  }
};

template <int VEC>
__global__ void __launch_bounds__(tile::THREADS, 2)
min_dist_tile_kernel(const float* __restrict__ X, const float* __restrict__ C,
                     const float* __restrict__ x_norm, const float* __restrict__ c_norm,
                     float* __restrict__ out_min, int32_t* __restrict__ out_arg,
                     int64_t n, int64_t k, int64_t d) {
  __shared__ __align__(16) float smem[tile::SMEM_FLOATS];
  __shared__ float xn[tile::BM];
  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * tile::BM;
  if (tid < tile::BM) xn[tid] = row0 + tid < n ? x_norm[row0 + tid] : 0.0f;  // read after run()'s barriers

  MinArgmin epi{c_norm, xn, k};
#pragma unroll
  for (int i = 0; i < tile::TM; ++i) {
    epi.best[i] = inf_value<float>();
    epi.best_i[i] = 0;
  }
  const int n_tiles = static_cast<int>((k + tile::BN - 1) / tile::BN);
  tile::run<VEC>(X, n, row0, C, k, 0, n_tiles, d, smem, epi);

  // the 4 lanes of a row in this warp: lanes 4 * lane_m() + 0..3
#pragma unroll
  for (int i = 0; i < tile::TM; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      const float ov = __shfl_xor_sync(0xffffffffu, epi.best[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, epi.best_i[i], off);
      if (lex_less(ov, oi, epi.best[i], epi.best_i[i])) {
        epi.best[i] = ov;
        epi.best_i[i] = oi;
      }
    }
  }
  // the WARPS_N warps of a row, through shared memory (the stages are free)
  float* red_v = smem;                                                  // [WARPS_N][BM]
  int* red_i = reinterpret_cast<int*>(smem + tile::WARPS_N * tile::BM);  // [WARPS_N][BM]
  if (tile::lane_n() == 0) {
#pragma unroll
    for (int i = 0; i < tile::TM; ++i) {
      red_v[tile::warp_n() * tile::BM + tile::row_of(i)] = epi.best[i];
      red_i[tile::warp_n() * tile::BM + tile::row_of(i)] = epi.best_i[i];
    }
  }
  __syncthreads();
  if (tid < tile::BM && row0 + tid < n) {
    float bv = red_v[tid];
    int bi = red_i[tid];
#pragma unroll
    for (int w = 1; w < tile::WARPS_N; ++w) {
      const float ov = red_v[w * tile::BM + tid];
      const int oi = red_i[w * tile::BM + tid];
      if (lex_less(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    out_min[row0 + tid] = bv;
    out_arg[row0 + tid] = bi;
  }
}

int launch_tile(const void* X, const void* C, const void* x_norm, const void* c_norm,
                void* out_min, void* out_arg, long long n, long long k, long long d,
                void* stream) {
  if (d > 2147483647LL - tile::BK) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const unsigned int blocks = static_cast<unsigned int>((n + tile::BM - 1) / tile::BM);
    auto kernel = tile::copy_width(X, C, d) == 4 ? min_dist_tile_kernel<4> : min_dist_tile_kernel<1>;
    kernel<<<blocks, tile::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(X), static_cast<const float*>(C),
        static_cast<const float*>(x_norm), static_cast<const float*>(c_norm),
        static_cast<float*>(out_min), static_cast<int32_t*>(out_arg), n, k, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes.  They launch on `stream`, do not
// synchronise, allocate nothing, and return cudaGetLastError().
// srml_min_dist_argmin_f32 runs the pipelined kernel, with 16-byte copies
// when X, C and d * 4 are 16-byte aligned and 4-byte copies otherwise;
// srml_min_dist_argmin_f64 runs the first design.  The caller checks
// shapes: k < 2^31, d < 2^31 - 8.
extern "C" int srml_min_dist_argmin_f32(const void* X, const void* C,
                                        const void* x_norm, const void* c_norm,
                                        void* out_min, void* out_arg, long long n,
                                        long long k, long long d, void* stream) {
  return launch_tile(X, C, x_norm, c_norm, out_min, out_arg, n, k, d, stream);
}

extern "C" int srml_min_dist_argmin_f64(const void* X, const void* C,
                                        const void* x_norm, const void* c_norm,
                                        void* out_min, void* out_arg, long long n,
                                        long long k, long long d, void* stream) {
  return launch<double>(X, C, x_norm, c_norm, out_min, out_arg, n, k, d, stream);
}
