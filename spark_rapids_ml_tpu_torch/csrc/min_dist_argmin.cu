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
// Design, simple first:
//   - a 1-D grid over tiles of BM = 128 rows (64 in fp64); blocks carry nothing between
//     them (the TPU kernel's sequential center-tile grid axis with a VMEM
//     running min becomes a loop inside the block);
//   - each block loops over all center tiles of BN = BM and, inside, over
//     d in slices of BK staged in shared memory (X tile and C tile, stored
//     transposed and padded by one column against bank conflicts);
//   - each of the 256 threads keeps an 8 x 8 (fp64: 4 x 4) register
//     micro-tile of dot products (4 FMAs per shared-memory load, 2 in fp64,
//     against 1 for a thread per output), forms d2 in the
//     epilogue and keeps a per-row running (min, index) in registers;
//   - the 16 threads that share a row merge their (min, index) pairs with
//     warp shuffles;  one store per row.
// Every comparison is lexicographic on (value, index), so ties resolve to the
// lowest center index, as jnp.argmin does.  The ragged edges of n, k and d are
// masked here (nothing is padded in device memory) and every element offset
// is 64-bit: the KMeans flagship input has 3.0e9 elements.
// No wgmma, TMA or tensor cores yet.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Tile shapes.  Both types use 16 x 16 = 256 threads; fp64 takes a 4 x 4
// micro-tile so its accumulators stay in registers.
template <typename T> struct Tiles;
template <> struct Tiles<float> {
  static constexpr int BM = 128, BN = 128, TM = 8, TN = 8, BK = 16;
};
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

}  // namespace

// Plain C entry points, bound with ctypes.  They launch on `stream`, do not
// synchronise, allocate nothing, and return cudaGetLastError().
extern "C" int srml_min_dist_argmin_f32(const void* X, const void* C,
                                        const void* x_norm, const void* c_norm,
                                        void* out_min, void* out_arg, long long n,
                                        long long k, long long d, void* stream) {
  return launch<float>(X, C, x_norm, c_norm, out_min, out_arg, n, k, d, stream);
}

extern "C" int srml_min_dist_argmin_f64(const void* X, const void* C,
                                        const void* x_norm, const void* c_norm,
                                        void* out_min, void* out_arg, long long n,
                                        long long k, long long d, void* stream) {
  return launch<double>(X, C, x_norm, c_norm, out_min, out_arg, n, k, d, stream);
}
