// IVF-PQ asymmetric-distance (ADC) lookup-table accumulation for Hopper
// (sm_90a):
//
//     out[b, r] = sum_j T[b, j, code(b, r, j)]        j = 0 .. m_sub - 1
//
// summed in j order in fp32, each term an exact table read; a code >= ksub
// adds 0.0.  Two entry points:
//   - srml_lut_accumulate_f32: one byte per code, codes (B, R, m_sub) uint8,
//     T (B, m_sub, ksub <= 256).  Replaces the TPU kernel
//     spark_rapids_ml_tpu/ops/pallas_pq.py::_lut_accum_kernel (wrapper
//     _lut_accumulate_pallas);
//   - srml_fastscan_accumulate_f32: two 4-bit codes a byte, packed
//     (B, R, m_sub / 2) uint8 with code j in the low nibble of byte j / 2 when
//     j is even and in the high nibble when j is odd, T (B, m_sub, ksub <= 16).
//     Replaces spark_rapids_ml_tpu/ops/pallas_pq.py::_fastscan_kernel
//     (wrapper _fastscan_pallas).
//
// Exactness is the contract: the sum is sequential in j with __fadd_rn (no
// contraction, no reassociation; the build has no fast-math), so the kernel
// equals its plain version (an explicit loop over j of gather + add), the
// JAX package's numpy oracle and its interpret-mode Pallas kernels bit for
// bit.  The TPU kernels gather by a compare-select sweep over the ksub table
// lanes (Mosaic has no vector gather); here a thread reads the table entry
// from shared memory directly.
//
// What bounds it on the card: bytes.  Per row it reads m_sub code bytes
// (m_sub / 2 packed) and writes 4 bytes; the table is read once per block
// from global memory (32 KB at m_sub 32, ksub 256), so at the ANN path's
// shapes (32 queries x 161,792 rows x 32 bytes) the least time is the code
// bytes over the memory rate, ~0.06 ms.
//
// Design, simple first:
//   - a 2-D grid: tiles of THREADS rows on x, queries on y (at most 65,535 a
//     launch; more take further launches);
//   - the block stages T[b] in shared memory as [j][c], TABLE_FLOATS floats a
//     stage (j_stage subspaces, a multiple of 32), so any m_sub fits: a wider
//     table takes several stages, the running sum stays in a register;
//   - each thread owns one row and reads its codes as 16-byte vector loads
//     when the row width is a multiple of 16 bytes and the codes are 16-byte
//     aligned (two loads a row at m_sub = 32, one packed row), else byte by
//     byte, then runs the j loop of shared-memory lookups.
// Not yet: the random lookups conflict on shared-memory banks, and the
// caller gathers the probed lists' codes into a contiguous tile before the
// launch (the gather could be fused in).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;         // rows per block, one a thread
constexpr int TABLE_FLOATS = 8192;   // 32 KB of table per stage
constexpr long long MAX_GRID_Y = 65535;

__device__ __forceinline__ float lookup(const float* tab, int j, uint32_t code, int ksub) {
  return code < static_cast<uint32_t>(ksub) ? tab[j * ksub + static_cast<int>(code)] : 0.0f;
}

template <bool PACKED, bool VEC>
__global__ void __launch_bounds__(THREADS) lut_accumulate_kernel(
    const float* __restrict__ tables, const uint8_t* __restrict__ codes, float* __restrict__ out,
    long long b0, long long r, int m_sub, int ksub, int m_bytes, int j_stage) {
  __shared__ float tab[TABLE_FLOATS];
  const long long b = b0 + blockIdx.y;
  const long long row = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const bool live = row < r;
  const uint8_t* src = codes + (b * r + (live ? row : 0)) * m_bytes;
  const float* tb = tables + b * static_cast<long long>(m_sub) * ksub;
  float acc = 0.0f;
  for (int j0 = 0; j0 < m_sub; j0 += j_stage) {
    const int jn = min(j_stage, m_sub - j0);
    __syncthreads();  // every thread is done with the previous stage
    for (int i = threadIdx.x; i < jn * ksub; i += THREADS) tab[i] = tb[static_cast<long long>(j0) * ksub + i];
    __syncthreads();
    if (!live) continue;
    if (VEC) {
      // j0 is a multiple of 32 and the row width of 16 bytes, so the stage's
      // bytes are whole 16-byte words
      const int nwords = (PACKED ? jn / 2 : jn) / 16;
      const uint4* words = reinterpret_cast<const uint4*>(src + (PACKED ? j0 / 2 : j0));
      for (int g = 0; g < nwords; ++g) {
        const uint4 v = __ldg(words + g);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const uint32_t byte = (w[i >> 2] >> ((i & 3) * 8)) & 0xffu;
          if (PACKED) {
            const int j = 2 * (g * 16 + i);
            acc = __fadd_rn(acc, lookup(tab, j, byte & 15u, ksub));
            acc = __fadd_rn(acc, lookup(tab, j + 1, byte >> 4, ksub));
          } else {
            acc = __fadd_rn(acc, lookup(tab, g * 16 + i, byte, ksub));
          }
        }
      }
    } else {
      for (int j = 0; j < jn; ++j) {
        const int jj = j0 + j;
        const uint32_t code = PACKED ? ((src[jj >> 1] >> ((jj & 1) * 4)) & 15u) : src[jj];
        acc = __fadd_rn(acc, lookup(tab, j, code, ksub));
      }
    }
  }
  if (live) out[b * r + row] = acc;
}

template <bool PACKED>
int launch(const void* tables, const void* codes, void* out, long long nb, long long r, long long m_sub,
           long long ksub, int vec, void* stream) {
  constexpr long long LIMIT = 0x7fffffffLL;
  const long long m_bytes = PACKED ? m_sub / 2 : m_sub;
  if (nb < 0 || r < 0 || m_sub < 0 || ksub < 1 || ksub > (PACKED ? 16 : 256) ||
      (PACKED && m_sub % 2 != 0) || m_sub > LIMIT || (vec && m_bytes % 16 != 0) ||
      (r + THREADS - 1) / THREADS > LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0 || r == 0) return 0;
  // subspaces a stage: as many as the shared table holds, a multiple of 32
  const int j_stage = static_cast<int>((TABLE_FLOATS / ksub) / 32 * 32);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int gx = static_cast<unsigned int>((r + THREADS - 1) / THREADS);
  for (long long b0 = 0; b0 < nb; b0 += MAX_GRID_Y) {
    const dim3 grid(gx, static_cast<unsigned int>(nb - b0 < MAX_GRID_Y ? nb - b0 : MAX_GRID_Y));
    const auto* t = static_cast<const float*>(tables);
    const auto* c = static_cast<const uint8_t*>(codes);
    auto* o = static_cast<float*>(out);
    if (vec)
      lut_accumulate_kernel<PACKED, true><<<grid, THREADS, 0, s>>>(
          t, c, o, b0, r, static_cast<int>(m_sub), static_cast<int>(ksub), static_cast<int>(m_bytes), j_stage);
    else
      lut_accumulate_kernel<PACKED, false><<<grid, THREADS, 0, s>>>(
          t, c, o, b0, r, static_cast<int>(m_sub), static_cast<int>(ksub), static_cast<int>(m_bytes), j_stage);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// tables (nb, m_sub, ksub) f32, codes (nb, r, m_sub) uint8, out (nb, r) f32;
// vec != 0 when m_sub % 16 == 0 and codes is 16-byte aligned.
extern "C" int srml_lut_accumulate_f32(const void* tables, const void* codes, void* out, long long nb,
                                       long long r, long long m_sub, long long ksub, int vec, void* stream) {
  return launch<false>(tables, codes, out, nb, r, m_sub, ksub, vec, stream);
}

// tables (nb, m_sub, ksub <= 16) f32, packed (nb, r, m_sub / 2) uint8,
// out (nb, r) f32; vec != 0 when (m_sub / 2) % 16 == 0 and packed is 16-byte
// aligned.
extern "C" int srml_fastscan_accumulate_f32(const void* tables, const void* packed, void* out, long long nb,
                                            long long r, long long m_sub, long long ksub, int vec,
                                            void* stream) {
  return launch<true>(tables, packed, out, nb, r, m_sub, ksub, vec, stream);
}
