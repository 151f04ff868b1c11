// IVF-PQ asymmetric-distance (ADC) lookup-table accumulation for Hopper
// (sm_90a):
//
//     out[b, r] = sum_j T[b, j, code(b, r, j)]        j = 0 .. m_sub - 1
//
// summed in j order in fp32, each term an exact table read; a code >= ksub
// adds 0.0.  Two kernels:
//   - probed_lut_kernel (srml_lut_accumulate_probed_f32, and
//     srml_lut_accumulate_f32 on a contiguous tile): one byte per code, T
//     (B, m_sub, ksub <= 256), codes read in place from a plane of lists
//     (n_planes, L_pad, m_sub) uint8 at each query's probed slots.  Replaces
//     the TPU kernel spark_rapids_ml_tpu/ops/pallas_pq.py::_lut_accum_kernel
//     (wrapper _lut_accumulate_pallas);
//   - lut_accumulate_kernel<true, VEC> (srml_fastscan_accumulate_f32): two
//     4-bit codes a byte, packed (B, R, m_sub / 2) uint8 with code j in the low nibble of
//     byte j / 2 when j is even and in the high nibble when j is odd, T
//     (B, m_sub, ksub <= 16).  Replaces spark_rapids_ml_tpu/ops/pallas_pq.py::
//     _fastscan_kernel (wrapper _fastscan_pallas).
//
// Exactness is the contract: the sum is sequential in j with __fadd_rn (no
// contraction, no reassociation; the build has no fast-math), so the kernels
// equal their plain versions (an explicit loop over j of gather + add), the
// JAX package's numpy oracle and its interpret-mode Pallas kernels bit for
// bit.  The TPU kernels gather by a compare-select sweep over the ksub table
// lanes (Mosaic has no vector gather); here a thread reads the table entry
// from shared memory directly.
//
// What bounds it on the card: bytes.  Per valid row it reads m_sub code bytes
// (m_sub / 2 packed) and writes 4 bytes; the table is read once per block.
//
// probed_lut_kernel's design:
//   - the ANN search probes nprobe lists of L_pad slots per query, and most
//     slots lie past their list's count (~69% at the ANN arms' 158 x 2048).
//     The kernel reads each probed list's codes where the index keeps them
//     (no gathered copy) and only the rows below the list's count; every
//     other row gets +inf;
//   - the grid is (blocks a query, queries): as many blocks a query as the
//     card holds at once across the queries (the caller's count, from
//     srml_lut_probed_occupancy: the table's shared memory limits the blocks
//     an SM), each staging its query's whole table in shared memory once
//     ([j][c], up to 48 KB; a wider table is staged in parts per tile) and
//     walking the query's (list, 256-row tile) units in turn;
//   - each thread owns one row: its codes as 16-byte vector loads when the
//     row width is a multiple of 16 bytes and the plane 16-byte aligned
//     (two loads a row at m_sub 32), else byte by byte, then the j loop of
//     shared-memory lookups.  The lanes of a warp look up one j at random
//     codes, which conflicts on shared-memory banks (~3.5-way for uniform
//     codes); a layout with the lanes on different j needs a row's sum to
//     pass between lanes (a shuffle a term), which costs the shared-memory
//     pipe about as much.
//   The contiguous form (B, R, m_sub) is the same kernel with each query its
//   own plane: one list of R rows, all valid.
//
// lut_accumulate_kernel and launch<PACKED> are PR 4's first design, kept
// as they were for the fast-scan form (PACKED true; the one-byte form is
// the probed kernel above): a 2-D grid of 256-row tiles by queries (at most
// 65,535 a launch), the table staged per block as [j][c] in TABLE_FLOATS
// stages; it still takes a contiguous (gathered) tile.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;         // rows per block, one a thread
constexpr int TABLE_FLOATS = 8192;   // 32 KB of table per stage
constexpr int PROBED_TABLE_FLOATS = 12288;  // probed: 48 KB of table, static-size limit
constexpr long long MAX_GRID_Y = 65535;

__device__ __forceinline__ float lookup(const float* tab, int j, uint32_t code, int ksub) {
  return code < static_cast<uint32_t>(ksub) ? tab[j * ksub + static_cast<int>(code)] : 0.0f;
}

// ---------------------------------------------------------------------------
// probed_lut_kernel
// ---------------------------------------------------------------------------

template <bool VEC>
__global__ void __launch_bounds__(THREADS) probed_lut_kernel(
    const float* __restrict__ tables, const uint8_t* __restrict__ plane, const long long* __restrict__ slots,
    const int32_t* __restrict__ counts, float* __restrict__ out, long long b0, int nprobe, long long n_planes,
    int l_pad, int m_sub, int ksub, int j_stage, int tiles_per_list) {
  extern __shared__ float tab[];
  const long long b = b0 + blockIdx.y;
  const float* tb = tables + b * static_cast<long long>(m_sub) * ksub;
  const bool whole = j_stage >= m_sub;
  if (whole) {
    for (int i = threadIdx.x; i < m_sub * ksub; i += THREADS) tab[i] = tb[i];
    __syncthreads();
  }
  const int units = nprobe * tiles_per_list;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int pr = u / tiles_per_list;
    const int row = (u - pr * tiles_per_list) * THREADS + threadIdx.x;
    const long long at = b * nprobe + pr;
    const long long slot = slots[at];
    int count = counts[at];
    count = slot < 0 || slot >= n_planes ? 0 : min(max(count, 0), l_pad);
    const bool live = row < count;
    const uint8_t* src = plane + ((live ? slot : 0) * l_pad + (live ? row : 0)) * static_cast<long long>(m_sub);
    float acc = 0.0f;
    if (whole) {
      if (live) {
        if (VEC) {
          const uint4* words = reinterpret_cast<const uint4*>(src);
          for (int g = 0; g < m_sub / 16; ++g) {
            const uint4 v = __ldg(words + g);
            const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int i = 0; i < 16; ++i)
              acc = __fadd_rn(acc, lookup(tab, g * 16 + i, (w[i >> 2] >> ((i & 3) * 8)) & 0xffu, ksub));
          }
        } else {
          for (int j = 0; j < m_sub; ++j) acc = __fadd_rn(acc, lookup(tab, j, src[j], ksub));
        }
      }
    } else {
      // a table wider than the shared stage: its parts in turn, the running
      // sum in a register (the loop is uniform over the block)
      for (int j0 = 0; j0 < m_sub; j0 += j_stage) {
        const int jn = min(j_stage, m_sub - j0);
        __syncthreads();  // every thread is done with the previous part
        for (int i = threadIdx.x; i < jn * ksub; i += THREADS) tab[i] = tb[static_cast<long long>(j0) * ksub + i];
        __syncthreads();
        if (live)
          for (int j = 0; j < jn; ++j) acc = __fadd_rn(acc, lookup(tab, j, src[j0 + j], ksub));
      }
    }
    if (row < l_pad) out[at * l_pad + row] = live ? acc : __int_as_float(0x7f800000);
  }
}

// ---------------------------------------------------------------------------
// lut_accumulate_kernel (the fast-scan form)
// ---------------------------------------------------------------------------

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

// The probed kernel's table stage for a table of m_sub x ksub: subspaces a
// stage (all of them when the table fits) and the dynamic shared memory a
// block, <= 48 KB.
struct ProbedStage {
  bool whole;
  int j_stage;
  int smem;
};

ProbedStage probed_stage(long long m_sub, long long ksub) {
  ProbedStage st;
  st.whole = m_sub * ksub <= PROBED_TABLE_FLOATS;
  st.j_stage = static_cast<int>(st.whole ? (m_sub > 0 ? m_sub : 1) : PROBED_TABLE_FLOATS / ksub);
  const int table_floats = st.whole ? static_cast<int>(m_sub * ksub) : st.j_stage * static_cast<int>(ksub);
  st.smem = static_cast<int>(sizeof(float)) * (table_floats > 0 ? table_floats : 1);
  return st;
}

int launch_probed(const void* tables, const void* plane, const void* slots, const void* counts, void* out,
                  long long nb, long long nprobe, long long n_planes, long long l_pad, long long m_sub,
                  long long ksub, int vec, long long splits, void* stream) {
  constexpr long long LIMIT = 0x7fffffffLL;
  const long long tiles = (l_pad + THREADS - 1) / THREADS;
  if (nb < 0 || nprobe < 0 || n_planes < 0 || l_pad < 0 || m_sub < 0 || ksub < 1 || ksub > 256 ||
      m_sub > LIMIT || l_pad > LIMIT || nprobe * tiles > LIMIT || (vec && m_sub % 16 != 0) || splits < 1 ||
      splits > LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0 || nprobe == 0 || l_pad == 0) return 0;
  const ProbedStage st = probed_stage(m_sub, ksub);
  const int j_stage = st.j_stage, smem = st.smem;
  const int vec_here = vec && st.whole;  // the staged parts read bytes
  const long long units = nprobe * tiles;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const float*>(tables);
  const auto* c = static_cast<const uint8_t*>(plane);
  const auto* sl = static_cast<const long long*>(slots);
  const auto* cn = static_cast<const int32_t*>(counts);
  auto* o = static_cast<float*>(out);
  for (long long b0 = 0; b0 < nb; b0 += MAX_GRID_Y) {
    const dim3 grid(static_cast<unsigned int>(splits < units ? splits : units),
                    static_cast<unsigned int>(nb - b0 < MAX_GRID_Y ? nb - b0 : MAX_GRID_Y));
    if (vec_here)
      probed_lut_kernel<true><<<grid, THREADS, smem, s>>>(t, c, sl, cn, o, b0, static_cast<int>(nprobe), n_planes,
                                                          static_cast<int>(l_pad), static_cast<int>(m_sub),
                                                          static_cast<int>(ksub), j_stage, static_cast<int>(tiles));
    else
      probed_lut_kernel<false><<<grid, THREADS, smem, s>>>(t, c, sl, cn, o, b0, static_cast<int>(nprobe), n_planes,
                                                           static_cast<int>(l_pad), static_cast<int>(m_sub),
                                                           static_cast<int>(ksub), j_stage, static_cast<int>(tiles));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// tables (nb, m_sub, ksub <= 256) f32, plane (n_planes, l_pad, m_sub) uint8,
// slots (nb, nprobe) int64, counts (nb, nprobe) int32, out (nb, nprobe,
// l_pad) f32: row r of probe p is the sum over plane[slots[b, p], r] when
// r < counts[b, p] (clamped to [0, l_pad]; 0 for a slot outside
// [0, n_planes)), else +inf.  vec != 0 when m_sub % 16 == 0 and plane is
// 16-byte aligned; `splits` blocks a query (the caller sizes them from
// srml_lut_probed_occupancy).
extern "C" int srml_lut_accumulate_probed_f32(const void* tables, const void* plane, const void* slots,
                                              const void* counts, void* out, long long nb, long long nprobe,
                                              long long n_planes, long long l_pad, long long m_sub,
                                              long long ksub, int vec, long long splits, void* stream) {
  return launch_probed(tables, plane, slots, counts, out, nb, nprobe, n_planes, l_pad, m_sub, ksub, vec, splits,
                       stream);
}

// Blocks of the probed kernel that one SM holds at once for a table of
// m_sub x ksub <= 256 (the instance `vec` picks, at its shared memory), into
// *blocks; returns a CUDA error code.  The caller sizes `splits` from it.
extern "C" int srml_lut_probed_occupancy(long long m_sub, long long ksub, int vec, int* blocks) {
  if (m_sub < 1 || ksub < 1 || ksub > 256 || (vec && m_sub % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const ProbedStage st = probed_stage(m_sub, ksub);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, vec && st.whole ? probed_lut_kernel<true> : probed_lut_kernel<false>, THREADS, st.smem));
}

// tables (nb, m_sub, ksub <= 256) f32, codes (nb, r, m_sub) uint8, out
// (nb, r) f32: the probed kernel with each query its own plane of one list
// of r rows; slots (nb,) int64 = 0 .. nb - 1 and counts (nb,) int32 = r,
// made by the caller.  vec and splits as above.
extern "C" int srml_lut_accumulate_f32(const void* tables, const void* codes, const void* slots,
                                       const void* counts, void* out, long long nb, long long r, long long m_sub,
                                       long long ksub, int vec, long long splits, void* stream) {
  return launch_probed(tables, codes, slots, counts, out, nb, 1, nb, r, m_sub, ksub, vec, splits, stream);
}

// tables (nb, m_sub, ksub <= 16) f32, packed (nb, r, m_sub / 2) uint8,
// out (nb, r) f32; vec != 0 when (m_sub / 2) % 16 == 0 and packed is 16-byte
// aligned.
extern "C" int srml_fastscan_accumulate_f32(const void* tables, const void* packed, void* out, long long nb,
                                            long long r, long long m_sub, long long ksub, int vec,
                                            void* stream) {
  return launch<true>(tables, packed, out, nb, r, m_sub, ksub, vec, stream);
}
