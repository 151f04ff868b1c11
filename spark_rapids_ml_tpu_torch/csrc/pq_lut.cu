// IVF-PQ asymmetric-distance (ADC) lookup-table accumulation for Hopper
// (sm_90a):
//
//     out[b, r] = sum_j T[b, j, code(b, r, j)]        j = 0 .. m_sub - 1
//
// summed in j order in fp32, each term an exact table read; a code >= ksub
// adds 0.0.  Two kernels, both reading each query's probed lists in place
// from a plane of lists at the query's slots, +inf past a list's count:
//   - probed_lut_kernel (srml_lut_accumulate_probed_f32): one byte per code, T
//     (B, m_sub, ksub <= 256), plane (n_planes, L_pad, m_sub) uint8.
//     Replaces the TPU kernel spark_rapids_ml_tpu/ops/pallas_pq.py::
//     _lut_accum_kernel (wrapper _lut_accumulate_pallas);
//   - fastscan_probed_kernel (srml_fastscan_accumulate_probed_f32): two 4-bit
//     codes a byte, plane (n_planes, L_pad, m_sub / 2) uint8 with code j in
//     the low nibble of byte j / 2 when j is even and in the high nibble
//     when j is odd, T (B, m_sub, ksub <= 16).  Replaces spark_rapids_ml_tpu/
//     ops/pallas_pq.py::_fastscan_kernel (wrapper _fastscan_pallas).
//
// Exactness is the contract: the sum is sequential in j with __fadd_rn (no
// contraction, no reassociation; the build has no fast-math), so the kernels
// equal their plain versions (an explicit loop over j of gather + add), the
// JAX package's numpy oracle and its interpret-mode Pallas kernels bit for
// bit.  The TPU kernels gather by a compare-select sweep over the ksub table
// lanes (Mosaic has no vector gather); here a lookup is a shared-memory read
// (one-byte codes) or a warp shuffle (4-bit codes).
//
// What bounds them on the card: bytes.  Per valid row they read m_sub code
// bytes (m_sub / 2 packed); every output row is written (4 bytes); the
// tables are read once per block.
//
// Both kernels share the probed design:
//   - the ANN search probes nprobe lists of L_pad slots per query, and most
//     slots lie past their list's count (~69% at the ANN arms' 158 x 2048).
//     The kernel reads each probed list's codes where the index keeps them
//     (no gathered copy) and only the rows below the list's count; every
//     other row gets +inf, and so does every row of a slot outside
//     [0, n_planes);
//   - a contiguous tile (B, R, m_bytes) is a plane of B lists, each query
//     probing its own list of R rows (the wrappers' contiguous forms);
//   - the grid is (blocks a query, queries): as many blocks a query as the
//     card holds at once across the queries (the caller's count, from
//     srml_*_occupancy), each taking its query's table once and walking the
//     query's (list, row-tile) units.
//
// probed_lut_kernel: the block stages its query's whole table in shared
// memory ([j][c], up to 48 KB; a wider table is staged in parts per tile)
// and walks 256-row units, one row a thread: its codes as 16-byte vector
// loads when the row width is a multiple of 16 bytes and the plane 16-byte
// aligned (two loads a row at m_sub 32), else byte by byte, then the j loop
// of shared-memory lookups.  The lanes of a warp look up one j at random
// codes, which conflicts on shared-memory banks (~3.5-way for uniform
// codes); a layout with the lanes on different j needs a row's sum to pass
// between lanes (a shuffle a term), which costs the shared-memory pipe
// about as much.
//
// fastscan_probed_kernel: ksub <= 16, so the table lives in registers: lane
// l holds T[j][l & 15] for the 32 subspaces of a chunk (16 packed bytes),
// and a lookup is __shfl_sync(t[j], code), which moves bits exactly and has
// no banks to conflict on.  The source lane is the packed word shifted to
// nibble j, unmasked: the shuffle reads only its low 5 bits, code j and one
// bit of the next nibble, which picks lane code or code + 16, and both hold
// T[j][code] (lanes past ksub hold 0.0, so a code >= ksub adds 0.0).  Each
// warp walks its own contiguous run of the query's (list, 32 x FS_ROWS-row)
// units, so the lists' valid rows spread evenly over the warps; a lane
// carries FS_ROWS = 4 rows 32 apart (coalesced 16-byte loads: the warp
// reads 512 contiguous bytes a row set, all 4 loads issued before the
// first lookup) and stores each sum as one float of a coalesced 128-byte
// row.  Row sets wholly past the count skip their loads and lookups.
// Blocks of 128 threads held to 80 registers, 6 an SM (the occupancy
// calculator sizes the blocks a query from that).  m_sub > 32 reloads the
// register table per chunk and unit (no caller has it).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;         // rows per block, one a thread
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
// fastscan_probed_kernel
// ---------------------------------------------------------------------------

constexpr int FS_THREADS = 128;
constexpr int FS_BLOCKS_AN_SM = 6;  // __launch_bounds__' floor: at most 80 registers a thread
constexpr int FS_WARPS = FS_THREADS / 32;
constexpr int FS_CHUNK = 32;  // subspaces of one register table: 16 packed bytes a row
constexpr int FS_ROWS = 4;    // rows a lane carries (32 x FS_ROWS rows a warp unit)

// The register table of subspaces j0 .. j0 + jn - 1: t[i] = T[j0 + i][lane & 15],
// 0.0 where lane & 15 >= ksub.
__device__ __forceinline__ void fs_table(float (&t)[FS_CHUNK], const float* tb, int j0, int jn, int ksub,
                                         int lane) {
  const int c = lane & 15;
#pragma unroll
  for (int i = 0; i < FS_CHUNK; ++i) t[i] = i < jn && c < ksub ? __ldg(tb + (j0 + i) * ksub + c) : 0.0f;
}

// One row's packed bytes of a chunk (<= 16 of them) as four words.
template <bool VEC>
__device__ __forceinline__ uint4 fs_codes(const uint8_t* src, int nbytes) {
  if (VEC) return __ldg(reinterpret_cast<const uint4*>(src));
  unsigned long long lo = 0, hi = 0;
  for (int q = 0; q < nbytes; ++q) {
    const unsigned long long v = __ldg(src + q);
    if (q < 8)
      lo |= v << (8 * q);
    else
      hi |= v << (8 * (q - 8));
  }
  return make_uint4(static_cast<uint32_t>(lo), static_cast<uint32_t>(lo >> 32), static_cast<uint32_t>(hi),
                    static_cast<uint32_t>(hi >> 32));
}

// acc + the chunk's jn terms in j order (FULL: jn == FS_CHUNK).
template <bool FULL>
__device__ __forceinline__ float fs_sum(float acc, const float (&t)[FS_CHUNK], uint4 v, int jn) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < FS_CHUNK; ++j) {
    if (!FULL && j >= jn) break;  // uniform over the warp
    acc = __fadd_rn(acc, __shfl_sync(0xffffffffu, t[j], static_cast<int>(w[j >> 3] >> ((j & 7) * 4))));
  }
  return acc;
}

template <bool VEC>
__global__ void __launch_bounds__(FS_THREADS, FS_BLOCKS_AN_SM) fastscan_probed_kernel(
    const float* __restrict__ tables, const uint8_t* __restrict__ plane, const long long* __restrict__ slots,
    const int32_t* __restrict__ counts, float* __restrict__ out, long long b0, int nprobe, long long n_planes,
    int l_pad, int m_sub, int ksub) {
  constexpr int TILE = 32 * FS_ROWS;
  const int lane = threadIdx.x & 31;
  const long long b = b0 + blockIdx.y;
  const float* tb = tables + b * static_cast<long long>(m_sub) * ksub;
  const int m_bytes = m_sub >> 1;
  const int chunks = (m_sub + FS_CHUNK - 1) / FS_CHUNK;
  float t[FS_CHUNK];
  if (chunks == 1) fs_table(t, tb, 0, m_sub, ksub, lane);
  // this warp's contiguous run of the query's (list, row-tile) units
  const int tiles = (l_pad + TILE - 1) / TILE;
  const long long units = static_cast<long long>(nprobe) * tiles;
  const long long warps = static_cast<long long>(gridDim.x) * FS_WARPS;
  const long long gw = static_cast<long long>(blockIdx.x) * FS_WARPS + (threadIdx.x >> 5);
  const long long u_end = (gw + 1) * units / warps;
  int p_at = -1, count = 0;
  const uint8_t* list = plane;
  for (long long u = gw * units / warps; u < u_end; ++u) {
    const int p = static_cast<int>(u / tiles);
    const int row0 = static_cast<int>(u - static_cast<long long>(p) * tiles) * TILE;
    if (p != p_at) {
      p_at = p;
      const long long slot = slots[b * nprobe + p];
      const int c = counts[b * nprobe + p];
      count = slot < 0 || slot >= n_planes ? 0 : min(max(c, 0), l_pad);
      list = plane + (count > 0 ? slot : 0) * static_cast<long long>(l_pad) * m_bytes;
    }
    float acc[FS_ROWS];
#pragma unroll
    for (int k = 0; k < FS_ROWS; ++k) acc[k] = 0.0f;
    if (row0 < count) {
      for (int ch = 0; ch < chunks; ++ch) {
        const int j0 = ch * FS_CHUNK, jn = min(FS_CHUNK, m_sub - j0);
        if (chunks > 1) fs_table(t, tb, j0, jn, ksub, lane);
        uint4 v[FS_ROWS];
#pragma unroll
        for (int k = 0; k < FS_ROWS; ++k) {
          const int row = row0 + k * 32 + lane;
          v[k] = row < count ? fs_codes<VEC>(list + static_cast<long long>(row) * m_bytes + j0 / 2, jn / 2)
                             : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int k = 0; k < FS_ROWS; ++k)
          if (row0 + k * 32 < count) acc[k] = fs_sum<VEC>(acc[k], t, v[k], jn);
      }
    }
    float* o = out + (b * nprobe + p) * static_cast<long long>(l_pad);
#pragma unroll
    for (int k = 0; k < FS_ROWS; ++k) {
      const int row = row0 + k * 32 + lane;
      if (row < l_pad) o[row] = row < count ? acc[k] : __int_as_float(0x7f800000);
    }
  }
}

int fastscan_invalid(long long nb, long long nprobe, long long n_planes, long long l_pad, long long m_sub,
                     long long ksub, int vec, long long splits) {
  constexpr long long LIMIT = 0x7fffffffLL;
  return nb < 0 || nprobe < 0 || n_planes < 0 || l_pad < 0 || m_sub < 0 || m_sub % 2 != 0 || ksub < 1 ||
         ksub > 16 || m_sub > LIMIT / 16 || l_pad > LIMIT - 32 * FS_ROWS ||
         nprobe * ((l_pad + 32 * FS_ROWS - 1) / (32 * FS_ROWS)) > LIMIT || (vec && m_sub % 32 != 0) ||
         splits < 1 || splits > LIMIT;
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

// tables (nb, m_sub even, ksub <= 16) f32, plane (n_planes, l_pad, m_sub / 2)
// uint8 packed codes, slots (nb, nprobe) int64, counts (nb, nprobe) int32,
// out (nb, nprobe, l_pad) f32: row r of probe p is the sum over
// plane[slots[b, p], r] when r < counts[b, p] (clamped to [0, l_pad]; 0 for
// a slot outside [0, n_planes)), else +inf.  vec != 0 when m_sub % 32 == 0
// (16 packed bytes a chunk) and plane is 16-byte aligned; `splits` blocks a
// query (the caller sizes them from srml_fastscan_probed_occupancy).  The
// contiguous form (nb, r, m_sub / 2) is this entry with nprobe 1, n_planes
// nb, l_pad r, slots b and counts r.
extern "C" int srml_fastscan_accumulate_probed_f32(const void* tables, const void* plane, const void* slots,
                                                   const void* counts, void* out, long long nb, long long nprobe,
                                                   long long n_planes, long long l_pad, long long m_sub,
                                                   long long ksub, int vec, long long splits, void* stream) {
  if (fastscan_invalid(nb, nprobe, n_planes, l_pad, m_sub, ksub, vec, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0 || nprobe == 0 || l_pad == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long units = nprobe * ((l_pad + 32 * FS_ROWS - 1) / (32 * FS_ROWS));
  const long long blocks = (units + FS_WARPS - 1) / FS_WARPS;
  const auto* t = static_cast<const float*>(tables);
  const auto* c = static_cast<const uint8_t*>(plane);
  const auto* sl = static_cast<const long long*>(slots);
  const auto* cn = static_cast<const int32_t*>(counts);
  auto* o = static_cast<float*>(out);
  for (long long b0 = 0; b0 < nb; b0 += MAX_GRID_Y) {
    const dim3 grid(static_cast<unsigned int>(splits < blocks ? splits : blocks),
                    static_cast<unsigned int>(nb - b0 < MAX_GRID_Y ? nb - b0 : MAX_GRID_Y));
    const int np = static_cast<int>(nprobe), lp = static_cast<int>(l_pad), ms = static_cast<int>(m_sub),
              ks = static_cast<int>(ksub);
    if (vec)
      fastscan_probed_kernel<true><<<grid, FS_THREADS, 0, s>>>(t, c, sl, cn, o, b0, np, n_planes, lp, ms, ks);
    else
      fastscan_probed_kernel<false><<<grid, FS_THREADS, 0, s>>>(t, c, sl, cn, o, b0, np, n_planes, lp, ms, ks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Blocks of the fast-scan kernel that one SM holds at once (the instance
// `vec` picks), into *blocks; returns a CUDA error code.
extern "C" int srml_fastscan_probed_occupancy(int vec, int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, vec ? fastscan_probed_kernel<true> : fastscan_probed_kernel<false>, FS_THREADS, 0));
}
