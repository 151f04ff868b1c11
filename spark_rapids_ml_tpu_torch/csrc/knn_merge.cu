// Fused merge of the exact-kNN candidate pool for Hopper (sm_90a).  For each
// query row of a pool of P = ng * m (value = -d2, position) pairs, laid out
// as ng groups of m (csrc/knn_topm.cu):
//
//   - the top k pairs by (value descending, pool slot ascending), which on
//     the pool's finite values is the unique lexicographic (-d2, position)
//     order: slots rise with position among equal values;
//   - dist = sqrt(max(-value, 0)) and the positions of those k (ranks past
//     the pool read as -inf, position 0);
//   - the margined threshold tu = t + (|t| * 1e-6 + 1e-30) of the k-th value
//     t (tu = t when t is not finite), the overflow flag "some group's m-th
//     kept value > tu", and the count of kept values > tu (the audit compares
//     it with the count kernel's).
//
// Replaces the TPU kernel spark_rapids_ml_tpu/ops/pallas_knn.py::
// _knn_fused_merge_kernel (wrapper knn_fused_pallas), which runs k iterated
// first-occurrence argmax passes over a VMEM-resident pool tile.
//
// What bounds it on the card: it reads the pool once (8 bytes a pair) and
// writes 8 bytes per kept neighbour; there are no flops to speak of, so it
// is bound by bytes: ~0.07 ms for an 8192-query block at the kNN flagship
// (P = 3519).
//
// Design, simple first: one block per query row, any P and any k.  Each pair
// is a 64-bit key (order-preserving bits of the value, inverted for
// descending order, above the slot index); keys are unique, so every rank
// names one pair and the result is fully determined.  The kept ranks
// [0, min(k, P)) are taken in windows of WINDOW ranks: an MSD radix select
// (8 bits a pass over the row's keys, read from global memory, with a
// 256-bin shared histogram) finds the window's last key, the keys between
// the previous window's last key and it (exactly the window's ranks) are
// gathered into shared memory, and a bitonic network sorts them.  The
// rank-k key gives the threshold.  For the flagship's k = 200 that is one
// window of 256 sorted keys and a few select passes over 3,519 keys, where a
// sort of the whole pool would order 4,096.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WINDOW = 4096;  // ranks sorted at once: 32 KB of keys
constexpr int THREADS = 256;
constexpr unsigned long long PAD_KEY = ~0ull;  // above every key: slots < 2^31

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Order-preserving bits of v, inverted: smaller key = larger v.  -0 and +0
// are one value, as in the plain version's comparisons.
__device__ __forceinline__ uint32_t desc_bits(float v) {
  if (v == 0.0f) v = 0.0f;
  uint32_t u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ~u;
}

__device__ __forceinline__ unsigned long long key_of(const float* v, int i) {
  return (static_cast<unsigned long long>(desc_bits(v[i])) << 32) | static_cast<uint32_t>(i);
}

struct SelectState {
  unsigned int hist[256];
  unsigned long long prefix;
  unsigned long long found;
  int rank;
  int unique;
};

// The rank-th smallest (1-based) of the row's p keys.  Each pass fixes the
// next 8 bits of the answer from a histogram of the keys that agree with the
// bits fixed so far; once the chosen bin holds one key, one more pass reads
// it.  Called by the whole block; ends synchronised.
__device__ unsigned long long select_key(const float* v, int p, int rank, SelectState& s) {
  unsigned long long prefix = 0, mask = 0;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int b = threadIdx.x; b < 256; b += blockDim.x) s.hist[b] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < p; i += blockDim.x) {
      const unsigned long long key = key_of(v, i);
      if ((key & mask) == prefix) atomicAdd(&s.hist[(key >> shift) & 255], 1u);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int r = rank, digit = 0;
      while (static_cast<int>(s.hist[digit]) < r) r -= s.hist[digit++];
      s.prefix = prefix | (static_cast<unsigned long long>(digit) << shift);
      s.rank = r;
      s.unique = s.hist[digit] == 1;
    }
    __syncthreads();
    prefix = s.prefix;
    rank = s.rank;
    mask |= 255ull << shift;
    if (s.unique) {
      if (shift == 0) return prefix;
      for (int i = threadIdx.x; i < p; i += blockDim.x) {
        const unsigned long long key = key_of(v, i);
        if ((key & mask) == prefix) s.found = key;
      }
      __syncthreads();
      const unsigned long long found = s.found;
      __syncthreads();  // s is rewritten by the next call
      return found;
    }
  }
  return prefix;
}

__global__ void __launch_bounds__(THREADS)
knn_fused_merge_kernel(const float* __restrict__ pool_v, const int32_t* __restrict__ pool_p,
                       float* __restrict__ dist, int32_t* __restrict__ pos,
                       int32_t* __restrict__ flags, float* __restrict__ thresh,
                       int32_t* __restrict__ above, int p, int k, int m) {
  __shared__ unsigned long long keys[WINDOW];
  __shared__ SelectState s;
  __shared__ int n_keys, n_above;
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  const float* v = pool_v + row * p;
  const int32_t* pp = pool_p + row * p;
  float* d_out = dist + row * k;
  int32_t* p_out = pos + row * k;

  const int kept = k < p ? k : p;
  const unsigned long long kth = k <= p ? select_key(v, p, k, s) : PAD_KEY;
  const float t = k <= p ? v[kth & 0xffffffffu] : neg_inf();
  const float tu = isfinite(t) ? __fadd_rn(t, __fadd_rn(__fmul_rn(fabsf(t), 1e-6f), 1e-30f)) : t;
  if (tid == 0) n_above = 0;

  int mine = 0;
  unsigned long long lo = 0;
  for (int r0 = 0; r0 < kept; r0 += WINDOW) {
    const int r1 = kept - r0 > WINDOW ? r0 + WINDOW : kept;
    const unsigned long long hi = r1 == k ? kth : select_key(v, p, r1, s);
    if (tid == 0) n_keys = 0;
    __syncthreads();
    for (int i = tid; i < p; i += blockDim.x) {
      const unsigned long long key = key_of(v, i);
      if ((r0 == 0 || key > lo) && key <= hi) {
        const int at = atomicAdd(&n_keys, 1);
        if (at < WINDOW) keys[at] = key;  // exactly r1 - r0 keys: keys are unique
      }
    }
    const int cnt = r1 - r0;
    int p_pad = 1;
    while (p_pad < cnt) p_pad <<= 1;
    __syncthreads();
    for (int i = cnt + tid; i < p_pad; i += blockDim.x) keys[i] = PAD_KEY;
    __syncthreads();
    for (int size = 2; size <= p_pad; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = tid; i < p_pad / 2; i += blockDim.x) {
          const int a_at = 2 * i - (i & (stride - 1));
          const int b_at = a_at + stride;
          const unsigned long long a = keys[a_at];
          const unsigned long long b = keys[b_at];
          if ((a > b) == ((a_at & size) == 0)) {
            keys[a_at] = b;
            keys[b_at] = a;
          }
        }
        __syncthreads();
      }
    }
    for (int r = tid; r < cnt; r += blockDim.x) {
      const int slot = static_cast<int>(keys[r] & 0xffffffffu);
      const float val = v[slot];
      d_out[r0 + r] = sqrtf(fmaxf(-val, 0.0f));
      p_out[r0 + r] = pp[slot];
      mine += val > tu ? 1 : 0;
    }
    __syncthreads();  // keys is refilled by the next window
    lo = hi;
  }
  for (int r = kept + tid; r < k; r += blockDim.x) {
    d_out[r] = sqrtf(fmaxf(-neg_inf(), 0.0f));
    p_out[r] = 0;
  }
  int overflow = 0;
  for (int g = tid; g < p / m; g += blockDim.x) overflow |= v[g * m + m - 1] > tu ? 1 : 0;
  if (mine) atomicAdd(&n_above, mine);
  const int any = __syncthreads_or(overflow);
  if (tid == 0) {
    flags[row] = any;
    thresh[row] = tu;
    above[row] = n_above;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Launches on `stream`, does not
// synchronise, allocates nothing, returns a CUDA error code (0 on success).
// The caller has checked shapes: 1 <= p, k < 2^31, p % m == 0, nq < 2^31.
extern "C" int srml_knn_fused_merge_f32(const void* pool_v, const void* pool_p, void* dist,
                                        void* pos, void* flags, void* thresh, void* above,
                                        long long nq, long long p, long long k, long long m,
                                        void* stream) {
  constexpr long long LIMIT = 0x7fffffffLL;
  if (p < 1 || p > LIMIT || k < 1 || k > LIMIT || m < 1 || p % m != 0 || nq > LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq <= 0) return 0;
  knn_fused_merge_kernel<<<static_cast<unsigned int>(nq), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pool_v), static_cast<const int32_t*>(pool_p),
      static_cast<float*>(dist), static_cast<int32_t*>(pos), static_cast<int32_t*>(flags),
      static_cast<float*>(thresh), static_cast<int32_t*>(above), static_cast<int>(p),
      static_cast<int>(k), static_cast<int>(m));
  return static_cast<int>(cudaGetLastError());
}
