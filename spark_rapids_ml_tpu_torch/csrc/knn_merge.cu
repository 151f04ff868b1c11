// Fused merge of the exact-kNN and ANN candidate pools for Hopper (sm_90a).
// For each query row of a pool of P = ng * m (value = -d2, position) pairs,
// laid out as ng groups of m (csrc/knn_topm.cu; the ANN probe pools are
// nprobe lists of L_pad slots):
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
// What bounds it on the card: bytes.  The function needs each pool value
// once (4 bytes a slot), the positions of the k kept only, and writes 8
// bytes per kept neighbour and 12 a row: 0.160-0.162 ms at an ANN sweep
// block (414 x 323,584, k 200-1600), 0.040 ms at an exact-kNN flagship
// block (8192 x 3,519, k 200), at 3.35 TB/s; there are no flops to speak
// of.
//
// Two kernels, picked per launch by ops/knn_kernels._merge_route:
//
//   radix_merge_kernel<NT> (NT 256 or 512; k <= RADIX_MAX_K, rows up to MAX_CLUSTER slices
//   of ops/knn_kernels.SLICE_KEYS values): a thread-block cluster of `cl` CTAs of NT threads
//   merges one row, each CTA holding one slice of the row's values in shared
//   memory, so the row is read from device memory once.  Wide rows (the ANN
//   pools, 323,584 slots) take 16 CTAs of 512 threads, ~80 KB of values
//   each, two CTAs an SM; narrow rows (the exact-kNN pools, 3,519-5,880
//   slots) one CTA of 256, several an SM (both measured best on the card).
//   - One thread issues the slice as bulk copies (cp.async.bulk, one
//     mbarrier per 16-KB chunk) and the block histograms each chunk as it
//     lands.
//   - The select runs on the 32-bit order key of the value alone, in passes
//     of 11 / 11 / 10 bits over the staged slices.  It stops as soon as the
//     keys below the chosen bin plus the whole bin fit the 2,048-key sort
//     (usually after the first or second pass): the sort then settles the
//     bin, equal values included, by (key, slot).  Only a bin of equal keys
//     too large for the sort takes its lowest slots by a prefix count in
//     slot order across the cluster.
//   - Histogram increments are warp-aggregated: the lanes that share the
//     first valid lane's bin take one shared atomic (the key's top bits put
//     most of a row, and every -inf slot, in one or two bins).
//   - Each CTA sums the cluster's counts for its own 1/cl of the bins
//     through distributed shared memory; every CTA then scans only the
//     range that holds the rank.
//   - The winners, as 64-bit (key, slot) keys, are written into the first
//     CTA's shared memory and sorted there (bitonic, 2-8 keys a thread in
//     registers, strides under a warp's reach by shuffles, longer ones
//     through shared memory); the positions are read for the kept only.
//
//   window_merge_kernel (larger k or wider rows): the first design, one block
//   a row over 64-bit (key, slot) keys in global memory: an MSD radix select
//   (8 bits a pass, 256-bin shared histogram) finds each window's last key,
//   the window's keys are gathered into shared memory and sorted.  It serves
//   k past one shared window (KNN_WIDE_KS reaches 25,000).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

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

// The bitonic network over n (a power of two) 64-bit keys in shared memory,
// ascending.  Called by the whole block; ends synchronised.
__device__ void bitonic_sort(unsigned long long* keys, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += blockDim.x) {
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
}

// ---------------------------------------------------------------------------
// radix_merge_kernel
// ---------------------------------------------------------------------------

constexpr int RADIX_MAX_K = 2048;      // ranks sorted in the first CTA's shared memory
constexpr int SORT_MIN = 256;          // the sort's least width
constexpr int BINS = 2048;             // 11-bit digits
constexpr int CHUNK_FLOATS = 4096;     // 16 KB a bulk copy
constexpr int MAX_CHUNKS = 16;         // slices of up to 64K values
constexpr int MAX_CLUSTER = 16;        // CTAs a row (non-portable above 8)

// the select's digits: bits 31-21, 20-10 and 9-0 of the key
__device__ __forceinline__ int pass_shift(int pass) { return pass == 0 ? 21 : pass == 1 ? 10 : 0; }
__device__ __forceinline__ int pass_bits(int pass) { return pass == 2 ? 10 : 11; }

struct RadixShared {
  union {
    struct {
      unsigned int hist[BINS];  // this CTA's counts of the current pass
      unsigned int tot[BINS];   // the cluster's counts, for this CTA's 1/cl of the bins
    } h;
    unsigned long long sorted[RADIX_MAX_K];  // the winners (first CTA), once the select is done
  } u;
  unsigned long long bar[MAX_CHUNKS];
  unsigned int red[16];  // one a warp, up to 512 threads
  unsigned int range_sum;
  int rstar;
  unsigned int base;
  int digit;
  unsigned int rank_next, bin_total;
  unsigned int pub_less, pub_ties;  // read by the other CTAs of the cluster
  unsigned int off, take;
  unsigned int n_less, n_tie;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// Add the lanes with `valid` to hist[digit], called by all 32 lanes of a
// warp: the lanes that share the first valid lane's digit with one shared
// atomic, the others one each.  Most of a row's keys fall in one or two bins
// of the first digit (a pool's -inf slots all in one), so most lanes take
// the aggregated add; keys spread over many bins collide little.
__device__ __forceinline__ void hist_add(unsigned int* hist, bool valid, uint32_t digit) {
  const unsigned active = __ballot_sync(0xffffffffu, valid);
  if (active == 0) return;
  const int leader = __ffs(active) - 1;
  const uint32_t lead = __shfl_sync(0xffffffffu, digit, leader);
  const unsigned same = __ballot_sync(0xffffffffu, valid && digit == lead);
  if ((threadIdx.x & 31) == leader)
    atomicAdd(&hist[lead], __popc(same));
  else if (valid && digit != lead)
    atomicAdd(&hist[digit], 1u);
}

// Sum of v over the block, returned to every thread.  Ends synchronised.
template <int NT>
__device__ unsigned int block_sum(unsigned int v, RadixShared& s) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) s.red[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned int total = 0;
  for (int w = 0; w < NT / 32; ++w) total += s.red[w];
  __syncthreads();
  return total;
}

// Exclusive prefix of v over the block in thread order.  Ends synchronised.
template <int NT>
__device__ unsigned int block_exclusive(unsigned int v, RadixShared& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned int x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) s.red[warp] = incl;
  __syncthreads();
  unsigned int before = 0;
  for (int w = 0; w < warp; ++w) before += s.red[w];
  __syncthreads();
  return before + incl - v;
}

// Ascending bitonic sort of n keys in shared memory, n a power of two in
// [SORT_MIN, RADIX_MAX_K], by n / E threads of E keys each (indices
// E t .. E t + E - 1) in registers: strides below E run in registers,
// strides E .. 32 E - 1 across the lanes of a warp by shuffles, and only the
// longer strides through shared memory (a barrier each).  Ends synchronised.
template <int NT, int E>
__device__ void sort_keys_by(unsigned long long* keys, int n) {
  const int t = threadIdx.x;
  const bool act = t < n / E;  // whole warps: n / E is a multiple of 32
  unsigned long long x[E];
  if (act) {
#pragma unroll
    for (int e = 0; e < E; ++e) x[e] = keys[t * E + e];
  }
  for (int size = 2; size <= n; size <<= 1) {
    int d = size >> 1;
    if (d >= 32 * E) {
      if (act) {
#pragma unroll
        for (int e = 0; e < E; ++e) keys[t * E + e] = x[e];
      }
      __syncthreads();
      for (; d >= 32 * E; d >>= 1) {
        for (int i = t; i < n / 2; i += NT) {
          const int a_at = 2 * i - (i & (d - 1));
          const int b_at = a_at + d;
          const unsigned long long a = keys[a_at], b = keys[b_at];
          if ((a > b) == ((a_at & size) == 0)) {
            keys[a_at] = b;
            keys[b_at] = a;
          }
        }
        __syncthreads();
      }
      if (act) {
#pragma unroll
        for (int e = 0; e < E; ++e) x[e] = keys[t * E + e];
      }
    }
    if (act) {
      for (; d >= E; d >>= 1) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int i = t * E + e;
          const unsigned long long y = __shfl_xor_sync(0xffffffffu, x[e], d / E);
          const bool keep_min = ((i & d) == 0) == ((i & size) == 0);
          x[e] = keep_min ? (x[e] < y ? x[e] : y) : (x[e] < y ? y : x[e]);
        }
      }
#pragma unroll
      for (int dd = E / 2; dd >= 1; dd >>= 1) {
        if (dd < size) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            if ((e & dd) == 0) {
              const bool up = ((t * E + e) & size) == 0;
              const unsigned long long a = x[e], b = x[e | dd];
              if ((a > b) == up) {
                x[e] = b;
                x[e | dd] = a;
              }
            }
          }
        }
      }
    }
  }
  if (act) {
#pragma unroll
    for (int e = 0; e < E; ++e) keys[t * E + e] = x[e];
  }
  __syncthreads();
}

// The sort above with as many threads as the width takes two keys each, up
// to the block: 2, 4 or 8 keys a thread.
template <int NT>
__device__ void sort_keys(unsigned long long* keys, int n) {
  if (n <= 2 * NT)
    sort_keys_by<NT, 2>(keys, n);
  else if (n <= 4 * NT)
    sort_keys_by<NT, 4>(keys, n);
  else
    sort_keys_by<NT, 8>(keys, n);
}

// The four staged values of float4 word j of the slice (element i of the
// slice at sl[off + i]): their order keys and whether each is in the slice.
struct Quad {
  uint32_t key[4];
  bool ok[4];
  int i0;  // the slice index of the first
};

__device__ __forceinline__ Quad quad_at(const float* sl, int j, int nv, int off, int n) {
  Quad q;
  const float4 x = j < nv ? reinterpret_cast<const float4*>(sl)[j] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float xs[4] = {x.x, x.y, x.z, x.w};
  q.i0 = 4 * j - off;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    q.key[c] = desc_bits(xs[c]);
    q.ok[c] = j < nv && q.i0 + c >= 0 && q.i0 + c < n;
  }
  return q;
}

template <int NT>
__global__ void __launch_bounds__(NT)
radix_merge_kernel(const float* __restrict__ pool_v, const int32_t* __restrict__ pool_p,
                   float* __restrict__ dist, int32_t* __restrict__ pos, int32_t* __restrict__ flags,
                   float* __restrict__ thresh, int32_t* __restrict__ above, int p, int k, int m, int slice) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ RadixShared s;
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int crank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const long long row = blockIdx.x / cl;
  const float* v = pool_v + row * p;
  const int sel = k < p ? k : p;  // ranks kept

  // ---- stage the slice [lo, lo + n) of the row: element i at sl[off + i]
  const int lo = crank * slice;
  const int n = lo < p ? min(slice, p - lo) : 0;
  const float* src = v + lo;
  float* sl = reinterpret_cast<float*>(dyn);
  const int off = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const int head = min(n, (4 - off) & 3);  // values before the first 16-byte boundary
  const int body = (n - head) & ~3;
  const int tail = n - head - body;
  const int nchunks = (body + CHUNK_FLOATS - 1) / CHUNK_FLOATS;
  const int nv = (off + n + 3) >> 2;  // float4 words that cover the slice
  if (tid == 0) {
    for (int c = 0; c < nchunks; ++c) mbar_init(&s.bar[c], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    s.n_less = 0;
    s.n_tie = 0;
  }
  for (int b = tid; b < BINS; b += NT) s.u.h.hist[b] = 0;
  __syncthreads();
  if (tid == 0) {
    for (int c = 0; c < nchunks; ++c) {
      const int count = min(CHUNK_FLOATS, body - c * CHUNK_FLOATS);
      const uint32_t bytes = static_cast<uint32_t>(count) * 4u;
      mbar_expect_tx(&s.bar[c], bytes);
      bulk_load(sl + off + head + c * CHUNK_FLOATS, src + head + c * CHUNK_FLOATS, bytes, &s.bar[c]);
    }
  }

  // ---- pass 0 over the arriving slice: histogram of the top 11 bits
  if (warp == 0) {
    const bool valid = lane < head + tail;
    uint32_t key = 0;
    if (valid) {
      const int i = lane < head ? lane : body + lane;  // head, then tail
      const float x = src[i];
      sl[off + i] = x;
      key = desc_bits(x);
    }
    hist_add(s.u.h.hist, valid, key >> 21);
  }
  for (int c = 0; c < nchunks; ++c) {
    const int count4 = min(CHUNK_FLOATS, body - c * CHUNK_FLOATS) / 4;
    const float4* q = reinterpret_cast<const float4*>(sl + off + head + c * CHUNK_FLOATS);
    mbar_wait(&s.bar[c], 0);
    for (int base = warp * 32; base < count4; base += NT) {
      const int i4 = base + lane;
      const bool valid = i4 < count4;
      const float4 x = valid ? q[i4] : make_float4(0.f, 0.f, 0.f, 0.f);
      hist_add(s.u.h.hist, valid, desc_bits(x.x) >> 21);
      hist_add(s.u.h.hist, valid, desc_bits(x.y) >> 21);
      hist_add(s.u.h.hist, valid, desc_bits(x.z) >> 21);
      hist_add(s.u.h.hist, valid, desc_bits(x.w) >> 21);
    }
  }

  // ---- the select: the bucket (keys whose top bits equal `prefix`) that
  // holds rank `rank`, narrowed a digit a pass
  const int bw = BINS / cl;  // bins whose cluster totals this CTA sums
  uint32_t prefix = 0;
  unsigned int rank = static_cast<unsigned int>(sel);
  unsigned int less_local = 0;  // this slice's keys in buckets below the chosen one
  unsigned int bin_total = 0;
  int shift = 0, digit = 0;
  for (int pass = 0; pass < 3; ++pass) {
    shift = pass_shift(pass);
    if (pass > 0) {
      const int hi_shift = shift + pass_bits(pass);
      const uint32_t mask = (1u << pass_bits(pass)) - 1u;
      for (int b = tid; b < BINS; b += NT) s.u.h.hist[b] = 0;
      __syncthreads();
      for (int base = warp * 32; base < nv; base += NT) {
        const Quad q = quad_at(sl, base + lane, nv, off, n);
        bool in[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) in[c] = q.ok[c] && (q.key[c] >> hi_shift) == prefix;
        if (__any_sync(0xffffffffu, in[0] || in[1] || in[2] || in[3])) {
#pragma unroll
          for (int c = 0; c < 4; ++c) hist_add(s.u.h.hist, in[c], (q.key[c] >> shift) & mask);
        }
      }
    }
    cluster.sync();  // every slice's histogram is complete

    // the counts to scan for the bin that holds the rank: one CTA's own are
    // the row's; on a cluster, the totals of the CTA whose bin range holds it
    const unsigned int* tot = s.u.h.hist;
    unsigned int target = rank;
    int bin0 = 0, nbins = BINS;
    if (cl > 1) {
      // cluster totals of this CTA's bins [crank * bw, (crank + 1) * bw)
      unsigned int mine = 0;
      for (int b = tid; b < bw; b += NT) {
        const int bin = crank * bw + b;
        unsigned int t = 0;
#pragma unroll 4
        for (int r = 0; r < cl; ++r) t += cluster.map_shared_rank(s.u.h.hist, r)[bin];
        s.u.h.tot[bin] = t;
        mine += t;
      }
      mine = block_sum<NT>(mine, s);
      if (tid == 0) s.range_sum = mine;
      cluster.sync();  // every CTA's totals are complete
      if (warp == 0) {
        const unsigned int x = lane < cl ? *cluster.map_shared_rank(&s.range_sum, lane) : 0u;
        unsigned int incl = x;
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned int y = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += y;
        }
        if (lane < cl && incl - x < rank && rank <= incl) {
          s.rstar = lane;
          s.base = incl - x;
        }
      }
      __syncthreads();
      bin0 = s.rstar * bw;
      nbins = bw;
      target = rank - s.base;
      tot = cluster.map_shared_rank(s.u.h.tot, s.rstar) + bin0;
    }
    const int per = (nbins + NT - 1) / NT;
    unsigned int part = 0;
    for (int j = 0; j < per; ++j) {
      const int b = tid * per + j;
      if (b < nbins) part += tot[b];
    }
    const unsigned int before = block_exclusive<NT>(part, s);
    if (before < target && target <= before + part) {
      unsigned int c = before;
      for (int j = 0; j < per; ++j) {
        const int b = tid * per + j;
        const unsigned int t = tot[b];
        if (target <= c + t) {
          s.digit = bin0 + b;
          s.rank_next = target - c;
          s.bin_total = t;
          break;
        }
        c += t;
      }
    }
    __syncthreads();
    digit = s.digit;
    if (cl == 1) {
      less_local += rank - s.rank_next;  // the bucket's keys in lower bins
    } else {
      unsigned int below = 0;
      for (int b = tid; b < digit; b += NT) below += s.u.h.hist[b];
      less_local += block_sum<NT>(below, s);
    }
    rank = s.rank_next;
    bin_total = s.bin_total;
    prefix = (prefix << pass_bits(pass)) | static_cast<uint32_t>(digit);
    // stop once the keys below the bucket and all of the bucket fit the
    // sort, which then settles the bucket by (key, slot)
    if (sel - rank + bin_total <= RADIX_MAX_K) break;
  }
  // Selected: every key with (key >> shift) < prefix, and the `rank` lowest
  // slots among those with (key >> shift) == prefix: all of the bucket goes
  // to the sort when it fits, else (equal keys past it, after the last
  // pass) only the `rank` lowest slots, taken in slot order.
  const bool whole_bucket = sel - rank + bin_total <= RADIX_MAX_K;
  const int gathered = whole_bucket ? static_cast<int>(sel - rank + bin_total) : sel;

  if (tid == 0) {
    s.pub_less = less_local;
    s.pub_ties = s.u.h.hist[digit];
  }
  cluster.sync();  // counts published; every histogram read is done
  if (tid == 0) {
    unsigned int out_off = 0, ties_before = 0, take = 0;
    for (int r = 0; r < cl; ++r) {
      const unsigned int lr = *cluster.map_shared_rank(&s.pub_less, r);
      const unsigned int tr = *cluster.map_shared_rank(&s.pub_ties, r);
      const unsigned int left = rank > ties_before ? rank - ties_before : 0u;
      const unsigned int tk = whole_bucket || tr < left ? tr : left;
      if (r < crank) out_off += lr + tk;
      if (r == crank) take = tk;
      ties_before += tr;
    }
    s.off = out_off;
    s.take = take;
  }
  __syncthreads();

  // ---- the winners, as (key, slot) into the first CTA's shared memory: the
  // keys below the bucket at any place, then the ties taken
  unsigned long long* dst = cluster.map_shared_rank(s.u.sorted, 0) + s.off;
  const unsigned int my_less = s.pub_less, my_ties = s.pub_ties, take = s.take;
  const bool take_all = take == my_ties && take > 0;
  for (int base = warp * 32; base < nv; base += NT) {
    const Quad q = quad_at(sl, base + lane, nv, off, n);
    unsigned bl[4], bt[4];
    unsigned int nl = 0, nt = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t top = q.key[c] >> shift;
      bl[c] = __ballot_sync(0xffffffffu, q.ok[c] && top < prefix);
      bt[c] = __ballot_sync(0xffffffffu, take_all && q.ok[c] && top == prefix);
      nl += __popc(bl[c]);
      nt += __popc(bt[c]);
    }
    if (nl + nt == 0) continue;  // uniform over the warp
    unsigned int at_l = 0, at_t = 0;
    if (lane == 0) {
      if (nl) at_l = atomicAdd(&s.n_less, nl);
      if (nt) at_t = my_less + atomicAdd(&s.n_tie, nt);
    }
    at_l = __shfl_sync(0xffffffffu, at_l, 0);
    at_t = __shfl_sync(0xffffffffu, at_t, 0);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned long long both =
          (static_cast<unsigned long long>(q.key[c]) << 32) | static_cast<uint32_t>(lo + q.i0 + c);
      if ((bl[c] >> lane) & 1u) dst[at_l + __popc(bl[c] & lt_mask)] = both;
      if ((bt[c] >> lane) & 1u) dst[at_t + __popc(bt[c] & lt_mask)] = both;
      at_l += __popc(bl[c]);
      at_t += __popc(bt[c]);
    }
  }
  if (!take_all && take > 0) {
    // the first `take` ties of this slice in slot order
    unsigned int running = 0;
    for (int c0 = 0; c0 < n && running < take; c0 += NT) {
      const int i = c0 + tid;
      const uint32_t key = i < n ? desc_bits(sl[off + i]) : 0u;
      const bool is_tie = i < n && (key >> shift) == prefix;
      const unsigned bt = __ballot_sync(0xffffffffu, is_tie);
      if (lane == 0) s.red[warp] = __popc(bt);
      __syncthreads();
      unsigned int warp_off = 0, chunk = 0;
      for (int w = 0; w < NT / 32; ++w) {
        warp_off += w < warp ? s.red[w] : 0u;
        chunk += s.red[w];
      }
      __syncthreads();
      const unsigned int r = running + warp_off + __popc(bt & lt_mask);
      if (is_tie && r < take)
        dst[my_less + r] = (static_cast<unsigned long long>(key) << 32) | static_cast<uint32_t>(lo + i);
      running += chunk;
    }
  }
  cluster.sync();  // every winner is in the first CTA's shared memory
  if (crank != 0) return;

  unsigned long long* keys = s.u.sorted;
  int sort_n = SORT_MIN;
  while (sort_n < gathered) sort_n <<= 1;
  for (int i = gathered + tid; i < sort_n; i += NT) keys[i] = PAD_KEY;
  __syncthreads();
  sort_keys<NT>(keys, sort_n);
  const int32_t* pp = pool_p + row * p;
  float* d_out = dist + row * k;
  int32_t* p_out = pos + row * k;
  const float t = k <= p ? v[keys[k - 1] & 0xffffffffu] : neg_inf();
  const float tu = isfinite(t) ? __fadd_rn(t, __fadd_rn(__fmul_rn(fabsf(t), 1e-6f), 1e-30f)) : t;
  unsigned int mine = 0;
  for (int r0 = tid; r0 < sel; r0 += 4 * NT) {
    // four independent gathers in flight a thread
    float val[4];
    int32_t where[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + u * NT;
      if (r < sel) {
        const int slot = static_cast<int>(keys[r] & 0xffffffffu);
        val[u] = v[slot];
        where[u] = pp[slot];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + u * NT;
      if (r < sel) {
        d_out[r] = sqrtf(fmaxf(-val[u], 0.0f));
        p_out[r] = where[u];
        mine += val[u] > tu ? 1u : 0u;
      }
    }
  }
  for (int r = sel + tid; r < k; r += NT) {
    d_out[r] = sqrtf(fmaxf(-neg_inf(), 0.0f));
    p_out[r] = 0;
  }
  int overflow = 0;
  for (int g = tid; g < p / m; g += NT) overflow |= v[g * m + m - 1] > tu ? 1 : 0;
  const unsigned int n_above = block_sum<NT>(mine, s);
  const int any = __syncthreads_or(overflow);
  if (tid == 0) {
    flags[row] = any;
    thresh[row] = tu;
    above[row] = static_cast<int32_t>(n_above);
  }
}

// ---------------------------------------------------------------------------
// window_merge_kernel
// ---------------------------------------------------------------------------

constexpr int WINDOW = 4096;  // ranks sorted at once: 32 KB of keys

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
window_merge_kernel(const float* __restrict__ pool_v, const int32_t* __restrict__ pool_p,
                    float* __restrict__ dist, int32_t* __restrict__ pos, int32_t* __restrict__ flags,
                    float* __restrict__ thresh, int32_t* __restrict__ above, int p, int k, int m) {
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
    bitonic_sort(keys, p_pad);
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

// Shared memory of the radix kernel for one launch shape, or -1 when the
// shape is not one it takes.
long long radix_smem(long long p, long long k, long long cluster, int* slice) {
  if (k > RADIX_MAX_K || cluster < 1 || cluster > MAX_CLUSTER || (cluster & (cluster - 1)) != 0) return -1;
  const long long sl = (p + cluster - 1) / cluster;
  if (sl > static_cast<long long>(MAX_CHUNKS) * CHUNK_FLOATS) return -1;
  *slice = static_cast<int>(sl);
  return ((sl + 4) * 4 + 15) / 16 * 16;  // 3 values of slack: the 16-byte alignment of the bulk copies
}

using RadixKernel = void (*)(const float*, const int32_t*, float*, int32_t*, int32_t*, float*, int32_t*, int, int,
                             int, int);

// The radix kernel for `threads` a CTA (256 or 512), or null.
RadixKernel radix_kernel(long long threads) {
  switch (threads) {
    case 256: return radix_merge_kernel<256>;
    case 512: return radix_merge_kernel<512>;
    default: return nullptr;
  }
}

cudaError_t radix_config(RadixKernel fn, long long threads, long long cluster, long long smem,
                         cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(static_cast<unsigned int>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// Plain C entry point, bound with ctypes.  Launches on `stream`, does not
// synchronise, allocates nothing, returns a CUDA error code (0 on success).
// cluster 0 takes the window kernel; 1, 2, 4, 8 or 16 the radix kernel with
// that many CTAs a row of `threads` threads (256 or 512; k <= 2048).  The
// caller has checked shapes: 1 <= p, k < 2^31, p % m == 0, nq < 2^31.
extern "C" int srml_knn_fused_merge_f32(const void* pool_v, const void* pool_p, void* dist, void* pos,
                                        void* flags, void* thresh, void* above, long long nq, long long p,
                                        long long k, long long m, long long cluster, long long threads,
                                        void* stream) {
  constexpr long long LIMIT = 0x7fffffffLL;
  if (p < 1 || p > LIMIT || k < 1 || k > LIMIT || m < 1 || p % m != 0 || nq > LIMIT || cluster < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const float*>(pool_v);
  const auto* pp = static_cast<const int32_t*>(pool_p);
  auto* d = static_cast<float*>(dist);
  auto* po = static_cast<int32_t*>(pos);
  auto* f = static_cast<int32_t*>(flags);
  auto* t = static_cast<float*>(thresh);
  auto* a = static_cast<int32_t*>(above);
  if (cluster == 0) {
    window_merge_kernel<<<static_cast<unsigned int>(nq), THREADS, 0, s>>>(
        v, pp, d, po, f, t, a, static_cast<int>(p), static_cast<int>(k), static_cast<int>(m));
    return static_cast<int>(cudaGetLastError());
  }
  int slice = 0;
  const long long smem = radix_smem(p, k, cluster, &slice);
  const RadixKernel fn = radix_kernel(threads);
  if (smem < 0 || fn == nullptr || nq * cluster > LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = radix_config(fn, threads, cluster, smem, cfg, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.gridDim = dim3(static_cast<unsigned int>(nq * cluster));
  cfg.stream = s;
  err = cudaLaunchKernelEx(&cfg, fn, v, pp, d, po, f, t, a, static_cast<int>(p), static_cast<int>(k),
                           static_cast<int>(m), slice);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of the radix kernel that fit on the card at once for one launch
// shape, and its dynamic shared memory a CTA; returns a CUDA error code.
extern "C" int srml_knn_merge_occupancy(long long p, long long k, long long cluster, long long threads,
                                        int* clusters, int* smem_bytes) {
  int slice = 0;
  const long long smem = radix_smem(p, k, cluster, &slice);
  const RadixKernel fn = radix_kernel(threads);
  if (smem < 0 || fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = radix_config(fn, threads, cluster, smem, cfg, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.gridDim = dim3(static_cast<unsigned int>(cluster * 1024));
  *smem_bytes = static_cast<int>(smem);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, fn, &cfg));
}
