// B11, the ring shift of the in-mesh exchange, for Hopper (sm_90a):
//
//     dst[p] receives a byte copy of src[p]      p = 0 .. n_pairs - 1
//
// one launch per source device, for every (source, destination) pair whose
// source lies on that device.  The wrapper (ops/exchange_kernels.ring_shift)
// builds the pairs from a permutation: the flat +shift rotation of the data
// axis or the topology's gateway cycle, so one kernel serves both schedules.
// Replaces the TPU kernel spark_rapids_ml_tpu/parallel/exchange.py
// ::_ring_shift_remote_dma (its body at :484, pallas_call at :508), which
// serves only the flat rotation: every shard sends its whole block to shard
// (i + shift) mod n by one remote DMA and waits on the send and receive
// semaphores.  The TPU kernel's remote copy becomes stores through a
// destination pointer: on one card the destination is another buffer of the
// same memory; across cards it is the peer card's memory, reached through
// unified virtual addressing after the wrapper enabled peer access.  The
// receive semaphore becomes an event the wrapper records on the source
// device's stream after the launch, which each destination device's stream
// waits on.
//
// What bounds it on the card: bytes.  Each pair reads its block once and
// writes it once, so a shift of n blocks of B bytes on one card moves
// 2 * n * B bytes at 3.35 TB/s (at the kNN ring hop's query blocks, 4 x
// 2,048 x 3000 floats, ~0.059 ms); across cards the writes cross NVLink at
// 450 GB/s each way.
//
// Design, simple first:
//   - the pairs travel to the kernel by value in a parameter struct of up to
//     MAX_PAIRS entries (__grid_constant__, read in place), so the launch
//     needs no host-to-device copy;
//   - blockIdx.y picks the pair, a grid-stride loop over x copies it: 16-byte
//     words when both pointers are 16-byte aligned, 4-byte words when both
//     are 4-byte aligned, bytes otherwise; the ragged tail goes byte by byte;
//   - out of place: sources and destinations are distinct buffers (the
//     wrapper allocates the destinations), so no pair overwrites a block
//     another pair still reads.
// Not yet: overlap with compute on a side stream (the JAX ring overlaps the
// next hop's query shift with the local scan).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_PAIRS = 64;
constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS_X = 2048;

struct Pair {
  const unsigned char* src;
  unsigned char* dst;
  long long nbytes;
};

struct Params {
  Pair pairs[MAX_PAIRS];
};

template <typename Word>
__device__ __forceinline__ void copy_words(const Word* __restrict__ src, Word* __restrict__ dst, long long n,
                                           long long first, long long stride) {
#pragma unroll 4
  for (long long i = first; i < n; i += stride) dst[i] = src[i];
}

__global__ void __launch_bounds__(THREADS) ring_shift_kernel(const __grid_constant__ Params params) {
  const Pair pair = params.pairs[blockIdx.y];
  const long long first = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const uintptr_t both = reinterpret_cast<uintptr_t>(pair.src) | reinterpret_cast<uintptr_t>(pair.dst);
  long long done = 0;
  if ((both & 15) == 0) {
    const long long words = pair.nbytes >> 4;
    copy_words(reinterpret_cast<const uint4*>(pair.src), reinterpret_cast<uint4*>(pair.dst), words, first, stride);
    done = words << 4;
  } else if ((both & 3) == 0) {
    const long long words = pair.nbytes >> 2;
    copy_words(reinterpret_cast<const uint32_t*>(pair.src), reinterpret_cast<uint32_t*>(pair.dst), words, first,
               stride);
    done = words << 2;
  }
  copy_words(pair.src + done, pair.dst + done, pair.nbytes - done, first, stride);
}

}  // namespace

// Copies srcs[p] (nbytes[p] bytes) to dsts[p] for p < n_pairs, with a kernel
// on `device` (every source lies there; a destination may lie on a peer
// whose access the caller enabled) queued on `stream` of that device.
// Returns a cudaError_t; -1 when n_pairs is out of range.
extern "C" int srml_ring_shift(int device, const unsigned long long* srcs, const unsigned long long* dsts,
                               const long long* nbytes, int n_pairs, void* stream) {
  if (n_pairs < 1 || n_pairs > MAX_PAIRS) return -1;
  int previous = 0;
  cudaError_t err = cudaGetDevice(&previous);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params params = {};
  long long widest = 0;
  for (int p = 0; p < n_pairs; ++p) {
    params.pairs[p].src = reinterpret_cast<const unsigned char*>(srcs[p]);
    params.pairs[p].dst = reinterpret_cast<unsigned char*>(dsts[p]);
    params.pairs[p].nbytes = nbytes[p];
    widest = nbytes[p] > widest ? nbytes[p] : widest;
  }
  long long blocks = (widest / 16 + THREADS - 1) / THREADS;
  blocks = blocks < 1 ? 1 : (blocks > MAX_BLOCKS_X ? MAX_BLOCKS_X : blocks);
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_pairs));
  ring_shift_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(params);
  err = cudaGetLastError();
  cudaError_t restore = cudaSetDevice(previous);
  return static_cast<int>(err != cudaSuccess ? err : restore);
}

// Lets kernels on `device` store into memory of `peer`.  Returns a
// cudaError_t (0 also when access was already enabled), or -1 when the
// hardware gives `device` no access to `peer`.
extern "C" int srml_enable_peer_access(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!can) return -1;
  int previous = 0;
  err = cudaGetDevice(&previous);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the error the runtime recorded
    err = cudaSuccess;
  }
  cudaError_t restore = cudaSetDevice(previous);
  return static_cast<int>(err != cudaSuccess ? err : restore);
}
