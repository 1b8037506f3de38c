// 32-bit content hash of a packed chunk word stream, on a Hopper card.
//
// Replaces the Pallas TPU kernel src/repro/kernels/chunk_hash/kernel.py
// (chunk_hash_pallas / chunk_hash_kernel, with mix_terms): the sum, mod 2^32,
// of mix(w_i + i*P2) over the first `n` words. The caller applies the length
// fold and avalanche (ref.finalize) to the 4-byte sum it reads back.
//
// Bound: device memory. Each word is read once (4 bytes) and takes seven
// 32-bit integer instructions, below the card's integer rate, so the floor
// is n*4 bytes over the memory rate (2 MiB per 4-bit chunk: under a
// microsecond, which a launch outlasts). What is left to a design is to
// keep many loads in flight and to collect the sum without a queue.
//
// Design:
// - Loads are 16 bytes a thread (uint4 through the read-only path), each
//   thread issuing kVecPerThread of them before it uses any. A head of up
//   to 3 words before the first 16-byte boundary (a view such as w[1:])
//   and a tail of up to 3 words are read one word at a time. The index
//   that enters a term is the word's own position in the stream. Indices
//   are 32-bit: the caller refuses n >= 2^32, so i mod 2^32 = i.
// - The grid is at most kMaxBlocks blocks, one wave of the card; at the
//   save path's 524,288 words, 512 blocks whose threads read one uint4
//   each (tools/kernel_variants.py times 1, 2 and 4 a thread, and a
//   grid of at most 264 blocks).
// - A block reduces its sum by warp shuffles and shared memory, and its
//   thread 0 adds it into `out` with one atomicAdd: at most 528 adds a
//   launch, where one a warp made 8,448 at the save path's size. The
//   launcher zeroes `out` with cudaMemsetAsync on the same stream, so a
//   launch keeps no state of its own and needs no PyTorch fill. The sum is
//   exact mod 2^32 in any order, so the hash is the reference's bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kPrime1 = 0x9E3779B1u;
constexpr uint32_t kPrime2 = 0x85EBCA77u;
constexpr uint32_t kPrime3 = 0xC2B2AE3Du;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 4;
constexpr int kVecPerThread = 1;

__device__ __forceinline__ uint32_t mix_term(uint32_t w, uint32_t i) {
  uint32_t t = w + i * kPrime2;
  t ^= t >> 15;
  t *= kPrime1;
  t ^= t >> 13;
  t *= kPrime3;
  return t;
}

// The block's sum, in thread 0.
__device__ __forceinline__ uint32_t block_sum(uint32_t v) {
  __shared__ uint32_t warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// words: the stream; head: words before the first 16-byte-aligned one
// (0-3, at most n); out: the sum, zeroed before the launch.
__global__ void __launch_bounds__(kThreads)
chunk_hash_kernel(const uint32_t* __restrict__ words, uint32_t n, uint32_t head,
                  uint32_t* __restrict__ out) {
  const uint32_t tid = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t nthreads = gridDim.x * kThreads;
  uint32_t sum = 0;
  if (tid < head) sum += mix_term(__ldg(words + tid), tid);
  const uint32_t nvec = (n - head) / 4;
  const uint4* vec = reinterpret_cast<const uint4*>(words + head);
  for (uint32_t base = tid; base < nvec; base += nthreads * kVecPerThread) {
    uint4 w[kVecPerThread];
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const uint32_t v = base + k * nthreads;
      if (v < nvec) w[k] = __ldg(vec + v);
    }
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const uint32_t v = base + k * nthreads;
      if (v < nvec) {
        const uint32_t i = head + 4 * v;
        sum += mix_term(w[k].x, i) + mix_term(w[k].y, i + 1) +
               mix_term(w[k].z, i + 2) + mix_term(w[k].w, i + 3);
      }
    }
  }
  const uint32_t tail = head + 4 * nvec;  // n - tail < 4
  if (tid < n - tail) sum += mix_term(__ldg(words + tail + tid), tail + tid);
  sum = block_sum(sum);
  if (threadIdx.x == 0 && sum != 0) atomicAdd(out, sum);
}

}  // namespace

// words: n uint32 on the device (4-byte aligned, any 16-byte offset);
// out: one uint32 on the device, which receives the sum. n < 2^32.
// A 4-byte cudaMemsetAsync of `out`, then one launch (n = 0 included), both
// on `stream`. Returns the memset's error or cudaGetLastError() after the
// launch.
extern "C" int chunk_hash_launch(const void* words, long long n, void* out, void* stream) {
  if (n < 0 || n >= (1LL << 32)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint32_t head = (uint32_t)((16 - ((uintptr_t)words & 15)) & 15) / 4;
  const uint32_t h = head < n ? head : (uint32_t)n;
  const long long nvec = (n - h) / 4;
  long long blocks = (nvec + (long long)kThreads * kVecPerThread - 1) /
                     ((long long)kThreads * kVecPerThread);
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const cudaError_t err = cudaMemsetAsync(out, 0, 4, st);
  if (err != cudaSuccess) return (int)err;
  chunk_hash_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      (const uint32_t*)words, (uint32_t)n, h, (uint32_t*)out);
  return (int)cudaGetLastError();
}
