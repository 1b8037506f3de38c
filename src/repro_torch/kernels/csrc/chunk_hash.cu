// 32-bit content hash of a packed chunk word stream, on a Hopper card.
//
// Replaces the Pallas TPU kernel src/repro/kernels/chunk_hash/kernel.py
// (chunk_hash_pallas / chunk_hash_kernel, with mix_terms): the sum, mod 2^32,
// of mix(w_i + i*P2) over the first `n` words. The length fold and avalanche
// (ref.finalize) run on the host after the 4-byte read-back.
//
// Bound: device memory. Each word is read once (4 bytes) and takes seven
// 32-bit integer instructions, below the card's integer rate, so the floor
// is n*4 bytes over the memory rate (2 MiB per 4-bit chunk: under a
// microsecond, which a launch outlasts).
//
// Design: a grid-stride loop keeps the loads coalesced and the grid small;
// every term is uint32 arithmetic with native wraparound, so the sum is the
// reference's exactly whatever the order. A warp reduces its lanes with
// shuffles and adds one partial into the zeroed accumulator with atomicAdd.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kPrime1 = 0x9E3779B1u;
constexpr uint32_t kPrime2 = 0x85EBCA77u;
constexpr uint32_t kPrime3 = 0xC2B2AE3Du;

__device__ __forceinline__ uint32_t mix_term(uint32_t w, uint32_t i) {
  uint32_t t = w + i * kPrime2;
  t ^= t >> 15;
  t *= kPrime1;
  t ^= t >> 13;
  t *= kPrime3;
  return t;
}

__global__ void chunk_hash_kernel(const uint32_t* __restrict__ words,
                                  long long n, uint32_t* __restrict__ acc) {
  uint32_t sum = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    sum += mix_term(words[i], (uint32_t)i);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  if ((threadIdx.x & 31) == 0 && sum != 0) atomicAdd(acc, sum);
}

}  // namespace

// words: n uint32 on the device; acc: one uint32 on the device, zeroed by
// the caller. Returns cudaGetLastError() after the launch.
extern "C" int chunk_hash_launch(const void* words, long long n, void* acc,
                                 void* stream) {
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 8) blocks = 132 * 8;
    chunk_hash_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
        (const uint32_t*)words, n, (uint32_t*)acc);
  }
  return (int)cudaGetLastError();
}
