// EmbeddingBag-sum (gather + bag-sum), the recsys lookup, on a Hopper card.
//
// Replaces the Pallas TPU kernel src/repro/kernels/embedding_bag/kernel.py
// (embedding_bag_pallas / embedding_bag_kernel): out[b] = sum over h of
// table[ids[b, h]], for a (V, D) f32 table and (B, H) int32 ids, f32 out.
//
// Bound: device memory. Each id reads one D-float row and each bag writes
// one; there is one add per value read, far below the card's f32 rate. So
// the floor is (B*H*D + B*D)*4 + B*H*4 bytes over the memory rate. At the
// serving shapes (H = 1, D = 64) a 512-bag call moves 264 KB, which a
// launch outlasts.
//
// Design: a group of `tpb` threads (a power of two up to 32, within one
// warp) owns one bag; thread c of the group owns columns c, c + tpb, ...
// of the row, as float4 where D % 4 == 0 and the table is 16-byte aligned,
// as single floats otherwise, so each group reads whole rows coalesced and
// the table is neither padded nor copied. The sum runs over h = 0..H-1 in
// order, starting from the first row itself, so H = 1 is an exact copy.
// The row offset id * D is taken in 64 bits: a full-vocabulary table holds
// more than 2^31 values. The ids of one bag lie at ids + b * ids_stride
// (the wrapper passes a field's column of the (B, F, H) id tensor without
// copying it). An id outside [0, V) makes its bag NaN (jnp.take's fill
// value) instead of reading outside the table.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename V>
__device__ __forceinline__ void add_to(V& a, const V& b);

template <>
__device__ __forceinline__ void add_to<float>(float& a, const float& b) {
  a += b;
}

template <>
__device__ __forceinline__ void add_to<float4>(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

template <typename V>
__device__ __forceinline__ V nan_of();

template <>
__device__ __forceinline__ float nan_of<float>() {
  return __int_as_float(0x7fc00000);
}

template <>
__device__ __forceinline__ float4 nan_of<float4>() {
  const float n = __int_as_float(0x7fc00000);
  return make_float4(n, n, n, n);
}

// V = float4 or float; `cols` = D / (elements per V).
template <typename V>
__global__ void embedding_bag_kernel(const V* __restrict__ table,
                                     const int32_t* __restrict__ ids,
                                     V* __restrict__ out, long long vocab,
                                     int cols, int bags, int hot,
                                     long long ids_stride, int tpb) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long bag = t / tpb;
  const int c0 = (int)(t % tpb);
  if (bag >= bags) return;
  const int32_t* bag_ids = ids + bag * ids_stride;
  bool valid = true;
  for (int h = 0; h < hot; ++h) {
    const int32_t id = bag_ids[h];
    valid = valid && id >= 0 && (long long)id < vocab;
  }
  V* dst = out + bag * (long long)cols;
  if (!valid) {
    for (int c = c0; c < cols; c += tpb) dst[c] = nan_of<V>();
    return;
  }
  for (int c = c0; c < cols; c += tpb) {
    V acc = table[(long long)bag_ids[0] * cols + c];
    for (int h = 1; h < hot; ++h) {
      add_to(acc, table[(long long)bag_ids[h] * cols + c]);
    }
    dst[c] = acc;
  }
}

template <typename V>
cudaError_t launch(const void* table, const void* ids, void* out,
                   long long vocab, int cols, int bags, int hot,
                   long long ids_stride, cudaStream_t stream) {
  int tpb = 1;
  while (tpb < cols && tpb < 32) tpb <<= 1;
  const long long threads = (long long)bags * tpb;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  embedding_bag_kernel<V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const V*)table, (const int32_t*)ids, (V*)out, vocab, cols, bags, hot,
      ids_stride, tpb);
  return cudaGetLastError();
}

}  // namespace

// table: vocab*dim f32, row-major, on the device; ids: int32, bag b's hot
// ids at ids + b*ids_stride; out: bags*dim f32. hot >= 1. Returns
// cudaGetLastError() after the launch.
extern "C" int embedding_bag_launch(const void* table, const void* ids,
                                    void* out, long long vocab, int dim,
                                    int bags, int hot, long long ids_stride,
                                    void* stream) {
  if (bags <= 0 || dim <= 0) return (int)cudaGetLastError();
  if (hot <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = dim % 4 == 0 && ((uintptr_t)table % 16) == 0 &&
                   ((uintptr_t)out % 16) == 0;
  if (vec) {
    return (int)launch<float4>(table, ids, out, vocab, dim / 4, bags, hot,
                               ids_stride, st);
  }
  return (int)launch<float>(table, ids, out, vocab, dim, bags, hot,
                            ids_stride, st);
}
