// EmbeddingBag-sum (gather + bag-sum), the recsys lookup, on a Hopper card,
// for all fields of a batch in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/embedding_bag/kernel.py
// (embedding_bag_pallas / embedding_bag_kernel): out[b] = sum over h of
// table[ids[b, h]], for a (V, D) f32 table and (B, H) int32 ids. The
// reference's lookup_fields calls it once per field and stacks the fields;
// here one launch covers F fields: out[b, f] = sum over h of
// table_f[ids[b, f, h]], written as (B, F, D) f32 (F = 1: the single-table
// op) or bf16 (the lookup's output, each sum rounded once, to nearest even).
//
// Bound: device memory. Each id reads one D-float row and each bag writes
// one; there is one add per value read, far below the card's f32 rate. So
// the floor is B*F*(H*(D*4 + 4) + D*out_bytes) bytes over the memory rate.
// At dlrm-rm2's serving shapes (F = 26, H = 1, D = 64, bf16 out) a batch of
// 512 moves 5.2 MB, about 1.5 us.
//
// Design: the F table pointers and vocabulary sizes travel in a
// __grid_constant__ kernel parameter, so a call needs no host-to-device
// copy. A group of `tpb` threads (a power of two up to 32, within one warp)
// owns one (bag, field) pair, in (b, f) order, so consecutive groups write
// consecutive output rows; thread c of the group owns columns c, c + tpb,
// ... of the row, as float4 where D % 4 == 0 and every table is 16-byte
// aligned, as single floats otherwise, so each group reads whole rows
// coalesced and no table is padded or copied. The sum runs over h = 0..H-1
// in order, starting from the first row itself, so H = 1 is an exact copy.
// The row offset id * D is taken in 64 bits: a full-vocabulary table holds
// more than 2^31 values. The ids lie at ids + b*sb + f*sf + h*sh, strided as
// the caller's (B, F, H) tensor lies. An id outside [0, V_f) makes its bag
// NaN (jnp.take's fill value) instead of reading outside the table.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFields = 64;

struct Fields {
  const float* table[kMaxFields];
  long long vocab[kMaxFields];
};

__device__ __forceinline__ void add_to(float& a, const float& b) { a += b; }

__device__ __forceinline__ void add_to(float4& a, const float4& b) {
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

// Store column c of a row (in units of V) to an f32 or bf16 output row.
__device__ __forceinline__ void store(float* dst, int c, float v) { dst[c] = v; }

__device__ __forceinline__ void store(float* dst, int c, float4 v) {
  reinterpret_cast<float4*>(dst)[c] = v;
}

__device__ __forceinline__ void store(__nv_bfloat16* dst, int c, float v) {
  dst[c] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store(__nv_bfloat16* dst, int c, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  reinterpret_cast<uint2*>(dst)[c] = u;
}

// V = float4 or float; O = float or __nv_bfloat16; `cols` = D / (elements
// per V); tpb = 1 << log_tpb threads a (bag, field) pair.
template <typename V, typename O>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const __grid_constant__ Fields fields,
                     const int32_t* __restrict__ ids, long long sb,
                     long long sf, long long sh, O* __restrict__ out,
                     int n_fields, unsigned pairs, int hot, int dim, int cols,
                     int log_tpb) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  const unsigned pair = t >> log_tpb;
  const int c0 = (int)(t & ((1u << log_tpb) - 1));
  if (pair >= pairs) return;
  const unsigned b = pair / n_fields;
  const int f = (int)(pair - b * n_fields);
  const int32_t* bag_ids = ids + b * sb + f * sf;
  const V* table = reinterpret_cast<const V*>(fields.table[f]);
  const long long vocab = fields.vocab[f];
  bool valid = true;
  for (int h = 0; h < hot; ++h) {
    const int32_t id = bag_ids[h * sh];
    valid = valid && id >= 0 && (long long)id < vocab;
  }
  O* dst = out + (long long)pair * dim;
  const int tpb = 1 << log_tpb;
  if (!valid) {
    for (int c = c0; c < cols; c += tpb) store(dst, c, nan_of<V>());
    return;
  }
  for (int c = c0; c < cols; c += tpb) {
    V acc = table[(long long)bag_ids[0] * cols + c];
    for (int h = 1; h < hot; ++h) {
      add_to(acc, table[(long long)bag_ids[h * sh] * cols + c]);
    }
    store(dst, c, acc);
  }
}

template <typename V, typename O>
cudaError_t launch(const Fields& fields, const void* ids, long long sb,
                   long long sf, long long sh, void* out, int n_fields,
                   long long pairs, int hot, int dim, int cols,
                   cudaStream_t stream) {
  int log_tpb = 0;
  while ((1 << log_tpb) < cols && log_tpb < 5) ++log_tpb;
  const long long threads = pairs << log_tpb;
  if (threads > 0xffffffffLL - kThreads) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  embedding_bag_kernel<V, O><<<blocks, kThreads, 0, stream>>>(
      fields, (const int32_t*)ids, sb, sf, sh, (O*)out, n_fields,
      (unsigned)pairs, hot, dim, cols, log_tpb);
  return cudaGetLastError();
}

template <typename O>
cudaError_t launch_out(const Fields& fields, bool vec, const void* ids,
                       long long sb, long long sf, long long sh, void* out,
                       int n_fields, long long pairs, int hot, int dim,
                       cudaStream_t stream) {
  if (vec)
    return launch<float4, O>(fields, ids, sb, sf, sh, out, n_fields, pairs,
                             hot, dim, dim / 4, stream);
  return launch<float, O>(fields, ids, sb, sf, sh, out, n_fields, pairs, hot,
                          dim, dim, stream);
}

}  // namespace

// tables[f]: vocabs[f]*dim f32, row-major, on the device, for f < n_fields
// (host arrays of n_fields entries, 1 <= n_fields <= 64); ids: int32, bag
// b's field-f ids at ids + b*sb + f*sf + h*sh for h < hot (hot >= 1);
// out: bags*n_fields*dim values, f32 or (out_bf16) bf16. Returns
// cudaGetLastError() after the launch.
extern "C" int embedding_bag_launch(const void* const* tables,
                                    const long long* vocabs, int n_fields,
                                    const void* ids, long long sb,
                                    long long sf, long long sh, void* out,
                                    int out_bf16, int bags, int hot, int dim,
                                    void* stream) {
  if (n_fields < 1 || n_fields > kMaxFields || hot <= 0)
    return (int)cudaErrorInvalidValue;
  if (bags <= 0 || dim <= 0) return (int)cudaGetLastError();
  Fields fields;
  bool vec = dim % 4 == 0 && ((uintptr_t)out % 16) == 0;
  for (int f = 0; f < n_fields; ++f) {
    fields.table[f] = (const float*)tables[f];
    fields.vocab[f] = vocabs[f];
    vec = vec && ((uintptr_t)tables[f] % 16) == 0;
  }
  for (int f = n_fields; f < kMaxFields; ++f) {
    fields.table[f] = nullptr;
    fields.vocab[f] = 0;
  }
  const long long pairs = (long long)bags * n_fields;
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16)
    return (int)launch_out<__nv_bfloat16>(fields, vec, ids, sb, sf, sh, out,
                                          n_fields, pairs, hot, dim, st);
  return (int)launch_out<float>(fields, vec, ids, sb, sf, sh, out, n_fields,
                                pairs, hot, dim, st);
}
