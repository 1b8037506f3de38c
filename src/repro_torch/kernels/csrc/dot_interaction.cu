// DLRM dot-product feature interaction, on a Hopper card.
//
// Replaces the Pallas TPU kernel src/repro/kernels/dot_interaction/kernel.py
// (dot_interaction_pallas / dot_interaction_kernel): for each batch row,
// the dots <f_i, f_j> of its F features for i < j, in np.triu_indices(F, 1)
// order (row-major over i), from (B, F, D) bf16 or f32 features to (B, P)
// f32, P = F(F-1)/2. (The Pallas docstring says "lower-triangle"; its
// selection matrix takes the upper one, as here.)
//
// Bound: device memory at the model's shapes. Per row it reads F*D inputs
// and writes P f32 dots, and does P*D multiply-adds: at F = 27, D = 64 in
// bf16 that is 3,456 bytes read and 1,404 written against 22,464 FMAs,
// about 9.2 operations per byte (an FMA counts two), below the card's f32
// CUDA-core rate per byte of memory (67 TFLOP/s over 3.35 TB/s = 20).
//
// Design: a block takes `rows` batch rows (as many as fit 48 KB of shared
// memory, up to 8) and stages their features there as f32, each feature
// row at an odd stride so that threads reading the same column of
// different features hit different banks. The (i, j) of every pair is
// worked out once per block into a shared table, so no F^2 selection
// matrix is needed. Each thread then computes whole dots, pair index
// fastest, so consecutive threads write consecutive outputs. Each dot is
// accumulated in f32 over d = 0..D-1 in order. The TPU's padding of F and
// D to its tiles is not needed.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;
constexpr size_t kSmemBudget = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void dot_interaction_kernel(const T* __restrict__ feats,
                                       float* __restrict__ out, int batch,
                                       int nf, int dim, int stride,
                                       int rows) {
  extern __shared__ float smem[];
  const int pairs = nf * (nf - 1) / 2;
  float* xs = smem;                                   // rows * nf * stride
  int* pair_ij = (int*)(smem + (size_t)rows * nf * stride);  // pairs
  const long long row0 = (long long)blockIdx.x * rows;
  const long long left = batch - row0;
  const int nrows = left < rows ? (int)left : rows;

  for (int p = threadIdx.x; p < pairs; p += kThreads) {
    int i = 0, rem = p;
    while (rem >= nf - 1 - i) {
      rem -= nf - 1 - i;
      ++i;
    }
    pair_ij[p] = (i << 16) | (i + 1 + rem);
  }
  const int per_row = nf * dim;
  const T* src = feats + row0 * per_row;
  for (int e = threadIdx.x; e < nrows * per_row; e += kThreads) {
    const int r = e / per_row, rest = e % per_row;
    const int f = rest / dim, d = rest % dim;
    xs[(r * nf + f) * stride + d] = to_f32(src[e]);
  }
  __syncthreads();

  float* dst = out + row0 * pairs;
  for (int q = threadIdx.x; q < nrows * pairs; q += kThreads) {
    const int r = q / pairs, p = q % pairs;
    const int ij = pair_ij[p];
    const float* xi = xs + (r * nf + (ij >> 16)) * stride;
    const float* xj = xs + (r * nf + (ij & 0xffff)) * stride;
    float acc = 0.f;
    for (int d = 0; d < dim; ++d) acc = fmaf(xi[d], xj[d], acc);
    dst[q] = acc;
  }
}

template <typename T>
cudaError_t launch(const void* feats, void* out, int batch, int nf, int dim,
                   cudaStream_t stream) {
  const int stride = dim | 1;
  const int pairs = nf * (nf - 1) / 2;
  const size_t per_row = (size_t)nf * stride * sizeof(float);
  const size_t table = (size_t)pairs * sizeof(int);
  if (per_row + table > kSmemBudget) return cudaErrorInvalidValue;
  int rows = (int)((kSmemBudget - table) / per_row);
  if (rows > kMaxRows) rows = kMaxRows;
  const long long blocks = ((long long)batch + rows - 1) / rows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = rows * per_row + table;
  dot_interaction_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const T*)feats, (float*)out, batch, nf, dim, stride, rows);
  return cudaGetLastError();
}

}  // namespace

// feats: batch*nf*dim values, row-major, on the device, f32 (is_bf16 = 0)
// or bf16 (is_bf16 = 1); out: batch * nf(nf-1)/2 f32. 2 <= nf <= 32767.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue when
// one row's features do not fit the shared-memory budget).
extern "C" int dot_interaction_launch(const void* feats, void* out, int batch,
                                      int nf, int dim, int is_bf16,
                                      void* stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  if (nf < 2 || nf > 32767 || dim <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    return (int)launch<__nv_bfloat16>(feats, out, batch, nf, dim, st);
  }
  return (int)launch<float>(feats, out, batch, nf, dim, st);
}
