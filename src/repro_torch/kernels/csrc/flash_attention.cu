// Online-softmax (flash) attention forward for f32 inputs, on the SIMT
// pipes: the f32 route of flash_attention. bf16 inputs, which the bert4rec
// serve path gives, take the tensor-core kernel in flash_attention_mma.cu.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas / flash_kernel) for f32: o = softmax(q k^T /
// sqrt(D)) v per (batch, q head), with GQA (q head h reads kv head h / G),
// an optional causal mask, f32 scores and f32 running max m, sum l and
// accumulator acc, masked scores at exactly the f32 minimum, the final
// divide by max(l, 1e-30), and the output in f32.
//
// Bound: reading q, k, v once and writing o once would bound it (2*S*D
// FLOP per score against 16*D bytes per row), but its products run as f32
// FMAs (2*D a score, each with a shared-memory read), so the FMA and
// shared-memory pipes bound it. It keeps full f32 products, which the
// tensor cores would round (bf16) or shorten (tf32); no main path runs f32
// attention.
//
// Design: one block per (batch * q head, tile of 64 q rows); a loop over key
// tiles of 32 inside the block takes the place of the TPU's sequential
// "arbitrary" kv grid axis. Each q row is owned by TPR = ceil(D / 32)
// adjacent threads, each holding 32 head dims of q and of acc in registers
// (no padding of D to 128 lanes: D = 100 uses TPR = 4 with zero columns).
// A key tile is staged in shared memory, each 32-dim chunk of a row
// padded to 36 floats so the TPR threads of a row read float4s from
// distinct banks while the other rows' threads read the same address
// (a broadcast). Scores of a tile are summed over the TPR threads by xor
// shuffles, the tile's max rescales m, l and acc once, and p = exp(s - m)
// accumulates into acc. Under the causal mask, key tiles past the block's
// last row are skipped: they would add exp(-inf) = 0 and leave m unchanged.
// q, k, v are read through their batch, sequence and head strides (unit
// stride along D), as the projections leave them; o is written contiguous.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -FLT_MAX;  // the f32 minimum: the Pallas NEG_INF
constexpr int kBlockQ = 64;   // q rows per block
constexpr int kBlockK = 32;   // keys per shared-memory tile
constexpr int kChunk = 32;    // head dims per thread
constexpr int kStride = 36;   // floats per 32-dim chunk in shared memory

struct Strides {
  long long b, s, h;
};

template <int TPR>
__global__ void __launch_bounds__(kBlockQ * TPR)
flash_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
             int Hq, int Hkv, int D, Strides qs, Strides ks_, Strides vs_,
             float scale, int causal) {
  __shared__ __align__(16) float ks[kBlockK * TPR * kStride];
  __shared__ __align__(16) float vs[kBlockK * TPR * kStride];
  constexpr int DP = TPR * kChunk;
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int t = threadIdx.x % TPR;
  const int q0 = blockIdx.y * kBlockQ;
  const int qrow = q0 + (int)threadIdx.x / TPR;
  const bool live = qrow < Sq;

  float qr[kChunk], acc[kChunk];
  const float* qp = q + b * qs.b + (long long)min(qrow, Sq - 1) * qs.s + h * qs.h;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const int d = t * kChunk + i;
    qr[i] = d < D ? qp[d] : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const float* kb = k + b * ks_.b + hk * ks_.h;
  const float* vb = v + b * vs_.b + hk * vs_.h;
  const int k_end = causal ? min(Sk, q0 + kBlockQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kBlockK * DP; idx += blockDim.x) {
      const int j = idx / DP, d = idx % DP;
      const int key = k0 + j;
      const bool ok = key < Sk && d < D;
      const int so = (j * TPR + (d >> 5)) * kStride + (d & 31);
      ks[so] = ok ? kb[key * ks_.s + d] : 0.f;
      vs[so] = ok ? vb[key * vs_.s + d] : 0.f;
    }
    __syncthreads();

    float s[kBlockK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + (j * TPR + t) * kStride);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kChunk / 4; ++i) {
        const float4 kv = kr[i];
        dot += qr[4 * i] * kv.x;
        dot += qr[4 * i + 1] * kv.y;
        dot += qr[4 * i + 2] * kv.z;
        dot += qr[4 * i + 3] * kv.w;
      }
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int key = k0 + j;
      const bool masked = key >= Sk || (causal && key > qrow);
      s[j] = masked ? kNegInf : dot * scale;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(vs + (j * TPR + t) * kStride);
      const float p = s[j];
#pragma unroll
      for (int i = 0; i < kChunk / 4; ++i) {
        const float4 vv = vr[i];
        acc[4 * i] += p * vv.x;
        acc[4 * i + 1] += p * vv.y;
        acc[4 * i + 2] += p * vv.z;
        acc[4 * i + 3] += p * vv.w;
      }
    }
    m = m_new;
  }

  if (live) {
    const float den = fmaxf(l, 1e-30f);
    float* op = o + (((long long)b * Sq + qrow) * Hq + h) * D;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int d = t * kChunk + i;
      if (d < D) op[d] = acc[i] / den;
    }
  }
}

template <int TPR>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int Sq, int Sk, int Hq, int Hkv, int D, Strides qs,
                   Strides ks, Strides vs, float scale, int causal,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Sq + kBlockQ - 1) / kBlockQ));
  flash_kernel_f32<TPR><<<grid, kBlockQ * TPR, 0, stream>>>(
      q, k, v, o, Sq, Sk, Hq, Hkv, D, qs, ks, vs, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q: (B, Sq, Hq, D) f32; k, v: (B, Sk, Hkv, D) f32, each with the given
// batch, sequence and head strides (in elements) and unit stride along D;
// o: a contiguous (B, Sq, Hq, D) f32. scale is the f32 1/sqrt(D) the scores
// are multiplied by. 1 <= D <= 128, Hq % Hkv == 0, B * Hq < 2^31. Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_f32_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int Hq, int Hkv, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, float scale, int causal, void* stream) {
  if (B <= 0 || Sq <= 0) return (int)cudaGetLastError();
  if (Sk <= 0 || D <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  float* of = (float*)o;
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 32) return (int)launch<1>(qf, kf, vf, of, B, Sq, Sk, Hq, Hkv, D, qs, ks, vs, scale, causal, st);
  if (D <= 64) return (int)launch<2>(qf, kf, vf, of, B, Sq, Sk, Hq, Hkv, D, qs, ks, vs, scale, causal, st);
  if (D <= 128) return (int)launch<4>(qf, kf, vf, of, B, Sq, Sk, Hq, Hkv, D, qs, ks, vs, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
