// Fused row-wise quantize + bit-pack for checkpoint chunks, on a Hopper card.
//
// Replaces the Pallas TPU kernel src/repro/kernels/adaptive_quant/kernel.py
// (quant_pack_pallas / quant_pack_kernel, with _search_range and
// pack_codes_u32). Per row: min/max, then a greedy range search of n_steps
// steps (0 = plain uniform asymmetric), each step scoring two candidate
// ranges by their r-space squared error and keeping the better; then affine
// codes rint((clip(x, lo, hi) - lo) / scale), packed little-endian so code p
// sits at stream bit bits*p (the host pack_bits wire format).
//
// Bound: at the checkpoint's shapes ((65536, 64) f32, 4-bit adaptive,
// n_steps = 9) the search does 2*n_steps+1 passes of eight instructions
// over every value, one of them a rintf (FRND, on the 16-lane conversion
// pipe), against one 4-byte read and bits/8 bytes of write per value, so
// the conversion pipe bounds it, not device memory. The xor-shuffle
// reductions (five per lane per candidate, 32 lanes per clock per SM) cost
// about as much again.
//
// Design: one warp per row with the row held in registers (VPL values per
// lane), so the search passes never touch memory; min/max and both
// candidate errors reduce with xor-butterfly shuffles, which leave every lane
// with identical bits and hence the same greedy decision. A block owns 32
// rows, so its code range starts on a word boundary; codes are staged in
// shared memory and each thread then builds whole output words. Codes past
// the last row are zero, so the tail bits of the final word are zero.
//
// Exactness: rintf (round half to even, as jnp.round); a true IEEE divide
// for the final codes and for the search's 1/scale; and, where the reference
// divides by a constant (range / levels, range / num_bins), a multiply by the
// constant's f32 reciprocal, which is what XLA compiles that divide into.
// The file is built with -fmad=false so no multiply and add are fused where
// the reference rounds twice.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kRowsPerBlock = 32;
constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// scale^2 * sum over the row of (r - rint(clip(r, 0, levels)))^2 with
// r = (x - lo) * (1 / scale): the reference's _err_pair for one candidate.
template <int VPL>
__device__ __forceinline__ float range_error(const float (&v)[VPL], int dim,
                                             int lane, float lo, float hi,
                                             float levels, float inv_levels) {
  const float rng = hi - lo;
  const float s = rng > 0.f ? rng * inv_levels : 1.f;
  const float inv = 1.f / s;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    if (lane + 32 * k < dim) {
      const float r = (v[k] - lo) * inv;
      const float d = r - rintf(fminf(fmaxf(r, 0.f), levels));
      acc += d * d;
    }
  }
  return (s * s) * warp_sum(acc);
}

template <int VPL>
__global__ void __launch_bounds__(kThreads)
quant_pack_kernel(const float* __restrict__ x, uint32_t* __restrict__ words,
                  float* __restrict__ scale_out, float* __restrict__ zero_out,
                  int rows, int dim, int bits, int num_bins, int n_steps,
                  long long nwords) {
  extern __shared__ uint8_t codes[];  // kRowsPerBlock * dim
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 = (long long)blockIdx.x * kRowsPerBlock;
  const float levels = (float)((1 << bits) - 1);
  const float inv_levels = 1.f / levels;

  for (int r = warp; r < kRowsPerBlock; r += kThreads / 32) {
    uint8_t* crow = codes + r * dim;
    const long long row = row0 + r;
    if (row >= rows) {
      for (int j = lane; j < dim; j += 32) crow[j] = 0;
      continue;
    }
    const float* xr = x + row * dim;
    float v[VPL];
    float mn = kBig, mx = -kBig;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int j = lane + 32 * k;
      v[k] = j < dim ? xr[j] : 0.f;
      if (j < dim) {
        mn = fminf(mn, v[k]);
        mx = fmaxf(mx, v[k]);
      }
    }
    mn = warp_min(mn);
    mx = warp_max(mx);

    float best_lo = mn, best_hi = mx;
    if (n_steps > 0) {
      const float step = (mx - mn) * (1.f / (float)num_bins);
      float cur_lo = mn, cur_hi = mx;
      float best_err =
          range_error<VPL>(v, dim, lane, mn, mx, levels, inv_levels);
      for (int s = 0; s < n_steps; ++s) {
        const float err_lo =
            range_error<VPL>(v, dim, lane, cur_lo + step, cur_hi, levels,
                             inv_levels);
        const float err_hi =
            range_error<VPL>(v, dim, lane, cur_lo, cur_hi - step, levels,
                             inv_levels);
        const bool take_lo = err_lo <= err_hi;
        const float new_lo = take_lo ? cur_lo + step : cur_lo;
        const float new_hi = take_lo ? cur_hi : cur_hi - step;
        const float cur_err = take_lo ? err_lo : err_hi;
        if (cur_err < best_err) {
          best_lo = new_lo;
          best_hi = new_hi;
          best_err = cur_err;
        }
        cur_lo = new_lo;
        cur_hi = new_hi;
      }
    }

    const float rng = best_hi - best_lo;
    const float sc = rng > 0.f ? rng * inv_levels : 1.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int j = lane + 32 * k;
      if (j < dim) {
        const float xc = fminf(fmaxf(v[k], best_lo), best_hi);
        const float q = rintf((xc - best_lo) / sc);
        crow[j] = (uint8_t)fminf(fmaxf(q, 0.f), levels);
      }
    }
    if (lane == 0) {
      scale_out[row] = sc;
      zero_out[row] = best_lo;
    }
  }
  __syncthreads();

  // The block's 32*dim codes fill exactly dim*bits words, starting at word
  // blockIdx.x*dim*bits. Word w holds the codes overlapping bits
  // [32w, 32w+32) of the block's stream.
  const int n_codes = kRowsPerBlock * dim;
  const int block_words = dim * bits;
  const long long word0 = (long long)blockIdx.x * block_words;
  for (int w = threadIdx.x; w < block_words; w += kThreads) {
    if (word0 + w >= nwords) break;
    const int bit0 = 32 * w;
    const int p_end = min((bit0 + 31) / bits, n_codes - 1);
    uint32_t word = 0;
    for (int p = bit0 / bits; p <= p_end; ++p) {
      const int sh = p * bits - bit0;
      const uint32_t c = codes[p];
      word |= sh >= 0 ? (c << sh) : (c >> -sh);
    }
    words[word0 + w] = word;
  }
}

template <int VPL>
cudaError_t launch(const float* x, uint32_t* words, float* scale, float* zero,
                   int rows, int dim, int bits, int num_bins, int n_steps,
                   long long nwords, cudaStream_t stream) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const size_t smem = (size_t)kRowsPerBlock * dim;
  quant_pack_kernel<VPL><<<blocks, kThreads, smem, stream>>>(
      x, words, scale, zero, rows, dim, bits, num_bins, n_steps, nwords);
  return cudaGetLastError();
}

}  // namespace

// x: rows*dim f32, row-major, on the device; words: nwords =
// ceil(rows*dim*bits/32) uint32; scale, zero: rows f32 each. dim <= 1024,
// 1 <= bits <= 8. Returns cudaGetLastError() after the launch.
extern "C" int quant_pack_launch(const void* x, void* words, void* scale,
                                 void* zero, int rows, int dim, int bits,
                                 int num_bins, int n_steps, long long nwords,
                                 void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  const float* xp = (const float*)x;
  uint32_t* wp = (uint32_t*)words;
  float* sp = (float*)scale;
  float* zp = (float*)zero;
  cudaStream_t st = (cudaStream_t)stream;
  const int vpl = (dim + 31) / 32;
  cudaError_t err;
  if (vpl <= 1) err = launch<1>(xp, wp, sp, zp, rows, dim, bits, num_bins, n_steps, nwords, st);
  else if (vpl <= 2) err = launch<2>(xp, wp, sp, zp, rows, dim, bits, num_bins, n_steps, nwords, st);
  else if (vpl <= 4) err = launch<4>(xp, wp, sp, zp, rows, dim, bits, num_bins, n_steps, nwords, st);
  else if (vpl <= 8) err = launch<8>(xp, wp, sp, zp, rows, dim, bits, num_bins, n_steps, nwords, st);
  else if (vpl <= 16) err = launch<16>(xp, wp, sp, zp, rows, dim, bits, num_bins, n_steps, nwords, st);
  else if (vpl <= 32) err = launch<32>(xp, wp, sp, zp, rows, dim, bits, num_bins, n_steps, nwords, st);
  else err = cudaErrorInvalidValue;
  return (int)err;
}
