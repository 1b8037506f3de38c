// Row-wise adaptive asymmetric quantization with unpacked uint8 codes
// (Check-N-Run §4.2.3), on a Hopper card: the public adaptive_quant op.
//
// Replaces the Pallas TPU kernel src/repro/kernels/adaptive_quant/kernel.py
// (adaptive_quant_pallas / adaptive_quant_kernel, with _quant_err). Per row:
// min/max, step = (max - min) / num_bins, then n_steps greedy steps, each
// scoring the two candidate ranges [lo + step, hi] and [lo, hi - step] by
// the dequantize round-trip error sum((x - (rint((clip(x) - lo) / s) * s +
// lo))^2), taking the better and remembering the best range seen; then
// codes rint((clip(x, lo, hi) - lo) / scale) as uint8, and scale and zero.
//
// Bound: operations. Each of the 2*n_steps+1 candidate ranges costs every
// value a clip, a subtract, an IEEE divide (a reciprocal on the 16-lane
// conversion pipe plus a Newton refinement), a rintf (FRND, also on that
// pipe), a clamp, a multiply, two adds and a squared difference: at
// n_steps = 12 some 25 passes of about fifteen instructions per value,
// against one 4-byte read and one 1-byte write. The reductions add five
// shuffles per lane per candidate.
//
// Design: one warp per row, the row held in registers (VPL values per lane,
// dim <= 1024), so the search never rereads memory; the candidate errors
// reduce with xor-butterfly shuffles (warp_reduce.cuh), which leave every
// lane the same bits and hence the same greedy decision. Codes are written
// straight from the registers, one byte per value, coalesced along the row.
//
// Exactness: the same arithmetic as core.quantize.adaptive_quantize, the
// op's plain version: range / levels and (max - min) / num_bins as a
// multiply by the constant's f32 reciprocal, divides by the per-row scale
// as true IEEE divides, rintf (half to even, as torch.round), and the file
// built with -fmad=false so the dequantize multiply and add round twice, as
// the plain version's separate multiply and add do. Only the order of the
// error sums differs, so the scales and zeros match at f32 rounding and a
// rare near-tie may flip one greedy decision.

#include <cstdint>
#include <cuda_runtime.h>

#include "warp_reduce.cuh"

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

// sum over the row of (x - dequantize(quantize(x)))^2 for range [lo, hi]:
// core.quantize._affine_error for one row.
template <int VPL>
__device__ __forceinline__ float affine_error(const float (&v)[VPL], int dim,
                                              int lane, float lo, float hi,
                                              float levels, float inv_levels) {
  const float rng = hi - lo;
  const float s = rng > 0.f ? rng * inv_levels : 1.f;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    if (lane + 32 * k < dim) {
      const float xc = fminf(fmaxf(v[k], lo), hi);
      const float q = fminf(fmaxf(rintf((xc - lo) / s), 0.f), levels);
      const float d = v[k] - (q * s + lo);
      acc += d * d;
    }
  }
  return warp_sum(acc);
}

template <int VPL>
__global__ void __launch_bounds__(kThreads)
adaptive_quant_kernel(const float* __restrict__ x, uint8_t* __restrict__ codes,
                      float* __restrict__ scale_out, float* __restrict__ zero_out,
                      int rows, int dim, int bits, int num_bins, int n_steps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const float levels = (float)((1 << bits) - 1);
  const float inv_levels = 1.f / levels;
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

  const float step = (mx - mn) * (1.f / (float)num_bins);
  float cur_lo = mn, cur_hi = mx, best_lo = mn, best_hi = mx;
  float best_err = affine_error<VPL>(v, dim, lane, mn, mx, levels, inv_levels);
  for (int s = 0; s < n_steps; ++s) {
    const float err_lo = affine_error<VPL>(v, dim, lane, cur_lo + step, cur_hi,
                                           levels, inv_levels);
    const float err_hi = affine_error<VPL>(v, dim, lane, cur_lo, cur_hi - step,
                                           levels, inv_levels);
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

  const float rng = best_hi - best_lo;
  const float sc = rng > 0.f ? rng * inv_levels : 1.f;
  uint8_t* cr = codes + row * dim;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int j = lane + 32 * k;
    if (j < dim) {
      const float xc = fminf(fmaxf(v[k], best_lo), best_hi);
      cr[j] = (uint8_t)fminf(fmaxf(rintf((xc - best_lo) / sc), 0.f), levels);
    }
  }
  if (lane == 0) {
    scale_out[row] = sc;
    zero_out[row] = best_lo;
  }
}

template <int VPL>
cudaError_t launch(const float* x, uint8_t* codes, float* scale, float* zero,
                   int rows, int dim, int bits, int num_bins, int n_steps,
                   cudaStream_t stream) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  adaptive_quant_kernel<VPL><<<blocks, kThreads, 0, stream>>>(
      x, codes, scale, zero, rows, dim, bits, num_bins, n_steps);
  return cudaGetLastError();
}

}  // namespace

// x: rows*dim f32, row-major, on the device; codes: rows*dim uint8; scale,
// zero: rows f32 each. 1 <= dim <= 1024, 1 <= bits <= 8, num_bins >= 1.
// Returns cudaGetLastError() after the launch.
extern "C" int adaptive_quant_launch(const void* x, void* codes, void* scale,
                                     void* zero, int rows, int dim, int bits,
                                     int num_bins, int n_steps, void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  const float* xp = (const float*)x;
  uint8_t* cp = (uint8_t*)codes;
  float* sp = (float*)scale;
  float* zp = (float*)zero;
  cudaStream_t st = (cudaStream_t)stream;
  const int vpl = (dim + 31) / 32;
  cudaError_t err;
  if (vpl <= 1) err = launch<1>(xp, cp, sp, zp, rows, dim, bits, num_bins, n_steps, st);
  else if (vpl <= 2) err = launch<2>(xp, cp, sp, zp, rows, dim, bits, num_bins, n_steps, st);
  else if (vpl <= 4) err = launch<4>(xp, cp, sp, zp, rows, dim, bits, num_bins, n_steps, st);
  else if (vpl <= 8) err = launch<8>(xp, cp, sp, zp, rows, dim, bits, num_bins, n_steps, st);
  else if (vpl <= 16) err = launch<16>(xp, cp, sp, zp, rows, dim, bits, num_bins, n_steps, st);
  else if (vpl <= 32) err = launch<32>(xp, cp, sp, zp, rows, dim, bits, num_bins, n_steps, st);
  else err = cudaErrorInvalidValue;
  return (int)err;
}
