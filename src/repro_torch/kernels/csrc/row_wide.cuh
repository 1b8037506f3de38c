// The wide route of the two row-wise quantizers (quant_pack.cu and
// adaptive_quant.cu): a row wider than 1,024 values spread over one block.
//
// The narrow routes keep a row in one lane group's registers, at most 32
// values a lane, so they stop at dim 1,024. Here a block of kWideThreads
// threads owns a row: thread t holds the values t + kWideThreads * i,
// i < V (coalesced loads), at most 32 a thread, so a row of up to
// kWideThreads * 32 = 8,192 values fits the registers. Every reduction over
// the row (min and max, and each greedy step's two error sums) runs in
// three stages: a thread adds its values in i order, a warp adds its lanes
// in an xor butterfly (every lane ends with the same bits: each pair adds
// the same two operands), and after one barrier every thread adds the
// kWideWarps warp totals, in warp order, from shared memory. Every thread
// thus holds the same bits and takes the same greedy decision. Two
// shared-memory slots alternate between reductions, so one barrier a
// reduction is enough: a thread rewrites a slot only after the barrier of
// the reduction that followed its last read of it.
//
// The search is the narrow routes' greedy search (and the reference's
// _search_range): n_steps steps from [min, max], each scoring the two
// candidates [lo + step, hi] and [lo, hi - step] by Err, moving to the
// better (ties to the first) and keeping the best range seen. Err is the
// kernel's own candidate error: quant_pack's r-space error, adaptive_quant's
// dequantize round-trip error. Both kernels' wide routes call this one
// search.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace wide {

constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kMaxPerThread = 32;
constexpr int kMaxDim = kWideThreads * kMaxPerThread;  // 8,192
constexpr float kBig = 3.4e38f;

// The row's values this thread holds: v[i] = x[row][t + kWideThreads * i],
// 0 past the row's end; FULL: dim == kWideThreads * V.
template <int V, bool FULL>
__device__ __forceinline__ void load_row(const float* __restrict__ xr, int dim,
                                         float (&v)[V]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = t + kWideThreads * i;
    v[i] = (FULL || c < dim) ? xr[c] : 0.f;
  }
}

template <int V, bool FULL>
__device__ __forceinline__ bool holds(int i, int dim) {
  return FULL || (int)threadIdx.x + kWideThreads * i < dim;
}

// (a, b) summed over the block, the same bits in every thread. `slot`
// alternates between calls (see the file's head).
__device__ __forceinline__ float2 block_sum2(float2 p, float2 (&slot)[2][kWideWarps],
                                             int& next) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    p.x += __shfl_xor_sync(0xffffffffu, p.x, off);
    p.y += __shfl_xor_sync(0xffffffffu, p.y, off);
  }
  float2 (&s)[kWideWarps] = slot[next];
  next ^= 1;
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = p;
  __syncthreads();
  float2 tot = s[0];
#pragma unroll
  for (int w = 1; w < kWideWarps; ++w) {
    tot.x += s[w].x;
    tot.y += s[w].y;
  }
  return tot;
}

// (min, max) of the row over the block.
template <int V, bool FULL>
__device__ __forceinline__ float2 block_minmax(const float (&v)[V], int dim,
                                               float2 (&slot)[2][kWideWarps],
                                               int& next) {
  float mn = kBig, mx = -kBig;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (holds<V, FULL>(i, dim)) {
      mn = fminf(mn, v[i]);
      mx = fmaxf(mx, v[i]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  float2 (&s)[kWideWarps] = slot[next];
  next ^= 1;
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = make_float2(mn, mx);
  __syncthreads();
  float2 r = s[0];
#pragma unroll
  for (int w = 1; w < kWideWarps; ++w) {
    r.x = fminf(r.x, s[w].x);
    r.y = fmaxf(r.y, s[w].y);
  }
  return r;
}

// The greedy range search over the row. Err provides
//   float partial(lo, hi): this thread's share of a candidate's error sum,
//   float total(lo, hi, sum): the candidate's error from the block's sum.
// Returns the best range (lo, hi); n_steps == 0 returns (min, max).
template <class Err>
__device__ __forceinline__ float2 greedy_search(float mn, float mx, int num_bins,
                                                int n_steps, const Err& err,
                                                float2 (&slot)[2][kWideWarps],
                                                int& next) {
  float best_lo = mn, best_hi = mx;
  if (n_steps <= 0) return make_float2(best_lo, best_hi);
  const float step = (mx - mn) * (1.f / (float)num_bins);
  float cur_lo = mn, cur_hi = mx;
  const float2 e0 = block_sum2(make_float2(err.partial(mn, mx), 0.f), slot, next);
  float best_err = err.total(mn, mx, e0.x);
  for (int s = 0; s < n_steps; ++s) {
    const float lo_a = cur_lo + step, hi_b = cur_hi - step;
    const float2 e = block_sum2(
        make_float2(err.partial(lo_a, cur_hi), err.partial(cur_lo, hi_b)), slot, next);
    const float err_lo = err.total(lo_a, cur_hi, e.x);
    const float err_hi = err.total(cur_lo, hi_b, e.y);
    const bool take_lo = err_lo <= err_hi;
    const float new_lo = take_lo ? lo_a : cur_lo;
    const float new_hi = take_lo ? cur_hi : hi_b;
    const float cur_err = take_lo ? err_lo : err_hi;
    if (cur_err < best_err) {
      best_lo = new_lo;
      best_hi = new_hi;
      best_err = cur_err;
    }
    cur_lo = new_lo;
    cur_hi = new_hi;
  }
  return make_float2(best_lo, best_hi);
}

}  // namespace wide
