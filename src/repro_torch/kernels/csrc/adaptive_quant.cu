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
// value thirteen instructions on the common path: max and min (the clip), a
// subtract and a multiply (the quotient), two adds (the rounding), a
// subtract and a compare (the window test below, its OR folded into the
// compare), a multiply and an add (the dequantized value), a subtract, a
// multiply and an add (the squared error's sum). None runs on the 16-lane
// conversion pipe, so instruction issue bounds the kernel; one 4-byte read
// and one 1-byte write a value are far below it.
//
// Design: the layout of quant_pack.cu. A row lies in the registers of a
// group of L lanes (a power of two), each holding V = 32/L * K values
// (K = dim/32 rounded up to a power of two), so a candidate's scalar work
// (its range, scale, reciprocal, window and the greedy decision) is paid
// once per 16 values: at dim 64, L = 4 and a warp holds 8 rows. The error
// sum keeps the order of a warp that owns the row (this kernel's earlier
// design, and PyTorch's CUDA row sum where a warp spans the row): "virtual
// lane" t of 32 sums the values t + 32k in k order, then a tree adds lanes
// t and t + 16, t + 8, ..., t + 1. Lane j of the group holds the virtual
// lanes t = j + L*m, so the tree's first levels run in registers and the
// last log2(L) cross lanes as xor-butterfly shuffles inside the group,
// which leave every lane of the group the same bits and hence the same
// greedy decision. The sums, and so every decision, scale, zero and code,
// are bit-identical to the one-warp-a-row design's.
//
// Quotients without a divide. The plain version computes rint(fl(a / s))
// with a = fl(clip(x) - lo). Here each candidate takes inv = fl(1/s) once
// (__frcp_rn, correctly rounded) and each value t = fl(a * inv), rounded
// by two adds. With u = 2^-24 and Q = a / s exactly: where inv and t are
// normal, t = Q(1 + e1)(1 + e2) and fl(a / s) = Q(1 + e3), |e1|, |e2|, |e3|
// <= u, so |t - fl(a / s)| <= Q(3u + u^2). As a <= hi - lo and s =
// fl((hi - lo) * fl(1/levels)) (relative error below 2^-22 even where s is
// subnormal but 1/s finite), Q <= levels(1 + 2^-21), hence |t - fl(a / s)|
// < 4u(levels + 1) = the window. rint changes only at a half-integer: where
// t lies farther than the window from every half-integer, the two
// quotients lie between the same two half-integers and round to the same
// integer, at most levels, so the clamp to [0, levels] does nothing. The
// test |t - rint(t)| < 0.5 - window is false for a NaN or infinite t (s
// subnormal with 1/s overflowing, or 0 * inf); where inv is subnormal or 0
// (s >= 2^126, or s infinite), e1 is not bounded by u and the threshold is
// 0, so every value fails it. A lane with any value that fails it redoes
// its values with the plain version's true IEEE divide and clamp
// (exact_code, kept out of line so the common path holds no divide). Random
// quotients fall in the window at a rate of 2 * window a unit: 1.5e-5 at 4
// bits, 1.2e-4 at 8. tests/test_torch_adaptive_quant.py holds this rule in
// numpy against rint(a / s) at exact halves, their ulp neighbours and
// subnormal scales, with the window below.
//
// Rows wider than 1,024 values take the wide route (row_wide.cuh, shared
// with quant_pack.cu): one block of 256 threads a row, at most 32 values a
// thread, up to 8,192 values, with the same candidate arithmetic and
// window rule, the error sums added by thread, warp and block.
//
// Exactness otherwise: range / levels and (max - min) / num_bins as a
// multiply by the constant's f32 reciprocal, as the plain version does;
// round half to even, as rintf and torch.round; the file built with
// -fmad=false so the dequantize multiply and add round twice, as the plain
// version's separate multiply and add do. Row offsets are 64-bit.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "row_wide.cuh"

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kThreads = 256;
constexpr int kValuesPerLane = 16;
constexpr float kRoundMagic = 12582912.f;  // 1.5 * 2^23
// The window about a half-integer, per unit of levels + 1: 2^-22 = 4u.
constexpr float kWindowUnit = 2.384185791015625e-07f;

// rint(r) for 0 <= r <= 2^22, in two fma-pipe adds that are never
// contracted or reassociated.
__device__ __forceinline__ float round_even(float r) {
  return __fsub_rn(__fadd_rn(r, kRoundMagic), kRoundMagic);
}

// Reductions over the L lanes of a row group (xor offsets below L stay in
// the group). Each stage combines the same two operands on both lanes of a
// pair, so every lane of the group ends with the same bits.
template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int L>
__device__ __forceinline__ float group_min(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int L>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// A lane's registers: slot k*M + m holds the row's value 32k + L*m + j
// (lane j of the group, virtual lane t = L*m + j), M = 32 / L slots a k.
template <int L, int K>
struct Layout {
  static constexpr int M = 32 / L;
  static constexpr int V = M * K;
};

// A candidate range [lo, hi] with its scale s, inv = fl(1/s), and the
// threshold of the window test: 0, so that every value takes the divide,
// where inv is subnormal or 0, or hi < lo (a ratio above 1 can cross the
// bounds; the quotients are then negative and the clamp matters).
struct Range {
  float lo, hi, s, inv, half_w;
};

__device__ __forceinline__ Range make_range(float lo, float hi, float inv_levels,
                                            float window) {
  const float rng = hi - lo;
  const float s = rng > 0.f ? rng * inv_levels : 1.f;
  const float inv = __frcp_rn(s);
  return Range{lo, hi, s, inv, rng >= 0.f && inv >= FLT_MIN ? 0.5f - window : 0.f};
}

// The plain version's code of one value: a true IEEE divide, rintf and the
// clamp. Out of line, so the common path holds no divide.
__device__ __noinline__ float exact_code(float v, float lo, float hi, float s,
                                         float levels) {
  const float xc = fminf(fmaxf(v, lo), hi);
  return fminf(fmaxf(rintf(__fdiv_rn(xc - lo, s)), 0.f), levels);
}

// The same code on the common path; sets `near` where the quotient fails
// the window test (then the code may differ from exact_code's).
__device__ __forceinline__ float fast_code(float v, const Range& c, bool& near) {
  const float xc = fminf(fmaxf(v, c.lo), c.hi);
  const float t = (xc - c.lo) * c.inv;
  const float r = round_even(t);
  near |= !(fabsf(t - r) < c.half_w);
  return r;
}

// This lane's share of sum((x - (code * s + lo))^2), in the order above up
// to the shuffles: code(slot) gives each slot's code. `valid` marks the
// slots that hold a value of the row (all if FULL).
template <int L, int K, bool FULL, typename Code>
__device__ __forceinline__ float lane_error(const float (&v)[Layout<L, K>::V],
                                            uint32_t valid, const Range& c,
                                            Code code) {
  constexpr int M = Layout<L, K>::M;
  float part[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int slot = k * M + m;
      const float d = v[slot] - (code(slot) * c.s + c.lo);
      float dd = d * d;
      if (!FULL && !((valid >> slot) & 1u)) dd = 0.f;
      part[m] = k == 0 ? dd : part[m] + dd;
    }
  }
#pragma unroll
  for (int off = M / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int m = 0; m < off; ++m) part[m] = part[m] + part[m + off];
  }
  return part[0];
}

// sum over the row of (x - dequantize(quantize(x)))^2 for one candidate:
// core.quantize._affine_error for one row.
template <int L, int K, bool FULL>
__device__ __forceinline__ float affine_error(const float (&v)[Layout<L, K>::V],
                                              uint32_t valid, const Range& c,
                                              float levels) {
  bool near = false;
  float e = lane_error<L, K, FULL>(v, valid, c,
                                   [&](int slot) { return fast_code(v[slot], c, near); });
  if (near)  // rare: this lane's values again, by the divide
    e = lane_error<L, K, FULL>(v, valid, c, [&](int slot) {
      return exact_code(v[slot], c.lo, c.hi, c.s, levels);
    });
  return group_sum<L>(e);
}

// L lanes a row, K values a virtual lane; FULL: dim == 32*K (no masking).
template <int L, int K, bool FULL>
__global__ void __launch_bounds__(kThreads)
adaptive_quant_kernel(const float* __restrict__ x, uint8_t* __restrict__ codes,
                      float* __restrict__ scale_out, float* __restrict__ zero_out,
                      int rows, int dim, int bits, int num_bins, int n_steps) {
  constexpr int M = Layout<L, K>::M;
  constexpr int V = Layout<L, K>::V;
  constexpr int kRowsPerBlock = kThreads / L;
  const int j = threadIdx.x % L;
  uint32_t valid = 0;  // slots that hold a value of the row
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int m = 0; m < M; ++m)
      if (32 * k + L * m + j < dim) valid |= 1u << (k * M + m);
  // Every lane runs the group's shuffles; only a live row loads and stores.
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / L;
  const bool live = row < rows;
  const float levels = (float)((1 << bits) - 1);
  const float inv_levels = 1.f / levels;
  const float window = (levels + 1.f) * kWindowUnit;

  const float* xr = x + row * dim + j;
  float v[V];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int slot = k * M + m;
      v[slot] = live && (FULL || ((valid >> slot) & 1u)) ? xr[32 * k + L * m] : 0.f;
    }
  float mn = kBig, mx = -kBig;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (FULL || ((valid >> i) & 1u)) {
      mn = fminf(mn, v[i]);
      mx = fmaxf(mx, v[i]);
    }
  }
  mn = group_min<L>(mn);
  mx = group_max<L>(mx);

  const float step = (mx - mn) * (1.f / (float)num_bins);
  float cur_lo = mn, cur_hi = mx, best_lo = mn, best_hi = mx;
  float best_err = affine_error<L, K, FULL>(
      v, valid, make_range(mn, mx, inv_levels, window), levels);
  for (int s = 0; s < n_steps; ++s) {
    const float err_lo = affine_error<L, K, FULL>(
        v, valid, make_range(cur_lo + step, cur_hi, inv_levels, window), levels);
    const float err_hi = affine_error<L, K, FULL>(
        v, valid, make_range(cur_lo, cur_hi - step, inv_levels, window), levels);
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

  const Range c = make_range(best_lo, best_hi, inv_levels, window);
  float q[V];
  bool near = false;
#pragma unroll
  for (int i = 0; i < V; ++i) q[i] = fast_code(v[i], c, near);
  if (near) {
#pragma unroll
    for (int i = 0; i < V; ++i) q[i] = exact_code(v[i], c.lo, c.hi, c.s, levels);
  }
  if (!live) return;
  uint8_t* cr = codes + row * dim + j;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int m = 0; m < M; ++m)
      if (FULL || ((valid >> (k * M + m)) & 1u))
        cr[32 * k + L * m] = (uint8_t)q[k * M + m];
  if (j == 0) {
    scale_out[row] = c.s;
    zero_out[row] = best_lo;
  }
}

// adaptive_quant's candidate error on the wide route: this thread's share
// of affine_error's sum, its values added in i order, by the divide where a
// quotient fails the window test.
template <int V, bool FULL>
struct WideAffineError {
  const float (&v)[V];
  int dim;
  float levels, inv_levels, window;

  template <typename Code>
  __device__ __forceinline__ float sum(const Range& c, Code code) const {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = v[i] - (code(i) * c.s + c.lo);
      if (wide::holds<V, FULL>(i, dim)) acc = acc + d * d;
    }
    return acc;
  }
  __device__ __forceinline__ float partial(float lo, float hi) const {
    const Range c = make_range(lo, hi, inv_levels, window);
    bool near = false;
    const float e = sum(c, [&](int i) { return fast_code(v[i], c, near); });
    if (!near) return e;
    return sum(c, [&](int i) { return exact_code(v[i], c.lo, c.hi, c.s, levels); });
  }
  __device__ __forceinline__ float total(float, float, float s) const { return s; }
};

// The wide route: one block of wide::kWideThreads a row, V values a thread
// (FULL: dim == kWideThreads * V).
template <int V, bool FULL>
__global__ void __launch_bounds__(wide::kWideThreads)
adaptive_quant_wide_kernel(const float* __restrict__ x, uint8_t* __restrict__ codes,
                           float* __restrict__ scale_out, float* __restrict__ zero_out,
                           int dim, int bits, int num_bins, int n_steps) {
  __shared__ float2 slot[2][wide::kWideWarps];
  int next = 0;
  const int t = threadIdx.x;
  const long long row = blockIdx.x;
  float v[V];
  wide::load_row<V, FULL>(x + row * dim, dim, v);
  const float2 mm = wide::block_minmax<V, FULL>(v, dim, slot, next);
  const float levels = (float)((1 << bits) - 1);
  const float inv_levels = 1.f / levels;
  const WideAffineError<V, FULL> err{v, dim, levels, inv_levels,
                                     (levels + 1.f) * kWindowUnit};
  const float2 best = wide::greedy_search(mm.x, mm.y, num_bins, n_steps, err, slot, next);
  const Range c = make_range(best.x, best.y, inv_levels, err.window);
  float q[V];
  bool near = false;
#pragma unroll
  for (int i = 0; i < V; ++i) q[i] = fast_code(v[i], c, near);
  if (near) {
#pragma unroll
    for (int i = 0; i < V; ++i) q[i] = exact_code(v[i], c.lo, c.hi, c.s, levels);
  }
  uint8_t* cr = codes + row * dim + t;
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (wide::holds<V, FULL>(i, dim)) cr[wide::kWideThreads * i] = (uint8_t)q[i];
  if (t == 0) {
    scale_out[row] = c.s;
    zero_out[row] = best.x;
  }
}

struct Args {
  const float* x;
  uint8_t* codes;
  float* scale;
  float* zero;
  int rows, dim, bits, num_bins, n_steps;
  cudaStream_t stream;
};

template <int L, int K, bool FULL>
cudaError_t launch(const Args& a) {
  constexpr int kRowsPerBlock = kThreads / L;
  const int blocks = (a.rows + kRowsPerBlock - 1) / kRowsPerBlock;
  adaptive_quant_kernel<L, K, FULL><<<blocks, kThreads, 0, a.stream>>>(
      a.x, a.codes, a.scale, a.zero, a.rows, a.dim, a.bits, a.num_bins, a.n_steps);
  return cudaGetLastError();
}

// K values a virtual lane, and lanes enough for kValuesPerLane values each
// (at most 32).
template <int K>
cudaError_t launch_k(const Args& a) {
  constexpr int L = 32 * K / kValuesPerLane < 32 ? 32 * K / kValuesPerLane : 32;
  return a.dim == 32 * K ? launch<L, K, true>(a) : launch<L, K, false>(a);
}

// The wide route at V values a thread.
template <int V>
cudaError_t launch_wide(const Args& a) {
  if (a.dim == wide::kWideThreads * V)
    adaptive_quant_wide_kernel<V, true><<<a.rows, wide::kWideThreads, 0, a.stream>>>(
        a.x, a.codes, a.scale, a.zero, a.dim, a.bits, a.num_bins, a.n_steps);
  else
    adaptive_quant_wide_kernel<V, false><<<a.rows, wide::kWideThreads, 0, a.stream>>>(
        a.x, a.codes, a.scale, a.zero, a.dim, a.bits, a.num_bins, a.n_steps);
  return cudaGetLastError();
}

}  // namespace

// x: rows*dim f32, row-major, on the device; codes: rows*dim uint8; scale,
// zero: rows f32 each. 1 <= dim <= 8192 (the wide route past 1024),
// 1 <= bits <= 8, num_bins >= 1.
// Returns cudaGetLastError() after the launch.
extern "C" int adaptive_quant_launch(const void* x, void* codes, void* scale,
                                     void* zero, int rows, int dim, int bits,
                                     int num_bins, int n_steps, void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  const Args a{(const float*)x, (uint8_t*)codes, (float*)scale, (float*)zero,
               rows, dim, bits, num_bins, n_steps, (cudaStream_t)stream};
  cudaError_t err;
  if (dim <= 32) err = launch_k<1>(a);
  else if (dim <= 64) err = launch_k<2>(a);
  else if (dim <= 128) err = launch_k<4>(a);
  else if (dim <= 256) err = launch_k<8>(a);
  else if (dim <= 512) err = launch_k<16>(a);
  else if (dim <= 1024) err = launch_k<32>(a);
  else if (dim <= 2048) err = launch_wide<8>(a);
  else if (dim <= 3072) err = launch_wide<12>(a);
  else if (dim <= 4096) err = launch_wide<16>(a);
  else if (dim <= 6144) err = launch_wide<24>(a);
  else if (dim <= wide::kMaxDim) err = launch_wide<32>(a);
  else err = cudaErrorInvalidValue;
  return (int)err;
}
