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
// n_steps = 9) the search does 2*n_steps+1 passes of nine instructions over
// every value (sub, mul, max, min, two adds for the rounding, sub, mul,
// add), against one 4-byte read and bits/8 bytes of write per value, so
// instruction issue bounds it, not device memory.
//
// Design: a row lies in the registers of a group of L lanes (a power of
// two), each holding V = 32/L * K values (K = dim/32, rounded up to a power
// of two), so a candidate's scalar work (its range, the reciprocal of its
// scale, the greedy decision) is paid once per V values: at dim 64, V = 16
// and L = 4, so a warp holds 8 rows. The error sum keeps the order of a
// warp that owns the row: "virtual lane" t of 32 sums the values t + 32k in
// k order, then a tree adds lanes t and t + 16, t + 8, ..., t + 1 (the
// order of the parent kernel, and of PyTorch's CUDA row sum where a warp
// spans the row). Lane j of the group holds the virtual lanes t = j + L*m,
// so the tree's first levels (offsets 16 .. L) run in registers and the
// last log2(L) cross lanes as xor-butterfly shuffles inside the group,
// which leave every lane of the group with identical bits and hence the
// same decision. A block owns a multiple of 32 rows, so its code range
// starts on a word boundary. Where dim = 32*K, bits is 1, 2, 4 or 8 and
// the row's K*bits words split evenly over the group, the lanes OR their
// codes into the words in registers and a reduce-scatter over the group
// leaves lane j with words j*W/L .. (j+1)*W/L - 1 of the row, which it
// stores; otherwise codes are staged in shared memory and each thread then
// builds whole output words. Codes past the last row are zero, so the tail
// bits of the final word are zero.
//
// Rows wider than 1,024 values take the wide route (row_wide.cuh): one
// block of 256 threads a row, at most 32 values a thread, so up to 8,192
// values; the same search and code arithmetic, the error sums added by
// thread, warp and block. Its codes are staged in shared memory and each
// thread builds whole words of the row's bit range; where dim*bits is not a
// multiple of 32, a row's first and last words are shared with its
// neighbours, so the launcher zeroes the stream first and those two words
// are ORed in atomically (every other word is stored). Rows wider than 8,192
// take the long route (row_wide.cuh): the same block a row, the row staged
// in shared memory where it fits (else read from device memory) and
// streamed by every pass in the wide route's order; each word's codes are
// computed from the row as the word is built.
//
// Exactness: round half to even as rint does, by adding and subtracting
// 1.5 * 2^23 (exact for the clamped values, in [0, 255]); a true IEEE
// divide for the final codes and a correctly rounded reciprocal
// (__frcp_rn, bit-equal to 1.f / s) for the search's 1/scale; and, where
// the reference divides by a constant (range / levels, range / num_bins), a
// multiply by the constant's f32 reciprocal, which is what XLA compiles
// that divide into. The file is built with -fmad=false so no multiply and
// add are fused where the reference rounds twice.

#include <cstdint>
#include <cuda_runtime.h>

#include "row_wide.cuh"

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kThreads = 256;
constexpr int kValuesPerLane = 16;
constexpr float kRoundMagic = 12582912.f;  // 1.5 * 2^23

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

// scale^2 * sum over the row of (r - rint(clip(r, 0, levels)))^2 with
// r = (x - lo) * (1 / scale): the reference's _err_pair for one candidate.
// `valid` marks the slots that hold a value of the row (all if FULL).
template <int L, int K, bool FULL>
__device__ __forceinline__ float range_error(const float (&v)[Layout<L, K>::V],
                                             uint32_t valid, float lo, float hi,
                                             float levels, float inv_levels) {
  constexpr int M = Layout<L, K>::M;
  const float rng = hi - lo;
  const float s = rng > 0.f ? rng * inv_levels : 1.f;
  const float inv = __frcp_rn(s);
  float part[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int slot = k * M + m;
      const float r = (v[slot] - lo) * inv;
      const float d = r - round_even(fminf(fmaxf(r, 0.f), levels));
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
  return (s * s) * group_sum<L>(part[0]);
}

// One stage per xor offset O of the group, on the first N words of p:
// lanes with bit O set keep the upper half and send the lower, the others
// the reverse; what is kept lands in p[0, N/2).
template <int O, int N, int W>
__device__ __forceinline__ void reduce_scatter(uint32_t (&p)[W], int j) {
  if constexpr (O > 0) {
    const bool upper = (j & O) != 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const uint32_t send = upper ? p[i] : p[i + N / 2];
      const uint32_t keep = upper ? p[i + N / 2] : p[i];
      p[i] = keep | __shfl_xor_sync(0xffffffffu, send, O);
    }
    reduce_scatter<O / 2, N / 2>(p, j);
  }
}

// Whether a row of dim = 32*K packs its codes in registers: each slot's L
// codes (lanes 0..L-1) lie in one word, and the row's K*bits words split
// evenly over the L lanes.
template <int L, int K>
__host__ __device__ constexpr bool packs_in_registers(int bits) {
  return (bits == 1 || bits == 2 || bits == 4 || bits == 8) && L * bits <= 32 &&
         (K * bits) % L == 0;
}

// The register pack: the row's W = K*BITS words, each lane ORing its codes
// into all of them, then a reduce-scatter over the group (at offset o the
// lanes with bit o set keep the upper half of their words and send the
// lower) leaves lane j with words j*W/L .. (j+1)*W/L - 1, which it stores
// at row_words. Every lane of the warp runs it (the shuffles); only `live`
// rows store.
template <int BITS, int L, int K>
__device__ __forceinline__ void pack_row(const uint32_t (&q)[Layout<L, K>::V],
                                         int j, bool live,
                                         uint32_t* row_words) {
  constexpr int M = Layout<L, K>::M;
  constexpr int W = K * BITS;
  if constexpr (packs_in_registers<L, K>(BITS)) {
    uint32_t p[W];
#pragma unroll
    for (int w = 0; w < W; ++w) p[w] = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int bit = L * m * BITS;  // of the L codes of slot m, lane 0's
        p[k * BITS + bit / 32] |= q[k * M + m] << (bit % 32 + j * BITS);
      }
    }
    reduce_scatter<L / 2, W>(p, j);
    constexpr int kMine = W / L;
    uint32_t* dst = row_words + j * kMine;
    if (!live) return;
    if constexpr (kMine % 4 == 0) {
#pragma unroll
      for (int i = 0; i < kMine; i += 4)
        *reinterpret_cast<uint4*>(dst + i) = make_uint4(p[i], p[i + 1], p[i + 2], p[i + 3]);
    } else if constexpr (kMine % 2 == 0) {
#pragma unroll
      for (int i = 0; i < kMine; i += 2)
        *reinterpret_cast<uint2*>(dst + i) = make_uint2(p[i], p[i + 1]);
    } else {
#pragma unroll
      for (int i = 0; i < kMine; ++i) dst[i] = p[i];
    }
  }
}

// L lanes a row, K values a virtual lane; FULL: dim == 32*K (no masking);
// reg_pack: FULL and packs_in_registers<L, K>(bits).
template <int L, int K, bool FULL>
__global__ void __launch_bounds__(kThreads)
quant_pack_kernel(const float* __restrict__ x, uint32_t* __restrict__ words,
                  float* __restrict__ scale_out, float* __restrict__ zero_out,
                  int rows, int dim, int bits, int num_bins, int n_steps,
                  long long nwords, bool reg_pack) {
  constexpr int M = Layout<L, K>::M;
  constexpr int V = Layout<L, K>::V;
  constexpr int kGroups = kThreads / L;
  constexpr int kRowsPerBlock = kGroups > 32 ? kGroups : 32;
  extern __shared__ uint8_t codes[];  // kRowsPerBlock * dim, unless reg_pack
  const int g = threadIdx.x / L;
  const int j = threadIdx.x % L;
  uint32_t valid = 0;  // slots that hold a value of the row
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int m = 0; m < M; ++m)
      if (32 * k + L * m + j < dim) valid |= 1u << (k * M + m);
  const long long row0 = (long long)blockIdx.x * kRowsPerBlock;
  const float levels = (float)((1 << bits) - 1);
  const float inv_levels = 1.f / levels;

  for (int r = g; r < kRowsPerBlock; r += kGroups) {
    const long long row = row0 + r;
    const bool live = row < rows;
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

    float best_lo = mn, best_hi = mx;
    if (n_steps > 0) {
      const float step = (mx - mn) * (1.f / (float)num_bins);
      float cur_lo = mn, cur_hi = mx;
      float best_err =
          range_error<L, K, FULL>(v, valid, mn, mx, levels, inv_levels);
      for (int s = 0; s < n_steps; ++s) {
        const float err_lo = range_error<L, K, FULL>(
            v, valid, cur_lo + step, cur_hi, levels, inv_levels);
        const float err_hi = range_error<L, K, FULL>(
            v, valid, cur_lo, cur_hi - step, levels, inv_levels);
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
    uint32_t q[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float xc = fminf(fmaxf(v[i], best_lo), best_hi);
      const float c = round_even(__fdiv_rn(xc - best_lo, sc));
      q[i] = live ? (uint32_t)fminf(fmaxf(c, 0.f), levels) : 0u;
    }
    if (reg_pack) {
      uint32_t* row_words = words + row * (K * bits);
      switch (bits) {
        case 1: pack_row<1, L, K>(q, j, live, row_words); break;
        case 2: pack_row<2, L, K>(q, j, live, row_words); break;
        case 4: pack_row<4, L, K>(q, j, live, row_words); break;
        default: pack_row<8, L, K>(q, j, live, row_words); break;
      }
    } else {
      uint8_t* crow = codes + r * dim + j;
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int m = 0; m < M; ++m)
          if (FULL || ((valid >> (k * M + m)) & 1u))
            crow[32 * k + L * m] = (uint8_t)q[k * M + m];
    }
    if (live && j == 0) {
      scale_out[row] = sc;
      zero_out[row] = best_lo;
    }
  }
  if (reg_pack) return;
  __syncthreads();

  // The block's kRowsPerBlock*dim codes fill exactly kRowsPerBlock/32 *
  // dim*bits words, starting at word blockIdx.x times that. Word w holds
  // the codes overlapping bits [32w, 32w+32) of the block's stream.
  const int n_codes = kRowsPerBlock * dim;
  const int block_words = kRowsPerBlock / 32 * dim * bits;
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

// quant_pack's candidate error on the wide route: range_error's terms for
// the values this thread holds, added in i order; total() scales the
// block's sum by scale^2, as range_error does.
template <int V, bool FULL>
struct WideRangeError {
  const float (&v)[V];
  int dim;
  float levels, inv_levels;

  __device__ __forceinline__ float scale(float lo, float hi) const {
    const float rng = hi - lo;
    return rng > 0.f ? rng * inv_levels : 1.f;
  }
  __device__ __forceinline__ float partial(float lo, float hi) const {
    const float inv = __frcp_rn(scale(lo, hi));
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float r = (v[i] - lo) * inv;
      const float d = r - round_even(fminf(fmaxf(r, 0.f), levels));
      if (wide::holds<V, FULL>(i, dim)) acc = acc + d * d;
    }
    return acc;
  }
  __device__ __forceinline__ float total(float lo, float hi, float sum) const {
    const float s = scale(lo, hi);
    return (s * s) * sum;
  }
};

// The wide route: one block of wide::kWideThreads a row, V values a thread
// (FULL: dim == kWideThreads * V).
template <int V, bool FULL>
__global__ void __launch_bounds__(wide::kWideThreads)
quant_pack_wide_kernel(const float* __restrict__ x, uint32_t* __restrict__ words,
                       float* __restrict__ scale_out, float* __restrict__ zero_out,
                       int dim, int bits, int num_bins, int n_steps) {
  __shared__ float2 slot[2][wide::kWideWarps];
  __shared__ uint8_t codes[wide::kMaxDim];
  int next = 0;
  const int t = threadIdx.x;
  const long long row = blockIdx.x;
  float v[V];
  wide::load_row<V, FULL>(x + row * dim, dim, v);
  const float2 mm = wide::block_minmax<V, FULL>(v, dim, slot, next);
  const float levels = (float)((1 << bits) - 1);
  const float inv_levels = 1.f / levels;
  const WideRangeError<V, FULL> err{v, dim, levels, inv_levels};
  const float2 best = wide::greedy_search(mm.x, mm.y, num_bins, n_steps, err, slot, next);
  const float sc = err.scale(best.x, best.y);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (wide::holds<V, FULL>(i, dim)) {
      const float xc = fminf(fmaxf(v[i], best.x), best.y);
      const float c = round_even(__fdiv_rn(xc - best.x, sc));
      codes[t + wide::kWideThreads * i] = (uint8_t)fminf(fmaxf(c, 0.f), levels);
    }
  }
  if (t == 0) {
    scale_out[row] = sc;
    zero_out[row] = best.x;
  }
  __syncthreads();

  // The row's codes fill stream bits [b0, b1); word w holds bits [32w,
  // 32w + 32), the codes overlapping them.
  const long long b0 = row * dim * bits, b1 = b0 + (long long)dim * bits;
  for (long long w = (b0 >> 5) + t; w <= ((b1 - 1) >> 5); w += wide::kWideThreads) {
    const long long wb = w << 5;
    const int p_lo = wb > b0 ? (int)((wb - b0) / bits) : 0;
    const int p_hi = min(dim - 1, (int)((wb + 31 - b0) / bits));
    uint32_t word = 0;
    for (int p = p_lo; p <= p_hi; ++p) {
      const int sh = (int)(b0 + (long long)p * bits - wb);
      const uint32_t c = codes[p];
      word |= sh >= 0 ? (c << sh) : (c >> -sh);
    }
    if (wb >= b0 && wb + 32 <= b1) words[w] = word;
    else atomicOr(words + w, word);
  }
}

// quant_pack's candidate error on the long route: WideRangeError's terms
// for this thread's values t + kWideThreads * i, streamed from `row`.
struct LongRangeError {
  const float* row;
  int dim;
  float levels, inv_levels;

  __device__ __forceinline__ float scale(float lo, float hi) const {
    const float rng = hi - lo;
    return rng > 0.f ? rng * inv_levels : 1.f;
  }
  __device__ __forceinline__ float partial(float lo, float hi) const {
    const float inv = __frcp_rn(scale(lo, hi));
    float acc = 0.f;
    for (int c = threadIdx.x; c < dim; c += wide::kWideThreads) {
      const float r = (row[c] - lo) * inv;
      const float d = r - round_even(fminf(fmaxf(r, 0.f), levels));
      acc = acc + d * d;
    }
    return acc;
  }
  __device__ __forceinline__ float total(float lo, float hi, float sum) const {
    const float s = scale(lo, hi);
    return (s * s) * sum;
  }
};

// The long route: one block of wide::kWideThreads a row of any width; the
// row in dynamic shared memory when `in_smem`, else read from `x`.
__global__ void __launch_bounds__(wide::kWideThreads)
quant_pack_long_kernel(const float* __restrict__ x, uint32_t* __restrict__ words,
                       float* __restrict__ scale_out, float* __restrict__ zero_out,
                       int dim, int bits, int num_bins, int n_steps, bool in_smem) {
  extern __shared__ float srow[];
  __shared__ float2 slot[2][wide::kWideWarps];
  int next = 0;
  const int t = threadIdx.x;
  const long long row = blockIdx.x;
  const float* xr = wide::stage_row(x + row * dim, dim, in_smem, srow);
  const float2 mm = wide::long_minmax(xr, dim, slot, next);
  const float levels = (float)((1 << bits) - 1);
  const LongRangeError err{xr, dim, levels, 1.f / levels};
  const float2 best = wide::greedy_search(mm.x, mm.y, num_bins, n_steps, err, slot, next);
  const float sc = err.scale(best.x, best.y);
  if (t == 0) {
    scale_out[row] = sc;
    zero_out[row] = best.x;
  }

  // As the wide route's pack, each code computed from the row in place.
  const long long b0 = row * dim * bits, b1 = b0 + (long long)dim * bits;
  for (long long w = (b0 >> 5) + t; w <= ((b1 - 1) >> 5); w += wide::kWideThreads) {
    const long long wb = w << 5;
    const int p_lo = wb > b0 ? (int)((wb - b0) / bits) : 0;
    const int p_hi = min(dim - 1, (int)((wb + 31 - b0) / bits));
    uint32_t word = 0;
    for (int p = p_lo; p <= p_hi; ++p) {
      const float xc = fminf(fmaxf(xr[p], best.x), best.y);
      const float cf = round_even(__fdiv_rn(xc - best.x, sc));
      const uint32_t c = (uint32_t)fminf(fmaxf(cf, 0.f), levels);
      const int sh = (int)(b0 + (long long)p * bits - wb);
      word |= sh >= 0 ? (c << sh) : (c >> -sh);
    }
    if (wb >= b0 && wb + 32 <= b1) words[w] = word;
    else atomicOr(words + w, word);
  }
}

struct Args {
  const float* x;
  uint32_t* words;
  float* scale;
  float* zero;
  int rows, dim, bits, num_bins, n_steps;
  long long nwords;
  cudaStream_t stream;
};

template <int L, int K, bool FULL>
cudaError_t launch(const Args& a) {
  constexpr int kGroups = kThreads / L;
  constexpr int kRowsPerBlock = kGroups > 32 ? kGroups : 32;
  const bool reg_pack = FULL && packs_in_registers<L, K>(a.bits);
  const int blocks = (a.rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const size_t smem = reg_pack ? 0 : (size_t)kRowsPerBlock * a.dim;
  quant_pack_kernel<L, K, FULL><<<blocks, kThreads, smem, a.stream>>>(
      a.x, a.words, a.scale, a.zero, a.rows, a.dim, a.bits, a.num_bins,
      a.n_steps, a.nwords, reg_pack);
  return cudaGetLastError();
}

// K values a virtual lane, and lanes enough for kValuesPerLane values each
// (at most 32).
template <int K>
cudaError_t launch_k(const Args& a) {
  constexpr int L = 32 * K / kValuesPerLane < 32 ? 32 * K / kValuesPerLane : 32;
  return a.dim == 32 * K ? launch<L, K, true>(a) : launch<L, K, false>(a);
}

// The wide route at V values a thread. Rows that do not start on a word
// boundary share words with their neighbours: the stream is zeroed first.
template <int V>
cudaError_t launch_wide(const Args& a) {
  if ((long long)a.dim * a.bits % 32) {
    const cudaError_t err = cudaMemsetAsync(a.words, 0, a.nwords * 4, a.stream);
    if (err != cudaSuccess) return err;
  }
  if (a.dim == wide::kWideThreads * V)
    quant_pack_wide_kernel<V, true><<<a.rows, wide::kWideThreads, 0, a.stream>>>(
        a.x, a.words, a.scale, a.zero, a.dim, a.bits, a.num_bins, a.n_steps);
  else
    quant_pack_wide_kernel<V, false><<<a.rows, wide::kWideThreads, 0, a.stream>>>(
        a.x, a.words, a.scale, a.zero, a.dim, a.bits, a.num_bins, a.n_steps);
  return cudaGetLastError();
}

// The long route. As on the wide route, rows that do not start on a word
// boundary share words with their neighbours: the stream is zeroed first.
cudaError_t launch_long(const Args& a) {
  size_t smem;
  cudaError_t err = wide::long_smem(quant_pack_long_kernel, a.dim, smem);
  if (err != cudaSuccess) return err;
  if ((long long)a.dim * a.bits % 32) {
    err = cudaMemsetAsync(a.words, 0, a.nwords * 4, a.stream);
    if (err != cudaSuccess) return err;
  }
  quant_pack_long_kernel<<<a.rows, wide::kWideThreads, smem, a.stream>>>(
      a.x, a.words, a.scale, a.zero, a.dim, a.bits, a.num_bins, a.n_steps, smem > 0);
  return cudaGetLastError();
}

}  // namespace

// x: rows*dim f32, row-major, on the device; words: nwords =
// ceil(rows*dim*bits/32) uint32, 16-byte aligned; scale, zero: rows f32
// each. dim >= 1 (the wide route past 1,024, the long route past 8,192),
// 1 <= bits <= 8. Returns cudaGetLastError() after the launch.
extern "C" int quant_pack_launch(const void* x, void* words, void* scale,
                                 void* zero, int rows, int dim, int bits,
                                 int num_bins, int n_steps, long long nwords,
                                 void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  const Args a{(const float*)x, (uint32_t*)words, (float*)scale, (float*)zero,
               rows, dim, bits, num_bins, n_steps, nwords,
               (cudaStream_t)stream};
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
  else err = launch_long(a);
  return (int)err;
}
