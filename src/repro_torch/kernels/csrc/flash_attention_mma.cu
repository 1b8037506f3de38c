// Online-softmax (flash) attention forward for bf16 inputs, on the Hopper
// tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas / flash_kernel): o = softmax(q k^T / sqrt(D)) v per
// (batch, q head), with GQA (q head h reads kv head h / G), an optional
// causal mask (q index >= key index), masked scores at exactly the f32
// minimum, f32 running max m, sum l and accumulator acc, the final
// acc / max(l, 1e-30) (as acc times its row's reciprocal, within an f32 ulp),
// and the output in bf16. The f32 route is the SIMT kernel
// in flash_attention.cu.
//
// Bound: at the bert4rec serving shapes (S = 200, 2 heads of D = 32) the
// work is 2*S*D FLOP per score against 8*D bytes per row, far below the
// card's ridge (about 295 FLOP a byte in bf16), so reading q, k, v once
// and writing o once bounds it; next come the exps (one a score on the
// 16-lane MUFU pipe) and the tensor-core products. On an H100 this kernel
// reaches about a third of that bound: the mma.sync products (three per
// 16 x 8 block of scores, with p split as below) and about seven
// instructions a score of softmax take its time (PERF.md).
//
// Design, for that bound:
// - Both products run on the tensor cores: mma.sync m16n8k16, bf16 in and
//   f32 accumulation (the TPU's matrix unit takes its f32-cast tiles in one
//   bf16 pass at JAX's default precision). A fragments of q come from
//   ldmatrix, B fragments of k from ldmatrix and of v from ldmatrix.trans;
//   the f32 score fragments become bf16 A fragments of p in registers, as
//   its top half and the remainder (p v = hi v + lo v), so p keeps about 16
//   bits and the output stays within one bf16 step of f32 attention, as
//   the SIMT kernel's does. The online softmax steps over 64 keys: a row's
//   max takes two quad shuffles a step, its sum is reduced once at the end,
//   16-key groups past the tile's last live key are skipped, and a step
//   that lies wholly below Sk and the diagonal runs without guards or masks.
// - One block per (batch, kv head): its k and v are staged in shared memory
//   once, with 16-byte cp.async copies, and serve all G q heads and all
//   16-row q tiles, which the block's 4 warps take in turn; each warp
//   prefetches its next q tile while it computes the current one. Keys
//   longer than the shared-memory budget are staged in chunks, each round
//   of tiles walking the chunks.
// - Exps: exp2 of one FMA a score, s * (scale * log2 e) - m * (scale *
//   log2 e), on ex2.approx (one MUFU.EX2).
// - Ragged edges inside the kernel: key rows past Sk and head dims past D
//   are staged as zeros (D pads to a multiple of 16), scores of keys past Sk
//   or above the causal diagonal are set to the f32 minimum, q rows past Sq
//   are computed on zeros and not written. Key tiles wholly above a tile's
//   diagonal are skipped: they would add exp(min - m) = 0 and leave m as it
//   is.
// - Alignment: where a base pointer or stride is not a multiple of 8
//   elements, or a row's last 8 head dims are partial, the same staging
//   loop copies element by element. o, contiguous, is written a row at a
//   time from shared memory, 16 bytes a thread where D allows.
// Offsets are 64-bit.

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -FLT_MAX;  // the f32 minimum: the Pallas NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;            // bf16 columns of padding a staged row:
                                   // ldmatrix rows land in distinct banks
constexpr int kSmemBudget = 96 * 1024;  // k, v and the warps' q tiles

constexpr int kSub = 64;  // keys per online-softmax step

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// ldmatrix of four 8x8 bf16 tiles at a shared-memory byte address
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) as bf16 pairs hi and lo with hi + lo = (a, b) to about 16 bits:
// hi is a and b cut to bf16 (their top halves), lo the remainder (exact in
// f32) rounded to bf16. p v as hi v + lo v keeps p's rounding far below the
// output's bf16 step.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
  hi = __byte_perm(ua, ub, 0x7632);
  lo = pack_bf16(a - __uint_as_float(ua & 0xffff0000u), b - __uint_as_float(ub & 0xffff0000u));
}

// Rows [0, n) of a (rows, D) bf16 matrix at src (row stride rs elements,
// unit stride along D) into dst, rows of DP + kPad; rows [n, n_pad) and
// columns [D, DP) become zeros. 16-byte cp.async where vec (src and its
// stride 8-element aligned) and the 8 columns are whole, else element by
// element. Threads tid, tid + nthr, ... share the work.
template <int DP>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long rs,
                                           int n, int n_pad, int D, bool vec,
                                           int tid, int nthr) {
  constexpr int kChunks = DP / 8;
  for (int i = tid; i < n_pad * kChunks; i += nthr) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    bf16* d = dst + r * (DP + kPad) + c;
    const bf16* s = src + r * rs + c;
    if (r < n && vec && c + 8 <= D) {
      cp_async16(d, s);
    } else {
      union {
        uint4 u;
        bf16 h[8];
      } t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        t.h[j] = (r < n && c + j < D) ? s[j] : __ushort_as_bfloat16(0);
      *reinterpret_cast<uint4*>(d) = t.u;
    }
  }
}

// A warp's q tile: its A fragments, the f32 accumulator of p v, and each
// of its two rows' running max and sum (raw scores; the sum over this
// thread's columns only).
template <int DP>
struct TileState {
  uint32_t qa[DP / 16][4];
  float acc[DP / 8][4];
  float m[2], l[2];
};

// One online-softmax step over the staged keys k0 .. k0 + kSub - 1
// (k_addr, v_addr: this lane's ldmatrix row addresses at the step's first
// key). kFull: every key of the step is live and unmasked for every row of
// the tile, so no group is guarded and no score masked.
template <int DP, bool kFull>
__device__ __forceinline__ void attend_step(TileState<DP>& t, uint32_t k_addr,
                                            uint32_t v_addr, int k0, int cend, int Sk,
                                            int q0, bool causal, float scale_log2,
                                            int g4, int t4) {
  constexpr int LD = DP + kPad, KD = DP / 16, ND = DP / 8;
  constexpr int NG = kSub / 16;  // 16-key groups a step
  const int ng = kFull ? NG : min(NG, (cend - k0 + 15) / 16);  // groups with live keys
  float s[2 * NG][4];
#pragma unroll
  for (int kk = 0; kk < NG; ++kk) {
    if (kFull || kk < ng) {
      s[2 * kk][0] = s[2 * kk][1] = s[2 * kk][2] = s[2 * kk][3] = 0.f;
      s[2 * kk + 1][0] = s[2 * kk + 1][1] = s[2 * kk + 1][2] = s[2 * kk + 1][3] = 0.f;
#pragma unroll
      for (int ds = 0; ds < KD; ++ds) {
        uint32_t kf[4];
        ldsm_x4(kf, k_addr + kk * 16 * LD * 2 + ds * 32);
        mma_bf16(s[2 * kk], t.qa[ds], kf[0], kf[1]);
        mma_bf16(s[2 * kk + 1], t.qa[ds], kf[2], kf[3]);
      }
    }
  }
  // keys past Sk and above the diagonal, in the groups that hold any
  float gm[2][NG];
#pragma unroll
  for (int kk = 0; kk < NG; ++kk) {
    if (kFull || kk < ng) {
      const int kg = k0 + kk * 16;
      if (!kFull && (kg + 16 > Sk || (causal && kg + 15 > q0))) {
#pragma unroll
        for (int j = 2 * kk; j < 2 * kk + 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + j * 8 + 2 * t4 + (e & 1);
            const int row = q0 + g4 + (e >> 1) * 8;
            if (key >= Sk || (causal && key > row)) s[j][e] = kNegInf;
          }
      }
      gm[0][kk] = fmaxf(fmaxf(s[2 * kk][0], s[2 * kk][1]),
                        fmaxf(s[2 * kk + 1][0], s[2 * kk + 1][1]));
      gm[1][kk] = fmaxf(fmaxf(s[2 * kk][2], s[2 * kk][3]),
                        fmaxf(s[2 * kk + 1][2], s[2 * kk + 1][3]));
    }
  }
  float mx[2] = {t.m[0], t.m[1]};
#pragma unroll
  for (int kk = 0; kk < NG; ++kk) {
    if (kFull || kk < ng) {
      mx[0] = fmaxf(mx[0], gm[0][kk]);
      mx[1] = fmaxf(mx[1], gm[1][kk]);
    }
  }
  float corr[2], mc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    corr[i] = ex2((t.m[i] - mx[i]) * scale_log2);
    mc[i] = mx[i] * scale_log2;
    t.m[i] = mx[i];
    t.l[i] *= corr[i];
  }
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    t.acc[d][0] *= corr[0];
    t.acc[d][1] *= corr[0];
    t.acc[d][2] *= corr[1];
    t.acc[d][3] *= corr[1];
  }
#pragma unroll
  for (int kk = 0; kk < NG; ++kk) {
    if (kFull || kk < ng) {
#pragma unroll
      for (int j = 2 * kk; j < 2 * kk + 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = ex2(fmaf(s[j][e], scale_log2, -mc[e >> 1]));
      t.l[0] += (s[2 * kk][0] + s[2 * kk][1]) + (s[2 * kk + 1][0] + s[2 * kk + 1][1]);
      t.l[1] += (s[2 * kk][2] + s[2 * kk][3]) + (s[2 * kk + 1][2] + s[2 * kk + 1][3]);
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int dt = 0; dt < ND; dt += 2) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, v_addr + kk * 16 * LD * 2 + dt * 16);
        mma_bf16(t.acc[dt], hi, vf[0], vf[1]);
        mma_bf16(t.acc[dt + 1], hi, vf[2], vf[3]);
        mma_bf16(t.acc[dt], lo, vf[0], vf[1]);
        mma_bf16(t.acc[dt + 1], lo, vf[2], vf[3]);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Sk,
                 int Hq, int Hkv, int D, Strides qs, Strides ks_, Strides vs_,
                 float scale_log2, int causal, int kc, int vec_q, int vec_kv) {
  constexpr int LD = DP + kPad;
  constexpr int KD = DP / 16;  // k16 steps over the head dim
  constexpr int ND = DP / 8;   // n8 tiles over the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // kc key rows
  bf16* vs = ks + kc * LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this warp's two q tiles: the round's (then its o tile) and the next's
  bf16* qbuf = vs + kc * LD + warp * 2 * 16 * LD;
  const int g4 = lane >> 2, t4 = lane & 3, mi = lane >> 3, r8 = lane & 7;

  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  const bf16* kb = k + b * ks_.b + hk * ks_.h;
  const bf16* vb = v + b * vs_.b + hk * vs_.h;
  const int n_qt = (Sq + 15) / 16;
  const int items = G * n_qt;  // (q head of this kv head, 16-row q tile)
  const int n_chunks = (Sk + kc - 1) / kc;
  // keys a tile needs: all, or under the causal mask up to its last row
  auto key_end = [&](int item) {
    const int q0 = (item % n_qt) * 16;
    return causal ? min(Sk, min(q0 + 16, Sq)) : Sk;
  };

  // a warp's q tile of one item into one of its two buffers
  auto stage_q = [&](int item, bf16* dst) {
    const int h = hk * G + item / n_qt, q0 = (item % n_qt) * 16;
    stage_rows<DP>(dst, q + b * qs.b + (long long)q0 * qs.s + h * qs.h, qs.s,
                   min(16, Sq - q0), 16, D, vec_q, lane, 32);
  };

  // the first round's q tiles land with k and v, in one wait
  if (warp < items) stage_q(warp, qbuf);
  if (n_chunks == 1) {
    const int pad = (Sk + 15) / 16 * 16;
    stage_rows<DP>(ks, kb, ks_.s, Sk, pad, D, vec_kv, threadIdx.x, kThreads);
    stage_rows<DP>(vs, vb, vs_.s, Sk, pad, D, vec_kv, threadIdx.x, kThreads);
  }
  cp_async_wait_all();
  __syncthreads();

  // per-lane byte offsets of the ldmatrix rows: q and k tiles (non-transposed
  // A and B fragments), v tiles (transposed B fragments)
  const uint32_t ks_addr = smem_addr(ks), vs_addr = smem_addr(vs);
  const uint32_t a_off = (((mi & 1) * 8 + r8) * LD + (mi >> 1) * 8) * 2;
  const uint32_t k_off = (((mi >> 1) * 8 + r8) * LD + (mi & 1) * 8) * 2;
  const uint32_t v_off = (((mi & 1) * 8 + r8) * LD + (mi >> 1) * 8) * 2;

  for (int base = 0, round = 0; base < items; base += kWarps, ++round) {
    const int item = base + warp;
    const bool busy = item < items;
    const int h = hk * G + item / n_qt;
    const int q0 = (item % n_qt) * 16;
    const int kend = busy ? key_end(item) : 0;
    bf16* qt = qbuf + (round & 1) * 16 * LD;

    TileState<DP> t;
#pragma unroll
    for (int d = 0; d < ND; ++d) t.acc[d][0] = t.acc[d][1] = t.acc[d][2] = t.acc[d][3] = 0.f;
    t.m[0] = t.m[1] = kNegInf;
    t.l[0] = t.l[1] = 0.f;
    if (busy) {
      // prefetch the next round's tile, then wait for this round's
      if (item + kWarps < items) stage_q(item + kWarps, qbuf + ((round + 1) & 1) * 16 * LD);
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;\n" ::: "memory");
      __syncwarp();
#pragma unroll
      for (int ds = 0; ds < KD; ++ds) ldsm_x4(t.qa[ds], smem_addr(qt) + a_off + ds * 32);
    }

    for (int c = 0; c < n_chunks; ++c) {
      const int c0 = c * kc;
      if (n_chunks > 1) {
        int round_end = 0;
        for (int w = 0; w < kWarps && base + w < items; ++w)
          round_end = max(round_end, key_end(base + w));
        if (c0 >= round_end) break;  // the same on every thread
        const int n = min(kc, Sk - c0), pad = (n + 15) / 16 * 16;
        __syncthreads();
        stage_rows<DP>(ks, kb + c0 * ks_.s, ks_.s, n, pad, D, vec_kv, threadIdx.x, kThreads);
        stage_rows<DP>(vs, vb + c0 * vs_.s, vs_.s, n, pad, D, vec_kv, threadIdx.x, kThreads);
        cp_async_wait_all();
        __syncthreads();
      }
      const int cend = min(kend, c0 + kc);
      for (int k0 = c0; k0 < cend; k0 += kSub) {
        const uint32_t row0 = (k0 - c0) * LD * 2;  // byte offset of the step's first key
        // a step wholly below Sk and the diagonal needs no guard or mask
        const uint32_t ka = ks_addr + row0 + k_off, va = vs_addr + row0 + v_off;
        const bool full = k0 + kSub <= cend && !(causal && k0 + kSub - 1 > q0);
        if (full)
          attend_step<DP, true>(t, ka, va, k0, cend, Sk, q0, causal, scale_log2, g4, t4);
        else
          attend_step<DP, false>(t, ka, va, k0, cend, Sk, q0, causal, scale_log2, g4, t4);
      }
    }

    if (busy) {
      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float l = t.l[i];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[i] = 1.f / fmaxf(l, 1e-30f);
      }
      // the o tile through shared memory, so each row leaves in 16-byte pieces
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        float o4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) o4[e] = t.acc[d][e] * inv[e >> 1];
        *reinterpret_cast<uint32_t*>(qt + g4 * LD + d * 8 + 2 * t4) = pack_bf16(o4[0], o4[1]);
        *reinterpret_cast<uint32_t*>(qt + (g4 + 8) * LD + d * 8 + 2 * t4) = pack_bf16(o4[2], o4[3]);
      }
      __syncwarp();
      const int rows = min(16, Sq - q0);
      bf16* ob = o + (((long long)b * Sq + q0) * Hq + h) * D;
      const long long ors = (long long)Hq * D;
      if (D % 8 == 0) {
#pragma unroll
        for (int i = lane; i < 16 * ND; i += 32) {
          const int r = i / ND, c = (i % ND) * 8;
          if (r < rows && c < D)
            *reinterpret_cast<uint4*>(ob + r * ors + c) =
                *reinterpret_cast<const uint4*>(qt + r * LD + c);
        }
      } else {
        for (int i = lane; i < rows * D; i += 32) {
          const int r = i / D, c = i % D;
          ob[r * ors + c] = qt[r * LD + c];
        }
      }
      __syncwarp();
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Sk, int Hq, int Hkv, int D, Strides qs, Strides ks,
                   Strides vs, float scale_log2, int causal, int vec_q, int vec_kv,
                   cudaStream_t stream) {
  constexpr int LD = DP + kPad;
  constexpr int q_bytes = kWarps * 2 * 16 * LD * 2;
  constexpr int key_bytes = 2 * LD * 2;  // a k row and a v row
  constexpr int max_keys = (kSmemBudget - q_bytes) / key_bytes / kSub * kSub;
  static_assert(max_keys >= kSub, "one step of keys must fit the budget");
  const int sk16 = (Sk + 15) / 16 * 16;
  const int kc = sk16 <= max_keys ? sk16 : max_keys;
  const int smem = q_bytes + kc * key_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel_mma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  flash_kernel_mma<DP><<<(unsigned)(B * Hkv), kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, Sq, Sk, Hq, Hkv, D,
      qs, ks, vs, scale_log2, causal, kc, vec_q, vec_kv);
  return cudaGetLastError();
}

}  // namespace

// q: (B, Sq, Hq, D) bf16; k, v: (B, Sk, Hkv, D) bf16, each with the given
// batch, sequence and head strides (in elements) and unit stride along D;
// o: a contiguous (B, Sq, Hq, D) bf16. scale is the f32 1/sqrt(D) of the
// scores. vec_q / vec_kv: the base pointer and the three strides of q
// (k and v) are multiples of 8 elements, so whole 8-column pieces of a row
// load with 16-byte copies. 1 <= D <= 128, Hq % Hkv == 0,
// B * Hkv < 2^31. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_mma_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
    int Hq, int Hkv, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, float scale, int causal, int vec_q, int vec_kv, void* stream) {
  if (B <= 0 || Sq <= 0) return (int)cudaGetLastError();
  if (Sk <= 0 || D <= 0 || D > 128 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const float sl = scale * kLog2e;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch ((D + 15) / 16) {
    case 1: err = launch<16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, qs, ks, vs, sl, causal, vec_q, vec_kv, st); break;
    case 2: err = launch<32>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, qs, ks, vs, sl, causal, vec_q, vec_kv, st); break;
    case 3: err = launch<48>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, qs, ks, vs, sl, causal, vec_q, vec_kv, st); break;
    case 4: err = launch<64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, qs, ks, vs, sl, causal, vec_q, vec_kv, st); break;
    case 5: err = launch<80>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, qs, ks, vs, sl, causal, vec_q, vec_kv, st); break;
    case 6: err = launch<96>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, qs, ks, vs, sl, causal, vec_q, vec_kv, st); break;
    case 7: err = launch<112>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, qs, ks, vs, sl, causal, vec_q, vec_kv, st); break;
    default: err = launch<128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, qs, ks, vs, sl, causal, vec_q, vec_kv, st); break;
  }
  return (int)err;
}
