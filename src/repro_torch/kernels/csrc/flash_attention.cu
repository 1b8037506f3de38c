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
// Bound: the two products, 4*D FLOP a score as f32 FMAs (2*D
// instructions), against 16*D bytes a row read or written: at bert4rec's
// shapes the FMA pipe bounds it. The route keeps full f32 products: no
// tensor-core instruction, which would round (bf16) or shorten (tf32) them.
// No main path runs f32 attention.
//
// Design, for that bound. Each FMA's operands come from shared memory,
// which delivers 32 floats a clock to an SM against 128 FMA lanes, so a
// float loaded must feed several FMAs: the products are register-tiled as
// in an SGEMM.
// - One block per (batch, kv head). Its k and v are staged in shared
//   memory once, with 16-byte cp.async copies, and serve every q head of
//   the GQA group and every q tile; the block's warps take (q head, q tile)
//   items in turn and work alone once k and v have landed. Keys longer
//   than the shared-memory budget are staged in chunks, each round of
//   items walking the chunks (on no measured shape).
// - A warp's q tile is 16 rows, staged in the warp's own shared memory.
//   Lane = kg + 8 * rg: the lane holds rows 4rg .. 4rg + 3 and keys kg,
//   kg + 8, kg + 16, kg + 24 of a 32-key tile, so q k^T takes 8 float4
//   loads for 64 FMAs a 4-dim step (the four q float4s first, then a k
//   float4 at a time). Staged q and key rows are padded to D + 4 floats,
//   so the float4s a load phase reads fall in distinct banks. A lane holds
//   at most 128 registers, two blocks to an SM. (8 rows or 8 keys a lane,
//   or 4 key groups of 8 keys, would load less a FMA but spill, halve the
//   warps an SM holds or stage k and v in chunks: slower, as
//   tools/kernel_variants.py measures by rewriting Tile's constants.)
// - The tile's scores become p in registers: a row's max over its 8 lanes
//   takes three xor shuffles; p = exp2(s * scale*log2e - m * scale*log2e),
//   one FMA and one MUFU.EX2 a score; each lane keeps its own part of a
//   row's sum, reduced once at the end. p goes to the warp's shared-memory
//   tile ([key][row], padded so the stores do not conflict) and p v runs
//   with the lane holding the same rows and head dims kg*4 + 32j: a key
//   costs one broadcast float4 load of p and D/32 of v for D/2 FMAs.
//   So each FMA waits on half a float from shared memory, whose 32 floats
//   a clock then bound the kernel at half the FMA pipe's rate.
// - Keys past the last whole 32-key tile go in 8-key tiles (one key a
//   lane), so S = 200 computes no key it does not need. Scores of keys
//   past Sk or above the causal diagonal are set to the f32 minimum; tiles
//   wholly above a q tile's diagonal are skipped (they would add exp(min -
//   m) = 0 and leave m as it is), and a tile wholly below it runs without
//   the mask.
// - Ragged edges: key rows past Sk and head dims past D are staged as
//   zeros (D pads to DP, a multiple of 32), q rows past Sq are computed on
//   zeros and not written. Where a base pointer or stride is not a
//   multiple of 4 floats, or a row's last 4 dims are partial, the staging
//   loop copies element by element. o, contiguous, is written from
//   registers, a float4 a lane where D allows.
// Offsets are 64-bit.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -FLT_MAX;  // the f32 minimum: the Pallas NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxWarps = 8;
constexpr int kMinBlocks = 2;  // blocks an SM holds: <= 128 registers a thread
constexpr int kKeyTile = 32;  // keys of a whole tile
// 113 KB a block: two blocks fill an SM's 228 KB with the 1 KB each
// reserves, and bert4rec's (200 keys, 7 warps) fits whole
constexpr int kSmemBudget = 113 * 1024;

struct Strides {
  long long b, s, h;
};

// A warp's lanes: lane = kg + KG * rg, KG key groups by 32 / KG row
// groups of RPL q rows.
template <int DP>
struct Tile {
  static constexpr int KG = 8;                  // key groups a row group spans
  static constexpr int RPL = 4;                 // q rows a lane
  static constexpr int R = 32 / KG * RPL;       // q rows a warp's tile
  static constexpr int KPL = kKeyTile / KG;     // keys a lane of a whole tile
  static constexpr int TPL = 8 / KG;            // and of an 8-key tile
  static constexpr int QLD = DP + 4;            // floats a staged q row
  static constexpr int KLD = DP + 4;            // floats a staged key row
  static constexpr int VLD = DP;                // floats a staged value row
  static constexpr int PLD = R + 32 / KG;       // floats a key's row of p
  static constexpr int DPL = DP / KG;           // head dims a lane in p v
  static constexpr int warp_floats = R * QLD + kKeyTile * PLD;  // q tile, p
  static constexpr int key_bytes = (KLD + VLD) * 4;
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rows [0, n) of a (rows, D) f32 matrix at src (row stride rs elements,
// unit stride along D) into dst, rows of ld floats; rows [n, n_pad) and
// columns [D, DP) become zeros. 16-byte cp.async where vec (src and its
// stride 4-float aligned) and the 4 columns are whole, else element by
// element. Threads tid, tid + nthr, ... share the work.
template <int DP>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* src,
                                           long long rs, int n, int n_pad, int D,
                                           bool vec, int tid, int nthr) {
  constexpr int kChunks = DP / 4;
  for (int i = tid; i < n_pad * kChunks; i += nthr) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    float* d = dst + r * ld + c;
    const float* s = src + r * rs + c;
    if (r < n && vec && c + 4 <= D) {
      cp_async16(d, s);
    } else {
      float4 t;
      t.x = (r < n && c < D) ? s[0] : 0.f;
      t.y = (r < n && c + 1 < D) ? s[1] : 0.f;
      t.z = (r < n && c + 2 < D) ? s[2] : 0.f;
      t.w = (r < n && c + 3 < D) ? s[3] : 0.f;
      *reinterpret_cast<float4*>(d) = t;
    }
  }
}

// A warp's q tile: the lane's rows' accumulators, running max (raw dot
// units) and its own part of each row's sum.
template <int DP>
struct RowState {
  float acc[Tile<DP>::RPL][Tile<DP>::DPL];
  float m[Tile<DP>::RPL], l[Tile<DP>::RPL];
};

// One online-softmax step over the KG * KPL staged keys at ks / vs (key
// index key0). kMask: some score of the tile is masked (keys past Sk, or
// above the diagonal for rows row0 .. row0 + RPL - 1).
template <int DP, int KPL, bool kMask>
__device__ __forceinline__ void attend_tile(RowState<DP>& st, const float* qw,
                                            const float* ks, const float* vs,
                                            float* pw, int key0, int Sk, int row0,
                                            bool causal, float sl, int kg, int rg) {
  using T = Tile<DP>;
  constexpr int RPL = T::RPL, KG = T::KG;
  float s[RPL][KPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i)
#pragma unroll
    for (int j = 0; j < KPL; ++j) s[i][j] = 0.f;
  const float* qr = qw + rg * RPL * T::QLD;
#pragma unroll
  for (int d = 0; d < DP; d += 4) {
    float4 qv[RPL];
#pragma unroll
    for (int i = 0; i < RPL; ++i)
      qv[i] = *reinterpret_cast<const float4*>(qr + i * T::QLD + d);
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const float4 kv = *reinterpret_cast<const float4*>(ks + (kg + KG * j) * T::KLD + d);
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
        s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
        s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
        s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
      }
    }
  }
  if (kMask) {
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int key = key0 + kg + KG * j;
#pragma unroll
      for (int i = 0; i < RPL; ++i)
        if (key >= Sk || (causal && key > row0 + i)) s[i][j] = kNegInf;
    }
  }
  float corr[RPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    float mx = s[i][0];
#pragma unroll
    for (int j = 1; j < KPL; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
    for (int off = 1; off < KG; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    mx = fmaxf(mx, st.m[i]);
    corr[i] = ex2((st.m[i] - mx) * sl);
    st.m[i] = mx;
    const float mc = mx * sl;
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      s[i][j] = ex2(fmaf(s[i][j], sl, -mc));
      ps += s[i][j];
    }
    st.l[i] = st.l[i] * corr[i] + ps;
  }
#pragma unroll
  for (int j = 0; j < KPL; ++j)
#pragma unroll
    for (int c = 0; c < RPL / 4; ++c)
      *reinterpret_cast<float4*>(pw + (kg + KG * j) * T::PLD + rg * RPL + 4 * c) =
          make_float4(s[4 * c][j], s[4 * c + 1][j], s[4 * c + 2][j], s[4 * c + 3][j]);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < RPL; ++i)
#pragma unroll
    for (int e = 0; e < T::DPL; ++e) st.acc[i][e] *= corr[i];
#pragma unroll
  for (int t = 0; t < KG * KPL; ++t) {
    float4 p4[RPL / 4];
#pragma unroll
    for (int c = 0; c < RPL / 4; ++c)
      p4[c] = *reinterpret_cast<const float4*>(pw + t * T::PLD + rg * RPL + 4 * c);
    const float* pp = reinterpret_cast<const float*>(p4);
#pragma unroll
    for (int mm = 0; mm < T::DPL / 4; ++mm) {
      const float4 v4 =
          *reinterpret_cast<const float4*>(vs + t * T::VLD + kg * 4 + 4 * KG * mm);
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        st.acc[i][4 * mm] = fmaf(pp[i], v4.x, st.acc[i][4 * mm]);
        st.acc[i][4 * mm + 1] = fmaf(pp[i], v4.y, st.acc[i][4 * mm + 1]);
        st.acc[i][4 * mm + 2] = fmaf(pp[i], v4.z, st.acc[i][4 * mm + 2]);
        st.acc[i][4 * mm + 3] = fmaf(pp[i], v4.w, st.acc[i][4 * mm + 3]);
      }
    }
  }
  __syncwarp();
}

template <int DP>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
flash_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
                 int Hq, int Hkv, int D, Strides qs, Strides ks_, Strides vs_,
                 float sl, int causal, int kc, int vec_q, int vec_kv) {
  using T = Tile<DP>;
  constexpr int RPL = T::RPL, R = T::R;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;              // kc key rows
  float* vs = ks + kc * T::KLD;  // kc value rows
  const int nw = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qw = vs + kc * T::VLD + warp * T::warp_floats;  // this warp's q tile
  float* pw = qw + R * T::QLD;                            // and its p
  const int kg = lane % T::KG, rg = lane / T::KG;

  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  const float* kb = k + b * ks_.b + hk * ks_.h;
  const float* vb = v + b * vs_.b + hk * vs_.h;
  const int n_qt = (Sq + R - 1) / R;
  const int items = G * n_qt;  // (q head of this kv head, R-row q tile)
  const int n_chunks = (Sk + kc - 1) / kc;
  // keys a tile needs: all, or under the causal mask up to its last row
  auto key_end = [&](int item) {
    const int q0 = (item % n_qt) * R;
    return causal ? min(Sk, min(q0 + R, Sq)) : Sk;
  };

  if (n_chunks == 1) {
    const int pad = (Sk + 7) / 8 * 8;
    stage_rows<DP>(ks, T::KLD, kb, ks_.s, Sk, pad, D, vec_kv, threadIdx.x, blockDim.x);
    stage_rows<DP>(vs, T::VLD, vb, vs_.s, Sk, pad, D, vec_kv, threadIdx.x, blockDim.x);
    cp_async_wait_all();
    __syncthreads();
  }

  for (int base = 0; base < items; base += nw) {
    const int item = base + warp;
    const bool busy = item < items;
    const int h = hk * G + item / n_qt;
    const int q0 = (item % n_qt) * R;
    const int kend = busy ? key_end(item) : 0;
    const int row0 = q0 + rg * RPL;

    RowState<DP> st;
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
#pragma unroll
      for (int e = 0; e < T::DPL; ++e) st.acc[i][e] = 0.f;
      st.m[i] = kNegInf;
      st.l[i] = 0.f;
    }
    if (busy) {
      stage_rows<DP>(qw, T::QLD, q + b * qs.b + (long long)q0 * qs.s + h * qs.h, qs.s,
                     min(R, Sq - q0), R, D, vec_q, lane, 32);
      cp_async_wait_all();
      __syncwarp();
    }

    for (int c = 0; c < n_chunks; ++c) {
      const int c0 = c * kc;
      if (n_chunks > 1) {
        int round_end = 0;
        for (int w = 0; w < nw && base + w < items; ++w)
          round_end = max(round_end, key_end(base + w));
        if (c0 >= round_end) break;  // the same on every thread
        const int n = min(kc, Sk - c0), pad = (n + 7) / 8 * 8;
        __syncthreads();
        stage_rows<DP>(ks, T::KLD, kb + c0 * ks_.s, ks_.s, n, pad, D, vec_kv,
                       threadIdx.x, blockDim.x);
        stage_rows<DP>(vs, T::VLD, vb + c0 * vs_.s, vs_.s, n, pad, D, vec_kv,
                       threadIdx.x, blockDim.x);
        cp_async_wait_all();
        __syncthreads();
      }
      const int cend = min(kend, c0 + kc);
      int k0 = c0;
      for (; k0 + kKeyTile <= cend; k0 += kKeyTile) {
        const float* kt = ks + (k0 - c0) * T::KLD;
        const float* vt = vs + (k0 - c0) * T::VLD;
        // every key at or below the tile's first row: nothing to mask
        if (!causal || k0 + kKeyTile - 1 <= q0)
          attend_tile<DP, T::KPL, false>(st, qw, kt, vt, pw, k0, Sk, row0, causal, sl,
                                         kg, rg);
        else
          attend_tile<DP, T::KPL, true>(st, qw, kt, vt, pw, k0, Sk, row0, causal, sl,
                                        kg, rg);
      }
      for (; k0 < cend; k0 += 8)
        attend_tile<DP, T::TPL, true>(st, qw, ks + (k0 - c0) * T::KLD,
                                 vs + (k0 - c0) * T::VLD, pw, k0, Sk, row0, causal, sl,
                                 kg, rg);
    }

    if (busy) {
      const bool vec_o = D % 4 == 0;
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        float l = st.l[i];
#pragma unroll
        for (int off = 1; off < T::KG; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
        const int row = row0 + i;
        if (row >= Sq) continue;
        const float den = fmaxf(l, 1e-30f);
        float* op = o + (((long long)b * Sq + row) * Hq + h) * D;
#pragma unroll
        for (int mm = 0; mm < T::DPL / 4; ++mm) {
          const int d = kg * 4 + 4 * T::KG * mm;
          float4 r;
          r.x = st.acc[i][4 * mm] / den;
          r.y = st.acc[i][4 * mm + 1] / den;
          r.z = st.acc[i][4 * mm + 2] / den;
          r.w = st.acc[i][4 * mm + 3] / den;
          if (vec_o && d + 4 <= D) {
            *reinterpret_cast<float4*>(op + d) = r;
          } else {
            if (d < D) op[d] = r.x;
            if (d + 1 < D) op[d + 1] = r.y;
            if (d + 2 < D) op[d + 2] = r.z;
            if (d + 3 < D) op[d + 3] = r.w;
          }
        }
      }
    }
  }
}

template <int DP>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, int B,
                   int Sq, int Sk, int Hq, int Hkv, int D, Strides qs, Strides ks,
                   Strides vs, float sl, int causal, int vec_q, int vec_kv,
                   cudaStream_t stream) {
  using T = Tile<DP>;
  constexpr int warp_bytes = T::warp_floats * 4;
  const int items = (Hq / Hkv) * ((Sq + T::R - 1) / T::R);
  // as few warps as take the items in the fewest rounds
  int nw = items < kMaxWarps ? items : kMaxWarps;
  const int rounds = (items + nw - 1) / nw;
  nw = (items + rounds - 1) / rounds;
  // and at least one whole key tile beside them
  while (nw > 1 && kSmemBudget - nw * warp_bytes < kKeyTile * T::key_bytes) --nw;
  const int fit = (kSmemBudget - nw * warp_bytes) / T::key_bytes;
  const int sk8 = (Sk + 7) / 8 * 8;
  const int kc = sk8 <= fit ? sk8 : fit / kKeyTile * kKeyTile;
  const int smem = nw * warp_bytes + kc * T::key_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel_f32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  flash_kernel_f32<DP><<<(unsigned)(B * Hkv), nw * 32, smem, stream>>>(
      q, k, v, o, Sq, Sk, Hq, Hkv, D, qs, ks, vs, sl, causal, kc, vec_q, vec_kv);
  return cudaGetLastError();
}

}  // namespace

// q: (B, Sq, Hq, D) f32; k, v: (B, Sk, Hkv, D) f32, each with the given
// batch, sequence and head strides (in elements) and unit stride along D;
// o: a contiguous (B, Sq, Hq, D) f32. scale is the f32 1/sqrt(D) the scores
// are multiplied by. vec_q / vec_kv: the base pointer and the three strides
// of q (k and v) are multiples of 4 elements, so whole 4-column pieces of a
// row load with 16-byte copies. 1 <= D <= 128, Hq % Hkv == 0,
// B * Hkv < 2^31. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_f32_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
    int Hq, int Hkv, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, float scale, int causal, int vec_q, int vec_kv, void* stream) {
  if (B <= 0 || Sq <= 0) return (int)cudaGetLastError();
  if (Sk <= 0 || D <= 0 || D > 128 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  float* of = (float*)o;
  const float sl = scale * kLog2e;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch ((D + 31) / 32) {
    case 1: err = launch<32>(qf, kf, vf, of, B, Sq, Sk, Hq, Hkv, D, qs, ks, vs, sl, causal, vec_q, vec_kv, st); break;
    case 2: err = launch<64>(qf, kf, vf, of, B, Sq, Sk, Hq, Hkv, D, qs, ks, vs, sl, causal, vec_q, vec_kv, st); break;
    case 3: err = launch<96>(qf, kf, vf, of, B, Sq, Sk, Hq, Hkv, D, qs, ks, vs, sl, causal, vec_q, vec_kv, st); break;
    default: err = launch<128>(qf, kf, vf, of, B, Sq, Sk, Hq, Hkv, D, qs, ks, vs, sl, causal, vec_q, vec_kv, st); break;
  }
  return (int)err;
}
