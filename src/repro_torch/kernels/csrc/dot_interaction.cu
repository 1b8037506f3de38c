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
// bf16 that is 3,456 bytes read and 1,404 written against 22,464 FMAs. On
// the tensor cores (989 TFLOP/s bf16) those products take about 0.01 ms for
// 262,144 rows, against 0.38 ms to move the bytes at 3.35 TB/s.
//
// bf16 design (the serve path): the Gram matrix of each row on the tensor
// cores, mma.sync m16n8k16 bf16 -> f32. A warp takes 4 batch rows at a time
// (4 rows of P f32 dots start on a 16-byte boundary, so the warp stores
// them as float4s), or 1 where the batch has fewer 4-row units than the
// card holds warps (serve_p99's 512 rows), and walks the units with a
// stride of all the grid's warps, each unit's features copied into shared
// memory with 16-byte cp.async while the unit before is computed (two
// buffers a warp). A
// feature row sits at a pitch of 2*DP + 16 bytes (DP = D rounded up to 16,
// the columns past D zero): an odd number of 16-byte chunks, so the 8 rows
// an ldmatrix reads fall in 8 different bank groups. F is padded to MT
// 16-row m-tiles by pointing the ldmatrix rows past F at a zero chunk. At
// each 16-wide k-step a warp loads the 2*MT 8-row groups of the row's
// features with MT ldmatrix.x4: these are at once the A fragments of the
// MT m-tiles and the B fragments of the 2*MT n-tiles (the product is X
// times X transposed, both read as rows of X), and multiplies only the
// tiles that hold pairs i < j, m-tile mt against n-tiles 2*mt .. 2*MT-1:
// 6 of 8 at F <= 32. The accumulators go to a staging buffer in shared
// memory in triu order, and the warp writes its 4 rows' dots with float4
// stores. bf16 products are exact in f32; each dot is summed in f32 in the
// tensor cores' order. Takes 2 <= F <= 64 and any D whose two buffers fit
// the block's shared memory; where D % 8 != 0 or the features are not
// 16-byte aligned, the staging copies element by element.
//
// f32 design: the CUDA cores (tf32 would not hold the f32 dots). A block
// takes `rows` batch rows (as many as fit 48 KB of shared memory, up to 8)
// and stages their features there, each feature row at an odd stride so
// that threads reading the same column of different features hit different
// banks; the (i, j) of every pair is worked out once per block into a
// shared table; each thread computes whole dots, pair index fastest, so
// consecutive threads write consecutive outputs, accumulated in f32 over
// d = 0..D-1 in order.

#include <cstdint>
#include <initializer_list>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ------------------------------------------------------------------ bf16

constexpr int kUnitRows = 4;      // batch rows a warp takes at a time (at most)
constexpr int kMaxMTiles = 4;     // 16-row m-tiles: F <= 64
constexpr int kMaxWarps = 2;      // warps a block
constexpr size_t kSmemMax = 227 * 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

// ldmatrix of four 8x8 bf16 tiles; lane l gives the address of row l % 8 of
// tile l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The tiles that hold pairs i < j: m-tile mt against n-tiles 2*mt ..
// 2*MT-1, MT*MT + MT of them, numbered in that order.
template <int MT>
constexpr int kTiles = MT * MT + MT;

__host__ __device__ constexpr int tile_index(int mt, int nt, int n_mtiles) {
  return 2 * n_mtiles * mt - mt * (mt - 1) + nt - 2 * mt;
}

struct MmaArgs {
  const __nv_bfloat16* feats;
  float* out;
  long long batch, units;
  int unit_rows;   // batch rows a warp takes at a time: kUnitRows, or 1
  int nf, dim, dp, pitch, pairs;
  int in_bytes;    // one unit's staged features: unit_rows * nf * pitch
  int out_bytes;   // one unit's staged dots, rounded up to 16 bytes
  int warp_bytes;  // two input buffers, the staged dots, a zero chunk
  bool vec;        // 16-byte copies: dim % 8 == 0 and feats 16-byte aligned
};

// Copies unit u's features (rows [u, u + 1) * unit_rows of the batch,
// fewer at the end) into buf: feature row rf of the unit at rf * pitch. The vector path
// issues cp.async; the other copies element by element. (rf, c) of this
// lane's first element come from `first`, and advance by `step` a pass.
__device__ __forceinline__ void stage_unit(const MmaArgs& a, long long u, uint8_t* buf,
                                           int lane, int2 first, int2 step) {
  const long long row0 = u * a.unit_rows;
  const long long left = a.batch - row0;
  const int nrows = left < a.unit_rows ? (int)left : a.unit_rows;
  const int per = a.vec ? a.dim / 8 : a.dim;  // items of a feature row
  const int n = nrows * a.nf * per;
  int rf = first.x, c = first.y;
  if (a.vec) {
    const uint8_t* src = reinterpret_cast<const uint8_t*>(a.feats + row0 * a.nf * a.dim);
    for (int e = lane; e < n; e += 32) {
      cp_async16(buf + rf * a.pitch + c * 16, src + (size_t)e * 16);
      rf += step.x;
      c += step.y;
      if (c >= per) { c -= per; ++rf; }
    }
  } else {
    const __nv_bfloat16* src = a.feats + row0 * a.nf * a.dim;
    for (int e = lane; e < n; e += 32) {
      *reinterpret_cast<__nv_bfloat16*>(buf + rf * a.pitch + c * 2) = src[e];
      rf += step.x;
      c += step.y;
      if (c >= per) { c -= per; ++rf; }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int MT>
__global__ void __launch_bounds__(kMaxWarps * 32)
dot_interaction_mma_kernel(const __grid_constant__ MmaArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x % 32;
  uint8_t* base = smem + (threadIdx.x / 32) * a.warp_bytes;
  float* staged = reinterpret_cast<float*>(base + 2 * a.in_bytes);
  uint8_t* zero = base + 2 * a.in_bytes + a.out_bytes;

  // the zero chunk and the columns [dim, dp) of both buffers, which the
  // staging never writes
  if (lane < 4) reinterpret_cast<uint32_t*>(zero)[lane] = 0u;
  const int pad = a.dp - a.dim;
  for (int e = lane; e < 2 * a.unit_rows * a.nf * pad; e += 32) {
    const int rf = e / pad;
    *reinterpret_cast<__nv_bfloat16*>(base + rf * a.pitch + (a.dim + e % pad) * 2) =
        __float2bfloat16(0.f);
  }

  const int per = a.vec ? a.dim / 8 : a.dim;
  const int2 first = make_int2(lane / per, lane % per);
  const int2 step = make_int2(32 / per, 32 % per);
  // this lane's ldmatrix row within each x4 load: 8-row group 2*mt + (l/8
  // & 1), k-half l / 16; rows past F read the zero chunk
  const int lrow = lane & 7, lgroup = (lane >> 3) & 1, lhalf = lane >> 4;
  const int gid = lane >> 2, tig = lane & 3;

  const long long nwarps = (long long)gridDim.x * (blockDim.x / 32);
  long long u = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (u < a.units) stage_unit(a, u, base, lane, first, step);
  for (int it = 0; u < a.units; ++it, u += nwarps) {
    if (u + nwarps < a.units)
      stage_unit(a, u + nwarps, base + ((it + 1) & 1) * a.in_bytes, lane, first, step);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();

    const uint8_t* cur = base + (it & 1) * a.in_bytes;  // two buffers
    const long long row0 = u * a.unit_rows;
    const long long left = a.batch - row0;
    const int nrows = left < a.unit_rows ? (int)left : a.unit_rows;
#pragma unroll 1
    for (int r = 0; r < nrows; ++r) {
      const uint8_t* rb = cur + r * a.nf * a.pitch;
      // this lane's ldmatrix row of each x4 load, and its step a k (0 for
      // the zero chunk, which serves every k)
      uint32_t row_addr[MT], k_bytes[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int f = 8 * (2 * mt + lgroup) + lrow;
        row_addr[mt] = f < a.nf ? smem_addr(rb + f * a.pitch + lhalf * 16) : smem_addr(zero);
        k_bytes[mt] = f < a.nf ? 2 : 0;
      }
      float acc[kTiles<MT>][4];
#pragma unroll
      for (int t = 0; t < kTiles<MT>; ++t)
        acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
      for (int k = 0; k < a.dp; k += 16) {
        // the 2*MT 8-row groups at this k: A of m-tile mt is frag[mt], B of
        // n-tile nt is frag[nt / 2][nt % 2] and frag[nt / 2][2 + nt % 2]
        uint32_t frag[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) ldsm_x4(frag[mt], row_addr[mt] + k * k_bytes[mt]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 2 * mt; nt < 2 * MT; ++nt)
            mma_bf16(acc[tile_index(mt, nt, MT)], frag[mt], frag[nt / 2][nt & 1],
                     frag[nt / 2][2 + (nt & 1)]);
      }
      float* st = staged + r * a.pairs;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 2 * mt; nt < 2 * MT; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = 16 * mt + gid + (q >> 1) * 8;
            const int j = 8 * nt + 2 * tig + (q & 1);
            if (i < j && j < a.nf)
              st[i * (2 * a.nf - i - 1) / 2 + j - i - 1] = acc[tile_index(mt, nt, MT)][q];
          }
    }
    __syncwarp();
    float* dst = a.out + row0 * a.pairs;
    if (nrows == kUnitRows) {
      // 4 rows of dots: pairs float4s from a 16-byte boundary (row0 % 4 == 0)
      const float4* src4 = reinterpret_cast<const float4*>(staged);
      float4* dst4 = reinterpret_cast<float4*>(dst);
      for (int e = lane; e < a.pairs; e += 32) __stcs(dst4 + e, src4[e]);
    } else {
      for (int e = lane; e < nrows * a.pairs; e += 32) dst[e] = staged[e];
    }
    __syncwarp();  // the staged dots and this buffer are free again
  }
}

// The bytes a warp's buffers take at (nf, dim) with units of `rows` batch
// rows: two buffers of features, the dots rounded up to 16 bytes, a zero
// chunk.
size_t mma_warp_bytes(int nf, int dim, int rows) {
  const size_t pitch = 2 * ((dim + 15) / 16 * 16) + 16;
  const size_t dots = ((size_t)rows * nf * (nf - 1) / 2 * 4 + 15) / 16 * 16;
  return 2 * (size_t)rows * nf * pitch + dots + 16;
}

template <int MT>
cudaError_t launch_mma_mt(MmaArgs a, cudaStream_t stream) {
  auto kernel = dot_interaction_mma_kernel<MT>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // 4-row units where there are enough of them to fill the warps the card
  // holds; 1-row units otherwise, so that a small batch spreads over more
  // warps
  long long cap = 0;
  int warps = 1;
  size_t smem = 0;
  for (int rows : {kUnitRows, 1}) {
    a.unit_rows = rows;
    a.units = (a.batch + rows - 1) / rows;
    a.in_bytes = rows * a.nf * a.pitch;
    a.out_bytes = (rows * a.pairs * 4 + 15) / 16 * 16;
    a.warp_bytes = (int)mma_warp_bytes(a.nf, a.dim, rows);
    warps = (size_t)kMaxWarps * a.warp_bytes <= kSmemMax ? kMaxWarps : 1;
    smem = (size_t)warps * a.warp_bytes;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32,
                                                          smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cap = (long long)sms * per_sm;
    if (a.units >= cap * warps) break;
  }
  const long long want = (a.units + warps - 1) / warps;
  const int blocks = (int)(want < cap ? want : cap);
  kernel<<<blocks, warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_mma(const void* feats, void* out, long long batch, int nf, int dim,
                       cudaStream_t stream) {
  if (nf > 16 * kMaxMTiles || mma_warp_bytes(nf, dim, kUnitRows) > kSmemMax)
    return cudaErrorInvalidValue;
  MmaArgs a{};
  a.feats = static_cast<const __nv_bfloat16*>(feats);
  a.out = static_cast<float*>(out);
  a.batch = batch;
  a.nf = nf;
  a.dim = dim;
  a.dp = (dim + 15) / 16 * 16;
  a.pitch = 2 * a.dp + 16;
  a.pairs = nf * (nf - 1) / 2;
  a.vec = dim % 8 == 0 && reinterpret_cast<uintptr_t>(feats) % 16 == 0;
  switch ((nf + 15) / 16) {
    case 1: return launch_mma_mt<1>(a, stream);
    case 2: return launch_mma_mt<2>(a, stream);
    case 3: return launch_mma_mt<3>(a, stream);
    default: return launch_mma_mt<4>(a, stream);
  }
}

// ------------------------------------------------------------------ f32

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;
constexpr size_t kSmemBudget = 48 * 1024;

__global__ void dot_interaction_kernel(const float* __restrict__ feats,
                                       float* __restrict__ out, int batch, int nf,
                                       int dim, int stride, int rows) {
  extern __shared__ float smem_f32[];
  const int pairs = nf * (nf - 1) / 2;
  float* xs = smem_f32;                                       // rows * nf * stride
  int* pair_ij = (int*)(smem_f32 + (size_t)rows * nf * stride);  // pairs
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
  // element e = threadIdx.x + kThreads*n of the block's rows is feature row
  // rf (of all rows), column d; both advance without a divide
  const float* src = feats + row0 * nf * dim;
  int rf = threadIdx.x / dim, d = threadIdx.x % dim;
  const int rf_step = kThreads / dim, d_step = kThreads % dim;
  for (int e = threadIdx.x; e < nrows * nf * dim; e += kThreads) {
    xs[rf * stride + d] = src[e];
    rf += rf_step;
    d += d_step;
    if (d >= dim) { d -= dim; ++rf; }
  }
  __syncthreads();

  float* dst = out + row0 * pairs;
  int r = threadIdx.x / pairs, p = threadIdx.x % pairs;
  const int r_step = kThreads / pairs, p_step = kThreads % pairs;
  for (int q = threadIdx.x; q < nrows * pairs; q += kThreads) {
    const int ij = pair_ij[p];
    const float* xi = xs + (r * nf + (ij >> 16)) * stride;
    const float* xj = xs + (r * nf + (ij & 0xffff)) * stride;
    float acc = 0.f;
    for (int k = 0; k < dim; ++k) acc = fmaf(xi[k], xj[k], acc);
    dst[q] = acc;
    r += r_step;
    p += p_step;
    if (p >= pairs) { p -= pairs; ++r; }
  }
}

cudaError_t launch_f32(const void* feats, void* out, int batch, int nf, int dim,
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
  dot_interaction_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const float*)feats, (float*)out, batch, nf, dim, stride, rows);
  return cudaGetLastError();
}

}  // namespace

// feats: batch*nf*dim values, row-major, on the device, f32 (is_bf16 = 0)
// or bf16 (is_bf16 = 1); out: batch * nf(nf-1)/2 f32, 16-byte aligned.
// bf16: 2 <= nf <= 64 and a warp's buffers for 4-row units (mma_warp_bytes)
// within 227 KB; f32: 2 <= nf <= 32767 and one row's
// features, as f32, within 48 KB. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape its route refuses).
extern "C" int dot_interaction_launch(const void* feats, void* out, int batch,
                                      int nf, int dim, int is_bf16,
                                      void* stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  if (nf < 2 || nf > 32767 || dim <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) return (int)launch_mma(feats, out, batch, nf, dim, st);
  return (int)launch_f32(feats, out, batch, nf, dim, st);
}

