// Stride-4 FPN chain of the pixel decoder, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fused_fpn_stride4
// (openpvsg_tpu/ops/pallas/fpn_kernel.py:95; bodies k1 :125, k2 :166, k3 :242):
//
//   mask_feature = mask_1x1(relu(GN2(conv3x3(GN1(lateral_1x1(f0)) + up2x(s8)))))
//
// GN1 applies to the lateral alone, before the upsample add. Each GroupNorm
// needs whole-image statistics, so the chain is three launches:
//
//   fpn_lateral  l_raw = f0 @ w_lat + b_lat; per-(b, c) sum and sum of squares
//   fpn_conv3x3  x2 = conv3x3(x1) + b_out, where x1 = GN1affine(l_raw) +
//                up2x(s8), zero outside the image; per-(b, c) sums of x2
//   fpn_mask     out = relu(GN2affine(x2)) @ w_mask + b_mask
//
// The (B, C) sums are folded into per-channel scale and bias by the caller
// (kernels/fpn.py) between launches. Products accumulate in float32 and the
// group statistics are float32 sums of the float32 results (accumulator plus
// bias) before rounding, as in the Pallas body. The operands that the Pallas
// kernel casts to compute_dtype before its products (x1, the relu output)
// are rounded to the activation type here too.
//
// Deterministic statistics: every CTA reduces its own per-channel sums in a
// fixed order (no float atomics) and writes them to its column of a
// (2, B, C, tiles) float32 buffer; the caller sums the tile axis in a fixed
// order. fpn_stats_tiles() gives the number of tiles.
//
// Two routes, chosen by the activation dtype:
//
// * float32: the parity path. A SIMT tiled GEMM (128x128 block tile, 8x8
//   outputs per thread, float32 FMA, no tensor cores) for all three launches.
//
// * bfloat16, the model's operating point: wgmma.mma_async m64n128k16 (bf16
//   in, float32 accumulate), the warpgroup product that alone reaches the
//   tensor cores' full rate. B (the weights, as they lie in memory: the
//   MN-major operand) and the 1x1 launches' A stream in by TMA, with the
//   128-byte swizzle, into rings of shared-memory slots guarded by mbarriers;
//   one thread issues each stage, so no warp stalls on issuing loads. Each
//   warpgroup keeps one wgmma group in flight across the next stage. What
//   bounds each launch on the main path (B = 2 frames, 96x120, C = 256; H100
//   SXM at 700 W: 989 TFLOP/s bf16, 3.35 TB/s):
//
//   - fpn_conv3x3 (27.2 GFLOP over 27.7 MB) is bound by operations. One CTA
//     (3 warpgroups) owns a 24x8 pixel tile (192 pixels) and computes N in
//     passes of 128 channels, so x1 is built once per CTA and each CTA reads
//     the (9C, N) weight once: a prologue writes the 26x10 halo tile of x1 to
//     shared memory with batched 16-byte loads of l_raw and s8 and the
//     bilinear taps computed once per halo row and column. wgmma reads A
//     from that tile directly (8-channel planes of pixels: an 8-pixel tile
//     row is one core matrix), so each of the nine taps is a shifted operand
//     address, with no copy and no registers (a first version that brought
//     A in through ldmatrix and registers spent a large share of its loop
//     there), while 64-deep weight slices stream through a 4-slot TMA ring. 96x120 makes 4 x 15 = 60 tiles per
//     image, 120 CTAs over 132 SMs: one wave.
//   - fpn_lateral and fpn_mask (3.0 GFLOP over 23.6 MB each, 127 FLOP per
//     byte against the card's ~295) are bound by bytes. A persistent CTA per
//     SM (B x SMs / B CTAs, each on one image) keeps the whole (K, N) weight
//     (up to 256 x 256) in shared memory and walks 64-pixel tiles, streaming
//     A exactly once through a 6-slot TMA ring that runs across tile
//     boundaries, so the next tile's loads overlap this tile's epilogue.
//     wgmma takes A from registers (ldmatrix from the swizzled ring), where
//     fpn_mask applies the GN2 affine + relu + rounding first. The
//     epilogue writes the bf16 tile to shared memory and one thread stores it
//     by TMA, which drains while the next tile computes; fpn_mask reads its
//     image's GN2 affine once. fpn_lateral's CTA sums its GN1 statistics over
//     all its tiles.
//
//   fpn_conv3x3's epilogue adds the bias, stages the bf16 tile in shared
//   memory and stores it with 16-byte stores. The bf16 route takes channel
//   counts that are multiples of 8 up to 256 (zero-filled by TMA to the MMA
//   tile); ragged pixel tiles are masked (TMA clips the 1x1 launches' stores).
//
// Every entry point launches on the given stream, allocates nothing and
// returns the first CUDA error (cudaErrorInvalidValue for arguments it does
// not take).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { LATERAL = 0, CONV3X3 = 1, MASK = 2 };

// the SIMT route is instantiated for float32 only (bf16 runs on tensor cores)
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

// the value as the activation type holds it
template <typename T> __device__ __forceinline__ float round_cd(float v) {
  return to_f(from_f<T>(v));
}

// torch's bilinear source taps for align_corners=False (upsample_bilinear2d):
// output index dst reads input rows i0 and i0 + ip with weights l0 and l1.
__device__ __forceinline__ void bilinear_taps(int dst, int in_size, int out_size,
                                              int& i0, int& ip, float& l0, float& l1) {
  const float scale = (float)in_size / (float)out_size;
  float src = scale * ((float)dst + 0.5f) - 0.5f;
  if (src < 0.f) src = 0.f;
  i0 = (int)src;
  ip = (i0 < in_size - 1) ? 1 : 0;
  l1 = src - (float)i0;
  l0 = 1.f - l1;
}

// ===========================================================================
// float32 route: SIMT tiled GEMM
// ===========================================================================

constexpr int BM = 128;  // output pixels per block
constexpr int BN = 128;  // output channels per block
constexpr int BK = 8;    // reduction depth per shared-memory stage
constexpr int NT = 256;  // 16 x 16 threads, each owns 8 x 8 outputs

template <typename T>
struct Args {
  const T* a;         // LATERAL: f0 (B, HW, K); CONV3X3: l_raw (B, HW, C); MASK: x2 (B, HW, K)
  const T* s8;        // CONV3X3: stride-8 map (B, H8, W8, C)
  const float* sc;    // (B, C) GroupNorm scale of the A operand (CONV3X3: GN1, MASK: GN2)
  const float* bi;    // (B, C) GroupNorm bias of the A operand
  const T* w;         // (K, N) row-major; CONV3X3: K = 9 * C ordered (dy, dx, ci)
  const float* bias;  // (N)
  T* out;             // (B, HW, N)
  float* sum;         // (B, tiles, N) per-block sums of the float32 outputs
  float* sumsq;       // (B, tiles, N) per-block sums of their squares
  int HW, H, W, H8, W8, C, K, N;
};

template <typename T, int MODE>
__global__ void __launch_bounds__(NT) fpn_gemm(const Args<T> p) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, b = blockIdx.z;
  const int lda = (MODE == CONV3X3) ? p.C : p.K;
  const T* a_img = p.a + (size_t)b * p.HW * lda;
  const float* sc = p.sc + (size_t)b * lda;
  const float* bi = p.bi + (size_t)b * lda;

  // this thread's A-tile slot: one pixel, 4 consecutive k
  const int ar = tid >> 1, ak = (tid & 1) * 4;
  const int am = m0 + ar;
  const bool a_ok = am < p.HW;
  const int ay = a_ok ? am / p.W : 0, ax = a_ok ? am % p.W : 0;
  // this thread's B-tile slot: one k, 4 consecutive n
  const int bk = tid >> 5, bn = (tid & 31) * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    float av[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (MODE == LATERAL) {
      if (a_ok) {
        const T* row = a_img + (size_t)am * p.K;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + ak + j;
          if (k < p.K) av[j] = to_f(row[k]);
        }
      }
    } else if constexpr (MODE == MASK) {
      if (a_ok) {
        const T* row = a_img + (size_t)am * p.K;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + ak + j;
          if (k < p.K) av[j] = round_cd<T>(fmaxf(to_f(row[k]) * sc[k] + bi[k], 0.f));
        }
      }
    } else {
      // K = 9 * C with C % BK == 0: the whole stage lies in one tap (dy, dx)
      const int tap = k0 / p.C;
      const int ci0 = k0 - tap * p.C + ak;
      const int ys = ay + tap / 3 - 1, xs = ax + tap % 3 - 1;
      if (a_ok && ys >= 0 && ys < p.H && xs >= 0 && xs < p.W) {
        int r0, rp, c0, cp;
        float wr0, wr1, wc0, wc1;
        bilinear_taps(ys, p.H8, p.H, r0, rp, wr0, wr1);
        bilinear_taps(xs, p.W8, p.W, c0, cp, wc0, wc1);
        const T* t00 = p.s8 + (((size_t)b * p.H8 + r0) * p.W8 + c0) * p.C;
        const T* t01 = t00 + (size_t)cp * p.C;
        const T* t10 = t00 + (size_t)rp * p.W8 * p.C;
        const T* t11 = t10 + (size_t)cp * p.C;
        const T* lat = a_img + ((size_t)ys * p.W + xs) * p.C;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ci = ci0 + j;
          const float up = wr0 * (wc0 * to_f(t00[ci]) + wc1 * to_f(t01[ci])) +
                           wr1 * (wc0 * to_f(t10[ci]) + wc1 * to_f(t11[ci]));
          av[j] = round_cd<T>(to_f(lat[ci]) * sc[ci] + bi[ci] + up);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) As[ak + j][ar] = av[j];
    {
      const int k = k0 + bk;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + bn + j;
        Bs[bk][bn + j] = (k < p.K && n < p.N) ? to_f(p.w[(size_t)k * p.N + n]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: bias, store, and (LATERAL, CONV3X3) this block's per-channel
  // sums of the float32 results, reduced over its 16 thread rows in order
  T* out_img = p.out + (size_t)b * p.HW * p.N;
  float cs[8], cq[8], bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + tx + 16 * j;
    cs[j] = 0.f;
    cq[j] = 0.f;
    bias[j] = n < p.N ? p.bias[n] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= p.HW) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= p.N) continue;
      const float v = acc[i][j] + bias[j];
      out_img[(size_t)m * p.N + n] = from_f<T>(v);
      cs[j] += v;
      cq[j] += v * v;
    }
  }
  if constexpr (MODE != MASK) {
    __shared__ float red_s[16][BN];
    __shared__ float red_q[16][BN];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red_s[ty][tx + 16 * j] = cs[j];
      red_q[ty][tx + 16 * j] = cq[j];
    }
    __syncthreads();
    if (tid < BN && n0 + tid < p.N) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        s += red_s[r][tid];
        q += red_q[r][tid];
      }
      const size_t at = ((size_t)b * p.N + n0 + tid) * gridDim.x + blockIdx.x;
      p.sum[at] = s;
      p.sumsq[at] = q;
    }
  }
}

template <int MODE>
int run_f32(const void* a, const void* s8, const float* sc, const float* bi, const void* w,
            const float* bias, void* out, float* sum, float* sumsq, int B, int HW, int H,
            int W, int H8, int W8, int C, int K, int N, void* stream) {
  if (B <= 0 || HW <= 0 || K <= 0 || N <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  Args<float> p;
  p.a = static_cast<const float*>(a);
  p.s8 = static_cast<const float*>(s8);
  p.sc = sc;
  p.bi = bi;
  p.w = static_cast<const float*>(w);
  p.bias = bias;
  p.out = static_cast<float*>(out);
  p.sum = sum;
  p.sumsq = sumsq;
  p.HW = HW;
  p.H = H;
  p.W = W;
  p.H8 = H8;
  p.W8 = W8;
  p.C = C;
  p.K = K;
  p.N = N;
  const dim3 grid((HW + BM - 1) / BM, (N + BN - 1) / BN, B);
  fpn_gemm<float, MODE><<<grid, NT, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// ===========================================================================
// bfloat16 route: tensor cores (wgmma), TMA and mbarrier pipelines
// ===========================================================================

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int kMaxC = 256;  // widest K, C or N the route takes
// TMA ring depths; a warpgroup leaves one wgmma group in flight across the
// next stage's barrier, so a ring of S slots is loaded S - 2 stages ahead
// and a slot is refilled only once the wgmma that read it has completed
constexpr int kConvStages = 4;
constexpr int kGemmStages = 6;
constexpr int kWgmmaInFlight = 1;
// fpn_conv3x3: a kTH x kTW pixel tile, N in passes of 128 channels; one
// warpgroup per 8 image rows of 8 pixels (the 64 rows of its wgmma)
constexpr int kConvWG = 3;
constexpr int kConvThreads = 128 * kConvWG;
constexpr int kConvWarps = kConvThreads / 32;
constexpr int kTH = 8 * kConvWG;      // output rows per CTA
constexpr int kTW = 8;                // output columns per CTA: one 8-row group of a wgmma A tile
constexpr int kHW = kTW + 2;          // halo width
constexpr int kHP = (kTH + 2) * kHW;  // halo pixels
constexpr int kHPlane = kHP | 1;      // pixels per 8-channel plane of the halo tile; odd, so
                                      // the 16-byte stores of one pixel's planes hit all banks
constexpr int kConvNW = 128;                // output channels per pass
constexpr int kConvBK = 64;                 // input channels per weight stage
// fpn_lateral / fpn_mask: 64-pixel tiles x all N = 256 channels; warpgroup
// w computes channels 128 w .. 128 w + 127 of all 64 pixels
constexpr int kGemmThreads = 256;
constexpr int kGemmBM = 64;
constexpr int kGemmNW = 256;
constexpr int kGemmBK = 64;  // reduction depth per A stage: one 128-byte row

// The conv's output staging tile, written by rows of accumulator fragments,
// keeps 8 elements of padding per row, so that the eight rows one store
// touches fall on distinct banks.
__host__ __device__ constexpr int padded(int n) { return n + 8; }
__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers and TMA -------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the calling thread arrives and the barrier expects bytes more of TMA data
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n"
      "@!P bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// tile of the tensor map at coordinates (innermost first) -> shared dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}
// orders this thread's shared-memory stores before reads of the same memory
// by the async proxy (TMA stores, wgmma operands), after a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// shared src -> tile of the tensor map at coordinates (innermost first)
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(src))
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// waits until the committed stores have read their shared-memory sources
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// --- wgmma -------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// tells the compiler that the accumulators change here (the asynchronous
// wgmma writes them until its wait), so it keeps no copy across this point
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// B operand (weights), as they lie in memory: MN-major (the transposed
// operand), blocks of 64 output channels (128-byte rows, 16-byte chunks
// swizzled as TMA's and wgmma's 128-byte mode lay them out), KB input-channel
// rows each. Descriptor of the 16 x 128 slice at (k0, n0): the two 64-channel
// blocks KB * 128 bytes apart (leading byte offset), 8-row groups 1024 bytes
// apart (stride byte offset).
__device__ __forceinline__ uint64_t b_desc(const bf16* tile, int k0, int n0, int KB) {
  const bf16* p = tile + (n0 >> 6) * KB * 64 + k0 * 64;
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((KB * 128) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// A operand in shared memory, K-major without swizzle: 8 x 16-byte core
// matrices (8 rows of 8 channels), the two 8-channel halves of a k16 step
// lbo bytes apart, 8-row groups sbo bytes apart; addr is row 0, channel 0.
__device__ __forceinline__ uint64_t a_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d (64 x 128 per warpgroup, float32) = a (64 x 16, bf16, in shared memory at
// adesc) * b (16 x 128, bf16, MN-major in shared memory at bdesc), plus d
// when accumulate
__device__ __forceinline__ void wgmma_128_ss(float (&d)[64], uint64_t adesc, uint64_t bdesc,
                                             int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(adesc), "l"(bdesc), "r"(accumulate));
}

// d (64 x 128 per warpgroup, float32) = a (64 x 16, bf16, in registers: each
// warp's 16 rows in the mma.m16n8k16 A layout) * b (16 x 128, bf16,
// MN-major in shared memory at desc), plus d when accumulate
__device__ __forceinline__ void wgmma_128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                          int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const bf162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t word(const uint4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// relu(x * s + c) rounded to bf16, for a bf16 pair
__device__ __forceinline__ uint32_t gn_relu(uint32_t v, float2 s, float2 c) {
  return pack2(fmaxf(bf_lo(v) * s.x + c.x, 0.f), fmaxf(bf_hi(v) * s.y + c.y, 0.f));
}

// --- epilogue ----------------------------------------------------------------

// Sums v over the 8 lanes of a warp that share lane % 4 (the 8 row groups of
// an accumulator fragment) in a fixed order, halving the values exchanged at
// each step; the lane with g = lane / 4 gets the sums of entries 4g .. 4g + 3.
__device__ __forceinline__ void rows_reduce(const float (&v)[32], float (&r)[4], int lane) {
  const int g = lane >> 2;
  float h[16], q[8];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const bool up = g & 4;
    const float keep = up ? v[16 + i] : v[i], give = up ? v[i] : v[16 + i];
    h[i] = keep + __shfl_xor_sync(0xffffffffu, give, 16);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool up = g & 2;
    const float keep = up ? h[8 + i] : h[i], give = up ? h[i] : h[8 + i];
    q[i] = keep + __shfl_xor_sync(0xffffffffu, give, 8);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool up = g & 1;
    const float keep = up ? q[4 + i] : q[i], give = up ? q[i] : q[4 + i];
    r[i] = keep + __shfl_xor_sync(0xffffffffu, give, 4);
  }
}

// Fragment entry i (0..31) of a warp's 16 x 128 accumulator block holds
// channel 8 (i / 2) + 2 (lane % 4) + i % 2 of its 128.
__device__ __forceinline__ int frag_col(int i, int lane) {
  return (i >> 1) * 8 + (lane & 3) * 2 + (i & 1);
}

// Writes this warp's column sums v (over its rows) to red[wm][NW] at its
// warpgroup's channels, reduced over the warp's rows first.
template <int NW>
__device__ __forceinline__ void put_col_sums(const float (&v)[32], float* red, int wm, int wn,
                                             int lane) {
  float r[4];
  rows_reduce(v, r, lane);
#pragma unroll
  for (int i = 0; i < 4; ++i) red[wm * NW + wn * 128 + frag_col(4 * (lane >> 2) + i, lane)] = r[i];
}

// Accumulator pair j of a warp's 16 x 128 block (rows g = lane / 4 and g + 8,
// channels n = frag_col(2 j) and n + 1) plus the bias, as packed bf16 pairs
// for rows g (lo) and g + 8 (hi). With s and q, adds the float32 values of
// the valid rows (ok0, ok1) and their squares to this thread's column sums.
__device__ __forceinline__ void biased_pair(const float (&acc)[64], int j, const float* bias,
                                            int n, bool ok0, bool ok1, float (*s)[32],
                                            float (*q)[32], uint32_t& lo, uint32_t& hi) {
  const float b0 = bias[n], b1 = bias[n + 1];
  const float v00 = acc[4 * j] + b0, v01 = acc[4 * j + 1] + b1;
  const float v10 = acc[4 * j + 2] + b0, v11 = acc[4 * j + 3] + b1;
  if (s != nullptr) {
    (*s)[2 * j] += (ok0 ? v00 : 0.f) + (ok1 ? v10 : 0.f);
    (*s)[2 * j + 1] += (ok0 ? v01 : 0.f) + (ok1 ? v11 : 0.f);
    (*q)[2 * j] += (ok0 ? v00 * v00 : 0.f) + (ok1 ? v10 * v10 : 0.f);
    (*q)[2 * j + 1] += (ok0 ? v01 * v01 : 0.f) + (ok1 ? v11 * v11 : 0.f);
  }
  lo = pack2(v00, v01);
  hi = pack2(v10, v11);
}

// Adds the bias to a tile of (16 WM) pixels x 128 channels computed by WM
// warps (warp w: rows 16 w .., the warpgroup accumulator layout) and stores
// it as bf16 with 16-byte stores, staged in shared memory (row stride
// padded(128)) in ROUNDS rounds of 16 WM / ROUNDS rows. row_out(m) is the
// output row of tile row m at the tile's first channel, or nullptr outside
// the image; ncols channels are valid. With s and q, adds the float32 values
// of the valid rows and their squares to this thread's column sums.
template <int WM, int ROUNDS, class RowOut>
__device__ __forceinline__ void store_tile(const float (&acc)[64], const float* bias, bf16* stage,
                                           int ncols, RowOut row_out, float (*s)[32],
                                           float (*q)[32]) {
  constexpr int LD = padded(128), RW = WM / ROUNDS;
  const int tid = threadIdx.x, lane = tid & 31, wm = tid >> 5, g = lane >> 2;
  for (int round = 0; round < ROUNDS; ++round) {
    if (wm / RW == round) {
      const bool ok0 = row_out(16 * wm + g) != nullptr;
      const bool ok1 = row_out(16 * wm + g + 8) != nullptr;
      bf16* srow = stage + (16 * (wm % RW) + g) * LD;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = frag_col(2 * j, lane);
        biased_pair(acc, j, bias, n, ok0, ok1, s, q, *reinterpret_cast<uint32_t*>(srow + n),
                    *reinterpret_cast<uint32_t*>(srow + 8 * LD + n));
      }
    }
    __syncthreads();
    for (int idx = tid; idx < 16 * RW * 16; idx += 32 * WM) {
      const int m = idx / 16, n = (idx % 16) * 8;
      bf16* dst = row_out(round * 16 * RW + m);
      if (dst != nullptr && n < ncols)
        *reinterpret_cast<uint4*>(dst + n) = *reinterpret_cast<const uint4*>(stage + m * LD + n);
    }
    if (round + 1 < ROUNDS) __syncthreads();
  }
}

// Adds the bias to a 64 x 256 tile computed by 8 warps (warp w: rows 16 (w %
// 4) .., channels 128 (w / 4) .., the warpgroup accumulator layout) and writes
// it as bf16 to stage as the four 64 x 64 boxes of a TMA store, each row's
// 16-byte chunk c at c ^ (row % 8) (the 128-byte swizzle). With s and q,
// adds the float32 values of the rows below nrows and their squares to this
// thread's column sums.
__device__ __forceinline__ void stage_tile_swizzled(const float (&acc)[64], const float* bias,
                                                    bf16* stage, int nrows, float (*s)[32],
                                                    float (*q)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = 16 * (warp & 3) + (lane >> 2), wn = warp >> 2;
  // row r0 + 8 has the same swizzle as row r0
  unsigned char* rows = reinterpret_cast<unsigned char*>(stage) + r0 * 128 + (lane & 3) * 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    // box 2 wn + j / 8, chunk j % 8 of the row
    unsigned char* at = rows + (2 * wn + (j >> 3)) * 8192 + (((j & 7) ^ (r0 & 7)) << 4);
    biased_pair(acc, j, bias, wn * 128 + frag_col(2 * j, lane), r0 < nrows, r0 + 8 < nrows, s, q,
                *reinterpret_cast<uint32_t*>(at), *reinterpret_cast<uint32_t*>(at + 8 * 128));
  }
}

// ---------------------------------------------------------------------------
// fpn_conv3x3, bf16: implicit GEMM over a shared halo tile of x1
// ---------------------------------------------------------------------------

struct ConvArgs {
  const bf16* l_raw;  // (B, H, W, C)
  const bf16* s8;     // (B, H8, W8, C)
  const float* sc;    // (B, C) GN1 scale
  const float* bi;    // (B, C) GN1 bias
  const float* bias;  // (N)
  bf16* out;          // (B, H, W, N)
  float* part;        // (2, B, N, tiles) partial sums and sums of squares
  int B, H, W, H8, W8, C, N, tiles_w, tiles;
};

struct Taps {
  int o0, o1;  // the two source rows (or columns)
  float w0, w1;
};

// shared memory, in order: weight ring (1024-byte aligned slots), halo tile
// (8-channel planes of kHPlane pixels), output staging of one warpgroup's
// rows (bf16); bias, GN1 scale and bias, column-sum reduction (float32);
// bilinear taps; ring barriers
constexpr int kConvSlot = kConvBK * kConvNW;  // elements
constexpr int conv_smem_bytes(int C) {
  return (kConvStages * kConvSlot + kHPlane * round_up(C, kConvBK) + 64 * padded(kConvNW)) * 2 +
         (kMaxC + 2 * kMaxC + kConvWarps * kConvNW) * 4 + (kTH + 2 + kHW) * 16 + kConvStages * 8;
}

// wmap: the (3, 3, C, N) weight as a (N, C, 9) tensor map (innermost first),
// boxes of 64 x 64 x 1, 128-byte swizzle; a weight stage is two boxes
__global__ void __launch_bounds__(kConvThreads, 1)
    fpn_conv3x3_tc(const ConvArgs p, const __grid_constant__ CUtensorMap wmap) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int C32 = round_up(p.C, kConvBK);
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* halo = ring + kConvStages * kConvSlot;
  bf16* stage = halo + kHPlane * C32;
  float* bias_s = reinterpret_cast<float*>(stage + 64 * padded(kConvNW));
  float* sc_s = bias_s + kMaxC;
  float* bi_s = sc_s + kMaxC;
  float* red = bi_s + kMaxC;
  Taps* rtap = reinterpret_cast<Taps*>(red + kConvWarps * kConvNW);
  Taps* ctap = rtap + kTH + 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(ctap + kHW);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, tile = blockIdx.x;
  constexpr int kAhead = kConvStages - 2;
  const int y0 = (tile / p.tiles_w) * kTH, x0 = (tile % p.tiles_w) * kTW;
  const int nck = C32 / kConvBK;  // channel slices per tap (C32: C rounded up to them)
  const int per_pass = 9 * nck;   // stages per 128-channel pass
  const int n_stages = (p.N + kConvNW - 1) / kConvNW * per_pass;

  // weight stage s: input channels c0 .. c0 + 63 of tap (dy, dx), the 128
  // output channels of its pass (zero-filled past C and N)
  auto load_w = [&](int s) {
    const int pass = s / per_pass, r = s - pass * per_pass, tap = r / nck;
    uint64_t* bar = full + s % kConvStages;
    bf16* slot = ring + (s % kConvStages) * kConvSlot;
    const int c0 = (r - tap * nck) * kConvBK;
    mbar_expect(bar, kConvSlot * 2);
    tma_load(slot, &wmap, bar, pass * kConvNW, c0, tap);
    tma_load(slot + kConvBK * 64, &wmap, bar, pass * kConvNW + 64, c0, tap);
  };
  if (tid == 0) {
    for (int i = 0; i < kConvStages; ++i) mbar_init(full + i, 1);
    mbar_init_fence();
    for (int s = 0; s < kAhead && s < n_stages; ++s) load_w(s);
  }

  // prologue: bias, GN1 affine of this image, bilinear taps per halo row and
  // column, then the halo tile of x1 = GN1affine(l_raw) + up2x(s8), rounded
  // to bf16, zero outside the image and in the channel padding
  for (int i = tid; i < kMaxC; i += kConvThreads) bias_s[i] = i < p.N ? p.bias[i] : 0.f;
  for (int i = tid; i < p.C; i += kConvThreads) {
    sc_s[i] = p.sc[(size_t)b * p.C + i];
    bi_s[i] = p.bi[(size_t)b * p.C + i];
  }
  if (tid < kTH + 2 + kHW) {
    const bool row = tid < kTH + 2;
    const int dst = row ? y0 + tid - 1 : x0 + (tid - kTH - 2) - 1;
    int i0, ip;
    float l0, l1;
    bilinear_taps(dst, row ? p.H8 : p.W8, row ? p.H : p.W, i0, ip, l0, l1);
    rtap[tid] = Taps{i0, i0 + ip, l0, l1};  // rtap and ctap are contiguous
  }
  __syncthreads();
  {
    // kU chunks of 8 channels per thread and round: all their loads are
    // issued before any is used
    constexpr int kU = 2;
    const int cg8 = C32 / 8, total = kHP * cg8;
    const bf16* s8_img = p.s8 + (size_t)b * p.H8 * p.W8 * p.C;
    for (int base = tid; base < total; base += kU * kConvThreads) {
      uint4 t[kU][5];
      bool ok[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = base + u * kConvThreads;
        const int pix = i / cg8, c = (i - pix * cg8) * 8;
        const int hy = pix / kHW, hx = pix - hy * kHW;
        const int y = y0 + hy - 1, x = x0 + hx - 1;
        ok[u] = i < total && c < p.C && y >= 0 && y < p.H && x >= 0 && x < p.W;
        if (ok[u]) {
          const Taps r = rtap[hy], q = ctap[hx];
          const bf16* s8c = s8_img + c;
          const bf16* src[5] = {s8c + ((size_t)r.o0 * p.W8 + q.o0) * p.C,
                                s8c + ((size_t)r.o0 * p.W8 + q.o1) * p.C,
                                s8c + ((size_t)r.o1 * p.W8 + q.o0) * p.C,
                                s8c + ((size_t)r.o1 * p.W8 + q.o1) * p.C,
                                p.l_raw + (((size_t)b * p.H + y) * p.W + x) * p.C + c};
#pragma unroll
          for (int e = 0; e < 5; ++e) t[u][e] = __ldg(reinterpret_cast<const uint4*>(src[e]));
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = base + u * kConvThreads;
        if (i >= total) break;
        const int pix = i / cg8, c = (i - pix * cg8) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (ok[u]) {
          const int hy = pix / kHW, hx = pix - hy * kHW;
          const Taps r = rtap[hy], q = ctap[hx];
          uint32_t o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t a00 = word(t[u][0], e), a01 = word(t[u][1], e);
            const uint32_t a10 = word(t[u][2], e), a11 = word(t[u][3], e);
            const uint32_t al = word(t[u][4], e);
            const int ci = c + 2 * e;
            const float up_lo = r.w0 * (q.w0 * bf_lo(a00) + q.w1 * bf_lo(a01)) +
                                r.w1 * (q.w0 * bf_lo(a10) + q.w1 * bf_lo(a11));
            const float up_hi = r.w0 * (q.w0 * bf_hi(a00) + q.w1 * bf_hi(a01)) +
                                r.w1 * (q.w0 * bf_hi(a10) + q.w1 * bf_hi(a11));
            o[e] = pack2(bf_lo(al) * sc_s[ci] + bi_s[ci] + up_lo,
                         bf_hi(al) * sc_s[ci + 1] + bi_s[ci + 1] + up_hi);
          }
          v = make_uint4(o[0], o[1], o[2], o[3]);
        }
        *reinterpret_cast<uint4*>(halo + ((c >> 3) * kHPlane + pix) * 8) = v;
      }
    }
  }
  fence_proxy_async();  // the halo tile is read by wgmma

  // main loop: passes of 128 output channels x 9 taps x C32 / 64 channel
  // slices; the first barrier also publishes the halo tile. Warpgroup g
  // computes image rows 8 g .. 8 g + 7 of the tile, and its wgmma reads A
  // straight from the halo tile: row m is pixel (8 g + m / 8 + dy, m % 8 +
  // dx), so each 8-row group is 8 pixels of one halo row (a core matrix) and
  // a tap is a shifted start address.
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const uint32_t a_wg = smem_u32(halo) + (warp / 4) * 8 * kHW * 16;
  auto step = [&](int s) {
    __syncthreads();  // every warpgroup is done with the slot refilled next
    if (tid == 0 && s + kAhead < n_stages) load_w(s + kAhead);
    const int pass = s / per_pass, r = s - pass * per_pass;
    const int tap = r / nck, c0 = (r - tap * nck) * kConvBK;
    const int dy = tap / 3, dx = tap - 3 * dy;
    const uint32_t a0 = a_wg + ((c0 >> 3) * kHPlane + dy * kHW + dx) * 16;
    mbar_wait(full + s % kConvStages, (s / kConvStages) & 1);
    const bf16* wst = ring + (s % kConvStages) * kConvSlot;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kConvBK / 16; ++kk)
      wgmma_128_ss(acc, a_desc(a0 + kk * 2 * kHPlane * 16, kHPlane * 16, kHW * 16),
                   b_desc(wst, kk * 16, 0, kConvBK), r > 0 || kk > 0);
    wgmma_commit();
    if (r < per_pass - 1) {
      wgmma_wait<kWgmmaInFlight>();
      return;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    const int n0 = pass * kConvNW;
    auto row_out = [&](int m) -> bf16* {
      const int y = y0 + m / kTW, x = x0 + m % kTW;
      return (y < p.H && x < p.W) ? p.out + (((size_t)b * p.H + y) * p.W + x) * p.N + n0
                                  : nullptr;
    };
    float cs[32], cq[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) cs[i] = cq[i] = 0.f;
    store_tile<kConvWarps, kConvWG>(acc, bias_s + n0, stage, p.N - n0, row_out, &cs, &cq);
    // GN2 partial sums of this tile: sums, then squares, through red
    __syncthreads();
    const size_t at = ((size_t)b * p.N + n0) * p.tiles + tile;  // + n tiles
    const size_t sq = (size_t)p.B * p.N * p.tiles;
    put_col_sums<kConvNW>(cs, red, warp, 0, lane);
    __syncthreads();
    if (tid < kConvNW && n0 + tid < p.N) {
      float t = 0.f;
      for (int w = 0; w < kConvWarps; ++w) t += red[w * kConvNW + tid];
      p.part[at + (size_t)tid * p.tiles] = t;
    }
    __syncthreads();
    put_col_sums<kConvNW>(cq, red, warp, 0, lane);
    __syncthreads();
    if (tid < kConvNW && n0 + tid < p.N) {
      float t = 0.f;
      for (int w = 0; w < kConvWarps; ++w) t += red[w * kConvNW + tid];
      p.part[sq + at + (size_t)tid * p.tiles] = t;
    }
  };
  for (int s = 0; s < n_stages; ++s) step(s);
}

// ---------------------------------------------------------------------------
// fpn_lateral / fpn_mask, bf16: persistent 1x1 GEMM with a resident weight
// ---------------------------------------------------------------------------

struct GemmArgs {
  const float* sc;    // MASK: (B, K) GN2 scale
  const float* bi;    // MASK: (B, K) GN2 bias
  const float* bias;  // (N)
  float* part;        // LATERAL: (2, B, N, gridDim.x) partial sums and squares
  int HW, K, N;
};

// shared memory, in order: weight, A ring, output staging (bf16, 1024-byte
// aligned boxes; fpn_lateral's final column-sum reduction reuses it); bias,
// GN2 scale and bias of this CTA's image (float32); barriers
static_assert(kGemmBM * kGemmNW * 2 >= 2 * 4 * kGemmNW * 4, "staging too small");
constexpr int gemm_smem_bytes(int K) {
  return (round_up(K, 64) * kGemmNW + kGemmStages * kGemmBM * kGemmBK + kGemmBM * kGemmNW) * 2 +
         3 * kMaxC * 4 + (kGemmStages + kMaxC / kGemmBK) * 8;
}

// amap: A as a (K, HW, B) tensor map, boxes 64 x 64 x 1, 128-byte swizzle;
// wmap: the (K, N) weight as (N, K), boxes 64 x 64, 128-byte swizzle;
// omap: the output as (N, HW, B), boxes 64 x 64 x 1, 128-byte swizzle (TMA
// clips the ragged tile). Grid: (CTAs per image, B); each CTA walks the
// 64-pixel tiles of its image.
template <int MODE>
__global__ void __launch_bounds__(kGemmThreads, 1)
    fpn_gemm_tc(const GemmArgs p, const __grid_constant__ CUtensorMap amap,
                const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap omap) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int nk = (p.K + kGemmBK - 1) / kGemmBK, KP = nk * kGemmBK;
  bf16* wsm = reinterpret_cast<bf16*>(smem);
  bf16* ring = wsm + KP * kGemmNW;
  bf16* stage = ring + kGemmStages * kGemmBM * kGemmBK;
  float* bias_s = reinterpret_cast<float*>(stage + kGemmBM * kGemmNW);
  float* sc_s = bias_s + kMaxC;
  float* bi_s = sc_s + kMaxC;
  float* red = reinterpret_cast<float*>(stage);  // [sum | sumsq][4][256], after the last store
  uint64_t* full = reinterpret_cast<uint64_t*>(bi_s + kMaxC);
  uint64_t* wbar = full + kGemmStages;  // one per 64-deep block of the weight
  constexpr int kAhead = kGemmStages - 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp & 3, wg = warp >> 2;  // warp's 16 rows; warpgroup's 128 channels
  const int b = blockIdx.y;
  const int tpi = (p.HW + kGemmBM - 1) / kGemmBM;  // tiles per image
  const int n_my = (tpi - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int G = n_my * nk;  // this CTA's stages, over all its tiles

  // A stage g: tile blockIdx.x + (g / nk) gridDim.x of image b, channels
  // (g % nk) 64 ..
  auto load_a = [&](int g) {
    const int m0 = (blockIdx.x + (g / nk) * gridDim.x) * kGemmBM, k0 = (g % nk) * kGemmBK;
    uint64_t* bar = full + g % kGemmStages;
    mbar_expect(bar, kGemmBM * kGemmBK * 2);
    tma_load(ring + (g % kGemmStages) * kGemmBM * kGemmBK, &amap, bar, k0, m0, b);
  };
  // the weight in 64-deep blocks, each after the A stage that first needs it
  if (tid == 0) {
    for (int i = 0; i < kGemmStages + nk; ++i) mbar_init(full + i, 1);
    mbar_init_fence();
    for (int kc = 0; kc < nk; ++kc) {
      if (kc < kAhead && kc < G) load_a(kc);
      mbar_expect(wbar + kc, kGemmBK * kGemmNW * 2);
      for (int nb = 0; nb < kGemmNW / 64; ++nb)
        tma_load(wsm + (nb * KP + kc * kGemmBK) * 64, &wmap, wbar + kc, nb * 64, kc * kGemmBK);
    }
    for (int s = nk; s < kAhead && s < G; ++s) load_a(s);
  }
  for (int i = tid; i < kMaxC; i += kGemmThreads) {
    bias_s[i] = i < p.N ? p.bias[i] : 0.f;
    if (MODE == MASK) {  // zero past K, where the A operand is zero-filled
      sc_s[i] = i < p.K ? p.sc[(size_t)b * p.K + i] : 0.f;
      bi_s[i] = i < p.K ? p.bi[(size_t)b * p.K + i] : 0.f;
    }
  }
  __syncthreads();

  float acc[64], cs[32], cq[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) cs[i] = cq[i] = 0.f;
  // ldmatrix rows of the 128-byte swizzled A slot: row r, 16-byte chunk c
  // lies at chunk c ^ (r % 8)
  const int arow = wr * 16 + (lane & 15), achunk = lane >> 4, t4 = lane & 3;
  // one stage; a holds its A fragments until its wgmma completes
  auto step = [&](int g, uint32_t (&a)[kGemmBK / 16][4]) {
    __syncthreads();  // every warpgroup is done with the slot refilled next
    if (tid == 0 && g + kAhead < G) load_a(g + kAhead);
    const int kc = g % nk;
    if (g < nk) mbar_wait(wbar + kc, 0);
    mbar_wait(full + g % kGemmStages, (g / kGemmStages) & 1);
    const bf16* ast = ring + (g % kGemmStages) * kGemmBM * kGemmBK + arow * kGemmBK;
#pragma unroll
    for (int kk = 0; kk < kGemmBK / 16; ++kk) {
      ldsm_x4(a[kk], ast + (((2 * kk + achunk) ^ (arow & 7)) << 3));
      if (MODE == MASK) {
        // GN2 affine + relu + rounding on the A fragments: registers 0, 1
        // hold channels kk*16 + 2*t4 + {0, 1}, registers 2, 3 those + 8
        const int kl = kc * kGemmBK + kk * 16 + 2 * t4;
        const float2 s0 = *reinterpret_cast<const float2*>(sc_s + kl);
        const float2 s1 = *reinterpret_cast<const float2*>(sc_s + kl + 8);
        const float2 c0 = *reinterpret_cast<const float2*>(bi_s + kl);
        const float2 c1 = *reinterpret_cast<const float2*>(bi_s + kl + 8);
        a[kk][0] = gn_relu(a[kk][0], s0, c0);
        a[kk][1] = gn_relu(a[kk][1], s0, c0);
        a[kk][2] = gn_relu(a[kk][2], s1, c1);
        a[kk][3] = gn_relu(a[kk][3], s1, c1);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGemmBK / 16; ++kk)
      wgmma_128(acc, a[kk], b_desc(wsm, kc * kGemmBK + kk * 16, wg * 128, KP),
                kc > 0 || kk > 0);
    wgmma_commit();
    if (kc < nk - 1) {
      wgmma_wait<kWgmmaInFlight>();
      return;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    // the previous tile's TMA store has read the staging buffer; this one's
    // drains while the next tile computes
    if (tid == 0) tma_store_wait_read();
    __syncthreads();
    const int m0 = (blockIdx.x + (g / nk) * gridDim.x) * kGemmBM;
    stage_tile_swizzled(acc, bias_s, stage, p.HW - m0, MODE == LATERAL ? &cs : nullptr,
                        MODE == LATERAL ? &cq : nullptr);
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      for (int nb = 0; nb * 64 < p.N; ++nb) tma_store(&omap, stage + nb * 64 * 64, nb * 64, m0, b);
      tma_store_commit();
    }
  };
  uint32_t a0[kGemmBK / 16][4], a1[kGemmBK / 16][4];
  for (int g = 0; g < G; g += 2) {
    step(g, a0);
    if (g + 1 < G) step(g + 1, a1);
  }
  if (tid == 0) tma_store_wait_read();
  if (MODE == LATERAL) {
    // GN1 partial sums of this CTA's tiles, through the staging buffer
    __syncthreads();
    put_col_sums<kGemmNW>(cs, red, wr, wg, lane);
    put_col_sums<kGemmNW>(cq, red + 4 * kGemmNW, wr, wg, lane);
    __syncthreads();
    const size_t at = (size_t)b * p.N * gridDim.x + blockIdx.x;  // + n gridDim.x
    const size_t sq = (size_t)gridDim.y * p.N * gridDim.x;
    if (tid < p.N) {
      float s = 0.f, q = 0.f;
      for (int w = 0; w < 4; ++w) {
        s += red[w * kGemmNW + tid];
        q += red[(4 + w) * kGemmNW + tid];
      }
      p.part[at + (size_t)tid * gridDim.x] = s;
      p.part[sq + at + (size_t)tid * gridDim.x] = q;
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

constexpr int kMaxDevices = 64;

int current_device(int& dev) {
  const int rc = (int)cudaGetDevice(&dev);
  if (rc != 0) return rc;
  return dev < 0 || dev >= kMaxDevices ? (int)cudaErrorInvalidDevice : 0;
}

int sm_count(int dev) {
  static int n[kMaxDevices] = {};
  if (n[dev] == 0 && cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount, dev) !=
                         cudaSuccess)
    n[dev] = 0;
  return n[dev];
}

// raises the kernel's dynamic shared-memory limit to bytes on this device,
// once; allowed[dev] remembers the limit set
template <class Kernel>
int allow_smem(Kernel kernel, int bytes, int dev, int (&allowed)[kMaxDevices]) {
  if (bytes <= allowed[dev]) return 0;
  const int rc =
      (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc == 0) allowed[dev] = bytes;
  return rc;
}

// cuTensorMapEncodeTiled, looked up at run time (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a tensor map over a dense row-major array; dims and box innermost first
int tensor_map(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* base, int rank,
               const int* dims, const int* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t gdim[3], gstride[2];
  cuuint32_t bdim[3], estride[3] = {1, 1, 1};
  uint64_t stride = esize;
  for (int i = 0; i < rank; ++i) {
    gdim[i] = (cuuint64_t)dims[i];
    bdim[i] = (cuuint32_t)box[i];
    stride *= (uint64_t)dims[i];
    if (i + 1 < rank) gstride[i] = stride;
  }
  const CUresult rc = encode(map, type, rank, const_cast<void*>(base), gdim, gstride, bdim,
                             estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int gemm_ctas_per_image(int B, int HW, int dev) {
  const int tpi = (HW + kGemmBM - 1) / kGemmBM;
  int per = sm_count(dev) / B;
  if (per < 1) per = 1;
  return per < tpi ? per : tpi;
}

template <int MODE>
int run_gemm_tc(const void* a, const float* sc, const float* bi, const void* w,
                const float* bias, void* out, float* part, int B, int HW, int K, int N,
                void* stream) {
  if (B <= 0 || B > 65535 || HW <= 0 || K <= 0 || N <= 0 || K > kMaxC || N > kGemmNW || K % 8 ||
      N % 8 || !aligned16(a) || !aligned16(w) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  int rc = current_device(dev);
  if (rc != 0) return rc;
  if (sm_count(dev) <= 0) return (int)cudaErrorInvalidDevice;
  static int allowed[kMaxDevices] = {};
  const int bytes = gemm_smem_bytes(K);
  rc = allow_smem(fpn_gemm_tc<MODE>, bytes, dev, allowed);
  if (rc != 0) return rc;
  CUtensorMap amap, wmap, omap;
  const int adims[3] = {K, HW, B}, abox[3] = {kGemmBK, kGemmBM, 1};
  const int odims[3] = {N, HW, B}, obox[3] = {64, kGemmBM, 1};
  const int wdims[2] = {N, K}, wbox[2] = {64, kGemmBK};
  if ((rc = tensor_map(&amap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, 3, adims, abox,
                       CU_TENSOR_MAP_SWIZZLE_128B)) != 0 ||
      (rc = tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, 2, wdims, wbox,
                       CU_TENSOR_MAP_SWIZZLE_128B)) != 0 ||
      (rc = tensor_map(&omap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, 3, odims, obox,
                       CU_TENSOR_MAP_SWIZZLE_128B)) != 0)
    return rc;
  GemmArgs p{sc, bi, bias, part, HW, K, N};
  const dim3 grid(gemm_ctas_per_image(B, HW, dev), B);
  fpn_gemm_tc<MODE><<<grid, kGemmThreads, bytes, (cudaStream_t)stream>>>(p, amap, wmap, omap);
  return (int)cudaGetLastError();
}

int conv_tiles(int H, int W) { return ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW); }

int run_conv_tc(const void* l_raw, const void* s8, const float* sc1, const float* bi1,
                const void* w, const float* bias, void* out, float* part, int B, int H, int W,
                int H8, int W8, int C, int N, void* stream) {
  if (B <= 0 || B > 65535 || C > kMaxC || N <= 0 || N > kMaxC || N % 8 || !aligned16(l_raw) ||
      !aligned16(s8) || !aligned16(w) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  int rc = current_device(dev);
  if (rc != 0) return rc;
  static int allowed[kMaxDevices] = {};
  const int bytes = conv_smem_bytes(C);
  rc = allow_smem(fpn_conv3x3_tc, bytes, dev, allowed);
  if (rc != 0) return rc;
  CUtensorMap wmap;
  const int wdims[3] = {N, C, 9}, wbox[3] = {64, kConvBK, 1};
  if ((rc = tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, 3, wdims, wbox,
                       CU_TENSOR_MAP_SWIZZLE_128B)) != 0)
    return rc;
  const int tiles_w = (W + kTW - 1) / kTW;
  ConvArgs p{static_cast<const bf16*>(l_raw), static_cast<const bf16*>(s8), sc1, bi1, bias,
             static_cast<bf16*>(out), part, B, H, W, H8, W8, C, N, tiles_w,
             conv_tiles(H, W)};
  fpn_conv3x3_tc<<<dim3(p.tiles, 1, B), kConvThreads, bytes, (cudaStream_t)stream>>>(p, wmap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 for the activations and weights; biases,
// GroupNorm affines and sums are float32. Weights are (K, N) row-major for
// fpn_lateral and fpn_mask, (3, 3, C, N) for fpn_conv3x3.
//
// GroupNorm sums: part is a (2, B, N, tiles) float32 scratch buffer, tiles =
// fpn_stats_tiles(dtype, kernel, B, H, W), where every CTA writes its
// partial sums ([0]) and sums of squares ([1]) of each channel, each summed
// in a fixed order; the caller adds them up over tiles.

// kernel: 0 = fpn_lateral, 1 = fpn_conv3x3, over B images of H x W; minus a
// CUDA error code if the device cannot be read
int fpn_stats_tiles(int dtype, int kernel, int B, int H, int W) {
  if (dtype != 1) return (H * W + BM - 1) / BM;
  if (kernel == 1) return conv_tiles(H, W);
  int dev = 0;
  const int rc = current_device(dev);
  if (rc != 0) return -rc;
  return gemm_ctas_per_image(B, H * W, dev);
}

int fpn_lateral(int dtype, const void* f0, const void* w, const float* bias, void* out,
                float* part, int B, int HW, int K, int N, void* stream) {
  if (dtype == 0)
    return run_f32<LATERAL>(f0, nullptr, nullptr, nullptr, w, bias, out, part,
                            part + (size_t)B * N * ((HW + BM - 1) / BM), B, HW, 0, 1, 0, 0, 0,
                            K, N, stream);
  if (dtype == 1)
    return run_gemm_tc<LATERAL>(f0, nullptr, nullptr, w, bias, out, part, B, HW, K, N, stream);
  return (int)cudaErrorInvalidValue;
}

int fpn_conv3x3(int dtype, const void* l_raw, const void* s8, const float* sc1,
                const float* bi1, const void* w, const float* bias, void* out, float* part,
                int B, int H, int W, int H8, int W8, int C, int N, void* stream) {
  if (C <= 0 || C % 8 != 0 || H <= 0 || W <= 0 || H8 <= 0 || W8 <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return run_f32<CONV3X3>(l_raw, s8, sc1, bi1, w, bias, out, part,
                            part + (size_t)B * N * ((H * W + BM - 1) / BM), B, H * W, H, W, H8,
                            W8, C, 9 * C, N, stream);
  if (dtype == 1)
    return run_conv_tc(l_raw, s8, sc1, bi1, w, bias, out, part, B, H, W, H8, W8, C, N, stream);
  return (int)cudaErrorInvalidValue;
}

int fpn_mask(int dtype, const void* x2, const float* sc2, const float* bi2, const void* w,
             const float* bias, void* out, int B, int HW, int K, int N, void* stream) {
  if (dtype == 0)
    return run_f32<MASK>(x2, nullptr, sc2, bi2, w, bias, out, nullptr, nullptr, B, HW, 0, 1,
                         0, 0, 0, K, N, stream);
  if (dtype == 1)
    return run_gemm_tc<MASK>(x2, sc2, bi2, w, bias, out, nullptr, B, HW, K, N, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
