// Swin's window attention core, for Hopper (sm_90a): kernel B3.
//
// Replaces no TPU kernel. The JAX package leaves this chain to XLA, which
// fuses it on the TPU (openpvsg_tpu/models/swin.py:WindowAttention.__call__);
// unfused on the card it was ~10 kernels that wrote and read float32 logits
// of shape (windows, heads, L, L) about ten times. For window w and head h of
// the qkv projection's output (nW, L, 3C), C = H * hd, the kernel computes
//
//   s   = (q . k, bf16 operands, float32 sums) * (1 / sqrt(hd))
//   s   = s + bias[h]                  (float32 (H, L, L))
//   s   = s + mask[w % nM]             (float32 (nM, L, L), shifted blocks)
//   p   = softmax(s) over the full row in float32, cast to the compute dtype
//   out = p . v, float32 sums, stored in the compute dtype, heads
//         concatenated per token: (nW, L, C), what proj reads
//
// in the order and precision of models/swin.py's plain form
// (kernels/window_attention.py:window_attention_plain): the scale is torch's
// CUDA division by a scalar (a product with the float32 reciprocal), the
// scale, bias and mask are separate float32 roundings (no FMA contraction),
// the softmax takes the exact row max and sum and divides, as torch's
// warp softmax does. Only the order of the sums differs.
//
// What bounds it. Swin-L on one 384x640 frame (grids padded to window 12,
// L = 144, hd = 32): 15 GFLOP of q.k and p.v (0.015 ms at 989 TFLOP/s) over
// ~210 MB of q, k, v read and the output written once (0.063 ms at 3.35
// TB/s): bytes. Besides, every logit reads its float32 bias and, in shifted
// blocks, its mask (4 B each, from L2: per head 83 KB of bias shared by
// every window, per window 83 KB of mask shared by every head) and takes
// ~25 float32 instructions (scale, bias, mask, max, exp, sum, an IEEE
// division, the cast). On the card the kernel takes ~0.55 ms a frame
// (H100 SXM, 700 W): what holds it is the latency of that per-logit work
// and of the bias and mask reads at the occupancy the logits' registers
// allow, not DRAM.
//
// Design (bf16, the model's operating point). One CTA per (window, head),
// the heads of a window in adjacent CTAs, so the q/k/v rows of a window,
// which interleave the heads, are read from whole DRAM lines. L is padded to
// LP = 16 * KT rows; KT warps each own 16 query rows. k and v stream into
// shared memory by cp.async (16 B a copy; rows padded by 8 elements, so
// ldmatrix's eight row addresses hit distinct banks; pad rows zeroed) while
// each warp loads its q rows straight into mma A fragments. mma.sync
// m16n8k16 (bf16 in, float32 accumulate) computes the warp's 16 x LP
// logits into registers (72 floats a thread at L = 144); scale, bias, mask
// (read as 8-byte pairs where L is even), row max (quad shuffles), exp, sum
// and the division all stay there, and the normalised probabilities,
// rounded to bf16, are reused in place as the A fragments of p.v (the
// accumulator and A layouts of m16n8k16 coincide), with v's B fragments
// from ldmatrix.trans. The output leaves as bf16 pairs. wgmma is not used:
// its 64-row tile does not divide 144. Launch bounds ask for two CTAs of 9
// warps per SM (96 registers a thread, a few spilled): more warps in flight
// beat fewer spills. No dynamic shared memory (at most 41.5 KB static, hd =
// 64), so nothing is set on the function and the launch replays inside
// CUDA graphs.
//
// Measured against this design at Swin-L's stage shapes (ms a frame, same
// card and call): scalar bias and mask reads 0.61; a persistent CTA an SM
// walking runs of items that share their bias and mask tiles in shared
// memory 0.88 (9 warps an SM leave the schedulers idle); two independent
// halves a CTA walking such runs, bias and mask from L2, 0.80; ordering the
// CTAs by (head, mask row) 0.67 (the q/k/v reads lose their DRAM
// locality); the bias staged in shared memory by cp.async while q.k runs
// 0.50, kept out for its 108 KB of dynamic shared memory a CTA for 7%; CTAs
// of 3 warps at 168 registers, no spills, 0.58.
//
// float32 operands take a SIMT path in full float32 (no TF32): one thread
// per query row, three passes over the keys (max, sum, output), each
// recomputing the same logits in the same order. No cell times it.
//
// Every entry point launches on the given stream, allocates nothing and
// returns the first CUDA error (cudaErrorInvalidValue for arguments it does
// not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxL = 144;  // window 12

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// scale, then bias, then mask: three float32 roundings, as the plain form's
// three operations
__device__ __forceinline__ float logit(float dot, float scale, const float* bias_row,
                                       const float* mask_row, int col) {
  float v = __fadd_rn(__fmul_rn(dot, scale), bias_row[col]);
  if (mask_row != nullptr) v = __fadd_rn(v, mask_row[col]);
  return v;
}

// the float32 of a row at col and col + 1 (col even, col < L; 0 past L):
// one 8-byte read where rows are 8-byte aligned (L even)
__device__ __forceinline__ float2 pair_at(const float* row, int col, int L, bool even) {
  if (even) return *reinterpret_cast<const float2*>(row + col);
  return make_float2(row[col], col + 1 < L ? row[col + 1] : 0.f);
}

// ===========================================================================
// bfloat16: mma.sync, logits in registers
// ===========================================================================

template <int HD, int KT>
__global__ void __launch_bounds__(KT * 32, 2)
    wattn_bf16(const bf16* __restrict__ qkv, const float* __restrict__ bias,
               const float* __restrict__ mask, bf16* __restrict__ out, int L, int H, int nM,
               float scale) {
  constexpr int LP = KT * 16;     // padded rows and keys
  constexpr int NT = 2 * KT;      // 8-key tiles of the logits
  constexpr int KS = HD / 16;     // 16-deep steps of q.k
  constexpr int DT = HD / 8;      // 8-wide tiles of the output
  constexpr int STRIDE = HD + 8;  // shared row, in elements
  constexpr int CH = HD / 8;      // 16-byte chunks of a row
  __shared__ __align__(16) bf16 ks[LP * STRIDE];
  __shared__ __align__(16) bf16 vs[LP * STRIDE];

  const int h = blockIdx.x % H, w = blockIdx.x / H;
  const int C = H * HD, row3 = 3 * C;
  const bf16* base = qkv + (size_t)w * L * row3 + h * HD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < LP * CH; i += KT * 32) {
    const int r = i / CH, c = (i % CH) * 8;
    bf16* kd = ks + r * STRIDE + c;
    bf16* vd = vs + r * STRIDE + c;
    if (r < L) {
      cp_async16(kd, base + (size_t)r * row3 + C + c);
      cp_async16(vd, base + (size_t)r * row3 + 2 * C + c);
    } else {
      *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
    }
  }

  // q's A fragments, straight from global memory: rows g and g + 8 of the
  // warp's 16, columns 2t, 2t + 1 and 2t + 8, 2t + 9 of each 16-deep step
  const int g = lane >> 2, t = lane & 3;
  const int ra = warp * 16 + g, rb = ra + 8;
  uint32_t qa[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int c = s * 16 + 2 * t;
    const uint32_t* pa = reinterpret_cast<const uint32_t*>(base + (size_t)ra * row3 + c);
    const uint32_t* pb = reinterpret_cast<const uint32_t*>(base + (size_t)rb * row3 + c);
    qa[s][0] = ra < L ? pa[0] : 0u;
    qa[s][1] = rb < L ? pb[0] : 0u;
    qa[s][2] = ra < L ? pa[4] : 0u;
    qa[s][3] = rb < L ? pb[4] : 0u;
  }
  cp_async_wait_all();
  __syncthreads();

  // logits: acc[n] holds (ra, 8n + 2t), (ra, 8n + 2t + 1), (rb, ...), (rb, ...)
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    const bf16* krow = ks + (n * 8 + (lane & 7)) * STRIDE;
    if constexpr (KS == 1) {
      uint32_t b0, b1;
      ldsm_x2(b0, b1, krow + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[n], qa[0], b0, b1);
    } else {
#pragma unroll
      for (int s = 0; s < KS; s += 2) {
        uint32_t b[4];
        ldsm_x4(b, krow + s * 16 + (lane >> 3) * 8);
        mma_bf16(acc[n], qa[s], b[0], b[1]);
        mma_bf16(acc[n], qa[s + 1], b[2], b[3]);
      }
    }
  }

  // scale, bias, mask: three float32 roundings, as logit() takes them;
  // columns past L take -inf, rows past L 0 (they are not stored)
  const bool even = (L & 1) == 0;
  const float* bias_a = bias + ((size_t)h * L + ra) * L;
  const float* bias_b = bias + ((size_t)h * L + rb) * L;
  const float* mask_a = mask == nullptr ? nullptr : mask + ((size_t)(w % nM) * L + ra) * L;
  const float* mask_b = mask == nullptr ? nullptr : mask + ((size_t)(w % nM) * L + rb) * L;
  float max_a = -INFINITY, max_b = -INFINITY;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t;
    float2 ba = make_float2(0.f, 0.f), bb = ba, ma = ba, mb = ba;
    if (col < L) {
      if (ra < L) {
        ba = pair_at(bias_a, col, L, even);
        if (mask != nullptr) ma = pair_at(mask_a, col, L, even);
      }
      if (rb < L) {
        bb = pair_at(bias_b, col, L, even);
        if (mask != nullptr) mb = pair_at(mask_b, col, L, even);
      }
    }
    const float bv[4] = {ba.x, ba.y, bb.x, bb.y};
    const float mv[4] = {ma.x, ma.y, mb.x, mb.y};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col + (j & 1);
      const bool in_row = (j < 2 ? ra : rb) < L;
      float v;
      if (c >= L) {
        v = -INFINITY;
      } else if (!in_row) {
        v = 0.f;
      } else {
        v = __fadd_rn(__fmul_rn(acc[n][j], scale), bv[j]);
        if (mask != nullptr) v = __fadd_rn(v, mv[j]);
      }
      acc[n][j] = v;
    }
    max_a = fmaxf(max_a, fmaxf(acc[n][0], acc[n][1]));
    max_b = fmaxf(max_b, fmaxf(acc[n][2], acc[n][3]));
  }
  // a row lies in the four lanes of a quad
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    max_a = fmaxf(max_a, __shfl_xor_sync(0xffffffffu, max_a, o));
    max_b = fmaxf(max_b, __shfl_xor_sync(0xffffffffu, max_b, o));
  }
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      acc[n][j] = expf(acc[n][j] - max_a);
      acc[n][2 + j] = expf(acc[n][2 + j] - max_b);
      sum_a += acc[n][j];
      sum_b += acc[n][2 + j];
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o);
  }

  // p . v: the probabilities of keys 16c .. 16c + 15 are the A fragment
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
#pragma unroll
  for (int c = 0; c < KT; ++c) {
    uint32_t pa[4];
    pa[0] = pack_bf16(__fdiv_rn(acc[2 * c][0], sum_a), __fdiv_rn(acc[2 * c][1], sum_a));
    pa[1] = pack_bf16(__fdiv_rn(acc[2 * c][2], sum_b), __fdiv_rn(acc[2 * c][3], sum_b));
    pa[2] = pack_bf16(__fdiv_rn(acc[2 * c + 1][0], sum_a), __fdiv_rn(acc[2 * c + 1][1], sum_a));
    pa[3] = pack_bf16(__fdiv_rn(acc[2 * c + 1][2], sum_b), __fdiv_rn(acc[2 * c + 1][3], sum_b));
    const bf16* vrow =
        vs + (c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STRIDE + (lane >> 4) * 8;
#pragma unroll
    for (int d = 0; d < DT; d += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, vrow + d * 8);
      mma_bf16(o[d], pa, b[0], b[1]);
      mma_bf16(o[d + 1], pa, b[2], b[3]);
    }
  }

  bf16* oa = out + ((size_t)w * L + ra) * C + h * HD + 2 * t;
  bf16* ob = out + ((size_t)w * L + rb) * C + h * HD + 2 * t;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    if (ra < L) *reinterpret_cast<uint32_t*>(oa + d * 8) = pack_bf16(o[d][0], o[d][1]);
    if (rb < L) *reinterpret_cast<uint32_t*>(ob + d * 8) = pack_bf16(o[d][2], o[d][3]);
  }
}

// ===========================================================================
// float32: SIMT, one thread per query row
// ===========================================================================

template <int HD>
__global__ void __launch_bounds__(160)
    wattn_f32(const float* __restrict__ qkv, const float* __restrict__ bias,
              const float* __restrict__ mask, float* __restrict__ out, int L, int H, int nM,
              float scale) {
  const int h = blockIdx.x % H, w = blockIdx.x / H;
  const int C = H * HD, row3 = 3 * C;
  const int r = threadIdx.x;
  if (r >= L) return;
  const float* base = qkv + (size_t)w * L * row3 + h * HD;
  float q[HD];
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 v = *reinterpret_cast<const float4*>(base + (size_t)r * row3 + d);
    q[d] = v.x, q[d + 1] = v.y, q[d + 2] = v.z, q[d + 3] = v.w;
  }
  const float* bias_r = bias + ((size_t)h * L + r) * L;
  const float* mask_r = mask == nullptr ? nullptr : mask + ((size_t)(w % nM) * L + r) * L;
  // the same logit, bit for bit, in each of the three passes
  auto s_at = [&](int j) {
    const float* k = base + (size_t)j * row3 + C;
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      const float4 v = *reinterpret_cast<const float4*>(k + d);
      dot = fmaf(q[d], v.x, dot);
      dot = fmaf(q[d + 1], v.y, dot);
      dot = fmaf(q[d + 2], v.z, dot);
      dot = fmaf(q[d + 3], v.w, dot);
    }
    return logit(dot, scale, bias_r, mask_r, j);
  };
  float m = -INFINITY;
  for (int j = 0; j < L; ++j) m = fmaxf(m, s_at(j));
  float sum = 0.f;
  for (int j = 0; j < L; ++j) sum += expf(s_at(j) - m);
  float o[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) o[d] = 0.f;
  for (int j = 0; j < L; ++j) {
    const float p = __fdiv_rn(expf(s_at(j) - m), sum);
    const float* v = base + (size_t)j * row3 + 2 * C;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(v + d);
      o[d] = fmaf(p, x.x, o[d]);
      o[d + 1] = fmaf(p, x.y, o[d + 1]);
      o[d + 2] = fmaf(p, x.z, o[d + 2]);
      o[d + 3] = fmaf(p, x.w, o[d + 3]);
    }
  }
  float* dst = out + ((size_t)w * L + r) * C + h * HD;
#pragma unroll
  for (int d = 0; d < HD; d += 4)
    *reinterpret_cast<float4*>(dst + d) = make_float4(o[d], o[d + 1], o[d + 2], o[d + 3]);
}

template <int HD>
int run_bf16(const void* qkv, const float* bias, const float* mask, void* out, int nW, int L,
             int H, int nM, float scale, cudaStream_t stream) {
  const dim3 grid(nW * H);
  const bf16* in = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  switch ((L + 15) / 16) {
#define WATTN_CASE(KT)                                                                \
  case KT:                                                                            \
    wattn_bf16<HD, KT><<<grid, KT * 32, 0, stream>>>(in, bias, mask, o, L, H, nM, scale); \
    break;
    WATTN_CASE(1) WATTN_CASE(2) WATTN_CASE(3) WATTN_CASE(4) WATTN_CASE(5) WATTN_CASE(6)
    WATTN_CASE(7) WATTN_CASE(8) WATTN_CASE(9)
#undef WATTN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int HD>
int run_f32(const void* qkv, const float* bias, const float* mask, void* out, int nW, int L,
            int H, int nM, float scale, cudaStream_t stream) {
  wattn_f32<HD><<<nW * H, (L + 31) / 32 * 32, 0, stream>>>(
      static_cast<const float*>(qkv), bias, mask, static_cast<float*>(out), L, H, nM, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 for qkv (nW, L, 3 * H * hd) and out
// (nW, L, H * hd), both contiguous and 16-byte aligned; bias (H, L, L) and
// mask (nM, L, L, or null) float32 contiguous, window w taking mask row
// w % nM; hd one of 16, 32, 64; 1 <= L <= 144; scale the float32 factor of
// q.k (1 / sqrt(hd)).
int window_attention(int dtype, const void* qkv, const float* bias, const float* mask, void* out,
                     int nW, int L, int H, int hd, int nM, float scale, void* stream) {
  if (nW <= 0 || H <= 0 || L <= 0 || L > kMaxL || (mask != nullptr && (nM <= 0 || nW % nM)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (hd == 16) return run_bf16<16>(qkv, bias, mask, out, nW, L, H, nM, scale, s);
    if (hd == 32) return run_bf16<32>(qkv, bias, mask, out, nW, L, H, nM, scale, s);
    if (hd == 64) return run_bf16<64>(qkv, bias, mask, out, nW, L, H, nM, scale, s);
  } else if (dtype == 0) {
    if (hd == 16) return run_f32<16>(qkv, bias, mask, out, nW, L, H, nM, scale, s);
    if (hd == 32) return run_f32<32>(qkv, bias, mask, out, nW, L, H, nM, scale, s);
    if (hd == 64) return run_f32<64>(qkv, bias, mask, out, nW, L, H, nM, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
