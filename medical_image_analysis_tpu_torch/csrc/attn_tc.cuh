// The attention forward core on Hopper's tensor cores (sm_90a), shared by
// attention.cu (fused_attention) and vit_block.cu (the heads of
// vit_attn_fwd, and the recompute of o, the logsumexp and D = do . o in the
// ViT attention backward).
//
//   attn_tc_fwd_kernel <- _attn_kernel (medical_image_analysis_tpu/ops/
//                         attention.py:28, pallas_call :92), the heads of
//                         _attn_block_kernel (medical_image_analysis_tpu/
//                         ops/vit_block.py:81) and the forward recompute of
//                         _attn_block_bwd_kernel (:298, :307-317):
//                         softmax(q k^T * scale + mask) v
//
// Templated on the operand type T (fp32 or bf16), the head width HD (16, 32,
// 64, 128) and STATS (also write the per-row logsumexp and D = do . o, fp32
// only). q, k and v are read in place: any batch and token strides, heads
// and head dims contiguous, every row 16-byte aligned (the wrappers see to
// it). mask (L, L) fp32 or null; out (B, L, H, HD) contiguous in T.
//
// Bound on the H100 (the port's yardstick: products at the tensor-core
// rate of their operand type, fp32 in 3xTF32 at 495 / 3 = 165 TFLOP/s,
// bf16 at 989; the rest at 67 TFLOP/s; bytes at 3.35 TB/s): at ViT-B
// (B = 64, L = 197, 12 heads of 64) 7.63 GFLOP of products, 0.046 ms in
// fp32, level with its 155 MB of q, k, v and output; in bf16 its 77 MB,
// 0.023 ms. The mae_hd_1280 decoder's recompute (B = 16, L = 6,401, 16
// heads of 32): 1.34 TFLOP of products, 8.1 ms.
//
// Instruction and tiles: warp-level mma.sync, m16n8k8 in 3xTF32 for fp32
// (three MMAs per product, mma_tc.cuh) and m16n8k16 for bf16. Not wgmma,
// for three reasons that this design weighs above wgmma's higher peak: a
// tf32 wgmma takes only K-major shared-memory B operands, so every fp32
// tile would have to be split and stored twice (hi and lo) in a swizzled
// layout before each product; the probabilities p, computed in registers,
// feed the P.V product straight from the score accumulators (a fixed
// permutation of the k index for tf32, a repacking for bf16) with no trip
// through shared memory; and a fragment load transposes for free. wgmma is
// the next step once these kernels hold their numbers.
//   A block is 4 warps and owns 64 queries of one (batch, head); a warp owns
// 16 query rows. It walks tiles of NK keys (64; 32 at HD = 128 in fp32, to
// stay within two blocks an SM), K and V double-buffered in shared memory
// by cp.async while the previous tile multiplies. Rows are padded by 16
// bytes (HD + 4 fp32, HD + 8 bf16), which makes every fragment load free of
// bank conflicts. S = Q K^T goes to fp32 registers (NK / 2 a thread), then
// the scale and the mask, an online softmax in fp32 (the running max and
// sum per row, the quad's four lanes reduced by shuffles), p rounded to v's
// type, and P.V into the HD / 2 fp32 accumulators of each thread.
//
// Accumulation: each key tile's P.V starts from zero in the MMA's
// accumulators and is added to the running output by an ordinary fp32
// multiply-add. The tensor cores align the terms of their internal sums to
// the largest and truncate the rest, so a long sum kept in the MMA
// accumulators drifts toward zero by about half an fp32 step per MMA: over
// the 6,400 keys of the mae_hd_1280 decoder (800 k8 steps, x3) that is 1e-4
// of the sum, the checks' whole budget. Cut at every tile, the drift stays
// near 24 steps' worth.
//
// Rounding: online softmax, one pass: p = exp(s - m) is rounded to v's type
// before P.V and the division by the row sum comes at the end, where the
// TPU kernel normalises first and then rounds. In fp32 the two agree to
// rounding; in bf16 both round p once to bf16, at another scale, which the
// port's bf16 bound (two bf16 steps) holds. The logsumexp is stored in log2
// units (m + log2 l, with s already scaled by log2 e), as the backward reads
// it.
//
// What the old design (csrc/attention.cu before this header) lost, and what
// this one does: it gave a block 16 queries and kept their whole (16, L)
// score rows in shared memory, read the keys twice with scalar FMAs on the
// CUDA cores (67 TFLOP/s at best), and widened bf16 to fp32; here the keys
// are read once per 64 queries, the scores never leave registers, and every
// product is on the tensor cores.

#pragma once

#include <math_constants.h>

#include "mma_tc.cuh"

namespace {
namespace tc {

constexpr int kAttnThreads = 128;  // 4 warps
constexpr int kAttnRows = 64;      // queries a block owns, 16 a warp

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  long long q_bs, q_ts, k_bs, k_ts, v_bs, v_ts;  // batch and token strides
  const float* mask;  // (L, L) or null
  void* out;          // (B, L, H, HD) contiguous, T
  float* lse;         // (B, H, L), log2 units; STATS only
  const float* dout;  // (B, L, H, HD) fp32; STATS only
  float* dsum;        // (B, H, L): D = do . o; STATS only
  int B, H, L;
  float scale;
};

template <typename T>
__host__ __device__ constexpr int row_pad() {
  return 16 / static_cast<int>(sizeof(T));
}

template <typename T, int HD>
__host__ __device__ constexpr int attn_keys() {
  return (HD == 128 && sizeof(T) == 4) ? 32 : 64;
}

template <typename T, int HD>
constexpr size_t attn_smem_bytes() {
  return static_cast<size_t>(kAttnRows + 4 * attn_keys<T, HD>()) *
         (HD + row_pad<T>()) * sizeof(T);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// s[j] (16 rows x 8 keys) += Q_w K_j^T over HD: Q_w the warp's 16 rows of
// Qs, K_j rows 8j .. 8j+7 of Ks; both (rows, SP) in shared memory.
template <int HD, int NK, int SP>
__device__ __forceinline__ void scores(float (&s)[NK / 8][4], const float* Qw,
                                       const float* Ks, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    Split<4> a;
    a.set(0, Qw[g * SP + 8 * kk + t]);
    a.set(1, Qw[(g + 8) * SP + 8 * kk + t]);
    a.set(2, Qw[g * SP + 8 * kk + t + 4]);
    a.set(3, Qw[(g + 8) * SP + 8 * kk + t + 4]);
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
      Split<2> b;
      b.set(0, Ks[(8 * j + g) * SP + 8 * kk + t]);
      b.set(1, Ks[(8 * j + g) * SP + 8 * kk + t + 4]);
      mma_3xtf32(s[j], a, b);
    }
  }
}

template <int HD, int NK, int SP>
__device__ __forceinline__ void scores(float (&s)[NK / 8][4],
                                       const __nv_bfloat16* Qw,
                                       const __nv_bfloat16* Ks, int g, int t) {
  auto u32 = [](const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  };
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t a[4] = {u32(Qw + g * SP + 16 * kk + 2 * t),
                           u32(Qw + (g + 8) * SP + 16 * kk + 2 * t),
                           u32(Qw + g * SP + 16 * kk + 2 * t + 8),
                           u32(Qw + (g + 8) * SP + 16 * kk + 2 * t + 8)};
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
      const uint32_t b[2] = {u32(Ks + (8 * j + g) * SP + 16 * kk + 2 * t),
                             u32(Ks + (8 * j + g) * SP + 16 * kk + 2 * t + 8)};
      mma_bf16(s[j], a, b);
    }
  }
}

// o[n] (16 rows x 8 dims) += P V over the NK keys of the tile; P is the
// score accumulators s (now probabilities). tf32: k-step j takes keys
// 8j .. 8j+7 with its k index permuted (k = t is key 8j + 2t, k = t + 4 is
// key 8j + 2t + 1), so that the accumulators are the A fragment as they lie.
template <int HD, int NK, int SP>
__device__ __forceinline__ void p_times_v(float (&o)[HD / 8][4],
                                          const float (&s)[NK / 8][4],
                                          const float* Vs, int g, int t,
                                          int /*lane*/) {
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
    Split<4> a;
    a.set(0, s[j][0]);
    a.set(1, s[j][2]);
    a.set(2, s[j][1]);
    a.set(3, s[j][3]);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      Split<2> b;
      b.set(0, Vs[(8 * j + 2 * t) * SP + 8 * n + g]);
      b.set(1, Vs[(8 * j + 2 * t + 1) * SP + 8 * n + g]);
      mma_3xtf32(o[n], a, b);
    }
  }
}

// bf16: p rounded to bf16 pairs (two n8 score tiles make one k16 step), V's
// fragments by ldmatrix.trans.
template <int HD, int NK, int SP>
__device__ __forceinline__ void p_times_v(float (&o)[HD / 8][4],
                                          const float (&s)[NK / 8][4],
                                          const __nv_bfloat16* Vs, int g,
                                          int t, int lane) {
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                           pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                           pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
    const int row = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      uint32_t b[4];
      ldsm_x4_trans(b, Vs + row * SP + 16 * n + 8 * (lane >> 4));
      const uint32_t b0[2] = {b[0], b[1]};
      const uint32_t b1[2] = {b[2], b[3]};
      mma_bf16(o[2 * n], a, b0);
      mma_bf16(o[2 * n + 1], a, b1);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float a, float b);
template <>
__device__ __forceinline__ void store_pair<float>(float* dst, float a,
                                                  float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* dst,
                                                          float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// grid (ceil(L / 64), B * H), 128 threads, attn_smem_bytes<T, HD>() of
// dynamic shared memory.
template <typename T, int HD, bool STATS>
__global__ void __launch_bounds__(kAttnThreads)
    attn_tc_fwd_kernel(const AttnArgs p) {
  constexpr int SP = HD + row_pad<T>();
  constexpr int NK = attn_keys<T, HD>();
  extern __shared__ __align__(16) unsigned char attn_smem[];
  T* Qs = reinterpret_cast<T*>(attn_smem);  // [64][SP]
  T* Ks = Qs + kAttnRows * SP;              // [2][NK][SP]
  T* Vs = Ks + 2 * NK * SP;                 // [2][NK][SP]

  const int L = p.L, H = p.H;
  const int q0 = blockIdx.x * kAttnRows;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_bs + h * HD;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_bs + h * HD;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_bs + h * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  load_rows<T, HD, kAttnRows, SP, kAttnThreads>(Qs, qb, p.q_ts, q0, L);
  load_rows<T, HD, NK, SP, kAttnThreads>(Ks, kb, p.k_ts, 0, L);
  load_rows<T, HD, NK, SP, kAttnThreads>(Vs, vb, p.v_ts, 0, L);
  cp_async_commit();

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};
  float m_use[2] = {0.0f, 0.0f};
  const int row0 = q0 + warp * 16 + g;  // the thread's rows: row0, row0 + 8
  const int tiles = (L + NK - 1) / NK;

  for (int it = 0; it < tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < tiles) {
      load_rows<T, HD, NK, SP, kAttnThreads>(Ks + (st ^ 1) * NK * SP, kb,
                                             p.k_ts, (it + 1) * NK, L);
      load_rows<T, HD, NK, SP, kAttnThreads>(Vs + (st ^ 1) * NK * SP, vb,
                                             p.v_ts, (it + 1) * NK, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[NK / 8][4];
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    scores<HD, NK, SP>(s, Qs + warp * 16 * SP, Ks + st * NK * SP, g, t);

    // scale, mask, log2 units; the tile's row max
    const int k0 = it * NK;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        float v = s[j][e] * p.scale;
        if (p.mask != nullptr && row < L && key < L)
          v += p.mask[static_cast<size_t>(row) * L + key];
        v = key < L ? v * kLog2e : -CUDART_INF_F;
        s[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mnew = fmaxf(m[r], quad_max(mx[r]));
      // a row with every key so far masked keeps 0 as its reference
      m_use[r] = mnew == -CUDART_INF_F ? 0.0f : mnew;
      corr[r] = exp2f(m[r] - m_use[r]);
      m[r] = mnew;
    }
    float psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = exp2f(s[j][e] - m_use[e >> 1]);
        psum[e >> 1] += pv;
        s[j][e] = pv;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];

    // the tile's P.V from zero, then added to the running output in fp32
    float ot[HD / 8][4];
    zero(ot);
    p_times_v<HD, NK, SP>(ot, s, Vs + st * NK * SP, g, t, lane);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = o[n][e] * corr[e >> 1] + ot[n][e];
    __syncthreads();  // the stage is free for the load after next
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float lsum = quad_sum(l[r]);
    const float inv = 1.0f / lsum;
    const size_t orow = (static_cast<size_t>(b) * L + row) * H * HD + h * HD;
    float dot = 0.0f;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int c = 8 * n + 2 * t;
      const float o0 = o[n][2 * r] * inv, o1 = o[n][2 * r + 1] * inv;
      if (row < L) {
        store_pair<T>(out + orow + c, o0, o1);
        if constexpr (STATS) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(p.dout + orow + c);
          dot += o0 * d2.x + o1 * d2.y;
        }
      }
    }
    if constexpr (STATS) {
      dot = quad_sum(dot);
      if (row < L && t == 0) {
        const size_t ri = (static_cast<size_t>(b) * H + h) * L + row;
        p.lse[ri] = m_use[r] + log2f(lsum);
        p.dsum[ri] = dot;
      }
    }
  }
}

// Every row of q, k, v (and out, dout) 16-byte aligned: what cp.async and
// the paired stores need.
template <typename T>
inline bool attn_aligned(const AttnArgs& p) {
  auto ok = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  const long long e = 16 / static_cast<long long>(sizeof(T));
  return ok(p.q) && ok(p.k) && ok(p.v) && ok(p.out) &&
         p.q_bs % e == 0 && p.q_ts % e == 0 && p.k_bs % e == 0 &&
         p.k_ts % e == 0 && p.v_bs % e == 0 && p.v_ts % e == 0;
}

template <typename T, int HD, bool STATS>
cudaError_t launch_attn_tc(const AttnArgs& p, cudaStream_t stream) {
  const size_t smem = attn_smem_bytes<T, HD>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_tc_fwd_kernel<T, HD, STATS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.L + kAttnRows - 1) / kAttnRows, p.B * p.H);
  attn_tc_fwd_kernel<T, HD, STATS>
      <<<grid, kAttnThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The head widths the core takes; any other, a (B * H) above the grid's
// limit, or an unaligned row is refused.
template <typename T, bool STATS>
cudaError_t attn_tc_dispatch(int hd, const AttnArgs& p, cudaStream_t s) {
  if (p.B < 1 || p.H < 1 || p.L < 1 ||
      static_cast<long long>(p.B) * p.H > 65535 || !attn_aligned<T>(p))
    return cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch_attn_tc<T, 16, STATS>(p, s);
    case 32: return launch_attn_tc<T, 32, STATS>(p, s);
    case 64: return launch_attn_tc<T, 64, STATS>(p, s);
    case 128: return launch_attn_tc<T, 128, STATS>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc
}  // namespace
