// The pre-LN ViT block's two sub-layers for Hopper (sm_90a), forward and
// backward. They replace the four Pallas TPU kernels of
// medical_image_analysis_tpu/ops/vit_block.py:
//
//   vit_attn_fwd  <- _attn_block_kernel     (:81,  launched at :431)
//   vit_mlp_fwd   <- _mlp_block_kernel      (:126, launched at :431)
//   vit_attn_bwd  <- _attn_block_bwd_kernel (:298, launched at :522)
//   vit_mlp_bwd   <- _mlp_block_bwd_kernel  (:235, launched at :522)
//
// Each of the four is a short sequence of launches of the building blocks
// below, put together by the wrappers in ops/vit_block.py:
//
//   ln_stats_kernel  per-row mean and 1/sigma of x (fp32, eps 1e-6)
//   gemm_kernel      C = prologue(A) @ B with an epilogue. Prologues, applied
//                    while A is staged: LayerNorm from the row statistics
//                    (h = LN(x) rounded to x's dtype), or tanh-GELU of an
//                    fp32 pre-activation. Epilogues: fp32 store (or an fp32
//                    split-K partial), bias, bias + tanh-GELU, bias +
//                    residual, times GELU'(aux), plain store; rounded to the
//                    working dtype where the TPU kernel rounds.
//   attn_fwd_kernel  one block per (query tile, head, image) walks the key
//                    tiles with an online softmax and never stores the
//                    scores; writes each head's output in the working dtype
//                    and, for the backward, the per-row logsumexp and
//                    D = do . o.
//   attn_dkv_kernel, attn_dq_kernel  the flash-style backward: one pass
//                    over the query tiles for dK and dV, one over the key
//                    tiles for dQ, recomputing p from q, k and the
//                    logsumexp. No atomics.
//   colsum_kernel, ln_bwd_kernel  bias and LayerNorm gradients as per-block
//                    partials in a fixed order, summed by the wrapper.
//
// Choice of softmax: online (one pass over the keys, the running max and
// sum rescaling the output), not two passes. In fp32, the dtype of training,
// the two agree to rounding. In bf16 the TPU rounds p/l before p.v, and
// this kernel rounds exp(s - m) and divides by l at the end: both round p
// once to the working dtype, at another scale.
//
// What bounds them on the H100, and what the design does about it. Every
// product runs on the CUDA cores in fp32 (67 TFLOP/s at 700 W; TF32 is not
// used, so that the fp32 checks hold 1e-4), and bf16 operands are widened
// to fp32 in shared memory, so FLOPs bound every sub-layer at the shapes of
// mae_hd_1280 (B = 16): the decoder's attention sub-layer (L = 6401, d =
// 512, 16 heads) is about 1.56 TFLOP forward, 23 ms at peak; its MLP about
// 0.43 TFLOP, 6.4 ms; the encoder's (L = 1401, d = 768) attention about 0.20
// TFLOP, 3.0 ms, and MLP 0.21 TFLOP, 3.2 ms. The bytes moved (x, the weights,
// the q/k/v, head-output and hidden buffers written and read once) take a
// few ms at 3.35 TB/s. So the design keeps the arithmetic dense: the GEMM
// holds a 128 x 128 output tile in registers (8 x 8 a thread, two float4
// loads of A and of B per 64 FMAs), stages the next k-slice from device
// memory into registers while it multiplies the current one, and folds the
// LayerNorm, GELU, bias and residual into its staging and its stores so
// that no elementwise pass over the activations is launched. The attention
// core holds a 64 x 64 tile of scores (4 x 4 a thread) in registers, with
// the running max, sum and output. Weight gradients are products whose
// reduction runs over all B*L rows: with few output tiles the wrapper splits
// that reduction into fixed chunks whose fp32 partials it sums in order,
// so the card is filled and two runs give the same bits. The attention
// backward recomputes q, k, v, the head outputs and p from x, as the TPU
// kernel does (:307-317), and saves nothing in the forward. Its two passes
// (dK/dV over the query tiles, dQ over the key tiles) buy freedom from
// atomics with redundant work: the scores are computed three times (the
// forward recompute and once in each pass) and dp twice, 9 products of
// L x L x d where the function needs 6 (s, o, dV, dp, dQ, dK), so 1.5x the
// minimal L^2 work; the bound counts the 6. wgmma, TMA and tensor cores are
// later work.
//
// All launch on the caller's stream, allocate nothing, and return
// cudaGetLastError() (or the error of raising the shared-memory limit) so
// that the Python wrapper raises on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T and back: where the TPU kernel casts to x.dtype.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float<T>(from_float<T>(v));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float c = 0.7978845608028654f;
  const float t = tanhf(c * (x + 0.044715f * x * x * x));
  return 0.5f * (1.0f + t) +
         0.5f * x * (1.0f - t * t) * c * (1.0f + 3.0f * 0.044715f * x * x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum / max over the 16 lanes of a half warp (the lanes that share a row).
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// ---------------------------------------------------------------------------
// LayerNorm statistics: one warp a row.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void ln_stats_kernel(const T* __restrict__ x, float* __restrict__ mu,
                                float* __restrict__ rstd, int rows, int d,
                                float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * d;
  float s = 0.0f;
  for (int c = lane; c < d; c += 32) s += to_float<T>(xr[c]);
  const float mean = warp_sum(s) / d;
  float v = 0.0f;
  for (int c = lane; c < d; c += 32) {
    const float t = to_float<T>(xr[c]) - mean;
    v += t * t;
  }
  const float var = warp_sum(v) / d;
  if (lane == 0) {
    mu[row] = mean;
    rstd[row] = rsqrtf(var + eps);
  }
}

// ---------------------------------------------------------------------------
// GEMM with a prologue on A and an epilogue.
// ---------------------------------------------------------------------------

enum Pro { kProNone = 0, kProLn = 1, kProGelu = 2 };
enum Epi {
  kEpiF32 = 0,        // out (fp32) = acc; split z writes its own partial
  kEpiBias = 1,       // out = round(acc + bias)
  kEpiBiasGelu = 2,   // out = round(gelu(acc + bias))
  kEpiBiasResid = 3,  // out = round(resid + round(acc + bias))
  kEpiDgelu = 4,      // out = round(acc * gelu'(aux))
  kEpiStore = 5,      // out = round(acc)
};

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 8;
constexpr int kGemmThreads = 256;

template <typename T>
struct GemmArgs {
  const T* a;
  int a_trans, lda;  // A (M, K); stored (K, M) when a_trans
  const T* b;
  int b_trans, ldb;  // B (K, N); stored (N, K) when b_trans
  int M, N, K, k_chunk;
  int pro;
  const float* mu;
  const float* rstd;
  const T* gamma;
  const T* beta;
  int epi;
  const T* bias;
  const T* resid;  // (M, ldc)
  const float* aux;
  int ld_aux;
  void* out;  // float for kEpiF32, T otherwise
  int ldc;
};

template <typename T>
__device__ __forceinline__ float load_a(const GemmArgs<T>& p, int m, int k,
                                        int kend) {
  if (m >= p.M || k >= kend) return 0.0f;
  const size_t idx = p.a_trans ? static_cast<size_t>(k) * p.lda + m
                               : static_cast<size_t>(m) * p.lda + k;
  float v = to_float<T>(p.a[idx]);
  if (p.pro == kProLn) {
    const int row = p.a_trans ? k : m;
    const int feat = p.a_trans ? m : k;
    v = round_to<T>((v - p.mu[row]) * p.rstd[row] *
                        to_float<T>(p.gamma[feat]) +
                    to_float<T>(p.beta[feat]));
  } else if (p.pro == kProGelu) {
    v = round_to<T>(gelu_tanh(v));
  }
  return v;
}

template <typename T>
__device__ __forceinline__ float load_b(const GemmArgs<T>& p, int k, int n,
                                        int kend) {
  if (n >= p.N || k >= kend) return 0.0f;
  const size_t idx = p.b_trans ? static_cast<size_t>(n) * p.ldb + k
                               : static_cast<size_t>(k) * p.ldb + n;
  return to_float<T>(p.b[idx]);
}

// Element i (of 4) of a thread's share of a k-slice: (row or column within
// the tile, k within the slice), chosen so that neighbouring threads read
// neighbouring addresses of the stored layout.
__device__ __forceinline__ void slice_pos(int trans_fast_mn, int i, int& mn,
                                          int& k) {
  const int idx = threadIdx.x + kGemmThreads * i;
  if (trans_fast_mn) {  // consecutive along the tile's rows or columns
    k = idx / kBM;
    mn = idx % kBM;
  } else {  // consecutive along k
    mn = idx / kBK;
    k = idx % kBK;
  }
}

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_kernel(const GemmArgs<T> p) {
  // +4: the stores of a slice hit 32 banks, rows stay float4-aligned
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN + 4];
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * p.k_chunk;
  const int kend = min(p.K, kbeg + p.k_chunk);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float ra[4], rb[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int mn, k;
      slice_pos(p.a_trans, i, mn, k);
      ra[i] = load_a(p, m0 + mn, k0 + k, kend);
      slice_pos(!p.b_trans, i, mn, k);
      rb[i] = load_b(p, k0 + k, n0 + mn, kend);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int mn, k;
      slice_pos(p.a_trans, i, mn, k);
      As[k][mn] = ra[i];
      slice_pos(!p.b_trans, i, mn, k);
      Bs[k][mn] = rb[i];
    }
  };

  if (kbeg < kend) {
    fetch(kbeg);
    stage();
    __syncthreads();
  }
  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    const bool more = k0 + kBK < kend;
    if (more) fetch(k0 + kBK);  // in flight while this slice multiplies
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      stage();
      __syncthreads();
    }
  }

  // epilogue
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (n >= p.N) continue;
      const size_t o = static_cast<size_t>(m) * p.ldc + n;
      float v = acc[i][j];
      if (p.epi == kEpiF32) {
        static_cast<float*>(p.out)[static_cast<size_t>(blockIdx.z) * p.M *
                                       p.ldc + o] = v;
        continue;
      }
      switch (p.epi) {
        case kEpiBias:
          v = v + to_float<T>(p.bias[n]);
          break;
        case kEpiBiasGelu:
          v = gelu_tanh(v + to_float<T>(p.bias[n]));
          break;
        case kEpiBiasResid:
          v = to_float<T>(p.resid[o]) +
              round_to<T>(v + to_float<T>(p.bias[n]));
          break;
        case kEpiDgelu:
          v = v * gelu_tanh_grad(p.aux[static_cast<size_t>(m) * p.ld_aux + n]);
          break;
        default:
          break;
      }
      static_cast<T*>(p.out)[o] = from_float<T>(v);
    }
  }
}

// ---------------------------------------------------------------------------
// Attention core, forward: online softmax over 64-key tiles.
// ---------------------------------------------------------------------------

constexpr int kTile = 64;           // query rows / keys of a tile
constexpr int kAttnThreads = 256;   // 16 x 16: a thread owns 4 rows x 4 keys
constexpr int kRowPad = kTile + 4;  // float4-aligned stride of row-fast arrays
constexpr int kColPad = kTile + 1;  // conflict-free stride of key-fast arrays

template <int HD>
constexpr int attn_fwd_smem_floats() {
  return HD * kRowPad + HD * kColPad + kTile * HD + kTile * kRowPad;
}

// Loads rows [r0, r0 + 64) of one head's (L, HD) slice of a (B*L, ld)
// tensor into s as s[k][r] (stride `stride`), zero past row L.
template <typename T, int HD>
__device__ __forceinline__ void load_t(const T* __restrict__ src, size_t base,
                                       int ld, int r0, int L, float* s,
                                       int stride) {
  for (int idx = threadIdx.x; idx < kTile * HD; idx += blockDim.x) {
    const int r = idx / HD, k = idx % HD;
    s[k * stride + r] =
        r0 + r < L ? to_float<T>(src[base + static_cast<size_t>(r0 + r) * ld + k])
                   : 0.0f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kAttnThreads)
    attn_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ o,
                    float* __restrict__ lse, const float* __restrict__ dout,
                    float* __restrict__ dsum, int L, int H, float scale) {
  constexpr int NJ = HD / 16;  // output columns a thread owns
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // [HD][kRowPad]
  float* Ks = Qs + HD * kRowPad;     // [HD][kColPad]
  float* Vs = Ks + HD * kColPad;     // [kTile][HD]
  float* Ps = Vs + kTile * HD;       // [kTile keys][kRowPad]
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int d = H * HD, ld = 3 * d;
  const size_t base = static_cast<size_t>(b) * L * ld + h * HD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_t<T, HD>(qkv, base, ld, q0, L, Qs, kRowPad);
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();
    load_t<T, HD>(qkv, base + d, ld, k0, L, Ks, kColPad);
    for (int idx = threadIdx.x; idx < kTile * HD; idx += blockDim.x) {
      const int c = idx / HD, n = idx % HD;
      Vs[idx] = k0 + c < L ? to_float<T>(qkv[base + 2 * d +
                                             static_cast<size_t>(k0 + c) * ld +
                                             n])
                           : 0.0f;
    }
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int k = 0; k < HD; ++k) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qs[k * kRowPad + ty * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      float kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[k * kColPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = k0 + tx + 16 * j < L ? s[i][j] * scale : -INFINITY;
        rmax = fmaxf(rmax, s[i][j]);
      }
      const float mnew = fmaxf(m[i], half_max(rmax));
      const float corr = expf(m[i] - mnew);
      m[i] = mnew;
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = expf(s[i][j] - mnew);
        psum += pv;
        Ps[(tx + 16 * j) * kRowPad + ty * 4 + i] = round_to<T>(pv);
      }
      l[i] = l[i] * corr + psum;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&Ps[c * kRowPad + ty * 4]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = Vs[c * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const float lsum = half_sum(l[i]);
    const float inv = 1.0f / lsum;
    float dot = 0.0f;
    const size_t orow = (static_cast<size_t>(b) * L + row) * d + h * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float ov = acc[i][j] * inv;
      if (row < L) {
        o[orow + tx + 16 * j] = from_float<T>(ov);
        if (dout != nullptr) dot += ov * dout[orow + tx + 16 * j];
      }
    }
    if (dout != nullptr) dot = half_sum(dot);
    if (row < L && tx == 0) {
      const size_t r = (static_cast<size_t>(b) * H + h) * L + row;
      if (lse != nullptr) lse[r] = m[i] + logf(lsum);
      if (dsum != nullptr) dsum[r] = dot;
    }
  }
}

// ---------------------------------------------------------------------------
// Attention core, backward (fp32): dK and dV over query tiles, dQ over keys.
// p = exp(s * scale - lse); ds = p * (dp - D) * scale with dp = do . v.
// ---------------------------------------------------------------------------

template <int HD>
constexpr int attn_dkv_smem_floats() {
  return 2 * HD * kRowPad + 2 * HD * kColPad + 2 * kTile * kRowPad + 2 * kTile;
}

template <int HD>
__global__ void __launch_bounds__(kAttnThreads)
    attn_dkv_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dsum,
                    float* __restrict__ dqkv, int L, int H, float scale) {
  constexpr int NJ = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                   // [HD][kRowPad], key-row fast
  float* Vt = Kt + HD * kRowPad;      // [HD][kRowPad]
  float* Qs = Vt + HD * kRowPad;      // [HD][kColPad], query fast
  float* dOs = Qs + HD * kColPad;     // [HD][kColPad]
  float* Ps = dOs + HD * kColPad;     // [kTile queries][kRowPad keys]
  float* dSs = Ps + kTile * kRowPad;  // [kTile queries][kRowPad keys]
  float* lse_s = dSs + kTile * kRowPad;
  float* d_s = lse_s + kTile;
  const int c0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int d = H * HD, ld = 3 * d;
  const size_t base = static_cast<size_t>(b) * L * ld + h * HD;
  const size_t obase = static_cast<size_t>(b) * L * d + h * HD;
  const size_t rbase = (static_cast<size_t>(b) * H + h) * L;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_t<float, HD>(qkv, base + d, ld, c0, L, Kt, kRowPad);
  load_t<float, HD>(qkv, base + 2 * d, ld, c0, L, Vt, kRowPad);
  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.0f;

  for (int q0 = 0; q0 < L; q0 += kTile) {
    __syncthreads();
    load_t<float, HD>(qkv, base, ld, q0, L, Qs, kColPad);
    load_t<float, HD>(dout, obase, d, q0, L, dOs, kColPad);
    if (threadIdx.x < kTile) {
      const int q = q0 + threadIdx.x;
      lse_s[threadIdx.x] = q < L ? lse[rbase + q] : 0.0f;
      d_s[threadIdx.x] = q < L ? dsum[rbase + q] : 0.0f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < HD; ++k) {
      const float4 ka = *reinterpret_cast<const float4*>(&Kt[k * kRowPad + ty * 4]);
      const float4 va = *reinterpret_cast<const float4*>(&Vt[k * kRowPad + ty * 4]);
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
      const float vv[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float qv = Qs[k * kColPad + tx + 16 * j];
        const float gv = dOs[k * kColPad + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(kv[i], qv, s[i][j]);
          dp[i][j] = fmaf(vv[i], gv, dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qi = tx + 16 * j;
      const bool valid = q0 + qi < L;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = valid ? expf(s[i][j] * scale - lse_s[qi]) : 0.0f;
        Ps[qi * kRowPad + ty * 4 + i] = p;
        dSs[qi * kRowPad + ty * 4 + i] = p * (dp[i][j] - d_s[qi]) * scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int q = 0; q < kTile; ++q) {
      const float4 pa = *reinterpret_cast<const float4*>(&Ps[q * kRowPad + ty * 4]);
      const float4 sa = *reinterpret_cast<const float4*>(&dSs[q * kRowPad + ty * 4]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      const float sv[4] = {sa.x, sa.y, sa.z, sa.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = tx + 16 * j;
        const float gv = dOs[n * kColPad + q];
        const float qv = Qs[n * kColPad + q];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][j] = fmaf(pv[i], gv, dv[i][j]);
          dk[i][j] = fmaf(sv[i], qv, dk[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = c0 + ty * 4 + i;
    if (key >= L) continue;
    const size_t r = (static_cast<size_t>(b) * L + key) * ld + h * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dqkv[r + d + tx + 16 * j] = dk[i][j];
      dqkv[r + 2 * d + tx + 16 * j] = dv[i][j];
    }
  }
}

template <int HD>
constexpr int attn_dq_smem_floats() {
  return 2 * HD * kRowPad + 2 * HD * kColPad + kTile * kRowPad;
}

template <int HD>
__global__ void __launch_bounds__(kAttnThreads)
    attn_dq_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ dsum,
                   float* __restrict__ dqkv, int L, int H, float scale) {
  constexpr int NJ = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                  // [HD][kRowPad], query-row fast
  float* dOt = Qt + HD * kRowPad;    // [HD][kRowPad]
  float* Ks = dOt + HD * kRowPad;    // [HD][kColPad], key fast
  float* Vs = Ks + HD * kColPad;     // [HD][kColPad]
  float* dSs = Vs + HD * kColPad;    // [kTile keys][kRowPad queries]
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int d = H * HD, ld = 3 * d;
  const size_t base = static_cast<size_t>(b) * L * ld + h * HD;
  const size_t obase = static_cast<size_t>(b) * L * d + h * HD;
  const size_t rbase = (static_cast<size_t>(b) * H + h) * L;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_t<float, HD>(qkv, base, ld, q0, L, Qt, kRowPad);
  load_t<float, HD>(dout, obase, d, q0, L, dOt, kRowPad);
  float row_lse[4], row_d[4], dq[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty * 4 + i;
    row_lse[i] = q < L ? lse[rbase + q] : 0.0f;
    row_d[i] = q < L ? dsum[rbase + q] : 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();
    load_t<float, HD>(qkv, base + d, ld, k0, L, Ks, kColPad);
    load_t<float, HD>(qkv, base + 2 * d, ld, k0, L, Vs, kColPad);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < HD; ++k) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[k * kRowPad + ty * 4]);
      const float4 ga = *reinterpret_cast<const float4*>(&dOt[k * kRowPad + ty * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float gv[4] = {ga.x, ga.y, ga.z, ga.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kv = Ks[k * kColPad + tx + 16 * j];
        const float vv = Vs[k * kColPad + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(qv[i], kv, s[i][j]);
          dp[i][j] = fmaf(gv[i], vv, dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool valid = k0 + c < L;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = valid ? expf(s[i][j] * scale - row_lse[i]) : 0.0f;
        dSs[c * kRowPad + ty * 4 + i] = p * (dp[i][j] - row_d[i]) * scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      const float4 sa = *reinterpret_cast<const float4*>(&dSs[c * kRowPad + ty * 4]);
      const float sv[4] = {sa.x, sa.y, sa.z, sa.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = Ks[(tx + 16 * j) * kColPad + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][j] = fmaf(sv[i], kv, dq[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty * 4 + i;
    if (q >= L) continue;
    const size_t r = (static_cast<size_t>(b) * L + q) * ld + h * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dqkv[r + tx + 16 * j] = dq[i][j];
  }
}

// ---------------------------------------------------------------------------
// Column sums and the LayerNorm backward, as per-block partials.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void colsum_kernel(const T* __restrict__ x, int rows, int cols,
                              int rows_per, float* __restrict__ part) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const int r0 = blockIdx.y * rows_per;
  const int r1 = min(rows, r0 + rows_per);
  float s = 0.0f;
  for (int r = r0; r < r1; ++r) s += to_float<T>(x[static_cast<size_t>(r) * cols + c]);
  part[static_cast<size_t>(blockIdx.y) * cols + c] = s;
}

constexpr int kLnMaxCols = 1024;
constexpr int kLnWarps = 8;

// dx = dy + LN'(dh); dg, db partials over the block's rows_per rows. One
// warp a row; the warps' column sums meet in shared memory in warp order.
__global__ void __launch_bounds__(kLnWarps * 32)
    ln_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                  const float* __restrict__ dh, const float* __restrict__ mu,
                  const float* __restrict__ rstd, const float* __restrict__ g,
                  float* __restrict__ dx, float* __restrict__ dg_part,
                  float* __restrict__ db_part, int rows, int d, int rows_per) {
  constexpr int NJ = kLnMaxCols / 32;
  __shared__ float sg[kLnMaxCols], sb[kLnMaxCols];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * rows_per;
  const int r1 = min(rows, r0 + rows_per);
  float dg[NJ], db[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) dg[j] = db[j] = 0.0f;
  for (int r = r0 + warp; r < r1; r += kLnWarps) {
    const size_t o = static_cast<size_t>(r) * d;
    const float m = mu[r], inv = rstd[r];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      if (c < d) {
        const float xh = (x[o + c] - m) * inv;
        const float h = dh[o + c];
        const float dxh = h * g[c];
        s1 += dxh;
        s2 += dxh * xh;
        dg[j] += h * xh;
        db[j] += h;
      }
    }
    s1 = warp_sum(s1) / d;
    s2 = warp_sum(s2) / d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      if (c < d) {
        const float xh = (x[o + c] - m) * inv;
        dx[o + c] = dy[o + c] + (dh[o + c] * g[c] - s1 - xh * s2) * inv;
      }
    }
  }
  for (int w = 0; w < kLnWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        if (c < d) {
          sg[c] = w == 0 ? dg[j] : sg[c] + dg[j];
          sb[c] = w == 0 ? db[j] : sb[c] + db[j];
        }
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    dg_part[static_cast<size_t>(blockIdx.x) * d + c] = sg[c];
    db_part[static_cast<size_t>(blockIdx.x) * d + c] = sb[c];
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t launch_gemm(const GemmArgs<T>& p, cudaStream_t stream) {
  const int splits = (p.K + p.k_chunk - 1) / p.k_chunk;
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBM - 1) / kBM,
                  splits > 0 ? splits : 1);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  gemm_kernel<T><<<grid, kGemmThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_attn_fwd(const void* qkv, void* o, float* lse,
                            const float* dout, float* dsum, int B, int L,
                            int H, float scale, cudaStream_t stream) {
  const size_t smem = attn_fwd_smem_floats<HD>() * sizeof(float);
  const cudaError_t err = allow_smem(attn_fwd_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kTile - 1) / kTile, H, B);
  attn_fwd_kernel<T, HD><<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(o), lse, dout, dsum, L, H,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t attn_fwd_dispatch(const void* qkv, void* o, float* lse,
                              const float* dout, float* dsum, int B, int L,
                              int H, int hd, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_attn_fwd<T, 16>(qkv, o, lse, dout, dsum, B, L, H, scale, s);
    case 32: return launch_attn_fwd<T, 32>(qkv, o, lse, dout, dsum, B, L, H, scale, s);
    case 64: return launch_attn_fwd<T, 64>(qkv, o, lse, dout, dsum, B, L, H, scale, s);
    case 128: return launch_attn_fwd<T, 128>(qkv, o, lse, dout, dsum, B, L, H, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int HD>
cudaError_t launch_attn_bwd(const float* qkv, const float* dout,
                            const float* lse, const float* dsum, float* dqkv,
                            int B, int L, int H, float scale,
                            cudaStream_t stream) {
  const dim3 grid((L + kTile - 1) / kTile, H, B);
  const size_t smem_kv = attn_dkv_smem_floats<HD>() * sizeof(float);
  cudaError_t err = allow_smem(attn_dkv_kernel<HD>, smem_kv);
  if (err != cudaSuccess) return err;
  attn_dkv_kernel<HD><<<grid, kAttnThreads, smem_kv, stream>>>(
      qkv, dout, lse, dsum, dqkv, L, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_q = attn_dq_smem_floats<HD>() * sizeof(float);
  err = allow_smem(attn_dq_kernel<HD>, smem_q);
  if (err != cudaSuccess) return err;
  attn_dq_kernel<HD><<<grid, kAttnThreads, smem_q, stream>>>(
      qkv, dout, lse, dsum, dqkv, L, H, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launches (0 on success).

int mia_vit_ln_stats(const void* x, int is_bf16, float* mu, float* rstd,
                     int rows, int d, float eps, void* stream) {
  if (rows < 1 || d < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + 7) / 8;
  if (is_bf16)
    ln_stats_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), mu, rstd, rows, d, eps);
  else
    ln_stats_kernel<float><<<blocks, 256, 0, s>>>(static_cast<const float*>(x),
                                                  mu, rstd, rows, d, eps);
  return cudaGetLastError();
}

int mia_vit_gemm(int is_bf16, const void* a, int a_trans, int lda,
                 const void* b, int b_trans, int ldb, int M, int N, int K,
                 int k_chunk, int pro, const float* mu, const float* rstd,
                 const void* gamma, const void* beta, int epi,
                 const void* bias, const void* resid, const float* aux,
                 int ld_aux, void* out, int ldc, void* stream) {
  if (M < 1 || N < 1 || K < 1 || k_chunk < 1 || k_chunk % kBK != 0)
    return cudaErrorInvalidValue;
  if (pro == kProLn && (mu == nullptr || rstd == nullptr || gamma == nullptr ||
                        beta == nullptr))
    return cudaErrorInvalidValue;
  if ((epi == kEpiBias || epi == kEpiBiasGelu || epi == kEpiBiasResid) &&
      bias == nullptr)
    return cudaErrorInvalidValue;
  if ((epi == kEpiBiasResid && resid == nullptr) ||
      (epi == kEpiDgelu && aux == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    const GemmArgs<T> p{static_cast<const T*>(a), a_trans, lda,
                        static_cast<const T*>(b), b_trans, ldb, M, N, K,
                        k_chunk, pro, mu, rstd, static_cast<const T*>(gamma),
                        static_cast<const T*>(beta), epi,
                        static_cast<const T*>(bias),
                        static_cast<const T*>(resid), aux, ld_aux, out, ldc};
    return launch_gemm<T>(p, s);
  }
  using T = float;
  const GemmArgs<T> p{static_cast<const T*>(a), a_trans, lda,
                      static_cast<const T*>(b), b_trans, ldb, M, N, K,
                      k_chunk, pro, mu, rstd, static_cast<const T*>(gamma),
                      static_cast<const T*>(beta), epi,
                      static_cast<const T*>(bias),
                      static_cast<const T*>(resid), aux, ld_aux, out, ldc};
  return launch_gemm<T>(p, s);
}

int mia_vit_attn_fwd(int is_bf16, const void* qkv, void* o, float* lse,
                     const float* dout, float* dsum, int B, int L, int H,
                     int hd, float scale, void* stream) {
  if (B < 1 || L < 1 || H < 1 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  if (is_bf16 && dout != nullptr) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? attn_fwd_dispatch<__nv_bfloat16>(qkv, o, lse, dout, dsum,
                                                    B, L, H, hd, scale, s)
                 : attn_fwd_dispatch<float>(qkv, o, lse, dout, dsum, B, L, H,
                                            hd, scale, s);
}

int mia_vit_attn_bwd(const float* qkv, const float* dout, const float* lse,
                     const float* dsum, float* dqkv, int B, int L, int H,
                     int hd, float scale, void* stream) {
  if (B < 1 || L < 1 || H < 1 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_attn_bwd<16>(qkv, dout, lse, dsum, dqkv, B, L, H, scale, s);
    case 32: return launch_attn_bwd<32>(qkv, dout, lse, dsum, dqkv, B, L, H, scale, s);
    case 64: return launch_attn_bwd<64>(qkv, dout, lse, dsum, dqkv, B, L, H, scale, s);
    case 128: return launch_attn_bwd<128>(qkv, dout, lse, dsum, dqkv, B, L, H, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

int mia_vit_colsum(const void* x, int is_bf16, int rows, int cols,
                   int rows_per, float* part, void* stream) {
  if (rows < 1 || cols < 1 || rows_per < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((cols + 255) / 256, (rows + rows_per - 1) / rows_per);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (is_bf16)
    colsum_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), rows, cols, rows_per, part);
  else
    colsum_kernel<float><<<grid, 256, 0, s>>>(static_cast<const float*>(x),
                                              rows, cols, rows_per, part);
  return cudaGetLastError();
}

int mia_vit_ln_bwd(const float* x, const float* dy, const float* dh,
                   const float* mu, const float* rstd, const float* g,
                   float* dx, float* dg_part, float* db_part, int rows, int d,
                   int rows_per, void* stream) {
  if (rows < 1 || d < 1 || d > kLnMaxCols || rows_per < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + rows_per - 1) / rows_per;
  ln_bwd_kernel<<<blocks, kLnWarps * 32, 0, s>>>(x, dy, dh, mu, rstd, g, dx,
                                                 dg_part, db_part, rows, d,
                                                 rows_per);
  return cudaGetLastError();
}

}  // extern "C"
