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
//   ln_apply_kernel  h = LN(x) from those statistics, rounded to x's dtype
//                    as the TPU kernel's _ln(...).astype(x.dtype) (:89):
//                    one pass whose output every product that reads LN(x)
//                    shares, in all four sub-layers and swin_block.cu's.
//   gemm_tc_kernel   C = A @ B on the tensor cores (mma.sync): fp32
//                    operands in 3xTF32, bf16 operands as they are, either
//                    operand stored either way round. Epilogues: fp32 (or
//                    an fp32 split-K partial), bias, bias + tanh-GELU, bias
//                    + residual, times GELU'(aux), store, and bias writing
//                    both the fp32 pre-activation and its GELU; rounded to
//                    the working dtype where the TPU kernel rounds. Every
//                    product of the four sub-layers, and of swin_block.cu's.
//   attn_tc.cuh's core  each head's output from the packed (B*L, 3d) qkv,
//                    read in place, on the tensor cores: vit_attn_fwd (fp32
//                    or bf16), and with the per-row logsumexp and D = do . o
//                    the backward's recompute (fp32).
//   attn_dkv_tc_kernel, attn_dq_tc_kernel  the flash-style backward on the
//                    tensor cores: one pass over the query tiles for dK and
//                    dV, one over the key tiles for dQ, recomputing p from
//                    q, k and the logsumexp. No atomics.
//   colsum_kernel, ln_bwd_kernel  bias and LayerNorm gradients as per-block
//                    partials in a fixed order, summed by the wrapper.
//
// What bounds them on the H100, and what the design does about it. The
// products bound every sub-layer: at the tensor-core rate of their operand
// type (fp32 at fp32 accuracy in 3xTF32, 495 / 3 = 165 TFLOP/s; bf16 989),
// vit_attn_fwd needs 202 GFLOP at the mae_hd_1280 encoder (B = 16, L =
// 1,401, d = 768), 1.2 ms, and 1.56 TFLOP at its decoder (L = 6,401, d =
// 512, 16 heads of 32), 9.4 ms, most of it the L x L products of the core;
// vit_mlp_fwd 212 GFLOP (1.3 ms) and 430 GFLOP (2.6 ms); vit_mlp_bwd 529
// GFLOP (3.2 ms) and 1.07 TFLOP (6.5 ms); vit_attn_bwd 580 GFLOP (3.5 ms)
// and 4.62 TFLOP (28.0 ms). Their bytes are far below.
//
// mma.sync, not wgmma, for the reasons attn_tc.cuh gives: the 3xTF32 split
// happens in registers at each fragment load, a transposed operand costs
// nothing, and the attention's scores and dp feed the next products
// straight from the accumulators. The tensor cores truncate inside their
// sums, so every long reduction takes a tile's MMAs from zero and adds them
// to its accumulators in fp32 (mma_tc.cuh); one sum kept in the
// accumulators over the 102,416 rows of a weight gradient at the decoder
// misses the 1e-4 checks. Weight gradients, products whose reduction runs
// over all B*L rows, have few output tiles: the wrapper splits that
// reduction into fixed chunks whose fp32 partials it sums in order, so the
// card is filled and two runs give the same bits.
//
// The attention backward recomputes q, k, v, the head outputs and p from x,
// as the TPU kernel does (:307-317), and saves nothing in the forward. Its
// two passes (dK/dV over the query tiles, dQ over the key tiles) buy
// freedom from atomics with redundant work: the scores are computed three
// times (the forward recompute and once in each pass) and dp twice, 9
// products of L x L x d where the function needs 6 (s, o, dV, dp, dQ, dK),
// so 1.5x the minimal L^2 work; the bound counts the 6. The MLP forward
// writes LN(x) and the rounded GELU of the hidden layer (kEpiBiasGelu) and
// nothing in fp32, where the TPU kernel rounds them. The MLP backward
// recomputes the fp32 pre-activation once; its product's epilogue also
// writes the GELU of it for dW2, and the dhpre product reads it back for
// GELU'.
//
// All launch on the caller's stream, allocate nothing, and return
// cudaGetLastError() (or the error of raising the shared-memory limit) so
// that the Python wrapper raises on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "attn_tc.cuh"

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
// GEMM epilogues (the values ops/vit_block.py passes).
// ---------------------------------------------------------------------------

enum Epi {
  kEpiF32 = 0,          // out (fp32) = acc; split z writes its own partial
  kEpiBias = 1,         // out = round(acc + bias)
  kEpiBiasGelu = 2,     // out = round(gelu(acc + bias))
  kEpiBiasResid = 3,    // out = round(resid + round(acc + bias))
  kEpiDgelu = 4,        // out = round(acc * gelu'(aux))
  kEpiStore = 5,        // out = round(acc)
  kEpiBiasF32Gelu = 6,  // out (fp32) = acc + bias, out2 = round(gelu(out))
};

// ---------------------------------------------------------------------------
// The tensor-core building blocks (mma_tc.cuh, attn_tc.cuh).
// ---------------------------------------------------------------------------

// gemm_tc_kernel: C = A @ B on mma.sync, fp32 operands in 3xTF32 (m16n8k8),
// bf16 operands as they are (m16n8k16). A block of 8 warps owns a 128 x 128
// output tile, a warp 64 x 32 (4 x 4 m16n8 tiles, 64 fp32 accumulators a
// thread). Slices of 32 along k go from device memory to shared memory by
// cp.async, three slices in flight, each operand as it lies in device
// memory: K-contiguous rows padded by 16 bytes (36 floats, 40 bf16), or
// MN-contiguous rows padded to 136 elements; either keeps the fragment
// loads free of bank conflicts, so a transposed operand costs nothing. fp32
// fragments are read element by element and split into hi and lo as they
// are loaded; bf16 fragments are read as pairs along k, or by
// ldmatrix.trans where the operand's rows run along m or n. The products
// of each step (16 deep in fp32, the whole 32-deep slice in bf16: two MMAs
// along k either way) are summed from zero, two m16 tiles at a time, and
// added to the accumulators in fp32 (mma_tc.cuh). There is no prologue: the
// LayerNorm the TPU kernel applies while staging is one elementwise pass
// (ln_apply_kernel) whose output every product that reads LN(x) shares.
// The GELU that dW2 = gelu(hpre)^T dy reads is written once, as a second
// output of the hpre product's epilogue (kEpiBiasF32Gelu), and not applied
// to A at the fragment load, where each of the four warps that share an A
// slice would evaluate it again for every column tile: at the mae_hd_1280
// decoder that second fp32 output is 0.84 GB, alive only until dW2 is
// taken. The forward's hidden layer takes kEpiBiasGelu instead: the GELU
// of the fp32 sum, rounded once, and no fp32 pre-activation. Every contiguous extent and leading dimension is a multiple of 16
// bytes (4 floats, 8 bf16), as the 16-byte copies need.
constexpr int kTcBM = 128;
constexpr int kTcBN = 128;
constexpr int kTcBK = 32;
constexpr int kTcStages = 3;
constexpr int kTcThreads = 256;
constexpr int kTcMnPad = kTcBM + 8;  // MN-contiguous tile rows
static_assert(kTcBM == kTcBN, "one tile shape for A and B");

template <typename T>
__host__ __device__ constexpr int tc_kpad() {  // K-contiguous tile rows
  return kTcBK + 16 / static_cast<int>(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int tc_tile() {
  return kTcBM * tc_kpad<T>() > kTcBK * kTcMnPad ? kTcBM * tc_kpad<T>()
                                                 : kTcBK * kTcMnPad;
}
template <typename T>
constexpr size_t tc_smem() {
  return kTcStages * 2 * tc_tile<T>() * sizeof(T);
}

template <typename T>
struct TcGemmArgs {
  const T* a;
  int lda;  // A (M, K); stored (K, M) when the kernel's AT
  const T* b;
  int ldb;  // B (K, N); stored (N, K) when the kernel's BT
  int M, N, K, k_chunk;
  int epi;
  const T* bias;
  const T* resid;    // (M, ldc)
  const float* aux;  // (M, ld_aux)
  int ld_aux;
  void* out;  // float for kEpiF32 and kEpiBiasF32Gelu, T otherwise
  T* out2;    // kEpiBiasF32Gelu's GELU, (M, ldc)
  int ldc;
};

// One operand's 128 x 32 slice into shared memory: `kfast` when its rows
// in device memory run along k (rows r0.., k from k0), else its rows run
// along m or n (rows k0.., columns r0..). Zeros past `rows` and `kend`.
template <typename T, bool kfast>
__device__ __forceinline__ void load_tc_slice(T* dst, const T* src, int ld,
                                              int r0, int rows, int k0,
                                              int kend) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));  // elements a copy
#pragma unroll
  for (int i = 0; i < kTcBM * kTcBK / E / kTcThreads; ++i) {
    const int idx = threadIdx.x + kTcThreads * i;
    int r, c;  // tile row, column of the stored layout
    bool valid;
    size_t off;
    if (kfast) {
      r = idx / (kTcBK / E);
      c = (idx % (kTcBK / E)) * E;
      valid = r0 + r < rows && k0 + c < kend;
      off = static_cast<size_t>(r0 + r) * ld + k0 + c;
      tc::cp_async16(dst + r * tc_kpad<T>() + c, valid ? src + off : src,
                     valid);
    } else {
      r = idx / (kTcBM / E);
      c = (idx % (kTcBM / E)) * E;
      valid = k0 + r < kend && r0 + c < rows;
      off = static_cast<size_t>(k0 + r) * ld + r0 + c;
      tc::cp_async16(dst + r * kTcMnPad + c, valid ? src + off : src, valid);
    }
  }
}

// element (row of the output side, k) of a stored fp32 slice
template <bool kfast>
__device__ __forceinline__ float tc_at(const float* s, int r, int k) {
  return kfast ? s[r * tc_kpad<float>() + k] : s[k * kTcMnPad + r];
}

__device__ __forceinline__ void add_tiles(float (&acc)[4][4][4], int i0,
                                          const float (&tile)[8][4]) {
#pragma unroll
  for (int ii = 0; ii < 2; ++ii)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i0 + ii][j][e] += tile[4 * ii + j][e];
}

// One 16-deep step of an fp32 slice, from k = h, in 3xTF32. AK: A's rows
// in shared memory run along k; BK likewise for B.
template <bool AK, bool BK>
__device__ __forceinline__ void tc_step(float (&acc)[4][4][4],
                                        const float* As, const float* Bs,
                                        int h, int wm, int wn, int lane) {
  const int g = lane >> 2, t = lane & 3;
  tc::Split<2> b[2][4];  // 2 k8 steps x 4 n8 tiles
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = wn + 8 * j + g, k = h + 8 * kk + t;
      b[kk][j].set(0, tc_at<BK>(Bs, c, k));
      b[kk][j].set(1, tc_at<BK>(Bs, c, k + 4));
    }
#pragma unroll
  for (int i0 = 0; i0 < 4; i0 += 2) {
    float tile[8][4];
    tc::zero(tile);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int r = wm + 16 * (i0 + ii) + g, k = h + 8 * kk + t;
        tc::Split<4> a;
        a.set(0, tc_at<AK>(As, r, k));
        a.set(1, tc_at<AK>(As, r + 8, k));
        a.set(2, tc_at<AK>(As, r, k + 4));
        a.set(3, tc_at<AK>(As, r + 8, k + 4));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          tc::mma_3xtf32(tile[4 * ii + j], a, b[kk][j]);
      }
    add_tiles(acc, i0, tile);
  }
}

// A whole 32-deep bf16 slice: two k16 steps.
template <bool AK, bool BK>
__device__ __forceinline__ void tc_step(float (&acc)[4][4][4],
                                        const __nv_bfloat16* As,
                                        const __nv_bfloat16* Bs, int /*h*/,
                                        int wm, int wn, int lane) {
  constexpr int KP = tc_kpad<__nv_bfloat16>();
  const int g = lane >> 2, t = lane & 3;
  auto u32 = [](const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  };
  uint32_t b[2][4][2];  // 2 k16 steps x 4 n8 tiles
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int k0 = 16 * kk;
    if constexpr (BK) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* p = Bs + (wn + 8 * j + g) * KP + k0 + 2 * t;
        b[kk][j][0] = u32(p);
        b[kk][j][1] = u32(p + 8);
      }
    } else {  // rows along n: two n8 tiles a ldmatrix.trans
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t r[4];
        tc::ldsm_x4_trans(
            r, Bs + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kTcMnPad +
                   wn + 16 * jj + 8 * (lane >> 4));
        b[kk][2 * jj][0] = r[0];
        b[kk][2 * jj][1] = r[1];
        b[kk][2 * jj + 1][0] = r[2];
        b[kk][2 * jj + 1][1] = r[3];
      }
    }
  }
#pragma unroll
  for (int i0 = 0; i0 < 4; i0 += 2) {
    float tile[8][4];
    tc::zero(tile);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int r0 = wm + 16 * (i0 + ii), k0 = 16 * kk;
        uint32_t a[4];
        if constexpr (AK) {
          const __nv_bfloat16* p = As + (r0 + g) * KP + k0 + 2 * t;
          a[0] = u32(p);
          a[1] = u32(p + 8 * KP);
          a[2] = u32(p + 8);
          a[3] = u32(p + 8 * KP + 8);
        } else {  // rows along m: the four 8 x 8 pieces by ldmatrix.trans
          tc::ldsm_x4_trans(
              a, As + (k0 + (lane & 7) + 8 * (lane >> 4)) * kTcMnPad + r0 +
                     8 * ((lane >> 3) & 1));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) tc::mma_bf16(tile[4 * ii + j], a, b[kk][j]);
      }
    add_tiles(acc, i0, tile);
  }
}

// AT: A stored (K, M); BT: B stored (N, K). grid (ceil(N / 128),
// ceil(M / 128), splits), 256 threads, tc_smem<T>() of dynamic shared
// memory.
template <typename T, bool AT, bool BT>
__global__ void __launch_bounds__(kTcThreads)
    gemm_tc_kernel(const TcGemmArgs<T> p) {
  constexpr int kTile = tc_tile<T>();
  constexpr int kStep = sizeof(T) == 4 ? 16 : kTcBK;  // k a tc_step takes
  extern __shared__ __align__(16) unsigned char tc_raw[];
  T* sm = reinterpret_cast<T*>(tc_raw);  // [stage][A, B][kTile]
  const int m0 = blockIdx.y * kTcBM;
  const int n0 = blockIdx.x * kTcBN;
  const int kbeg = blockIdx.z * p.k_chunk;
  const int kend = min(p.K, kbeg + p.k_chunk);
  const int slices = kbeg < kend ? (kend - kbeg + kTcBK - 1) / kTcBK : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  auto load = [&](int slice) {
    T* st = sm + (slice % kTcStages) * 2 * kTile;
    const int k0 = kbeg + slice * kTcBK;
    load_tc_slice<T, !AT>(st, p.a, p.lda, m0, p.M, k0, kend);
    load_tc_slice<T, BT>(st + kTile, p.b, p.ldb, n0, p.N, k0, kend);
  };
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < slices) load(s);
    tc::cp_async_commit();
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) tc::zero(acc[i]);

  for (int it = 0; it < slices; ++it) {
    tc::cp_async_wait<kTcStages - 2>();
    __syncthreads();  // slice it landed; slice it - 1's stage is free
    if (it + kTcStages - 1 < slices) load(it + kTcStages - 1);
    tc::cp_async_commit();
    const T* As = sm + (it % kTcStages) * 2 * kTile;
    const T* Bs = As + kTile;
#pragma unroll
    for (int h = 0; h < kTcBK; h += kStep)
      tc_step<!AT, BT>(acc, As, Bs, h, wm, wn, lane);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int m = m0 + wm + 16 * i + g + 8 * e2;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + 8 * j + 2 * t;
        if (n >= p.N) continue;  // N is a multiple of 4: n + 1 < N too
        float v0 = acc[i][j][2 * e2], v1 = acc[i][j][2 * e2 + 1];
        const size_t o = static_cast<size_t>(m) * p.ldc + n;
        float* out32 = static_cast<float*>(p.out);
        if (p.epi == kEpiF32) {
          *reinterpret_cast<float2*>(
              out32 + static_cast<size_t>(blockIdx.z) * p.M * p.ldc + o) =
              make_float2(v0, v1);
          continue;
        }
        if (p.epi == kEpiBias || p.epi == kEpiBiasGelu ||
            p.epi == kEpiBiasResid || p.epi == kEpiBiasF32Gelu) {
          v0 += to_float<T>(p.bias[n]);
          v1 += to_float<T>(p.bias[n + 1]);
        }
        T* dst = static_cast<T*>(p.out) + o;
        if (p.epi == kEpiBiasF32Gelu) {
          *reinterpret_cast<float2*>(out32 + o) = make_float2(v0, v1);
          dst = p.out2 + o;
        }
        // one GELU for both epilogues that take it: a second inlined copy
        // of tanhf in this unrolled loop slowed the fp32 main loops by 10
        // to 18% on the H100 at the same register count (PERF.md, PR 11)
        if (p.epi == kEpiBiasGelu || p.epi == kEpiBiasF32Gelu) {
          v0 = gelu_tanh(v0);
          v1 = gelu_tanh(v1);
        } else if (p.epi == kEpiBiasResid) {
          v0 = to_float<T>(p.resid[o]) + round_to<T>(v0);
          v1 = to_float<T>(p.resid[o + 1]) + round_to<T>(v1);
        } else if (p.epi == kEpiDgelu) {
          const float* ax = p.aux + static_cast<size_t>(m) * p.ld_aux + n;
          v0 *= gelu_tanh_grad(ax[0]);
          v1 *= gelu_tanh_grad(ax[1]);
        }
        tc::store_pair<T>(dst, v0, v1);
      }
    }
}

// h = LN(x) from the row statistics, rounded to T: the GEMMs' A.
template <typename T>
__global__ void ln_apply_kernel(const T* __restrict__ x,
                                const float* __restrict__ mu,
                                const float* __restrict__ rstd,
                                const T* __restrict__ g,
                                const T* __restrict__ b, T* __restrict__ h,
                                int rows, int d) {
  const size_t n = static_cast<size_t>(rows) * d;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t r = i / d;
    const int c = static_cast<int>(i - r * d);
    h[i] = from_float<T>((to_float<T>(x[i]) - mu[r]) * rstd[r] *
                             to_float<T>(g[c]) +
                         to_float<T>(b[c]));
  }
}

// The two backward passes of the attention core, flash-style and without
// atomics, on 3xTF32 mma.sync (the forward core's reasons, attn_tc.cuh).
// p = exp2(s * scale * log2 e - lse), lse in log2 units from the core;
// ds = p (dp - D) scale with dp = do . v. A block is 4 warps and owns 64
// rows (keys in attn_dkv_tc_kernel, queries in attn_dq_tc_kernel), a warp
// 16; it walks tiles of the other side (64 rows; 16 at HD = 128, where the
// three HD-wide accumulators of a thread leave few registers), double-
// buffered by cp.async. Scores and dp stay in registers and feed the next
// products as A fragments (attn_tc.cuh's k permutation); accumulators stay
// in registers, each tile's products summed from zero and then added to
// them; every shared-memory row is padded to HD + 4 floats.
// qkv (B*L, 3d) fp32, dout (B*L, d) fp32, lse and dsum (B, H, L); dqkv
// (B*L, 3d). grid (ceil(L / 64), B * H), 128 threads.
template <int HD>
__host__ __device__ constexpr int bwd_tile() {
  return HD == 128 ? 16 : 64;
}

template <int HD>
constexpr size_t attn_dkv_tc_smem() {
  return (2 * 64 * (HD + 4) + 4 * bwd_tile<HD>() * (HD + 4) +
          4 * bwd_tile<HD>()) * sizeof(float);
}

template <int HD>
constexpr size_t attn_dq_tc_smem() {
  return (2 * 64 * (HD + 4) + 4 * bwd_tile<HD>() * (HD + 4)) * sizeof(float);
}

// acc (16 rows x 8) += A_w B^T over HD for two operand pairs at once:
// A_w rows of a warp (stride SP), B rows 8j .. 8j+7 (stride SP).
template <int HD, int NT, int SP>
__device__ __forceinline__ void two_scores(float (&s)[NT / 8][4],
                                           float (&dp)[NT / 8][4],
                                           const float* A1, const float* B1,
                                           const float* A2, const float* B2,
                                           int g, int t) {
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    tc::Split<4> a1, a2;
    const int c = 8 * kk + t;
    a1.set(0, A1[g * SP + c]);
    a1.set(1, A1[(g + 8) * SP + c]);
    a1.set(2, A1[g * SP + c + 4]);
    a1.set(3, A1[(g + 8) * SP + c + 4]);
    a2.set(0, A2[g * SP + c]);
    a2.set(1, A2[(g + 8) * SP + c]);
    a2.set(2, A2[g * SP + c + 4]);
    a2.set(3, A2[(g + 8) * SP + c + 4]);
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      tc::Split<2> b1, b2;
      b1.set(0, B1[(8 * j + g) * SP + c]);
      b1.set(1, B1[(8 * j + g) * SP + c + 4]);
      b2.set(0, B2[(8 * j + g) * SP + c]);
      b2.set(1, B2[(8 * j + g) * SP + c + 4]);
      tc::mma_3xtf32(s[j], a1, b1);
      tc::mma_3xtf32(dp[j], a2, b2);
    }
  }
}

// acc[n] (16 x 8) += P B over the NT rows of a tile: P the accumulators of
// a (16 x NT) product (k permuted as in attn_tc.cuh's p_times_v), B (NT,
// HD) rows of stride SP.
template <int HD, int NT, int SP>
__device__ __forceinline__ void acc_times(float (&acc)[HD / 8][4],
                                          const float (&pm)[NT / 8][4],
                                          const float* B, int g, int t) {
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    tc::Split<4> a;
    a.set(0, pm[j][0]);
    a.set(1, pm[j][2]);
    a.set(2, pm[j][1]);
    a.set(3, pm[j][3]);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      tc::Split<2> b;
      b.set(0, B[(8 * j + 2 * t) * SP + 8 * n + g]);
      b.set(1, B[(8 * j + 2 * t + 1) * SP + 8 * n + g]);
      tc::mma_3xtf32(acc[n], a, b);
    }
  }
}

template <int HD>
__device__ __forceinline__ void store_rows(float* dst,
                                           const float (&acc)[HD / 8][4],
                                           int row0, int L, size_t ld, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= L) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(dst + row * ld + 8 * n + 2 * t) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// dK and dV: a block owns 64 keys and walks the query tiles.
template <int HD>
__global__ void __launch_bounds__(128)
    attn_dkv_tc_kernel(const float* __restrict__ qkv,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ dsum,
                       float* __restrict__ dqkv, int L, int H, float scale) {
  constexpr int SP = HD + 4;
  constexpr int NQ = bwd_tile<HD>();
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                 // [64][SP]
  float* Vs = Ks + 64 * SP;         // [64][SP]
  float* Qs = Vs + 64 * SP;         // [2][NQ][SP]
  float* dOs = Qs + 2 * NQ * SP;    // [2][NQ][SP]
  float* lse_s = dOs + 2 * NQ * SP;  // [2][NQ]
  float* d_s = lse_s + 2 * NQ;       // [2][NQ]
  const int c0 = blockIdx.x * 64;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H;
  const int d = H * HD, ld = 3 * d;
  const float* qb = qkv + static_cast<size_t>(b) * L * ld + h * HD;
  const float* ob = dout + static_cast<size_t>(b) * L * d + h * HD;
  const float* lb = lse + (static_cast<size_t>(b) * H + h) * L;
  const float* db = dsum + (static_cast<size_t>(b) * H + h) * L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float c_log2 = scale * tc::kLog2e;

  auto load_tile = [&](int st, int q0) {
    tc::load_rows<float, HD, NQ, SP, 128>(Qs + st * NQ * SP, qb, ld, q0, L);
    tc::load_rows<float, HD, NQ, SP, 128>(dOs + st * NQ * SP, ob, d, q0, L);
    for (int i = threadIdx.x; i < NQ; i += 128) {
      const bool valid = q0 + i < L;
      lse_s[st * NQ + i] = valid ? lb[q0 + i] : 0.0f;
      d_s[st * NQ + i] = valid ? db[q0 + i] : 0.0f;
    }
  };
  tc::load_rows<float, HD, 64, SP, 128>(Ks, qb + d, ld, c0, L);
  tc::load_rows<float, HD, 64, SP, 128>(Vs, qb + 2 * d, ld, c0, L);
  load_tile(0, 0);
  tc::cp_async_commit();

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;
  const int tiles = (L + NQ - 1) / NQ;
  for (int it = 0; it < tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < tiles) {
      load_tile(st ^ 1, (it + 1) * NQ);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const float* Qt = Qs + st * NQ * SP;
    const float* dOt = dOs + st * NQ * SP;
    // s^T = K Q^T and dp^T = V dO^T: the warp's 16 keys x NQ queries
    float s[NQ / 8][4], dp[NQ / 8][4];
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    two_scores<HD, NQ, SP>(s, dp, Ks + warp * 16 * SP, Qt,
                           Vs + warp * 16 * SP, dOt, g, t);
    const int q0 = it * NQ;
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * t + (e & 1);
        const float pv = q0 + qi < L
                             ? exp2f(s[j][e] * c_log2 - lse_s[st * NQ + qi])
                             : 0.0f;
        s[j][e] = pv;
        dp[j][e] = pv * (dp[j][e] - d_s[st * NQ + qi]) * scale;
      }
    // dV += P^T dO, dK += dS^T Q: each tile's products from zero, then
    // added in fp32 (mma_tc.cuh: the MMAs truncate inside their sums)
    float tile[HD / 8][4];
    tc::zero(tile);
    acc_times<HD, NQ, SP>(tile, s, dOt, g, t);
    tc::add_to(dv, tile);
    tc::zero(tile);
    acc_times<HD, NQ, SP>(tile, dp, Qt, g, t);
    tc::add_to(dk, tile);
    __syncthreads();
  }
  float* out = dqkv + static_cast<size_t>(b) * L * ld + h * HD;
  const int row0 = c0 + warp * 16 + g;
  store_rows<HD>(out + d, dk, row0, L, ld, t);
  store_rows<HD>(out + 2 * d, dv, row0, L, ld, t);
}

// dQ: a block owns 64 queries and walks the key tiles.
template <int HD>
__global__ void __launch_bounds__(128)
    attn_dq_tc_kernel(const float* __restrict__ qkv,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum,
                      float* __restrict__ dqkv, int L, int H, float scale) {
  constexpr int SP = HD + 4;
  constexpr int NK = bwd_tile<HD>();
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [64][SP]
  float* dOs = Qs + 64 * SP;      // [64][SP]
  float* Ks = dOs + 64 * SP;      // [2][NK][SP]
  float* Vs = Ks + 2 * NK * SP;   // [2][NK][SP]
  const int q0 = blockIdx.x * 64;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H;
  const int d = H * HD, ld = 3 * d;
  const float* qb = qkv + static_cast<size_t>(b) * L * ld + h * HD;
  const float* ob = dout + static_cast<size_t>(b) * L * d + h * HD;
  const size_t rb = (static_cast<size_t>(b) * H + h) * L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float c_log2 = scale * tc::kLog2e;

  tc::load_rows<float, HD, 64, SP, 128>(Qs, qb, ld, q0, L);
  tc::load_rows<float, HD, 64, SP, 128>(dOs, ob, d, q0, L);
  tc::load_rows<float, HD, NK, SP, 128>(Ks, qb + d, ld, 0, L);
  tc::load_rows<float, HD, NK, SP, 128>(Vs, qb + 2 * d, ld, 0, L);
  tc::cp_async_commit();

  const int row0 = q0 + warp * 16 + g;
  float row_lse[2], row_d[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    row_lse[r] = row < L ? lse[rb + row] : 0.0f;
    row_d[r] = row < L ? dsum[rb + row] : 0.0f;
  }
  float dq[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;
  const int tiles = (L + NK - 1) / NK;
  for (int it = 0; it < tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < tiles) {
      tc::load_rows<float, HD, NK, SP, 128>(Ks + (st ^ 1) * NK * SP, qb + d,
                                            ld, (it + 1) * NK, L);
      tc::load_rows<float, HD, NK, SP, 128>(Vs + (st ^ 1) * NK * SP,
                                            qb + 2 * d, ld, (it + 1) * NK, L);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + st * NK * SP;
    float s[NK / 8][4], dp[NK / 8][4];
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    two_scores<HD, NK, SP>(s, dp, Qs + warp * 16 * SP, Kt,
                           dOs + warp * 16 * SP, Vs + st * NK * SP, g, t);
    const int k0 = it * NK;
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pv = k0 + 8 * j + 2 * t + (e & 1) < L
                             ? exp2f(s[j][e] * c_log2 - row_lse[r])
                             : 0.0f;
        dp[j][e] = pv * (dp[j][e] - row_d[r]) * scale;
      }
    float tile[HD / 8][4];  // dQ += dS K, the tile's products from zero
    tc::zero(tile);
    acc_times<HD, NK, SP>(tile, dp, Kt, g, t);
    tc::add_to(dq, tile);
    __syncthreads();
  }
  store_rows<HD>(dqkv + static_cast<size_t>(b) * L * ld + h * HD, dq, row0,
                 L, ld, t);
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

template <typename T, bool AT, bool BT>
cudaError_t launch_gemm_tc(const TcGemmArgs<T>& p, cudaStream_t stream) {
  const int splits = (p.K + p.k_chunk - 1) / p.k_chunk;
  const dim3 grid((p.N + kTcBN - 1) / kTcBN, (p.M + kTcBM - 1) / kTcBM,
                  splits > 0 ? splits : 1);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(gemm_tc_kernel<T, AT, BT>, tc_smem<T>());
  if (err != cudaSuccess) return err;
  gemm_tc_kernel<T, AT, BT><<<grid, kTcThreads, tc_smem<T>(), stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t gemm_tc_dispatch(const TcGemmArgs<T>& p, int a_trans,
                             int b_trans, cudaStream_t s) {
  if (a_trans)
    return b_trans ? launch_gemm_tc<T, true, true>(p, s)
                   : launch_gemm_tc<T, true, false>(p, s);
  return b_trans ? launch_gemm_tc<T, false, true>(p, s)
                 : launch_gemm_tc<T, false, false>(p, s);
}

template <int HD>
cudaError_t launch_attn_bwd(const float* qkv, const float* dout,
                            const float* lse, const float* dsum, float* dqkv,
                            int B, int L, int H, float scale,
                            cudaStream_t stream) {
  const dim3 grid((L + 63) / 64, B * H);
  const size_t smem_kv = attn_dkv_tc_smem<HD>();
  cudaError_t err = allow_smem(attn_dkv_tc_kernel<HD>, smem_kv);
  if (err != cudaSuccess) return err;
  attn_dkv_tc_kernel<HD><<<grid, 128, smem_kv, stream>>>(
      qkv, dout, lse, dsum, dqkv, L, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_q = attn_dq_tc_smem<HD>();
  err = allow_smem(attn_dq_tc_kernel<HD>, smem_q);
  if (err != cudaSuccess) return err;
  attn_dq_tc_kernel<HD><<<grid, 128, smem_q, stream>>>(
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

// The tensor-core GEMM: out (M, N) = A @ B with the epilogue, A (M, K) or
// stored (K, M) when a_trans, B (K, N) or stored (N, K) when b_trans, in
// fp32 or bf16. k_chunk is a multiple of 32, and below K only with the fp32
// epilogue (split z writes partial z). Every operand's contiguous extent,
// N and the leading dimensions are multiples of 16 bytes (4 fp32, 8 bf16)
// and a, b, out and out2 are 16-byte aligned; anything else is refused.
int mia_vit_gemm_tc(int is_bf16, const void* a, int a_trans, int lda,
                    const void* b, int b_trans, int ldb, int M, int N, int K,
                    int k_chunk, int epi, const void* bias, const void* resid,
                    const float* aux, int ld_aux, void* out, void* out2,
                    int ldc, void* stream) {
  auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  const int e = is_bf16 ? 8 : 4;  // elements in 16 bytes
  if (M < 1 || N < 1 || K < 1 || k_chunk < 1 || k_chunk % kTcBK != 0 ||
      N % e || lda % e || ldb % e || ldc % e || (a_trans ? M : K) % e ||
      (b_trans ? K : N) % e || !aligned(a) || !aligned(b) || !aligned(out))
    return cudaErrorInvalidValue;
  const bool biased = epi == kEpiBias || epi == kEpiBiasGelu ||
                      epi == kEpiBiasResid || epi == kEpiBiasF32Gelu;
  if ((!biased && epi != kEpiF32 && epi != kEpiDgelu && epi != kEpiStore) ||
      (epi != kEpiF32 && k_chunk < K) || (biased && bias == nullptr) ||
      (epi == kEpiBiasResid && resid == nullptr) ||
      (epi == kEpiDgelu && aux == nullptr) ||
      (epi == kEpiBiasF32Gelu && (out2 == nullptr || !aligned(out2))))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    const TcGemmArgs<T> p{static_cast<const T*>(a), lda,
                          static_cast<const T*>(b), ldb, M, N, K, k_chunk,
                          epi, static_cast<const T*>(bias),
                          static_cast<const T*>(resid), aux, ld_aux, out,
                          static_cast<T*>(out2), ldc};
    return gemm_tc_dispatch(p, a_trans, b_trans, s);
  }
  using T = float;
  const TcGemmArgs<T> p{static_cast<const T*>(a), lda,
                        static_cast<const T*>(b), ldb, M, N, K, k_chunk, epi,
                        static_cast<const T*>(bias),
                        static_cast<const T*>(resid), aux, ld_aux, out,
                        static_cast<T*>(out2), ldc};
  return gemm_tc_dispatch(p, a_trans, b_trans, s);
}

// h (rows, d) = LN(x) from the row statistics, in x's dtype.
int mia_vit_ln_apply(const void* x, int is_bf16, const float* mu,
                     const float* rstd, const void* g, const void* b,
                     void* h, int rows, int d, void* stream) {
  if (rows < 1 || d < 1) return cudaErrorInvalidValue;
  const size_t n = static_cast<size_t>(rows) * d;
  const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    ln_apply_kernel<T><<<blocks, 256, 0, s>>>(
        static_cast<const T*>(x), mu, rstd, static_cast<const T*>(g),
        static_cast<const T*>(b), static_cast<T*>(h), rows, d);
  } else {
    ln_apply_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(x), mu, rstd, static_cast<const float*>(g),
        static_cast<const float*>(b), static_cast<float*>(h), rows, d);
  }
  return cudaGetLastError();
}

// Each head's output o (B*L, d) in qkv's dtype through attn_tc.cuh's core,
// q, k and v read in place from the packed qkv (B*L, 3d). With lse, also
// the per-row logsumexp (log2 units) and D = do . o, (B, H, L) each, from
// do (B*L, d): the backward's recompute, fp32 only.
int mia_vit_attn_core_tc(int is_bf16, const void* qkv, void* o, float* lse,
                         const float* dout, float* dsum, int B, int L, int H,
                         int hd, float scale, void* stream) {
  const bool stats = lse != nullptr;
  if (hd < 1 || (stats && (is_bf16 || dout == nullptr || dsum == nullptr)) ||
      (!stats && (dout != nullptr || dsum != nullptr)))
    return cudaErrorInvalidValue;
  const long long d = static_cast<long long>(H) * hd;
  const long long bs = static_cast<long long>(L) * 3 * d;
  const size_t es = is_bf16 ? 2 : 4;
  const char* q = static_cast<const char*>(qkv);
  const tc::AttnArgs p{q, q + d * es, q + 2 * d * es, bs,   3 * d, bs,
                       3 * d, bs,     3 * d,          nullptr, o,   lse,
                       dout, dsum,    B,              H,       L,   scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return tc::attn_tc_dispatch<__nv_bfloat16, false>(hd, p, s);
  return stats ? tc::attn_tc_dispatch<float, true>(hd, p, s)
               : tc::attn_tc_dispatch<float, false>(hd, p, s);
}

int mia_vit_attn_bwd(const float* qkv, const float* dout, const float* lse,
                     const float* dsum, float* dqkv, int B, int L, int H,
                     int hd, float scale, void* stream) {
  if (B < 1 || L < 1 || H < 1 || static_cast<long long>(B) * H > 65535)
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
