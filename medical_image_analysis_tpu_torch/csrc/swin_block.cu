// The Swin block's window-attention sub-layer for Hopper (sm_90a), forward
// only. It replaces the Pallas TPU kernel of
// medical_image_analysis_tpu/ops/swin_block.py:
//
//   swin_attn_fwd  <- _swin_attn_kernel (:43, launched at :156)
//
//   out = x + proj(WindowMHA(LN(x)) with bias[head] + mask[r % nW]) + bo
//
// over windows x (B*nW, L = ws*ws, C) in window_partition order. The
// sub-layer is five launches put together by ops/swin_block.py:
// csrc/vit_block.cu's LayerNorm statistics (eps 1e-5) and LN(x) in the
// working dtype, then its tensor-core GEMM (gemm_tc_kernel) with the bias
// epilogue gives q, k and v in the working dtype; swin_attn_core_kernel
// below gives each head's output; the same GEMM with the bias + residual
// epilogue gives out.
//
// swin_attn_core_kernel: one block per (window, head). It stages that
// head's q, k and v (L x HD each) and the L x L fp32 scores in shared
// memory, about 28 KB at L = 49, HD = 32: s = (q . k) * scale, plus
// bias[head] and the shift mask of the window's in-image position (r % nW,
// by index arithmetic, no gather tensor); a row softmax by one warp a row;
// p rounded to the working dtype, then p . v, each output rounded to it.
// That is where the TPU kernel rounds (swin_block.py:50-88): q, k and v
// come in the working dtype, the scores and the softmax are fp32.
//
// What bounds the sub-layer on the H100, and what the design does about
// it. At swin_large's shapes (C = 192 to 1536, 6 to 48 heads of 32, L = 49)
// about 90% of the operations are the QKV and output projections; the
// attention core is 2 x 49 x 49 x 32 multiply-adds a row and head. The
// projections run on the tensor cores, fp32 in 3xTF32 (fp32-accurate, so
// the 1e-4 checks hold; 495 / 3 = 165 TFLOP/s at 700 W) and bf16 as it is
// (989): 59 GFLOP a block at B = 64, 0.36 ms in fp32. The core's 1 to 8
// GFLOP stay on the CUDA cores in fp32 (67 TFLOP/s), 0.01 to 0.11 ms. So
// operations bound it, against 77 to 310 MB of traffic, 0.02 to 0.09 ms at
// 3.35 TB/s. The core is small and holds everything of one (window, head)
// on chip, so no score tensor goes to device memory; the windows are many
// (4,096 x 6 heads at stage 0), so the card is full with one block per
// (window, head). A tensor-core core, wgmma and TMA are later work.
//
// Head widths 8, 16, 32 and 64 are compiled instances of the core (8 is
// the first stage of the small SwinCheX whose GradCAM builds AM-MRG's
// visual memory: embed 16, 2 heads). The core runs on the CUDA cores with
// a loop over the head width, so the narrow width takes fp32 and bf16
// alike; the projections' GEMM masks the K tail (C = 16 there).
//
// Launches on the caller's stream, allocates nothing, and returns
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

// v rounded to T and back: where the TPU kernel casts p to v's dtype.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float<T>(from_float<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr int kMaxL = 64;  // a row's keys: two per lane of its warp
constexpr int kThreads = 128;

// Shared floats of one block: q and k at a stride of HD + 1 (the score
// loop reads k[j][c] with j along the warp), v at HD, the scores at L.
template <int HD>
__host__ __device__ constexpr int core_smem_floats(int L) {
  return 2 * L * (HD + 1) + L * HD + L * L;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    swin_attn_core_kernel(const T* __restrict__ qkv,
                          const float* __restrict__ bias,
                          const float* __restrict__ mask, T* __restrict__ o,
                          int L, int H, int nw, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;               // [L][HD + 1]
  float* Ks = Qs + L * (HD + 1);  // [L][HD + 1]
  float* Vs = Ks + L * (HD + 1);  // [L][HD]
  float* Ss = Vs + L * HD;        // [L][L]
  const int win = blockIdx.x, h = blockIdx.y;
  const int C = H * HD, ld = 3 * C;
  const size_t row0 = static_cast<size_t>(win) * L;

  for (int idx = threadIdx.x; idx < L * HD; idx += kThreads) {
    const int r = idx / HD, c = idx % HD;
    const size_t src = (row0 + r) * ld + h * HD + c;
    Qs[r * (HD + 1) + c] = to_float<T>(qkv[src]);
    Ks[r * (HD + 1) + c] = to_float<T>(qkv[src + C]);
    Vs[r * HD + c] = to_float<T>(qkv[src + 2 * C]);
  }
  __syncthreads();

  const float* bh = bias + static_cast<size_t>(h) * L * L;
  const float* mw = mask + static_cast<size_t>(win % nw) * L * L;
  for (int idx = threadIdx.x; idx < L * L; idx += kThreads) {
    const int i = idx / L, j = idx % L;
    const float* q = Qs + i * (HD + 1);
    const float* k = Ks + j * (HD + 1);
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < HD; ++c) s = fmaf(q[c], k[c], s);
    Ss[idx] = s * scale + bh[idx] + mw[idx];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < L; i += kThreads / 32) {
    float* srow = Ss + i * L;
    const float s0 = lane < L ? srow[lane] : -INFINITY;
    const float s1 = lane + 32 < L ? srow[lane + 32] : -INFINITY;
    const float m = warp_max(fmaxf(s0, s1));
    const float e0 = lane < L ? expf(s0 - m) : 0.0f;
    const float e1 = lane + 32 < L ? expf(s1 - m) : 0.0f;
    const float inv = 1.0f / warp_sum(e0 + e1);
    if (lane < L) srow[lane] = round_to<T>(e0 * inv);
    if (lane + 32 < L) srow[lane + 32] = round_to<T>(e1 * inv);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < L * HD; idx += kThreads) {
    const int i = idx / HD, c = idx % HD;
    const float* p = Ss + i * L;
    float acc = 0.0f;
    for (int j = 0; j < L; ++j) acc = fmaf(p[j], Vs[j * HD + c], acc);
    o[(row0 + i) * C + h * HD + c] = from_float<T>(acc);
  }
}

template <typename T, int HD>
cudaError_t launch_core(const void* qkv, const float* bias, const float* mask,
                        void* o, int windows, int L, int H, int nw,
                        float scale, cudaStream_t stream) {
  const size_t smem = core_smem_floats<HD>(L) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        swin_attn_core_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(windows, H);
  swin_attn_core_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), bias, mask, static_cast<T*>(o), L, H, nw,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t core_dispatch(const void* qkv, const float* bias,
                          const float* mask, void* o, int windows, int L,
                          int H, int hd, int nw, float scale, cudaStream_t s) {
  switch (hd) {
    case 8: return launch_core<T, 8>(qkv, bias, mask, o, windows, L, H, nw, scale, s);
    case 16: return launch_core<T, 16>(qkv, bias, mask, o, windows, L, H, nw, scale, s);
    case 32: return launch_core<T, 32>(qkv, bias, mask, o, windows, L, H, nw, scale, s);
    case 64: return launch_core<T, 64>(qkv, bias, mask, o, windows, L, H, nw, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// qkv (windows * L, 3 * H * hd) in the working dtype; bias (H, L, L) and
// mask (nw, L, L) fp32; o (windows * L, H * hd). Returns the cudaError_t of
// the launch (0 on success).
int mia_swin_attn_core(int is_bf16, const void* qkv, const float* bias,
                       const float* mask, void* o, int windows, int L, int H,
                       int hd, int nw, float scale, void* stream) {
  if (windows < 1 || L < 1 || L > kMaxL || H < 1 || H > 65535 || nw < 1 ||
      windows % nw != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? core_dispatch<__nv_bfloat16>(qkv, bias, mask, o, windows,
                                                L, H, hd, nw, scale, s)
                 : core_dispatch<float>(qkv, bias, mask, o, windows, L, H,
                                        hd, nw, scale, s);
}

}  // extern "C"
