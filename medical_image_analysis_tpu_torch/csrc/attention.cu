// Fused short-sequence attention for Hopper (sm_90a): one kernel.
//
//   attention_fwd_kernel  <- _attn_kernel (medical_image_analysis_tpu/ops/
//                            attention.py:28): softmax(q k^T * scale + mask) v
//
// Layouts: q, k, v (B, L, H, HD) with any batch and token strides and the
// heads and head dims contiguous, so that q, k and v are read in place (the
// three (B, L, H, HD) slices of a (B, L, 3, H, HD) qkv product included);
// mask (L, L) fp32 or null, broadcast over batch and heads; out (B, L, H, HD)
// contiguous. fp32 or bf16, all one type.
//
// Rounding points are the TPU kernel's (:29-45): q and k widened to fp32,
// fp32 scores, the mask added in fp32, the row max and sum in fp32,
// p = exp(s - max) / sum rounded to v's type BEFORE the product with v, fp32
// accumulation, the output rounded to q's type. So the normalisation comes
// before the rounding: a one-pass online softmax that divides at the end
// would round differently. This kernel keeps each query's row of scores in
// shared memory instead (L <= kMaxL, which the dispatch guarantees: it takes
// this route only when an fp32 (L, L) tile fits 8 MiB), and reads the keys
// twice: once for the scores, once, as values, for the product.
//
// What bounds it on the H100: at ViT-B (B=64, L=197, 12 heads of 64) 7.6
// GFLOP of two products against 58 MB of q, k, v and output: operations (0.11
// ms at 67 TFLOP/s fp32). One block owns kQT queries of one (batch, head):
// it stages their q rows, then tiles of kKT keys (rows padded to HD + 1
// against bank conflicts), and each thread accumulates 4 scores x HD FMAs
// per key from shared memory; the softmax is one warp per query row; the
// product p v reads a staged tile of values per pass. No tensor cores yet
// (fp32 products, as the TPU kernel's first one); a wgmma version is later
// work.
//
// The kernel launches on the caller's stream, allocates nothing, and the C
// function returns cudaGetLastError() so that the Python wrapper can raise
// on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 16;    // queries per block
constexpr int kKT = 64;    // keys (or values) per staged tile
constexpr int kMaxL = 1448;  // the longest L with L * L * 4 <= 8 MiB
constexpr int kQPerThread = kQT * kKT / kThreads;  // scores a thread adds
static_assert(kThreads % kKT == 0 && kQT % (kThreads / kKT) == 0, "tiling");

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

struct Strides {
  long long q_bs, q_ts, k_bs, k_ts, v_bs, v_ts;  // batch and token strides
};

__host__ __device__ constexpr int smem_floats(int hd, int L) {
  return (kQT + kKT) * (hd + 1) + kQT * L;
}

// Stage rows r0 .. r0+nr-1 (at most kKT) of one head of x as fp32, rows of
// HD + 1 floats, zeros past nr.
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(const T* x, long long ts, int r0,
                                           int nr, int rmax, float* x_s) {
  for (int i = threadIdx.x; i < rmax * HD; i += kThreads) {
    const int rr = i / HD;
    const int c = i - rr * HD;
    x_s[rr * (HD + 1) + c] = rr < nr ? to_float(x[(r0 + rr) * ts + c]) : 0.0f;
  }
}

// grid (ceil(L / kQT), B * H), block kThreads, dynamic smem
// smem_floats(HD, L) floats.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ mask,
    T* __restrict__ out, int H, int L, Strides st, float scale) {
  extern __shared__ float smem[];
  constexpr int HP = HD + 1;
  float* q_s = smem;              // (kQT, HP)
  float* kv_s = q_s + kQT * HP;   // (kKT, HP)
  float* s_s = kv_s + kKT * HP;   // (kQT, L): scores, then p

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int q0 = blockIdx.x * kQT;
  const int nq = min(kQT, L - q0);
  const int tid = threadIdx.x;
  const T* qb = q + b * st.q_bs + h * HD;
  const T* kb = k + b * st.k_bs + h * HD;
  const T* vb = v + b * st.v_bs + h * HD;

  stage_rows<T, HD>(qb, st.q_ts, q0, nq, kQT, q_s);

  // ---- scores: s[q][j] = (q . k_j) * scale + mask[q][j] ----------------
  const int j = tid % kKT;
  const int qg = (tid / kKT) * kQPerThread;
  for (int k0 = 0; k0 < L; k0 += kKT) {
    const int nk = min(kKT, L - k0);
    __syncthreads();  // q_s staged / the previous tile consumed
    stage_rows<T, HD>(kb, st.k_ts, k0, nk, kKT, kv_s);
    __syncthreads();
    if (j >= nk) continue;
    float acc[kQPerThread];
#pragma unroll
    for (int i = 0; i < kQPerThread; ++i) acc[i] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < HD; ++c) {
      const float kc = kv_s[j * HP + c];
#pragma unroll
      for (int i = 0; i < kQPerThread; ++i)
        acc[i] += q_s[(qg + i) * HP + c] * kc;
    }
#pragma unroll
    for (int i = 0; i < kQPerThread; ++i) {
      const int qq = qg + i;
      if (qq < nq) {
        float s = acc[i] * scale;
        if (mask != nullptr)
          s += mask[static_cast<size_t>(q0 + qq) * L + k0 + j];
        s_s[qq * L + k0 + j] = s;
      }
    }
  }
  __syncthreads();

  // ---- softmax, one warp per query row: p = exp(s - max) / sum ---------
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int qq = warp; qq < nq; qq += kThreads / 32) {
    float* row = s_s + qq * L;
    float m = -CUDART_INF_F;
    for (int jj = lane; jj < L; jj += 32) m = fmaxf(m, row[jj]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.0f;
    for (int jj = lane; jj < L; jj += 32) {
      const float e = expf(row[jj] - m);
      row[jj] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int jj = lane; jj < L; jj += 32)
      row[jj] = to_float(from_float<T>(row[jj] / sum));  // p in v's type
  }

  // ---- out = p v, fp32 accumulation -------------------------------------
  constexpr int kOut = kQT * HD / kThreads;  // outputs a thread owns
  float acc[kOut > 0 ? kOut : 1];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.0f;
  for (int k0 = 0; k0 < L; k0 += kKT) {
    const int nk = min(kKT, L - k0);
    __syncthreads();  // p written / the previous tile consumed
    stage_rows<T, HD>(vb, st.v_ts, k0, nk, kKT, kv_s);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const int o = tid + i * kThreads;
      const int qq = o / HD;
      const int c = o - qq * HD;
      const float* p = s_s + qq * L + k0;
      float a = acc[i];
      for (int jj = 0; jj < nk; ++jj) a += p[jj] * kv_s[jj * HP + c];
      acc[i] = a;
    }
  }
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    const int o = tid + i * kThreads;
    const int qq = o / HD;
    const int c = o - qq * HD;
    if (qq < nq)
      out[((static_cast<size_t>(b) * L + q0 + qq) * H + h) * HD + c] =
          from_float<T>(acc[i]);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* mask, void* out, int B, int H, int L,
                   const Strides& st, float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(smem_floats(HD, L)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((L + kQT - 1) / kQT, B * H);
  attention_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), H, L, st, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     const float* mask, void* out, int B, int H, int L,
                     const Strides& st, float scale, cudaStream_t s) {
  switch (hd) {  // the head widths the kernel takes; any other is refused
    case 16:
      return launch<T, 16>(q, k, v, mask, out, B, H, L, st, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, mask, out, B, H, L, st, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, mask, out, B, H, L, st, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, mask, out, B, H, L, st, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int mia_attention_fwd(const void* q, const void* k, const void* v,
                      const float* mask, void* out, int is_bf16, int B, int H,
                      int L, int hd, long long q_bs, long long q_ts,
                      long long k_bs, long long k_ts, long long v_bs,
                      long long v_ts, float scale, void* stream) {
  if (B < 1 || H < 1 || L < 1 || L > kMaxL) return cudaErrorInvalidValue;
  const Strides st{q_bs, q_ts, k_bs, k_ts, v_bs, v_ts};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(hd, q, k, v, mask, out, B, H, L,
                                           st, scale, s)
                 : dispatch<float>(hd, q, k, v, mask, out, B, H, L, st, scale,
                                   s);
}

}  // extern "C"
