// Fused multi-direction Mamba forward for Hopper (sm_90a): two kernels.
//
// They replace the two Pallas TPU kernels that the serving path runs in
// medical_image_analysis_tpu/ops/mamba_fused.py:
//
//   mamba_xdbl_kernel  <- _xdbl_kernel      (x_dbl = silu(conv(x_dir)) @ Wx^T)
//   mamba_scan_kernel  <- _fused_fwd_kernel (conv + SiLU again, dt_proj,
//                                            softplus, S6 scan, D skip)
//
// Layouts (all contiguous):
//   xr, xc   (B, L, D) row-major / column-major scan sources, fp32 or bf16;
//            xc is null when K < 4.
//   conv_w   (K, taps, D) fp32, taps <= 4; conv_b (K, D) fp32
//   wx       (K, C, D) fp32, C = R + 2N     (x_proj weight)
//   dtw      (K, D, R) fp32                 (dt_proj weight)
//   dt_bias, Dv (K, D) fp32; A (K, D, N) fp32 (negative reals)
//   xdbl     (B*K, L, C) fp32, scan order
//   y        (B*K, L, D) in the source dtype, SOURCE order
//
// Direction k reads source (k >= 2 ? xc : xr); odd k scans it back to front,
// so scan row t is source row L-1-t. The TPU version flipped rows in VMEM with
// anti-identity matmuls and padded L to its chunk; here the flip is index
// arithmetic and nothing is padded: a reversed direction starts at source row
// L-1 with a zero conv carry and a zero state.
//
// What bounds them on the H100, and what the design does about it:
//  - xdbl: (B*K*L) x C x D fp32 FMAs, about 60 MFLOP per ARM-B layer at B=1,
//    reading 4*C*D weights per block from L2. One block owns ROWS scan rows of
//    one (b, k): it stages silu(conv(x)) for those rows in shared memory, then
//    each warp reduces over D for a set of the C outputs, reusing each weight
//    it loads for all ROWS rows. No tensor cores yet (the TPU kernel used the
//    MXU); a wgmma tile is later work.
//  - scan: a chain of L dependent steps per (b, k, d) channel, so latency, not
//    bytes or FLOPs, bounds it. One thread owns one channel and keeps its conv
//    window, its N fp32 states and A in registers; the block stages a tile of
//    x_dbl rows (shared by all its channels) and of source rows in shared
//    memory so that the loads of a tile are issued together, not once per
//    dependent step. The TPU's sequential L-chunk grid with VMEM carries
//    becomes this loop inside the thread. Chunk-start carries for a backward
//    pass are not written: serving needs none.
//
// Both launch on the caller's stream, allocate nothing, and return
// cudaGetLastError() so that the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxTaps = 4;
constexpr int kXdblThreads = 256;
constexpr int kXdblMaxRows = 8;
constexpr int kScanThreads = 64;  // channels per block
constexpr int kScanTile = 32;     // rows staged per pass

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
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float silu(float x) {
  return x * (1.0f / (1.0f + expf(-x)));
}

__device__ __forceinline__ float softplus(float x) {
  // logaddexp(x, 0), the form jax.nn.softplus uses
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

template <typename T>
__device__ __forceinline__ const T* source_of(const T* xr, const T* xc, int k,
                                              int b, int L, int D) {
  const T* src = (xc != nullptr && k >= 2) ? xc : xr;
  return src + static_cast<size_t>(b) * L * D;
}

// grid (ceil(L / rows), B*K), block kXdblThreads, dynamic smem rows*D floats
template <typename T>
__global__ void __launch_bounds__(kXdblThreads) mamba_xdbl_kernel(
    const T* __restrict__ xr, const T* __restrict__ xc,
    const float* __restrict__ conv_w, const float* __restrict__ conv_b,
    const float* __restrict__ wx, float* __restrict__ xdbl, int K, int L,
    int D, int C, int taps, int use_conv, int rows) {
  extern __shared__ float u_s[];  // (rows, D)
  const int bk = blockIdx.y;
  const int b = bk / K;
  const int k = bk - b * K;
  const bool rev = (k & 1) != 0;
  const int t0 = blockIdx.x * rows;
  const T* src = source_of(xr, xc, k, b, L, D);
  const float* w = conv_w + static_cast<size_t>(k) * taps * D;

  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D;
    const int d = i - r * D;
    const int t = t0 + r;
    float u = 0.0f;
    if (t < L) {
      if (use_conv) {
        float acc = 0.0f;
        for (int j = 0; j < taps; ++j) {
          const int tt = t - (taps - 1) + j;  // scan row feeding tap j
          if (tt >= 0) {
            const int s = rev ? L - 1 - tt : tt;
            acc += w[j * D + d] * to_float(src[static_cast<size_t>(s) * D + d]);
          }
        }
        u = silu(acc + conv_b[k * D + d]);
      } else {
        const int s = rev ? L - 1 - t : t;
        u = to_float(src[static_cast<size_t>(s) * D + d]);
      }
    }
    u_s[i] = u;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const float* wk = wx + static_cast<size_t>(k) * C * D;
  for (int c = warp; c < C; c += nwarps) {
    float acc[kXdblMaxRows];
#pragma unroll
    for (int r = 0; r < kXdblMaxRows; ++r) acc[r] = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float wv = wk[static_cast<size_t>(c) * D + d];
#pragma unroll
      for (int r = 0; r < kXdblMaxRows; ++r)
        if (r < rows) acc[r] += u_s[r * D + d] * wv;
    }
#pragma unroll
    for (int r = 0; r < kXdblMaxRows; ++r) {
      float v = acc[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && r < rows && t0 + r < L)
        xdbl[(static_cast<size_t>(bk) * L + t0 + r) * C + c] = v;
    }
  }
}

// grid (ceil(D / kScanThreads), B*K), block kScanThreads, dynamic smem
// (R*kScanThreads + kScanTile*C + kScanTile*kScanThreads) floats
template <typename T, int N>
__global__ void __launch_bounds__(kScanThreads) mamba_scan_kernel(
    const T* __restrict__ xr, const T* __restrict__ xc,
    const float* __restrict__ xdbl, const float* __restrict__ conv_w,
    const float* __restrict__ conv_b, const float* __restrict__ dtw,
    const float* __restrict__ dt_bias, const float* __restrict__ A,
    const float* __restrict__ Dv, T* __restrict__ y, int K, int L, int D,
    int R, int taps, int use_conv, int delta_softplus) {
  extern __shared__ float smem[];
  const int C = R + 2 * N;
  float* dtw_s = smem;                         // (R, kScanThreads)
  float* xd_s = dtw_s + R * kScanThreads;      // (kScanTile, C)
  float* x_s = xd_s + kScanTile * C;           // (kScanTile, kScanThreads)

  const int bk = blockIdx.y;
  const int b = bk / K;
  const int k = bk - b * K;
  const bool rev = (k & 1) != 0;
  const int d0 = blockIdx.x * kScanThreads;
  const int tid = threadIdx.x;
  const int d = d0 + tid;
  const bool active = d < D;
  const T* src = source_of(xr, xc, k, b, L, D);

  for (int i = tid; i < R * kScanThreads; i += kScanThreads) {
    const int dd = i / R;
    const int r = i - dd * R;
    dtw_s[r * kScanThreads + dd] =
        d0 + dd < D ? dtw[(static_cast<size_t>(k) * D + d0 + dd) * R + r]
                    : 0.0f;
  }

  // Taps are right-aligned in wp so that wp[kMaxTaps-1] multiplies x[t];
  // leading zero taps add exact zeros.
  float a[N], h[N];
  float wp[kMaxTaps], win[kMaxTaps - 1];
  float cb = 0.0f, db = 0.0f, dskip = 0.0f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = active ? A[(static_cast<size_t>(k) * D + d) * N + n] : 0.0f;
    h[n] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kMaxTaps; ++j) {
    const int src_tap = j - (kMaxTaps - taps);
    wp[j] = active && src_tap >= 0
                ? conv_w[(static_cast<size_t>(k) * taps + src_tap) * D + d]
                : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kMaxTaps - 1; ++j) win[j] = 0.0f;
  if (active) {
    cb = conv_b[k * D + d];
    db = dt_bias[k * D + d];
    dskip = Dv[k * D + d];
  }

  for (int t0 = 0; t0 < L; t0 += kScanTile) {
    const int nt = min(kScanTile, L - t0);
    __syncthreads();  // dtw_s written / previous tile consumed
    const float* xd_g = xdbl + (static_cast<size_t>(bk) * L + t0) * C;
    for (int i = tid; i < nt * C; i += kScanThreads) xd_s[i] = xd_g[i];
    for (int i = tid; i < nt * kScanThreads; i += kScanThreads) {
      const int r = i / kScanThreads;
      const int dd = i - r * kScanThreads;
      const int t = t0 + r;
      const int s = rev ? L - 1 - t : t;
      x_s[i] = d0 + dd < D
                   ? to_float(src[static_cast<size_t>(s) * D + d0 + dd])
                   : 0.0f;
    }
    __syncthreads();
    if (!active) continue;

    for (int r = 0; r < nt; ++r) {
      const float xv = x_s[r * kScanThreads + tid];
      float u = xv;
      if (use_conv) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxTaps - 1; ++j) acc += wp[j] * win[j];
        acc += wp[kMaxTaps - 1] * xv;
#pragma unroll
        for (int j = 0; j < kMaxTaps - 2; ++j) win[j] = win[j + 1];
        win[kMaxTaps - 2] = xv;
        u = silu(acc + cb);
      }
      const float* row = xd_s + r * C;
      float dt = 0.0f;
      for (int q = 0; q < R; ++q) dt += row[q] * dtw_s[q * kScanThreads + tid];
      dt += db;
      if (delta_softplus) dt = softplus(dt);
      const float dtu = dt * u;
      float out = 0.0f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(dt * a[n]) * h[n] + dtu * row[R + n];
        out += row[R + N + n] * h[n];
      }
      out += u * dskip;
      const int t = t0 + r;
      const int s = rev ? L - 1 - t : t;
      y[(static_cast<size_t>(bk) * L + s) * D + d] = from_float<T>(out);
    }
  }
}

template <typename T>
cudaError_t launch_xdbl(const void* xr, const void* xc, const float* conv_w,
                        const float* conv_b, const float* wx, float* xdbl,
                        int B, int K, int L, int D, int C, int taps,
                        int use_conv, int rows, cudaStream_t stream) {
  const dim3 grid((L + rows - 1) / rows, B * K);
  const size_t smem = static_cast<size_t>(rows) * D * sizeof(float);
  mamba_xdbl_kernel<T><<<grid, kXdblThreads, smem, stream>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xc), conv_w, conv_b,
      wx, xdbl, K, L, D, C, taps, use_conv, rows);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch_scan(const void* xr, const void* xc, const float* xdbl,
                        const float* conv_w, const float* conv_b,
                        const float* dtw, const float* dt_bias, const float* A,
                        const float* Dv, void* y, int B, int K, int L, int D,
                        int R, int taps, int use_conv, int delta_softplus,
                        cudaStream_t stream) {
  const int C = R + 2 * N;
  const size_t smem =
      static_cast<size_t>(R * kScanThreads + kScanTile * C +
                          kScanTile * kScanThreads) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mamba_scan_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((D + kScanThreads - 1) / kScanThreads, B * K);
  mamba_scan_kernel<T, N><<<grid, kScanThreads, smem, stream>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xc), xdbl, conv_w,
      conv_b, dtw, dt_bias, A, Dv, static_cast<T*>(y), K, L, D, R, taps,
      use_conv, delta_softplus);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_scan(int N, const void* xr, const void* xc,
                          const float* xdbl, const float* conv_w,
                          const float* conv_b, const float* dtw,
                          const float* dt_bias, const float* A,
                          const float* Dv, void* y, int B, int K, int L,
                          int D, int R, int taps, int use_conv,
                          int delta_softplus, cudaStream_t stream) {
#define MIA_SCAN_CASE(NN)                                                    \
  case NN:                                                                   \
    return launch_scan<T, NN>(xr, xc, xdbl, conv_w, conv_b, dtw, dt_bias, A, \
                              Dv, y, B, K, L, D, R, taps, use_conv,          \
                              delta_softplus, stream);
  switch (N) {
    MIA_SCAN_CASE(4)   // the tests' small layers
    MIA_SCAN_CASE(16)  // every ARM and VSSM d16 layer
    default:
      return cudaErrorInvalidValue;
  }
#undef MIA_SCAN_CASE
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int mia_mamba_xdbl(const void* xr, const void* xc, int is_bf16,
                   const float* conv_w, const float* conv_b, const float* wx,
                   float* xdbl, int B, int K, int L, int D, int C, int taps,
                   int use_conv, int rows, void* stream) {
  if (taps < 1 || taps > kMaxTaps || rows < 1 || rows > kXdblMaxRows)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_xdbl<__nv_bfloat16>(xr, xc, conv_w, conv_b, wx,
                                              xdbl, B, K, L, D, C, taps,
                                              use_conv, rows, s)
                 : launch_xdbl<float>(xr, xc, conv_w, conv_b, wx, xdbl, B, K,
                                      L, D, C, taps, use_conv, rows, s);
}

int mia_mamba_scan(const void* xr, const void* xc, int is_bf16,
                   const float* xdbl, const float* conv_w,
                   const float* conv_b, const float* dtw,
                   const float* dt_bias, const float* A, const float* Dv,
                   void* y, int B, int K, int L, int D, int N, int R, int taps,
                   int use_conv, int delta_softplus, void* stream) {
  if (taps < 1 || taps > kMaxTaps) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? dispatch_scan<__nv_bfloat16>(N, xr, xc, xdbl, conv_w, conv_b,
                                            dtw, dt_bias, A, Dv, y, B, K, L,
                                            D, R, taps, use_conv,
                                            delta_softplus, s)
             : dispatch_scan<float>(N, xr, xc, xdbl, conv_w, conv_b, dtw,
                                    dt_bias, A, Dv, y, B, K, L, D, R, taps,
                                    use_conv, delta_softplus, s);
}

}  // extern "C"
