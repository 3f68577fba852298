// The general selective scan (Mamba S6) for Hopper (sm_90a): two kernels.
//
// They replace the two Pallas TPU kernels of
// medical_image_analysis_tpu/ops/selective_scan_pallas.py:
//
//   selective_scan_fwd_kernel  <- _fwd_kernel (:108; the S6 scan over given
//                                 delta, B and C, delta bias, optional
//                                 softplus, D skip)
//   selective_scan_bwd_kernel  <- _bwd_kernel (:164; du, ddelta, dA, dB, dC,
//                                 dD, d delta_bias)
//
// Layout (the TPU kernels' folded one): rows = batch x groups, and row r
// takes the parameters of group g = r % G, so that grouped B/C and the K
// directions of selective_scan_dirs run in one launch.
//   u, delta, y, du, ddelta  (rows, L, D) contiguous, fp32 or bf16 (all one
//                            type)
//   B, C                     (rows, L, N) of the same type, element stride 1
//                            and row and step strides of their own, so that
//                            slices of a (B, K, L, R+2N) x_dbl are read in
//                            place
//   A (G, D, N), Dv, dbias (G, D) fp32
//
// Per row r, channel d and step t:
//   dt = delta[r,t,d] + dbias[g,d], through softplus (logaddexp(x, 0)) when
//        asked;
//   h  = exp(dt * A[g,d,:]) * h + dt * u[r,t,d] * B[r,t,:]   (fp32 state)
//   y[r,t,d] = C[r,t,:] . h + Dv[g,d] * u[r,t,d]
// and the backward is the adjoint P[t] = C[t] dy[t] + a[t+1] P[t+1] with
// the gradients of _bwd_kernel (:208-222).
//
// What bounds them on the H100, and what the design does about it: a chain
// of L dependent steps per (row, channel), each 16 exps and about 50 FMAs at
// N = 16: latency and issue rate, not bytes (vssm_tiny stage 0 at B=128 moves
// about 3.9 GB a forward in fp32, 1.2 ms at 3.35 TB/s) and not FLOPs.
//  - One thread owns one (row, channel) and loops over L itself, with its N
//    fp32 states and A in registers. That loop takes the place of the TPU's
//    sequential L-chunk grid and its VMEM carry (@pl.when(l == 0)).
//  - A block holds kThreads channels of one row. It stages a tile of B and C
//    rows, which all its channels share, and its channels' u and delta in
//    shared memory, so that the loads of a tile are issued together and not
//    once per dependent step.
//  - The backward walks the sequence forward once and writes the state
//    before every kChunk-row chunk into a scratch buffer of the wrapper
//    (rows x ceil(L / 8) x N x D fp32: 2.47 GB at vssm_tiny stage 0, B=128,
//    freed after the call). The forward saves no carries: inference needs
//    none. Then it walks the chunks back to front, rebuilding each chunk's
//    states from its carry into shared memory and running the adjoint
//    chain over its rows in reverse.
//  - dA, dD and d delta_bias are sums in the thread's registers, written
//    per row; dB and dC are sums over D, taken per block from the staged
//    states and adjoints in a fixed order and written as per-block partials
//    that the wrapper sums. No atomics: the gradients are deterministic.
// The TPU-only parts have no counterpart: the padding to the chunk and the
// 128-lane block (_pad_to, _pick_chunk, _pick_block_d), the reversed index
// maps and vmem_limit_bytes.
//
// Both kernels launch on the caller's stream, allocate nothing, and the C
// functions return cudaGetLastError() so that the Python wrapper can raise
// on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 64;            // channels per block
constexpr int kTile = 32;               // rows staged per pass
constexpr int kChunk = 8;               // rows the backward rebuilds at once
constexpr int kS = kThreads + 1;        // padded stride of per-thread columns
static_assert(kTile % kChunk == 0, "a tile holds whole chunks");

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

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

struct Strides {
  long long b_rs, b_ts, c_rs, c_ts;  // B and C: row and step strides
};

// Stage rows t0 .. t0+nt-1 of B and C (nt x N floats each).
template <typename T, int N>
__device__ __forceinline__ void stage_bc(const T* bp, const T* cp,
                                         const Strides& st, int t0, int nt,
                                         float* b_s, float* c_s) {
  for (int i = threadIdx.x; i < nt * N; i += kThreads) {
    const int rr = i / N;
    const int n = i - rr * N;
    b_s[i] = to_float(bp[(t0 + rr) * st.b_ts + n]);
    c_s[i] = to_float(cp[(t0 + rr) * st.c_ts + n]);
  }
}

// Stage the block's channels of rows t0 .. t0+nt-1 of x (rows of stride
// `stride` floats in x_s; 0 past D).
template <typename T>
__device__ __forceinline__ void stage_cols(const T* x, size_t row0, int t0,
                                           int nt, int d0, int D, float* x_s,
                                           int stride) {
  for (int i = threadIdx.x; i < nt * kThreads; i += kThreads) {
    const int rr = i / kThreads;
    const int dd = i - rr * kThreads;
    x_s[rr * stride + dd] =
        d0 + dd < D ? to_float(x[row0 + static_cast<size_t>(t0 + rr) * D +
                                 d0 + dd])
                    : 0.0f;
  }
}

// grid (ceil(D / kThreads), rows), block kThreads, static smem
template <typename T, int N>
__global__ void __launch_bounds__(kThreads) selective_scan_fwd_kernel(
    const T* __restrict__ u, const T* __restrict__ delta,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ Dv,
    const float* __restrict__ dbias, T* __restrict__ y, int L, int D, int G,
    Strides st, int delta_softplus) {
  __shared__ float u_s[kTile * kThreads];
  __shared__ float dt_s[kTile * kThreads];
  __shared__ float b_s[kTile * N];
  __shared__ float c_s[kTile * N];

  const int r = blockIdx.y;
  const int g = r % G;
  const int d0 = blockIdx.x * kThreads;
  const int tid = threadIdx.x;
  const int d = d0 + tid;
  const bool active = d < D;
  const size_t row0 = static_cast<size_t>(r) * L * D;
  const T* bp = Bm + r * st.b_rs;
  const T* cp = Cm + r * st.c_rs;

  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = active ? A[(static_cast<size_t>(g) * D + d) * N + n] : 0.0f;
    h[n] = 0.0f;
  }
  const float bias = active ? dbias[g * D + d] : 0.0f;
  const float dskip = active ? Dv[g * D + d] : 0.0f;

  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int nt = min(kTile, L - t0);
    __syncthreads();  // the previous tile is consumed
    stage_bc<T, N>(bp, cp, st, t0, nt, b_s, c_s);
    stage_cols(u, row0, t0, nt, d0, D, u_s, kThreads);
    stage_cols(delta, row0, t0, nt, d0, D, dt_s, kThreads);
    __syncthreads();
    if (!active) continue;
    for (int rr = 0; rr < nt; ++rr) {
      const float uv = u_s[rr * kThreads + tid];
      float dt = dt_s[rr * kThreads + tid] + bias;
      if (delta_softplus) dt = softplus(dt);
      const float dtu = dt * uv;
      float out = 0.0f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(dt * a[n]) * h[n] + dtu * b_s[rr * N + n];
        out += c_s[rr * N + n] * h[n];
      }
      out += uv * dskip;
      y[row0 + static_cast<size_t>(t0 + rr) * D + d] = from_float<T>(out);
    }
  }
}

__host__ __device__ constexpr int bwd_smem_floats(int N) {
  return 2 * kTile * kThreads        // u, delta tiles of pass 1
         + 2 * kTile * N             // B, C tiles
         + 2 * kChunk * N * kS       // h_s, p_s
         + 6 * kChunk * kS;          // per-row scalars of pass 2
}

// grid (ceil(D / kThreads), rows), block kThreads, dynamic smem
// bwd_smem_floats(N) floats.
//
// Pass 1 walks the sequence forward, as the forward kernel does, and writes
// the state before every kChunk-row chunk into `carries` (rows, nchunks, N,
// D); the thread that writes a carry is the one that reads it back. Pass 2
// walks the chunks back to front: it rebuilds the chunk's states from its
// carry into shared memory, then runs the adjoint chain over the chunk's
// rows in reverse, the adjoint state g carried from the chunk after it.
//
// Outputs: du, ddelta (rows, L, D) in the source type; dB_part, dC_part
// (nblocks, rows, L, N) fp32, this block's sums over its channels; dA_out
// (rows, D, N), dD_out and ddb_out (rows, D) fp32, per row.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads) selective_scan_bwd_kernel(
    const T* __restrict__ u, const T* __restrict__ delta,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ Dv,
    const float* __restrict__ dbias, const T* __restrict__ dy,
    float* __restrict__ carries, T* __restrict__ du, T* __restrict__ ddelta,
    float* __restrict__ dB_part, float* __restrict__ dC_part,
    float* __restrict__ dA_out, float* __restrict__ dD_out,
    float* __restrict__ ddb_out, int L, int D, int G, Strides st,
    int delta_softplus) {
  extern __shared__ float smem[];
  float* ut_s = smem;                          // (kTile, kThreads)
  float* dtt_s = ut_s + kTile * kThreads;      // (kTile, kThreads)
  float* b_s = dtt_s + kTile * kThreads;       // (kTile, N)
  float* c_s = b_s + kTile * N;                // (kTile, N)
  float* h_s = c_s + kTile * N;                // (kChunk * N, kS)
  float* p_s = h_s + kChunk * N * kS;          // (kChunk * N, kS)
  float* u_s = p_s + kChunk * N * kS;          // 6 x (kChunk, kS)
  float* draw_s = u_s + kChunk * kS;           // delta as given
  float* dy_s = draw_s + kChunk * kS;
  float* dt_s = dy_s + kChunk * kS;            // dt after bias and softplus
  float* sg_s = dt_s + kChunk * kS;            // softplus'(dt_raw)
  float* dtu_s = sg_s + kChunk * kS;           // dt * u

  const int rows = gridDim.y;
  const int r = blockIdx.y;
  const int g = r % G;
  const int d0 = blockIdx.x * kThreads;
  const int tid = threadIdx.x;
  const int d = d0 + tid;
  // Inactive lanes (d >= D) run the same code on zeros, so that every lane
  // reaches every barrier and their shared-memory entries are 0.
  const bool active = d < D;
  const size_t row0 = static_cast<size_t>(r) * L * D;
  const T* bp = Bm + r * st.b_rs;
  const T* cp = Cm + r * st.c_rs;
  const int nchunks = (L + kChunk - 1) / kChunk;
  float* car = carries + static_cast<size_t>(r) * nchunks * N * D;

  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = active ? A[(static_cast<size_t>(g) * D + d) * N + n] : 0.0f;
    h[n] = 0.0f;
  }
  const float bias = active ? dbias[g * D + d] : 0.0f;
  const float dskip = active ? Dv[g * D + d] : 0.0f;

  // ---- pass 1: the states at chunk starts ------------------------------
  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int nt = min(kTile, L - t0);
    __syncthreads();
    stage_bc<T, N>(bp, cp, st, t0, nt, b_s, c_s);
    stage_cols(u, row0, t0, nt, d0, D, ut_s, kThreads);
    stage_cols(delta, row0, t0, nt, d0, D, dtt_s, kThreads);
    __syncthreads();
    for (int rr = 0; rr < nt; ++rr) {
      const int t = t0 + rr;
      if (t % kChunk == 0 && active) {
#pragma unroll
        for (int n = 0; n < N; ++n)
          car[(static_cast<size_t>(t / kChunk) * N + n) * D + d] = h[n];
      }
      float dt = dtt_s[rr * kThreads + tid] + bias;
      if (delta_softplus) dt = softplus(dt);
      const float dtu = dt * ut_s[rr * kThreads + tid];
#pragma unroll
      for (int n = 0; n < N; ++n)
        h[n] = expf(dt * a[n]) * h[n] + dtu * b_s[rr * N + n];
    }
  }

  // ---- pass 2: chunks back to front ------------------------------------
  float gc[N], dA[N], hc[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    gc[n] = 0.0f;
    dA[n] = 0.0f;
  }
  float dD = 0.0f, ddb = 0.0f;
  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int nt = min(kChunk, L - t0);
    __syncthreads();  // the previous chunk's sums are taken
    stage_bc<T, N>(bp, cp, st, t0, nt, b_s, c_s);
    stage_cols(u, row0, t0, nt, d0, D, u_s, kS);
    stage_cols(delta, row0, t0, nt, d0, D, draw_s, kS);
    stage_cols(dy, row0, t0, nt, d0, D, dy_s, kS);
    __syncthreads();

    // rebuild the chunk's states from its carry
#pragma unroll
    for (int n = 0; n < N; ++n) {
      hc[n] = active ? car[(static_cast<size_t>(c) * N + n) * D + d] : 0.0f;
      h[n] = hc[n];
    }
    for (int rr = 0; rr < nt; ++rr) {
      const float dt_raw = draw_s[rr * kS + tid] + bias;
      float dt = dt_raw, sg = 1.0f;
      if (delta_softplus) {
        dt = softplus(dt_raw);
        sg = 1.0f / (1.0f + expf(-dt_raw));
      }
      const float dtu = dt * u_s[rr * kS + tid];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(dt * a[n]) * h[n] + dtu * b_s[rr * N + n];
        h_s[(rr * N + n) * kS + tid] = h[n];
      }
      dt_s[rr * kS + tid] = dt;
      sg_s[rr * kS + tid] = sg;
      dtu_s[rr * kS + tid] = dtu;
    }

    // the adjoint chain over the chunk's rows, last row first
    for (int rr = nt - 1; rr >= 0; --rr) {
      const float dyv = dy_s[rr * kS + tid];
      const float uv = u_s[rr * kS + tid];
      const float dt = dt_s[rr * kS + tid];
      float gb = 0.0f, ddt_a = 0.0f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float p = c_s[rr * N + n] * dyv + gc[n];
        p_s[(rr * N + n) * kS + tid] = p;
        const float hp =
            rr > 0 ? h_s[((rr - 1) * N + n) * kS + tid] : hc[n];
        const float an = expf(dt * a[n]);
        const float dloga = p * hp * an;  // the gradient w.r.t. dt * A
        dA[n] += dloga * dt;
        ddt_a += dloga * a[n];
        gb += p * b_s[rr * N + n];
        gc[n] = an * p;
      }
      const float ddt = (ddt_a + gb * uv) * sg_s[rr * kS + tid];
      dD += dyv * uv;
      ddb += ddt;
      if (active) {
        const size_t o = row0 + static_cast<size_t>(t0 + rr) * D + d;
        du[o] = from_float<T>(dt * gb + dyv * dskip);
        ddelta[o] = from_float<T>(ddt);
      }
    }
    __syncthreads();

    // sums over this block's channels: the chunk's rows of dB and dC
    const size_t part =
        ((static_cast<size_t>(blockIdx.x) * rows + r) * L + t0) * N;
    for (int o = tid; o < 2 * nt * N; o += kThreads) {
      const bool is_c = o >= nt * N;
      const int i = is_c ? o - nt * N : o;
      const int rr = i / N;
      const float* x = is_c ? h_s : p_s;
      const float* w = is_c ? dy_s : dtu_s;
      float acc = 0.0f;
      for (int j = 0; j < kThreads; ++j)
        acc += x[i * kS + j] * w[rr * kS + j];
      (is_c ? dC_part : dB_part)[part + i] = acc;
    }
  }

  if (active) {
#pragma unroll
    for (int n = 0; n < N; ++n)
      dA_out[(static_cast<size_t>(r) * D + d) * N + n] = dA[n];
    dD_out[static_cast<size_t>(r) * D + d] = dD;
    ddb_out[static_cast<size_t>(r) * D + d] = ddb;
  }
}

struct Args {
  const void* u;
  const void* delta;
  const float* A;
  const void* B;
  const void* C;
  const float* Dv;
  const float* dbias;
  Strides st;
  int rows, L, D, G, delta_softplus;
};

template <typename T, int N>
cudaError_t launch_fwd(const Args& p, void* y, cudaStream_t stream) {
  const dim3 grid((p.D + kThreads - 1) / kThreads, p.rows);
  selective_scan_fwd_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(p.u), static_cast<const T*>(p.delta), p.A,
      static_cast<const T*>(p.B), static_cast<const T*>(p.C), p.Dv, p.dbias,
      static_cast<T*>(y), p.L, p.D, p.G, p.st, p.delta_softplus);
  return cudaGetLastError();
}

struct BwdOut {
  const void* dy;
  float* carries;
  void* du;
  void* ddelta;
  float* dB_part;
  float* dC_part;
  float* dA;
  float* dD;
  float* ddb;
};

template <typename T, int N>
cudaError_t launch_bwd(const Args& p, const BwdOut& o, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(bwd_smem_floats(N)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        selective_scan_bwd_kernel<T, N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.D + kThreads - 1) / kThreads, p.rows);
  selective_scan_bwd_kernel<T, N><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(p.u), static_cast<const T*>(p.delta), p.A,
      static_cast<const T*>(p.B), static_cast<const T*>(p.C), p.Dv, p.dbias,
      static_cast<const T*>(o.dy), o.carries, static_cast<T*>(o.du),
      static_cast<T*>(o.ddelta), o.dB_part, o.dC_part, o.dA, o.dD, o.ddb,
      p.L, p.D, p.G, p.st, p.delta_softplus);
  return cudaGetLastError();
}

// The d_state values the presets and tests use; any other is refused.
#define MIA_SS_STATES(X) X(1) X(4) X(8) X(16)

template <typename T>
cudaError_t dispatch_fwd(int N, const Args& p, void* y, cudaStream_t s) {
#define MIA_SS_CASE(NN) \
  case NN:              \
    return launch_fwd<T, NN>(p, y, s);
  switch (N) {
    MIA_SS_STATES(MIA_SS_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef MIA_SS_CASE
}

template <typename T>
cudaError_t dispatch_bwd(int N, const Args& p, const BwdOut& o,
                         cudaStream_t s) {
#define MIA_SS_CASE(NN) \
  case NN:              \
    return launch_bwd<T, NN>(p, o, s);
  switch (N) {
    MIA_SS_STATES(MIA_SS_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef MIA_SS_CASE
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch (0 on success).
int mia_selective_scan_fwd(const void* u, const void* delta, const float* A,
                           const void* B, const void* C, const float* Dv,
                           const float* dbias, void* y, int is_bf16, int rows,
                           int L, int D, int N, int G, long long b_rs,
                           long long b_ts, long long c_rs, long long c_ts,
                           int delta_softplus, void* stream) {
  if (rows < 1 || L < 1 || D < 1 || G < 1 || rows % G != 0)
    return cudaErrorInvalidValue;
  const Args p{u, delta, A, B, C, Dv, dbias, Strides{b_rs, b_ts, c_rs, c_ts},
               rows, L, D, G, delta_softplus};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_fwd<__nv_bfloat16>(N, p, y, s)
                 : dispatch_fwd<float>(N, p, y, s);
}

int mia_selective_scan_bwd(const void* u, const void* delta, const float* A,
                           const void* B, const void* C, const float* Dv,
                           const float* dbias, const void* dy, float* carries,
                           void* du, void* ddelta, float* dB_part,
                           float* dC_part, float* dA, float* dD, float* ddb,
                           int is_bf16, int rows, int L, int D, int N, int G,
                           long long b_rs, long long b_ts, long long c_rs,
                           long long c_ts, int delta_softplus, void* stream) {
  if (rows < 1 || L < 1 || D < 1 || G < 1 || rows % G != 0)
    return cudaErrorInvalidValue;
  const Args p{u, delta, A, B, C, Dv, dbias, Strides{b_rs, b_ts, c_rs, c_ts},
               rows, L, D, G, delta_softplus};
  const BwdOut o{dy, carries, du, ddelta, dB_part, dC_part, dA, dD, ddb};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_bwd<__nv_bfloat16>(N, p, o, s)
                 : dispatch_bwd<float>(N, p, o, s);
}

}  // extern "C"
