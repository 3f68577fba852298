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
//  - The backward's three walks are latency-bound: a lone warp on a
//    scheduler waits out every exp, FMA and shared-memory access. So its
//    design is set by occupancy: at most 37 KB of shared memory and 168
//    registers a block of 64 threads, for 6 blocks (12 warps) an SM. Every
//    thread reads only its own channel's column of the rebuilt states
//    (stride kThreads, no padding); it holds its channel's u, dt,
//    softplus'(dt) and dy of the chunk's rows in registers; pass 1's tiles
//    lie where pass 2's states go.
//  - dA, dD and d delta_bias are sums in the thread's registers, written
//    per row. dB and dC are the only sums over channels: a transposing
//    reduction of warp shuffles sums each row's 2N terms over a warp, the
//    block adds its warps' sums in a fixed order and writes per-block
//    partials that the wrapper sums. No atomics: the gradients are
//    deterministic.
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

constexpr int kWarps = kThreads / 32;

__host__ __device__ constexpr int log2i(int x) {
  return x > 1 ? 1 + log2i(x / 2) : 0;
}

// The backward's shared memory, the larger of its two passes' plans:
//   pass 1: u and delta tiles (kTile, kThreads), B and C tiles (kTile, N);
//   pass 2: h_s (kChunk, N, kThreads), the chunk's B and C (kChunk, N), and
//           sum_s (kWarps, kChunk, 2N), each warp's sums of dB and dC.
// Pass 1's tiles lie where pass 2's h_s goes: 35,840 bytes at N = 16.
__host__ __device__ constexpr int bwd_pass1_floats(int N) {
  return 2 * kTile * kThreads + 2 * kTile * N;
}
__host__ __device__ constexpr int bwd_pass2_floats(int N) {
  return kChunk * N * kThreads + 2 * kChunk * N + kWarps * kChunk * 2 * N;
}
__host__ __device__ constexpr int bwd_smem_floats(int N) {
  return bwd_pass1_floats(N) > bwd_pass2_floats(N) ? bwd_pass1_floats(N)
                                                   : bwd_pass2_floats(N);
}
// Under the 48 KB a block takes without an opt-in, and small enough for
// kBwdBlocks blocks of an SM's 228 KB (1 KB of it reserved for each).
constexpr int kBwdBlocks = 6;
static_assert(bwd_smem_floats(16) * 4 <= 48 * 1024, "no opt-in needed");
static_assert(kBwdBlocks * (bwd_smem_floats(16) * 4 + 1024) <= 228 * 1024,
              "kBwdBlocks blocks of the backward fit an SM");

// One step of a transposing reduction over a warp, of the first 2 * Half
// of a lane's values: the lane keeps one half, sends the other to the lane
// `off` away and adds what comes back. Each step is its own instantiation,
// so that every index into v is a constant and v stays in registers (with
// a loop over the steps v went to local memory, and the kernel took 1.6
// times as long on an H100).
template <int M, int Half>
__device__ __forceinline__ void transpose_steps(float (&v)[M], int lane) {
  if constexpr (Half > 0) {
    constexpr int off = 32 * Half / M;
    const bool up = lane & off;
#pragma unroll
    for (int j = 0; j < Half; ++j) {
      const float send = up ? v[j] : v[j + Half];
      const float keep = up ? v[j + Half] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    transpose_steps<M, Half / 2>(v, lane);
  }
}

// The sums over a warp's 32 lanes of each of M values v[0..M-1] (M a power
// of two, at most 32): log2 M transposing steps (31 shuffles sum 32
// values), then butterflies for what is left when M < 32. Returns, in lane
// l, the sum of value l >> (5 - log2 M). The order of the additions is
// fixed.
template <int M>
__device__ __forceinline__ float warp_sums(float (&v)[M], int lane) {
  transpose_steps<M, M / 2>(v, lane);
  float sum = v[0];
#pragma unroll
  for (int off = 16 >> log2i(M); off > 0; off /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  return sum;
}

// grid (ceil(D / kThreads), rows), block kThreads, dynamic smem
// bwd_smem_floats(N) floats.
//
// Pass 1 walks the sequence forward, as the forward kernel does, and writes
// the state before every kChunk-row chunk into `carries` (rows, nchunks, N,
// D); the thread that writes a carry is the one that reads it back. Pass 2
// walks the chunks back to front: it rebuilds the chunk's states from its
// carry into its own column of h_s, then runs the adjoint chain over the
// chunk's rows in reverse, the adjoint state g carried from the chunk after
// it. A thread reads only its own column of h_s and holds its channel's
// u, dt, softplus'(dt) and dy of the chunk's rows in registers; the only
// sums across channels, dB's and dC's, are taken by warp shuffles.
//
// Outputs: du, ddelta (rows, L, D) in the source type; dB_part, dC_part
// (nblocks, rows, L, N) fp32, this block's sums over its channels; dA_out
// (rows, D, N), dD_out and ddb_out (rows, D) fp32, per row.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads, kBwdBlocks)
selective_scan_bwd_kernel(
    const T* __restrict__ u, const T* __restrict__ delta,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ Dv,
    const float* __restrict__ dbias, const T* __restrict__ dy,
    float* __restrict__ carries, T* __restrict__ du, T* __restrict__ ddelta,
    float* __restrict__ dB_part, float* __restrict__ dC_part,
    float* __restrict__ dA_out, float* __restrict__ dD_out,
    float* __restrict__ ddb_out, int L, int D, int G, Strides st,
    int delta_softplus) {
  constexpr int M = 2 * N;  // dB's and dC's terms of one row
  extern __shared__ float smem[];
  float* h_s = smem;                         // (kChunk * N, kThreads)
  float* b_s = h_s + kChunk * N * kThreads;  // (kChunk, N)
  float* c_s = b_s + kChunk * N;             // (kChunk, N)
  float* sum_s = c_s + kChunk * N;           // (kWarps, kChunk, M)
  float* ut_s = smem;                        // pass 1: (kTile, kThreads)
  float* dtt_s = ut_s + kTile * kThreads;    // (kTile, kThreads)
  float* bt_s = dtt_s + kTile * kThreads;    // (kTile, N)
  float* ct_s = bt_s + kTile * N;            // (kTile, N)

  const int rows = gridDim.y;
  const int r = blockIdx.y;
  const int g = r % G;
  const int d0 = blockIdx.x * kThreads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d = d0 + tid;
  // Inactive lanes (d >= D) run the same code on zeros, so that every lane
  // reaches every barrier and shuffle and adds 0 to the sums.
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
    stage_bc<T, N>(bp, cp, st, t0, nt, bt_s, ct_s);
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
        h[n] = expf(dt * a[n]) * h[n] + dtu * bt_s[rr * N + n];
    }
  }

  // ---- pass 2: chunks back to front ------------------------------------
  float gc[N], dA[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    gc[n] = 0.0f;
    dA[n] = 0.0f;
  }
  float dD = 0.0f, ddb = 0.0f;
  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int nt = min(kChunk, L - t0);
    // this thread's channel of the chunk's rows (0 past D and past L)
    float uv[kChunk], dtv[kChunk], sgv[kChunk], dyv[kChunk];
#pragma unroll
    for (int rr = 0; rr < kChunk; ++rr) {
      const bool in = active && rr < nt;
      const size_t o = row0 + static_cast<size_t>(t0 + rr) * D + d;
      uv[rr] = in ? to_float(u[o]) : 0.0f;
      dtv[rr] = in ? to_float(delta[o]) : 0.0f;
      dyv[rr] = in ? to_float(dy[o]) : 0.0f;
    }
#pragma unroll
    for (int n = 0; n < N; ++n)
      h[n] = active ? car[(static_cast<size_t>(c) * N + n) * D + d] : 0.0f;
    __syncthreads();  // pass 1's tiles, or the previous chunk's sums, taken
    stage_bc<T, N>(bp, cp, st, t0, nt, b_s, c_s);
    __syncthreads();

    // rebuild the chunk's states: slot rr of h_s holds the state before
    // row rr, and h the state after row nt - 1
#pragma unroll
    for (int n = 0; n < N; ++n) h_s[n * kThreads + tid] = h[n];
#pragma unroll
    for (int rr = 0; rr < kChunk; ++rr) {
      if (rr >= nt) break;
      const float dt_raw = dtv[rr] + bias;
      float dt = dt_raw, sg = 1.0f;
      if (delta_softplus) {
        dt = softplus(dt_raw);
        sg = 1.0f / (1.0f + expf(-dt_raw));
      }
      dtv[rr] = dt;
      sgv[rr] = sg;
      const float dtu = dt * uv[rr];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(dt * a[n]) * h[n] + dtu * b_s[rr * N + n];
        if (rr + 1 < nt) h_s[((rr + 1) * N + n) * kThreads + tid] = h[n];
      }
    }

    // the adjoint chain over the chunk's rows, last row first; h holds the
    // state after row rr
#pragma unroll
    for (int rr = kChunk - 1; rr >= 0; --rr) {
      if (rr >= nt) continue;
      const float dyr = dyv[rr];
      const float ur = uv[rr];
      const float dt = dtv[rr];
      const float dtu = dt * ur;
      float terms[M];  // p * dtu for dB, h * dy for dC
      float gb = 0.0f, ddt_a = 0.0f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float p = c_s[rr * N + n] * dyr + gc[n];
        const float hp = h_s[(rr * N + n) * kThreads + tid];
        const float an = expf(dt * a[n]);
        const float dloga = p * hp * an;  // the gradient w.r.t. dt * A
        dA[n] += dloga * dt;
        ddt_a += dloga * a[n];
        gb += p * b_s[rr * N + n];
        gc[n] = an * p;
        terms[n] = p * dtu;
        terms[N + n] = h[n] * dyr;
        h[n] = hp;
      }
      const float ddt = (ddt_a + gb * ur) * sgv[rr];
      dD += dyr * ur;
      ddb += ddt;
      if (active) {
        const size_t o = row0 + static_cast<size_t>(t0 + rr) * D + d;
        du[o] = from_float<T>(dt * gb + dyr * dskip);
        ddelta[o] = from_float<T>(ddt);
      }
      const float sum = warp_sums<M>(terms, lane);
      if ((lane & ((32 / M) - 1)) == 0)
        sum_s[(warp * kChunk + rr) * M + (lane >> (5 - log2i(M)))] = sum;
    }
    __syncthreads();

    // the block's sums: the warps' in a fixed order, the chunk's rows of
    // dB and dC
    const size_t part =
        ((static_cast<size_t>(blockIdx.x) * rows + r) * L + t0) * N;
    for (int o = tid; o < 2 * nt * N; o += kThreads) {
      const bool is_c = o >= nt * N;
      const int i = is_c ? o - nt * N : o;
      const int rr = i / N;
      const int k = rr * M + (is_c ? N : 0) + (i - rr * N);
      float acc = sum_s[k];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) acc += sum_s[w * kChunk * M + k];
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

// Asks for the largest shared-memory carveout, so that kBwdBlocks blocks of
// the backward can be resident on an SM.
template <typename T, int N>
cudaError_t configure_bwd() {
  return cudaFuncSetAttribute(selective_scan_bwd_kernel<T, N>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T, int N>
cudaError_t launch_bwd(const Args& p, const BwdOut& o, cudaStream_t stream) {
  const cudaError_t err = configure_bwd<T, N>();
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(bwd_smem_floats(N)) * sizeof(float);
  const dim3 grid((p.D + kThreads - 1) / kThreads, p.rows);
  selective_scan_bwd_kernel<T, N><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(p.u), static_cast<const T*>(p.delta), p.A,
      static_cast<const T*>(p.B), static_cast<const T*>(p.C), p.Dv, p.dbias,
      static_cast<const T*>(o.dy), o.carries, static_cast<T*>(o.du),
      static_cast<T*>(o.ddelta), o.dB_part, o.dC_part, o.dA, o.dD, o.ddb,
      p.L, p.D, p.G, p.st, p.delta_softplus);
  return cudaGetLastError();
}

// The backward's resident blocks an SM on the current device, at its
// launch's block and shared memory.
template <typename T, int N>
cudaError_t occupancy_bwd(int* blocks, int* smem_bytes) {
  const cudaError_t err = configure_bwd<T, N>();
  if (err != cudaSuccess) return err;
  *smem_bytes = bwd_smem_floats(N) * static_cast<int>(sizeof(float));
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, selective_scan_bwd_kernel<T, N>, kThreads, *smem_bytes);
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

template <typename T>
cudaError_t dispatch_occupancy(int N, int* blocks, int* smem_bytes) {
#define MIA_SS_CASE(NN) \
  case NN:              \
    return occupancy_bwd<T, NN>(blocks, smem_bytes);
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

// The backward kernel's resident blocks an SM on the current device
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at its launch's 64 threads
// and dynamic shared memory) into *blocks, and that shared memory in bytes
// into *smem_bytes.
int mia_selective_scan_bwd_blocks_per_sm(int N, int is_bf16, int* blocks,
                                         int* smem_bytes) {
  return is_bf16 ? dispatch_occupancy<__nv_bfloat16>(N, blocks, smem_bytes)
                 : dispatch_occupancy<float>(N, blocks, smem_bytes);
}

}  // extern "C"
