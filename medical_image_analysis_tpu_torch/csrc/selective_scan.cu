// The general selective scan (Mamba S6) for Hopper (sm_90a): two kernels.
//
// They replace the two Pallas TPU kernels of
// medical_image_analysis_tpu/ops/selective_scan_pallas.py:
//
//   selective_scan_fwd_kernel  <- _fwd_kernel (:108, launched at :305; the
//                                 S6 scan over given delta, B and C, delta
//                                 bias, optional softplus, D skip; see "the
//                                 forward")
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
// of L dependent steps per (row, channel), each N exps and about 4N other
// operations.
//  - The forward: at vssm_tiny stage 0, B=128 (512 rows, L 3,136, D 192,
//    N 16) fp32 it moves about 3.9 GB (1.17 ms at 3.35 TB/s), and its 4.9 G
//    exps go through the special-function units, 16 lanes an SM a clock:
//    about 1.3 ms at 1.755 GHz, a floor above the byte bound that
//    chip_smoke's bound does not count. It ran as one thread a (row,
//    channel) over all of L with 16 accurate expf a step, B and C read as
//    2N scalar loads, a 16-add dependent readout and each 32-row tile
//    loaded synchronously between two barriers: 4.80 ms at that shape and
//    0.091 ms at ARM-B's one image (48 blocks on 132 SMs), on an H100
//    80GB HBM3 at 700 W. It is now a leaner walk in one pass (2.25 ms
//    there, 0.055 ms at one image): see "the forward" below.
//  - The backward: one thread owns one (row, channel) and loops over L
//    itself, with its N fp32 states and A in registers. That loop takes the
//    place of the TPU's sequential L-chunk grid and its VMEM carry
//    (@pl.when(l == 0)). A block holds kThreads channels of one row. It
//    stages a tile of B and C rows, which all its channels share, and its
//    channels' u and delta in shared memory, so that the loads of a tile
//    are issued together and not once per dependent step.
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
//    deterministic, and so is the forward.
// The TPU-only parts have no counterpart: the padding to the chunk and the
// 128-lane block (_pad_to, _pick_chunk, _pick_block_d), the reversed index
// maps and vmem_limit_bytes.
//
// Both kernels launch on the caller's stream, allocate nothing, and the C
// functions return cudaGetLastError() so that the Python wrapper can raise
// on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

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

// ---- the forward ------------------------------------------------------------
//
// selective_scan_fwd_kernel: one pass over L, a block kThreads channels of
// one row, from a zero state.
//
// The walk: a thread owns one channel and its N fp32 states, A[n] log2(e)
// in registers. A step is dt = softplus(delta + bias) and dt u once, then
// for every n a decay ex2.approx(dt A[n] log2 e) (the special-function
// unit's exp2, relative error under 2^-22, where expf is about eight
// instructions), h = decay h + dt u B[n] and the readout C[n] h summed in
// four partial sums (no chain of N dependent adds), then + D u, written in
// the source dtype. The
// softplus takes its exp the same way and keeps log1pf (lg2(1 + e) would
// round the small exps of large negative inputs away). B and C of a row,
// which the block's channels share, are read from shared memory as float4
// broadcasts. The rows come kSub at a time through kStages buffers, the
// next kStages - 1 tiles in flight while one is walked, one barrier a
// tile: u and delta by 16-byte cp.async (plain loads where a row of D is
// not a multiple of 16 bytes); B and C of fp32 sources by 4-byte cp.async,
// each thread one column of B or C (a slice of x_dbl starts at any 4-byte
// offset, as B at 24 bytes into a 152-byte row at vssm_tiny stage 0), of
// bf16 sources by plain loads into registers, converted and stored after
// the walk. Registers are capped for kFwdBlocks blocks an SM (80, no
// spill), so that vssm_tiny stage 0 at B=128 (1,536 blocks) runs in one
// wave on 132 SMs.
//
// What bounds it (on an H100 80GB HBM3 at 700 W, vssm_tiny stage 0, B=128,
// fp32): 2.25 ms against 4.80 before and a 1.17 ms byte bound. Variants
// with one part taken out (time only), priced on a version whose staging
// cost more (2.51 ms): without the staging past the first tiles 1.85,
// without the softplus 2.12, without the decays' exps 2.27, without the y
// stores 2.37. So the instructions issued (about 150 a step, 17 of them on
// the special-function unit) and the staging share the time; the exps'
// floor (about 1.3 ms) and the bytes sit under it. Tiles of 8 rows, and B
// and C staged through registers, spilled up to 100 bytes at the cap.

constexpr int kSub = 4;             // rows the forward stages at once
constexpr int kStages = 4;          // tiles in flight or walked: buffers
constexpr int kFwdBlocks = 12;      // the forward's resident blocks an SM
constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the special-function unit; results below 2^-126 flush to 0, which
// forgets a state as an underflow does.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// softplus() with its exp by exp2_approx.
__device__ __forceinline__ float softplus_fast(float x) {
  return fmaxf(x, 0.0f) + log1pf(exp2_approx(-fabsf(x) * kLog2e));
}

// 16-byte cp.async into shared memory; with `valid` false it writes 0.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}
// 4-byte cp.async into shared memory.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits until at most `kPending` of this thread's latest groups are in
// flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ float element(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// A forward block's shared memory: kStages buffers of a tile's B and C
// rows (kSub, 2N) fp32, then kStages of its u and delta rows of the
// block's channels (2, kSub, kThreads) in the source type. 10,240 bytes at
// N = 16 in fp32.
template <typename T, int N>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return kStages * kSub * 2 * N * static_cast<int>(sizeof(float)) +
         kStages * 2 * kSub * kThreads * static_cast<int>(sizeof(T));
}

// What the forward kernel takes.
struct FwdArgs {
  const void* u;
  const void* delta;
  const float* A;
  const void* B;
  const void* C;
  const float* Dv;
  const float* dbias;
  void* y;
  Strides st;
  int L, D, G, delta_softplus;
  int vec;  // u and delta rows staged by 16-byte cp.async
};

// Element tid + kThreads j of a tile's (kSub, 2N) B and C rows is this
// thread's to stage, for j < bc_share<N>(): as 2N divides kThreads, a
// thread keeps one column c = tid % 2N of B (c < N) or C, in rows
// tid / 2N + j * bc_rows<N>() of each tile.
template <int N>
__host__ __device__ constexpr int bc_share() {
  return (kSub * 2 * N + kThreads - 1) / kThreads;
}
template <int N>
__host__ __device__ constexpr int bc_rows() {
  return kThreads / (2 * N);
}
// This thread's share of rows [t0, t0 + ns) of B and C, from col, its
// column of the row's B or C at step 0, whose step stride is ts: fp32
// sources straight into the tile's fp32 rows in bc by 4-byte cp.async (any
// offset of a slice of x_dbl is 4-byte aligned); bf16 sources into v, by
// plain loads, for store_bc to convert and store after the walk of the
// current tile (0 past the tile).
template <typename T, int N>
__device__ __forceinline__ void stage_bc_tile(const T* col, int ts, int t0,
                                              int ns, float* bc,
                                              float (&v)[bc_share<N>()]) {
  static_assert(kThreads % (2 * N) == 0, "a thread keeps one column");
  const unsigned tid = threadIdx.x;
  const int r0 = static_cast<int>(tid / (2 * N));
  const T* g = col + (t0 + r0) * ts;
#pragma unroll
  for (int j = 0; j < bc_share<N>(); ++j) {
    const int r = r0 + j * bc_rows<N>();
    const bool in = r < kSub && r < ns;
    if constexpr (sizeof(T) == sizeof(float)) {
      if (in)
        cp_async4(bc + tid + j * kThreads,
                  reinterpret_cast<const float*>(g + j * bc_rows<N>() * ts));
    } else {
      v[j] = in ? to_float(g[j * bc_rows<N>() * ts]) : 0.0f;
    }
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_bc(const float (&v)[bc_share<N>()],
                                         float* bc) {
  if constexpr (sizeof(T) != sizeof(float)) {
#pragma unroll
    for (int j = 0; j < bc_share<N>(); ++j) {
      const int e = threadIdx.x + j * kThreads;
      if (e < kSub * 2 * N) bc[e] = v[j];
    }
  }
}

// Start the loads of rows [t0, t0 + ns) of u and delta, the block's
// channels [d0, d0 + kThreads) (ub, db: the row's u and delta at channel
// d0), into ud (2, kSub, kThreads): by 16-byte cp.async with `vec` (a row
// of D a multiple of 16 bytes, both tensors 16-byte aligned: a granule is
// all in D or all past it, and past it zero-filled), else by plain loads,
// each thread its own channel (0 past D), and commit the group. Rows past
// ns are left as they are: the walk stops before them.
template <typename T>
__device__ __forceinline__ void stage_ud(const T* ub, const T* db, int t0,
                                         int ns, int dleft, int D, bool vec,
                                         T* ud) {
  constexpr int kPer = 16 / sizeof(T);         // elements a granule
  constexpr int kRowG = kThreads / kPer;       // granules a row
  constexpr int kAll = 2 * kSub * kRowG;       // granules a tile
  static_assert(kAll % kThreads == 0, "granules split evenly");
  if (vec) {
#pragma unroll
    for (int j = 0; j < kAll / kThreads; ++j) {
      const unsigned i = threadIdx.x + j * kThreads;
      const int arr = static_cast<int>(i / (kSub * kRowG));
      const unsigned rem = i % (kSub * kRowG);
      const int r = static_cast<int>(rem / kRowG);
      const int e = static_cast<int>(rem % kRowG) * kPer;
      if (r < ns) {
        const T* src = arr ? db : ub;
        const bool valid = e < dleft;
        cp_async16(ud + (arr * kSub + r) * kThreads + e,
                   valid ? src + (t0 + r) * D + e : src, valid);
      }
    }
  } else {
    const int dd = threadIdx.x;
#pragma unroll
    for (int arr = 0; arr < 2; ++arr) {
      const T* src = arr ? db : ub;
      for (int r = 0; r < ns; ++r)
        ud[(arr * kSub + r) * kThreads + dd] =
            dd < dleft ? src[(t0 + r) * D + dd] : from_float<T>(0.0f);
    }
  }
  cp_async_commit();
}

// grid (ceil(D / kThreads), rows), block kThreads, static smem
// fwd_smem_bytes<T, N>(): channels [d0, d0 + kThreads) of row blockIdx.y
// over all of L (see "the forward" above).
template <typename T, int N>
__global__ void __launch_bounds__(kThreads, kFwdBlocks)
    selective_scan_fwd_kernel(FwdArgs p) {
  __shared__ float4 smem4[fwd_smem_bytes<T, N>() / 16];
  float* const bc_s = reinterpret_cast<float*>(smem4);  // kStages buffers
  T* const ud_s = reinterpret_cast<T*>(bc_s + kStages * kSub * 2 * N);
  const int L = p.L, D = p.D;
  const int d0 = blockIdx.x * kThreads;
  const int r = blockIdx.y;
  const int g = r % p.G;
  const int tid = threadIdx.x;
  const int d = d0 + tid;
  // Threads of channels past D run the same code on zeros, so that every
  // thread reaches every barrier.
  const bool active = d < D;
  // The row's u, delta and y at channel d0, offset by t * D + channel; its
  // B and C rows.
  const size_t row0 = static_cast<size_t>(r) * L * D + d0;
  const T* ub = static_cast<const T*>(p.u) + row0;
  const T* db = static_cast<const T*>(p.delta) + row0;
  T* yb = static_cast<T*>(p.y) + row0 + tid;
  // this thread's column of B or C (bc_share), at step 0, and its stride
  const int bcc = static_cast<int>(threadIdx.x % (2 * N));
  const bool is_c = bcc >= N;
  const T* col = is_c ? static_cast<const T*>(p.C) + r * p.st.c_rs + bcc - N
                      : static_cast<const T*>(p.B) + r * p.st.b_rs + bcc;
  const int ts = static_cast<int>(is_c ? p.st.c_ts : p.st.b_ts);

  float a2[N], h[N];  // a2: A log2(e)
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = active ? p.A[(static_cast<size_t>(g) * D + d) * N + n] * kLog2e
                   : 0.0f;
    h[n] = 0.0f;
  }
  const float bias = active ? p.dbias[g * D + d] : 0.0f;
  const float dskip = active ? p.Dv[g * D + d] : 0.0f;

  float bcv[bc_share<N>()];  // bf16 sources: a tile's B and C
  const int nsub = (L + kSub - 1) / kSub;
  // Tile i goes to buffer i % kStages; tiles 0 .. kStages - 2 are in
  // flight before the walk starts, and tile j + kStages - 1 is started as
  // tile j is walked. Every step commits one group (empty past the last
  // tile), so that waiting for all but the latest kStages - 2 groups
  // waits for tile j.
  const auto stage = [&](int i) {
    if (i < nsub) {
      const int b = static_cast<int>(static_cast<unsigned>(i) % kStages);
      const int ns = min(kSub, L - i * kSub);
      stage_bc_tile<T, N>(col, ts, i * kSub, ns, bc_s + b * kSub * 2 * N,
                          bcv);
      stage_ud(ub, db, i * kSub, ns, D - d0, D, p.vec != 0,
               ud_s + b * 2 * kSub * kThreads);
    } else {
      cp_async_commit();
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    stage(i);
    if (i < nsub) store_bc<T, N>(bcv, bc_s + i * kSub * 2 * N);
  }
  for (int j = 0; j < nsub; ++j) {
    const int buf = static_cast<int>(static_cast<unsigned>(j) % kStages);
    const int t0 = j * kSub;
    const int ns = min(kSub, L - j * kSub);
    const int ahead = j + kStages - 1;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile j staged; the walk of tile j - 1 is done
    stage(ahead);
    const T* us = ud_s + buf * 2 * kSub * kThreads;
    const T* ds = us + kSub * kThreads;
    const float* bc = bc_s + buf * kSub * 2 * N;
    T* yt = yb + t0 * D;
#pragma unroll
    for (int rr = 0; rr < kSub; ++rr) {
      if (rr >= ns) break;
      const float dr = to_float(ds[rr * kThreads + tid]) + bias;
      const float dt = p.delta_softplus ? softplus_fast(dr) : dr;
      const float uv = to_float(us[rr * kThreads + tid]);
      const float dtu = dt * uv;
      const float* row = bc + rr * 2 * N;  // B, then C
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if constexpr (N % 4 == 0) {
#pragma unroll
        for (int v = 0; v < N; v += 4) {
          const float4 bv = *reinterpret_cast<const float4*>(row + v);
          const float4 cv = *reinterpret_cast<const float4*>(row + N + v);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            h[v + e] = exp2_approx(dt * a2[v + e]) * h[v + e] +
                       dtu * element(bv, e);
            acc[e] += element(cv, e) * h[v + e];
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = exp2_approx(dt * a2[n]) * h[n] + dtu * row[n];
          acc[n & 3] += row[N + n] * h[n];
        }
      }
      if (active)
        yt[rr * D] =
            from_float<T>((acc[0] + acc[1]) + (acc[2] + acc[3]) + uv * dskip);
    }
    if (ahead < nsub)
      store_bc<T, N>(bcv, bc_s + (static_cast<unsigned>(ahead) % kStages) *
                                     kSub * 2 * N);
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
static_assert(bwd_smem_floats(32) * 4 <= 227 * 1024,
              "N = 32 fits a block's opt-in shared memory");

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
// of two, at most 32; the backward takes 2N = 64 as two 32s): log2 M transposing steps (31 shuffles sum 32
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
      if constexpr (M <= 32) {
        const float sum = warp_sums<M>(terms, lane);
        if ((lane & ((32 / M) - 1)) == 0)
          sum_s[(warp * kChunk + rr) * M + (lane >> (5 - log2i(M)))] = sum;
      } else {
        // N = 32: the sums of each 32 of the 2N terms in turn; lane l
        // holds term 32 q + l of part q.
#pragma unroll
        for (int q = 0; q < M / 32; ++q) {
          float(&part)[32] = *reinterpret_cast<float(*)[32]>(terms + 32 * q);
          sum_s[(warp * kChunk + rr) * M + 32 * q + lane] =
              warp_sums<32>(part, lane);
        }
      }
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

// Asks for the largest shared-memory carveout for `kernel`, so that its
// cap of blocks an SM can be resident; once a device (`done` holds a bit a
// device that has it, as the setting belongs to the device's context).
cudaError_t max_carveout(const void* kernel, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <typename T, int N>
cudaError_t configure_fwd() {
  static std::atomic<unsigned> done{0};
  return max_carveout(
      reinterpret_cast<const void*>(selective_scan_fwd_kernel<T, N>), done);
}

template <typename T, int N>
cudaError_t launch_fwd(const Args& p, void* y, cudaStream_t stream) {
  const cudaError_t err = configure_fwd<T, N>();
  if (err != cudaSuccess) return err;
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  const FwdArgs a{p.u, p.delta, p.A, p.B, p.C, p.Dv, p.dbias, y, p.st, p.L,
                  p.D, p.G, p.delta_softplus,
                  p.D % static_cast<int>(16 / sizeof(T)) == 0 &&
                      aligned(p.u) && aligned(p.delta)};
  const dim3 grid((p.D + kThreads - 1) / kThreads, p.rows);
  selective_scan_fwd_kernel<T, N><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// The forward's resident blocks an SM on the current device, at its
// launch's block and shared memory.
template <typename T, int N>
cudaError_t occupancy_fwd(int* blocks, int* smem_bytes) {
  const cudaError_t err = configure_fwd<T, N>();
  if (err != cudaSuccess) return err;
  *smem_bytes = fwd_smem_bytes<T, N>();
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, selective_scan_fwd_kernel<T, N>, kThreads, 0);
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
cudaError_t configure_bwd() {
  static std::atomic<unsigned> done{0};
  const void* kernel =
      reinterpret_cast<const void*>(selective_scan_bwd_kernel<T, N>);
  // Past 48 KB (N = 32: 71,680 bytes) a block's dynamic shared memory
  // needs the opt-in; it is set with the carveout, once a device.
  constexpr int smem = bwd_smem_floats(N) * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  return max_carveout(kernel, done);
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

// The d_state widths the kernels are built for; the wrapper pads any
// other N up to the next of them and splits N past 32 into groups.
#define MIA_SS_STATES(X) X(1) X(4) X(8) X(16) X(32)

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
cudaError_t dispatch_fwd_occupancy(int N, int* blocks, int* smem_bytes) {
#define MIA_SS_CASE(NN) \
  case NN:              \
    return occupancy_fwd<T, NN>(blocks, smem_bytes);
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
  // int offsets within a row of u, delta, y, B and C
  const long long most = 2147483647LL;
  if (rows < 1 || L < 1 || D < 1 || G < 1 || rows % G != 0 ||
      rows > 65535 || static_cast<long long>(L) * D > most ||
      static_cast<long long>(L) * b_ts > most ||
      static_cast<long long>(L) * c_ts > most || b_ts < 0 || c_ts < 0)
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

// The forward kernel's resident blocks an SM on the current device (at
// its launch's 64 threads and static shared memory) into *blocks, and that
// shared memory in bytes into *smem_bytes.
int mia_selective_scan_fwd_blocks_per_sm(int N, int is_bf16, int* blocks,
                                         int* smem_bytes) {
  return is_bf16 ? dispatch_fwd_occupancy<__nv_bfloat16>(N, blocks,
                                                         smem_bytes)
                 : dispatch_fwd_occupancy<float>(N, blocks, smem_bytes);
}

}  // extern "C"
