// d_state=1 four-direction VMamba scan for Hopper (sm_90a): the three
// kernels of the forward and the three of the backward.
//
// They replace the two Pallas TPU kernels of
// medical_image_analysis_tpu/ops/scan_n1.py:
//
//   scan_n1_fwd_sums_kernel,
//   scan_n1_fwd_carry_kernel,
//   scan_n1_fwd_kernel       <- _fwd_kernel (:89, launched at :316)
//   scan_n1_bwd_sums_kernel,
//   scan_n1_bwd_carry_kernel,
//   scan_n1_bwd_grad_kernel  <- _bwd_kernel (:150, launched at :412)
//
// At N=1 the selective scan is a per-channel linear recurrence with scalar
// B and C per row:
//
//   dt[t,d] = softplus(x_dbl[t,:R] . W_dt[d,:] + bias[d])
//   h[t,d]  = exp(dt[t,d] * A[d]) * h[t-1,d] + dt[t,d] * B[t] * u[t,d]
//   y[t,d]  = C[t] * h[t,d] + D[d] * u[t,d]
//
// Layouts (all contiguous):
//   xr, xc   (B, L, D) row-major / column-major sources, fp32 or bf16
//   xdbl     (4, B, L, R+2) fp32, direction k in reference order
//            [row, col, row-rev, col-rev], rows in SOURCE order; columns
//            [dt_r (R) | B | C]
//   dtw      (4, D, R) fp32; dt_bias, A, Dv (4, D) fp32
//   y        (2, B, L, D) in the source dtype: y[s] is the sum of
//            direction s (scanned front to back) and direction s+2 (back
//            to front) of source s, each rounded to the source dtype and
//            added in it, as the TPU's aliased accumulation
//            (scan_n1.py:140-147) gives it.
//
// What bounds them on the H100, and what the design does about it:
//  - Each is a chain of L dependent steps per channel (L = 3136 at stage 0
//    of vssm1_base), so latency, not bytes or FLOPs, bounds it where one
//    thread walks a chain. dt_proj runs in the kernels, as the TPU kernel
//    runs it in its body (the fp32 (B, 4, L, D) dt tensor never exists):
//    W_dt's R columns for the block's channels sit in shared memory. Every
//    per-row term (dt's dot product, softplus, the decay, the input term;
//    in the backward also the terms after the adjoint) is computed for a
//    run of rows at once, with the rows interleaved in registers, so that
//    the dependent chain carries one FMA a step, as the TPU kernel's does.
//  - Both the forward and the backward run in parallel over L. At N=1 a
//    run of rows acts on a chain as a pair: the product P of its decays
//    and its end state H from a zero start (h_out = P h_in + H); on the
//    adjoint likewise (g_out = P g_in + G). A chunk is kChunk source rows,
//    cut into pieces of kSub rows in each direction's scan order (what a
//    thread holds in registers). The backward:
//      1. scan_n1_bwd_sums_kernel writes (P, H, G) for every (direction,
//         image, piece, channel): a block a (chunk, 64 channels, image,
//         direction);
//      2. scan_n1_bwd_carry_kernel walks each chain's pieces, one FMA a
//         piece, for the state entering each piece and the adjoint
//         entering it from the rows after (in scan order);
//      3. scan_n1_bwd_grad_kernel rebuilds each piece's states and
//         adjoints from those and computes the gradients: a block a (chunk,
//         64 channels, image, source) takes both directions of its source,
//         so du of the pair still sums in the thread.
//    The forward is the same walk without the adjoint, in one of two
//    regimes that the wrapper picks per call (fwd_chunk):
//      cut: scan_n1_fwd_sums_kernel writes (P, H) of every piece,
//         scan_n1_fwd_carry_kernel (kernel 2's walk in scan order alone)
//         the state entering each, and scan_n1_fwd_kernel the outputs, each
//         piece from its carried state. Both of the first and last take a
//         (chunk, 64 channels, image, source) a block: both directions of
//         the source over the chunk's rows, the forward one first, so that
//         a kernel reads a row once. The scan keeps the forward direction's
//         outputs in shared memory; the reversed one adds its own to them
//         in the same thread and writes the pair, so the pair sums in the
//         thread with the TPU's rounding points. At stage 0, B=12 that is
//         9,408 + 96 + 9,408 blocks.
//      one pass: scan_n1_fwd_kernel alone from a zero state, a block a (64
//         channels, image, source) walking every chunk of both directions
//         (ceil(D/64) x B x 2 blocks); the reversed direction reads the
//         forward one's outputs back from y, a piece's reads issued
//         together ahead of its walk. It is the choice where L is short or
//         that grid gives every SM a block: the cut regime stages every row
//         twice and computes its terms twice.
//    Both kernels share one body (fwd_body): it stages each chunk's rows in
//    source order through cp.async into one of two buffers while it walks
//    the other, takes dt's dot product four columns a vector read, its
//    decays as ex2.approx of dt A log2(e) and its softplus's exp so
//    (log1pf stays: lg2.approx(1 + e) loses dt at negative inputs), and
//    walks a full chunk at offsets fixed but for the piece's first row;
//    both are capped at kFwdBlocks blocks an SM (at 8, ptxas spilled up
//    to 204 bytes). Both are held by the instructions they issue, not by
//    latency: 6 or 10 blocks an SM, and one staging buffer or two, moved
//    them by a few percent; expf decays cost 10%.
//    The forward was first one thread a (source, image,
//    channel) chain over all of L, 96 blocks of 2 warps at stage 0, B=12,
//    on 132 SMs, each 32-row tile behind its staging loads: 1.78 to 1.90
//    ms there against a 0.048 ms bound, on an H100 80GB HBM3 at 700 W.
//  - The backward ran the same way until it was the port's slowest kernel
//    against its bound: one thread walked its chain three times over all L
//    rows, on a grid of (D / 64) x B x 2 blocks of 2 warps (96 blocks at
//    stage 0, B=12, on 132 SMs): 7.19 ms against a 0.07 ms bound on an H100
//    80GB HBM3 at 700 W. As a chunked scan it took 0.94 ms. dB, dC and dt_r
//    need sums over the D channels of each row: each block sums its 64
//    channels in a fixed order from the staged values (channel_sum, float4
//    reads of 16-byte aligned rows) and writes a per-block partial that
//    the wrapper sums. dA, dD, d dt_bias and dW_dt are written per chunk
//    and image and summed by the wrapper in a fixed order. No float
//    atomics: every output is the same in every run. Composing pieces
//    instead of walking rows changes only the rounding; there is no
//    division by a decay (a P that underflows to 0 forgets the state, as
//    the walk does).
//
// All launch on the caller's stream, allocate nothing (the wrapper
// allocates every workspace), and return cudaGetLastError() so that the
// Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int kThreads = 64;        // channels per block
constexpr int kChunk = 32;          // source rows a chunk
constexpr int kSub = 16;            // rows a piece: held in registers
constexpr int kCarryThreads = 128;  // chains per block of the carry kernels
constexpr int kGradBlocks = 6;      // the gradient kernel's blocks an SM
constexpr int kFwdBlocks = 6;       // the forward kernels' blocks an SM
constexpr int kPieces = kChunk / kSub;  // pieces of a chunk
// Row stride of the per-channel rows that the backward sums over channels:
// 16-byte aligned for float4 reads, and rows 4 banks apart, so that the 8
// lanes of a quarter warp reading 8 rows hit distinct banks.
constexpr int kLd = kThreads + 4;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kChunk % kSub == 0, "chunks hold whole pieces");
static_assert(kThreads % 4 == 0 && kLd % 4 == 0, "float4 rows");

__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

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

// 2^x by the special-function unit (relative error under 2^-22; results
// below 2^-126 flush to 0, which forgets a state as an underflow does).
// The forward takes its decays as exp2(dt A log2 e): one multiply and
// this, where expf is about eight instructions.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// logaddexp(x, 0), the form jax.nn.softplus uses; kFast takes its exp as
// exp2_approx. log1pf stays: log2 of 1 + e by lg2.approx rounds away the
// small e of a negative x (dt of the initial 1e-3 loses 2e-4 of itself).
template <bool kFast>
__device__ __forceinline__ float softplus(float x) {
  const float e = kFast ? exp2_approx(-fabsf(x) * kLog2e) : expf(-fabsf(x));
  return fmaxf(x, 0.0f) + log1pf(e);
}

// scan row i of a direction -> its source row
__device__ __forceinline__ int src_row(int i, int L, bool rev) {
  return rev ? L - 1 - i : i;
}

// The per-row terms of ROWS staged rows for the calling thread's channel,
// for all rows at once: dt_raw = bias + x_dbl[:R] . W_dt (the rows' dot
// products interleaved, q outer), dt = softplus(dt_raw), the decay
// av = exp(dt A) and the input term bv = dt u B; with kGrad also dt and
// softplus'(dt_raw). The rows are independent until the chain, so
// computing them first leaves h = av h + bv as the only dependent step of
// the walk (the TPU kernel's discipline, scan_n1.py:126-130). x_col and
// dtw_col point at this thread's column of the staged sources and of W_dt.
// Rows past the staged ones hold stale values; callers do not use them.
template <int ROWS, bool kGrad>
__device__ __forceinline__ void row_terms(
    const float* xd_s, int C, int R, const float* x_col, int x_stride,
    const float* dtw_col, int w_stride, float db, float a,
    float (&av)[ROWS], float (&bv)[ROWS],
    float (&dtv)[ROWS], float (&sgv)[ROWS]) {
  float v[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) v[r] = db;
  for (int q = 0; q < R; ++q) {
    const float w = dtw_col[q * w_stride];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) v[r] += xd_s[r * C + q] * w;
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float dt;
    if (kGrad) {  // softplus as softplus() computes it, its exp reused
      const float e = expf(-fabsf(v[r]));
      dt = fmaxf(v[r], 0.0f) + log1pf(e);
      dtv[r] = dt;
      // softplus'(dt_raw); the divisor is in [1, 2], where __fdividef is
      // within 2 ulp
      sgv[r] = __fdividef(v[r] >= 0.0f ? 1.0f : e, 1.0f + e);
    } else {
      dt = softplus<false>(v[r]);
    }
    av[r] = expf(dt * a);
    bv[r] = dt * x_col[r * x_stride] * xd_s[r * C + R];
  }
}

// 4-byte cp.async into shared memory; with `valid` false it writes 0 and
// reads nothing.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---- the forward ----------------------------------------------------------
//
// A block takes one source's two directions over one chunk (cut) or over
// every chunk (one pass), the forward direction first: its tiles are the
// chunks in the forward direction's scan order (ascending), then in the
// reversed one's (descending), each staged in source order into one of
// two buffers while it walks the other.
//
// Shared memory of the forward's kernels, in floats, every part 16-byte
// aligned: dtw_s (2, pad4(R), kThreads), W_dt of both directions of the
// block's source, zero past R and past D; two buffers of a chunk's x_dbl
// rows (kChunk, pad4(R + 2)) and two of its source rows (kChunk, kThreads)
// in the sources' dtype (elt bytes), in source order; with y_s, the scan's
// (kChunk, kThreads) outputs of the forward direction in the sources'
// dtype, which the reversed direction of a cut block adds its own to.
__host__ __device__ constexpr int fwd_smem_floats(int R, int elt, bool y_s) {
  return 2 * pad4(R) * kThreads + 2 * kChunk * pad4(R + 2) +
         (y_s ? 3 : 2) * kChunk * kThreads * elt / 4;
}

// Stage chunk c of direction k's x_dbl (plane xd_g, C floats a row) and of
// the source's rows for the block's channels into buffer (xd, x), rows in
// source order, by cp.async (in flight until cp_async_wait_all): 4 bytes a
// copy, so a bf16 copy takes two channels (by loads and stores where an
// odd D leaves a row's pairs unaligned). The columns of xd past C are
// never written: the kernel zeroes them once.
template <typename T>
__device__ __forceinline__ void stage_fwd_chunk(const float* xd_g,
                                                const T* src, int c, int nt,
                                                int D, int C, int d0,
                                                float* xd, T* x) {
  const int tid = threadIdx.x;
  const int Cp = pad4(C);
  const float* g = xd_g + static_cast<size_t>(c) * kChunk * C;
  for (int i = tid; i < nt * C; i += kThreads) {
    const int r = i / C;
    cp_async4(xd + r * Cp + (i - r * C), g + i, true);
  }
  const T* rows = src + static_cast<size_t>(c) * kChunk * D + d0;
  if constexpr (sizeof(T) == sizeof(float)) {
    const bool in = d0 + tid < D;
    for (int r = 0; r < nt; ++r)
      cp_async4(reinterpret_cast<float*>(x) + r * kThreads + tid,
                reinterpret_cast<const float*>(
                    rows + static_cast<size_t>(r) * D + (in ? tid : 0)),
                in);
  } else if (D % 2 == 0) {
    constexpr int kPairs = kThreads / 2;
    for (int i = tid; i < nt * kPairs; i += kThreads) {
      const int r = i / kPairs;
      const int dd = 2 * (i - r * kPairs);
      const bool in = d0 + dd < D;
      cp_async4(reinterpret_cast<float*>(x + r * kThreads + dd),
                reinterpret_cast<const float*>(
                    rows + static_cast<size_t>(r) * D + (in ? dd : 0)),
                in);
    }
  } else {
    const bool in = d0 + tid < D;
    for (int r = 0; r < nt; ++r)
      x[r * kThreads + tid] =
          in ? rows[static_cast<size_t>(r) * D + tid] : from_float<T>(0.0f);
  }
}

// What a thread of a forward block holds for one tile: its column of the
// staged rows, and its channel's constants in the tile's direction.
template <typename T>
struct FwdTile {
  const float* xd;  // the chunk's x_dbl rows (kChunk, Cp), source order
  const T* xs;      // this thread's column of the source rows, stride kThreads
  const float* w;   // this thread's column of W_dt, stride kThreads, Rp rows
  int Cp, R, Rp, nt;
  float a2, db;     // A log2(e), dt_bias
};

// The staged row (in source order) of scan row r0 + r of the tile's
// direction: r0 plus a constant when the chunk is full, else clamped into
// the staged rows (the terms of rows past them are not used).
template <bool kFull, bool kRev>
__device__ __forceinline__ int fwd_row(int r0, int r, int nt) {
  if (kFull) return kRev ? kChunk - 1 - r0 - r : r0 + r;
  return kRev ? max(nt - 1 - r0 - r, 0) : min(r0 + r, nt - 1);
}

// The per-row terms of the piece of kSub scan rows from r0, for all its
// rows at once (the rows interleaved in registers): dt = softplus(bias +
// x_dbl[:R] . W_dt), its dot four columns a vector read of x_dbl (W_dt is
// zero past R), the decay av = exp2_approx(dt A log2 e) and the input term
// bv = dt u B. Both forward kernels take them so, so that the summaries'
// P and H are those of the scan's rows.
template <typename T, bool kFull, bool kRev>
__device__ __forceinline__ void fwd_terms(const FwdTile<T>& p, int r0,
                                          float (&av)[kSub],
                                          float (&bv)[kSub]) {
  float v[kSub];
#pragma unroll
  for (int r = 0; r < kSub; ++r) v[r] = p.db;
  // half the rows at a time: the vector reads of all kSub rows in flight
  // at once took 64 registers and spilled
#pragma unroll
  for (int h0 = 0; h0 < kSub; h0 += kSub / 2) {
    for (int q = 0; q < p.Rp; q += 4) {
      const float w0 = p.w[q * kThreads], w1 = p.w[(q + 1) * kThreads];
      const float w2 = p.w[(q + 2) * kThreads], w3 = p.w[(q + 3) * kThreads];
#pragma unroll
      for (int r = h0; r < h0 + kSub / 2; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(
            p.xd + fwd_row<kFull, kRev>(r0, r, p.nt) * p.Cp + q);
        v[r] += x.x * w0;
        v[r] += x.y * w1;
        v[r] += x.z * w2;
        v[r] += x.w * w3;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kSub; ++r) {
    const int lr = fwd_row<kFull, kRev>(r0, r, p.nt);
    const float dt = softplus<true>(v[r]);
    av[r] = exp2_approx(dt * p.a2);
    bv[r] = dt * to_float(p.xs[lr * kThreads]) * p.xd[lr * p.Cp + p.R];
  }
}

// The summaries' tile: (P, H) of each piece, P the product of its decays
// and H its end state from 0, into slots (the direction's, image's and
// chunk's first slot, times D, plus d); a piece past the rows passes
// through (P 1, H 0).
template <typename T, bool kFull, bool kRev>
__device__ __forceinline__ void fwd_sums_tile(const FwdTile<T>& p,
                                              float* slots, size_t plane,
                                              int D) {
  // not unrolled, as in fwd_scan_tile
#pragma unroll 1
  for (int j = 0; j < kPieces; ++j) {
    const int r0 = j * kSub;
    float P = 1.0f, h = 0.0f;
    if (kFull || r0 < p.nt) {
      float av[kSub], bv[kSub];
      fwd_terms<T, kFull, kRev>(p, r0, av, bv);
#pragma unroll
      for (int r = 0; r < kSub; ++r) {
        if (kFull || r0 + r < p.nt) {
          P *= av[r];
          h = av[r] * h + bv[r];
        }
      }
    }
    slots[static_cast<size_t>(j) * D] = P;
    slots[plane + static_cast<size_t>(j) * D] = h;
  }
}

// The scan's tile: each piece from its carried state (h_in: the piece's
// slot, times D, plus d; null in one pass, where h carries on), its
// outputs C h + D u in the sources' dtype. The forward direction writes
// them to y_s (kCut) or to y (ycol: this thread's column of the chunk's
// first row, stride D); the reversed one adds its own to them and writes
// the pair to y.
template <typename T, bool kFull, bool kRev, bool kCut>
__device__ __forceinline__ void fwd_scan_tile(const FwdTile<T>& p,
                                              const float* h_in, int D,
                                              float dskip, float& h, T* y_s,
                                              T* ycol) {
  // The pieces are not unrolled: unrolled (each of the tile's instances
  // twice), the forward was 10% slower over the main path's shapes
  // (the variants in PERF.md).
#pragma unroll 1
  for (int j = 0; j < kPieces; ++j) {
    const int r0 = j * kSub;
    if (!kFull && r0 >= p.nt) break;
    if (kCut) h = h_in[static_cast<size_t>(j) * D];
    float av[kSub], bv[kSub];
    fwd_terms<T, kFull, kRev>(p, r0, av, bv);
    // the forward direction's outputs, which this thread wrote: read
    // together ahead of the walk and its stores
    float yf[kSub];
#pragma unroll
    for (int r = 0; r < kSub; ++r) {
      const int lr = fwd_row<kFull, kRev>(r0, r, p.nt);
      yf[r] = !kRev ? 0.0f
              : kCut ? to_float(y_s[lr * kThreads])
                     : to_float(ycol[static_cast<size_t>(lr) * D]);
    }
#pragma unroll
    for (int r = 0; r < kSub; ++r) {
      if (kFull || r0 + r < p.nt) {
        h = av[r] * h + bv[r];  // the only dependent chain
        const int lr = fwd_row<kFull, kRev>(r0, r, p.nt);
        const T out =
            from_float<T>(p.xd[lr * p.Cp + p.R + 1] * h +
                          dskip * to_float(p.xs[lr * kThreads]));
        if (kRev)
          ycol[static_cast<size_t>(lr) * D] =
              from_float<T>(yf[r] + to_float(out));
        else if (kCut)
          y_s[lr * kThreads] = out;
        else
          ycol[static_cast<size_t>(lr) * D] = out;
      }
    }
  }
}

// fn(a, b, c) with each flag as a std::bool_constant, so that fn can pass
// them on as template arguments.
template <typename Fn>
__device__ __forceinline__ void with_flags(bool a, bool b, bool c, Fn fn) {
  using T = std::true_type;
  using F = std::false_type;
  if (a)
    b ? (c ? fn(T(), T(), T()) : fn(T(), T(), F()))
      : (c ? fn(T(), F(), T()) : fn(T(), F(), F()));
  else
    b ? (c ? fn(F(), T(), T()) : fn(F(), T(), F()))
      : (c ? fn(F(), F(), T()) : fn(F(), F(), F()));
}

// The body of both forward kernels. grid (nchunks * nblk, B, 2 sources) a
// chunk a block (the summaries, and the scan when cut), or (nblk, B, 2) a
// block walking every chunk (the scan in one pass). kSums: write each
// piece's (P, H) to sums (2, 4, B, slots, D). Else the scan: from the
// carried states (carries (1, 4, B, slots, D) when cut; else from 0), y.
template <typename T, bool kSums>
__device__ __forceinline__ void fwd_body(
    float* smem, const T* xr, const T* xc, const float* xdbl,
    const float* dtw, const float* dt_bias, const float* A, const float* Dv,
    const float* carries, float* sums, T* y, int B, int L, int D, int R) {
  const int C = R + 2;
  const int Cp = pad4(C);
  const int Rp = pad4(R);
  float* const dtw_s = smem;                        // (2, Rp, kThreads)
  float* const xd_buf = dtw_s + 2 * Rp * kThreads;  // 2 x (kChunk, Cp)
  T* const x_buf = reinterpret_cast<T*>(xd_buf + 2 * kChunk * Cp);
  T* const y_s = x_buf + 2 * kChunk * kThreads;  // (kChunk, kThreads)

  const bool cut = kSums || carries != nullptr;
  const int nblk = (D + kThreads - 1) / kThreads;
  const int nchunks = (L + kChunk - 1) / kChunk;
  const int cb = cut ? blockIdx.x / nblk : 0;  // a cut block's chunk
  const int d0 = (blockIdx.x - cb * nblk) * kThreads;
  const int b = blockIdx.y;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int d = d0 + tid;
  // Inactive lanes (d >= D) stage and reach every barrier; they skip the
  // walks.
  const bool active = d < D;
  const T* src = (s == 0 ? xr : xc) + static_cast<size_t>(b) * L * D;
  const int per = cut ? 1 : nchunks;  // chunks a direction
  const size_t plane = static_cast<size_t>(4) * B * nchunks * kPieces * D;
  // tile t: its pass (0 forward, 1 reversed) and chunk
  auto chunk_of = [&](int t, int pass) {
    return cut ? cb : pass == 0 ? t : 2 * per - 1 - t;
  };
  auto stage = [&](int t) {
    const int pass = t >= per;
    const int c = chunk_of(t, pass);
    const int k = s + 2 * pass;
    stage_fwd_chunk(xdbl + (static_cast<size_t>(k) * B + b) * L * C, src, c,
                    min(kChunk, L - c * kChunk), D, C, d0,
                    xd_buf + (t & 1) * kChunk * Cp,
                    x_buf + (t & 1) * kChunk * kThreads);
    cp_async_commit();
  };

  // W_dt of both directions: element i = (pass, channel, q), q fastest, so
  // that neighbouring threads read neighbouring floats
  for (int i = tid; i < 2 * kThreads * Rp; i += kThreads) {
    const int pass = i / (kThreads * Rp);
    const int rest = i - pass * kThreads * Rp;
    const int dd = rest / Rp;
    const int q = rest - dd * Rp;
    const bool valid = q < R && d0 + dd < D;
    const int k = s + 2 * pass;
    cp_async4(dtw_s + (pass * Rp + q) * kThreads + dd,
              valid ? dtw + (static_cast<size_t>(k) * D + d0 + dd) * R + q
                    : dtw,
              valid);
  }
  // x_dbl's pad columns, read by the vector dot against W_dt's zeros
  for (int i = tid; i < 2 * kChunk * (Cp - C); i += kThreads) {
    const int r = i / (Cp - C);
    xd_buf[r * Cp + C + (i - r * (Cp - C))] = 0.0f;
  }
  stage(0);

  float h = 0.0f, dskip = 0.0f;
  FwdTile<T> p;
  p.Cp = Cp;
  p.R = R;
  p.Rp = Rp;
  for (int t = 0; t < 2 * per; ++t) {
    const int pass = t >= per;
    const int c = chunk_of(t, pass);
    const int k = s + 2 * pass;
    cp_async_wait_all();
    __syncthreads();  // tile t staged; every lane is done with tile t - 1
    if (t + 1 < 2 * per) stage(t + 1);
    if (!active) continue;
    if (t == 0 || t == per) {  // a direction starts
      p.a2 = A[k * D + d] * kLog2e;
      p.db = dt_bias[k * D + d];
      dskip = kSums ? 0.0f : Dv[k * D + d];
      h = 0.0f;
    }
    p.xd = xd_buf + (t & 1) * kChunk * Cp;
    p.xs = x_buf + (t & 1) * kChunk * kThreads + tid;
    p.w = dtw_s + pass * Rp * kThreads + tid;
    p.nt = min(kChunk, L - c * kChunk);
    const bool full = p.nt == kChunk;
    // the first slot of the tile's pieces, times D, plus d
    const size_t slot =
        ((static_cast<size_t>(k) * B + b) * nchunks * kPieces +
         c * kPieces) * D + d;
    const float* h_in = carries ? carries + slot : nullptr;
    T* ycol = kSums ? nullptr
                    : y + ((static_cast<size_t>(s) * B + b) * L +
                           static_cast<size_t>(c) * kChunk) * D + d;
    with_flags(full, pass == 1, cut, [&](auto kFull, auto kRev, auto kCut) {
      constexpr bool f = decltype(kFull)::value, r = decltype(kRev)::value;
      if constexpr (kSums)
        fwd_sums_tile<T, f, r>(p, sums + slot, plane, D);
      else
        fwd_scan_tile<T, f, r, decltype(kCut)::value>(p, h_in, D, dskip, h,
                                                      y_s + tid, ycol);
    });
  }
}

// 1 (forward, cut). Piece summaries: fwd_body's grid a chunk a block,
// dynamic smem fwd_smem_floats(R, sizeof(T), false) floats. Both forward
// kernels are capped for kFwdBlocks resident blocks an SM.
template <typename T>
__global__ void __launch_bounds__(kThreads, kFwdBlocks)
scan_n1_fwd_sums_kernel(const T* __restrict__ xr, const T* __restrict__ xc,
                        const float* __restrict__ xdbl,
                        const float* __restrict__ dtw,
                        const float* __restrict__ dt_bias,
                        const float* __restrict__ A,
                        float* __restrict__ sums, int B, int L, int D,
                        int R) {
  extern __shared__ float4 smem4[];  // 16-byte aligned
  fwd_body<T, true>(reinterpret_cast<float*>(smem4), xr, xc, xdbl, dtw,
                    dt_bias, A, nullptr, nullptr, sums, nullptr, B, L, D, R);
}

// 3 (forward). The scan: fwd_body's grid a chunk a block when cut (carries
// set), else a block a (64 channels, image, source); dynamic smem
// fwd_smem_floats(R, sizeof(T), cut) floats.
template <typename T>
__global__ void __launch_bounds__(kThreads, kFwdBlocks) scan_n1_fwd_kernel(
    const T* __restrict__ xr, const T* __restrict__ xc,
    const float* __restrict__ xdbl, const float* __restrict__ dtw,
    const float* __restrict__ dt_bias, const float* __restrict__ A,
    const float* __restrict__ Dv, const float* __restrict__ carries,
    T* __restrict__ y, int B, int L, int D, int R) {
  extern __shared__ float4 smem4[];  // 16-byte aligned
  fwd_body<T, false>(reinterpret_cast<float*>(smem4), xr, xc, xdbl, dtw,
                     dt_bias, A, Dv, carries, nullptr, y, B, L, D, R);
}

// sum over the block's channels of a[j] * b[j] (b null: of a[j]), in a fixed
// order: four interleaved partial sums, then their pairwise sum. a and b
// are 16-byte aligned.
__device__ __forceinline__ float channel_sum(const float* a, const float* b) {
  float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < kThreads; j += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + j);
    if (b) {
      const float4 y = *reinterpret_cast<const float4*>(b + j);
      p[0] += x.x * y.x;
      p[1] += x.y * y.y;
      p[2] += x.z * y.z;
      p[3] += x.w * y.w;
    } else {
      p[0] += x.x;
      p[1] += x.y;
      p[2] += x.z;
      p[3] += x.w;
    }
  }
  return (p[0] + p[1]) + (p[2] + p[3]);
}

// ---- the backward: three kernels ----------------------------------------
//
// A chunk is kChunk source rows [c kChunk, c kChunk + nt) of one image; a
// direction walks them front to back (k < 2) or back to front (k >= 2), in
// kPieces pieces of kSub rows in that scan order. Piece j of chunk c has
// the slot c kPieces + j; a piece past the chunk's rows (in the last chunk)
// is empty and passes states and adjoints through.
// Workspaces of the wrapper, fp32, (.., 4, B, nchunks * kPieces, D):
//   sums     (3, ..): per direction, piece and channel, the piece's product
//            of decays P, its end state H from a zero start, and the
//            adjoint that leaves its first row (in scan order) from a zero
//            adjoint coming in, G
//   carries  (2, ..): the state entering each piece, h_in, and the adjoint
//            entering its last row from the row after it, g_in
// (The forward's cut regime has the first two planes of sums and the first
// of carries, in the same slots.)
// Outputs (fp32): du (2, B, L, D), the gradient w.r.t. the sources through
// the scan and the D skip of both directions (the x_proj path reaches the
// sources through dxdbl, outside); dxdbl_part (nblk, 4, B, L, R+2) in
// source order, a partial per block of kThreads channels; dA, dD, ddb
// (nchunks, B, 4, D) and ddtw (nchunks, B, 4, R, D), a partial per chunk
// and image.

// dtw_s (R, ld) <- W_dt of direction k for the block's channels (0 past D)
__device__ __forceinline__ void stage_dtw(const float* dtw, int k, int D,
                                          int R, int d0, int ld,
                                          float* dtw_s) {
  for (int i = threadIdx.x; i < R * kThreads; i += kThreads) {
    const int dd = i / R;
    const int q = i - dd * R;
    dtw_s[q * ld + dd] =
        d0 + dd < D ? dtw[(static_cast<size_t>(k) * D + d0 + dd) * R + q]
                    : 0.0f;
  }
}

// Stage the nt rows of a chunk in a direction's scan order, from scan row
// i0 on: their x_dbl rows (C floats each, row stride xd_ld) into xd_s, and
// for the block's channels the source's rows into x_s and dy's into dy_s
// (row stride kThreads, zeros past D).
template <typename T>
__device__ __forceinline__ void stage_chunk(
    const float* xd_g, const T* src, const T* dyp, int i0, int nt, int L,
    int D, int C, int xd_ld, int d0, bool rev, float* xd_s, float* x_s,
    float* dy_s) {
  for (int o = threadIdx.x; o < nt * C; o += kThreads) {
    const int r = o / C;
    const int col = o - r * C;
    xd_s[r * xd_ld + col] =
        xd_g[static_cast<size_t>(src_row(i0 + r, L, rev)) * C + col];
  }
  for (int o = threadIdx.x; o < nt * kThreads; o += kThreads) {
    const int r = o / kThreads;
    const int dd = o - r * kThreads;
    const size_t row = static_cast<size_t>(src_row(i0 + r, L, rev)) * D;
    const bool in = d0 + dd < D;
    x_s[o] = in ? to_float(src[row + d0 + dd]) : 0.0f;
    dy_s[o] = in ? to_float(dyp[row + d0 + dd]) : 0.0f;
  }
}

// 1. Piece summaries. grid (nchunks * nblk, B, 4 directions), block
// kThreads, dynamic smem sums_smem_floats(R) floats. One pass over each
// piece's rows in scan order: P *= a, h = a h + b, and G += P C dy, the
// adjoint recurrence p = C dy + g, g = a p unrolled into its sum
// (G = sum over rows of the decays up to and including the row, times its
// C dy), so that one forward walk gives all three.
__host__ __device__ constexpr int sums_smem_floats(int R) {
  return R * kThreads + kChunk * (R + 2) + 2 * kChunk * kThreads;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) scan_n1_bwd_sums_kernel(
    const T* __restrict__ xr, const T* __restrict__ xc,
    const float* __restrict__ xdbl, const float* __restrict__ dtw,
    const float* __restrict__ dt_bias, const float* __restrict__ A,
    const T* __restrict__ dy, float* __restrict__ sums, int B, int L, int D,
    int R) {
  extern __shared__ float smem[];
  const int C = R + 2;
  float* dtw_s = smem;                    // (R, kThreads)
  float* xd_s = dtw_s + R * kThreads;     // (kChunk, C)
  float* x_s = xd_s + kChunk * C;         // (kChunk, kThreads): u
  float* dy_s = x_s + kChunk * kThreads;  // (kChunk, kThreads): dy

  const int nblk = (D + kThreads - 1) / kThreads;
  const int c = blockIdx.x / nblk;
  const int d0 = (blockIdx.x - c * nblk) * kThreads;
  const int b = blockIdx.y;
  const int k = blockIdx.z;
  const int s = k & 1;
  const bool rev = k >= 2;
  const int tid = threadIdx.x;
  const int d = d0 + tid;
  const int nchunks = (L + kChunk - 1) / kChunk;
  const int nt = min(kChunk, L - c * kChunk);
  const int i0 = rev ? L - c * kChunk - nt : c * kChunk;
  const size_t img = static_cast<size_t>(b) * L * D;

  stage_dtw(dtw, k, D, R, d0, kThreads, dtw_s);
  stage_chunk(xdbl + (static_cast<size_t>(k) * B + b) * L * C,
              (s == 0 ? xr : xc) + img,
              dy + static_cast<size_t>(s) * B * L * D + img, i0, nt, L, D, C,
              C, d0, rev, xd_s, x_s, dy_s);
  __syncthreads();
  if (d >= D) return;  // no barrier follows

  const float a = A[k * D + d];
  const float db = dt_bias[k * D + d];
  const size_t plane = static_cast<size_t>(4) * B * nchunks * kPieces * D;
  for (int j = 0; j < kPieces; ++j) {
    const int r0 = j * kSub;
    float P = 1.0f, h = 0.0f, G = 0.0f;  // an empty piece passes through
    if (r0 < nt) {
      float av[kSub], bv[kSub];
      row_terms<kSub, false>(xd_s + r0 * C, C, R, x_s + r0 * kThreads + tid,
                             kThreads, dtw_s + tid, kThreads, db, a, av, bv,
                             av, bv);
#pragma unroll
      for (int r = 0; r < kSub; ++r) {
        if (r0 + r < nt) {
          P *= av[r];
          h = av[r] * h + bv[r];
          G += P * (xd_s[(r0 + r) * C + R + 1] *
                    dy_s[(r0 + r) * kThreads + tid]);
        }
      }
    }
    const size_t o =
        ((static_cast<size_t>(k) * B + b) * nchunks * kPieces + c * kPieces +
         j) * D + d;
    sums[o] = P;
    sums[plane + o] = h;
    sums[2 * plane + o] = G;
  }
}

// 2. Carries. grid ceil(4 B D / kCarryThreads), block kCarryThreads: one
// thread a (direction, image, channel) chain walks its pieces in scan order
// for h_in (h = P h + H) and, with kAdj, in reverse for g_in (g = P g + G):
// one FMA a piece, with the loads of kBatch pieces issued ahead of their
// FMAs.
constexpr int kBatch = 8;

template <bool kAdj>
__device__ __forceinline__ void piece_carries(const float* sums,
                                              float* carries, int B,
                                              int nchunks, int D) {
  const int i = blockIdx.x * kCarryThreads + threadIdx.x;
  if (i >= 4 * B * D) return;
  const int kb = i / D;  // k * B + b
  const int d = i - kb * D;
  const bool rev = kb >= 2 * B;
  const int n = nchunks * kPieces;
  const size_t plane = static_cast<size_t>(4) * B * n * D;
  const size_t base = static_cast<size_t>(kb) * n * D + d;
  const float* P = sums + base;
  const float* H = P + plane;
  const float* G = H + plane;
  float* h_in = carries + base;
  float* g_in = h_in + plane;
  // the slot of the m-th piece in scan order, times D
  auto slot = [&](int m) {
    const int c = m / kPieces;
    return static_cast<size_t>((rev ? nchunks - 1 - c : c) * kPieces +
                               (m - c * kPieces)) * D;
  };
  float h = 0.0f;
  for (int m0 = 0; m0 < n; m0 += kBatch) {
    float p[kBatch], x[kBatch];
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      if (m0 + e < n) {
        p[e] = P[slot(m0 + e)];
        x[e] = H[slot(m0 + e)];
      }
    }
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      if (m0 + e < n) {
        h_in[slot(m0 + e)] = h;
        h = p[e] * h + x[e];
      }
    }
  }
  if (!kAdj) return;
  float g = 0.0f;
  for (int m0 = n - 1; m0 >= 0; m0 -= kBatch) {
    float p[kBatch], x[kBatch];
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      if (m0 - e >= 0) {
        p[e] = P[slot(m0 - e)];
        x[e] = G[slot(m0 - e)];
      }
    }
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      if (m0 - e >= 0) {
        g_in[slot(m0 - e)] = g;
        g = p[e] * g + x[e];
      }
    }
  }
}

__global__ void __launch_bounds__(kCarryThreads) scan_n1_bwd_carry_kernel(
    const float* __restrict__ sums, float* __restrict__ carries, int B,
    int nchunks, int D) {
  piece_carries<true>(sums, carries, B, nchunks, D);
}

// The forward's h_in of every piece: carries (1, 4, B, slots, D).
__global__ void __launch_bounds__(kCarryThreads) scan_n1_fwd_carry_kernel(
    const float* __restrict__ sums, float* __restrict__ carries, int B,
    int nchunks, int D) {
  piece_carries<false>(sums, carries, B, nchunks, D);
}


// 3. Gradients. grid (nchunks * nblk, B, 2 sources), block kThreads,
// dynamic smem grad_smem_floats(R) floats. Registers are capped for
// kGradBlocks resident blocks an SM (168 a thread, no spills on sm_90a;
// uncapped, 206 registers held 4 blocks, and with an IEEE division in the
// sigmoid stage 0 of vssm1_base, B=12, took 1.14 ms against 0.94 on an
// H100 80GB HBM3 at 700 W). The block takes both directions
// of its source over its chunk's rows, the forward one first, so that du
// of the pair sums in the thread. Each piece starts from its own h_in and
// g_in: rebuild its states, run the adjoint chain, then the per-row terms
// (walks 2 and 3 of a sequential backward, on kSub rows).
__host__ __device__ constexpr int grad_smem_floats(int R) {
  return R * kLd                  // dtw_s
         + 3 * kSub * kLd         // ddt_s, pdtu_s, hdy_s
         + R * kThreads           // dwdt_s
         + 2 * kChunk * kThreads  // x_s, dy_s
         + kChunk * pad4(R + 2);  // xd_s
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kGradBlocks) scan_n1_bwd_grad_kernel(
    const T* __restrict__ xr, const T* __restrict__ xc,
    const float* __restrict__ xdbl, const float* __restrict__ dtw,
    const float* __restrict__ dt_bias, const float* __restrict__ A,
    const float* __restrict__ Dv, const T* __restrict__ dy,
    const float* __restrict__ carries, float* __restrict__ du,
    float* __restrict__ dxdbl_part, float* __restrict__ dA_out,
    float* __restrict__ dD_out, float* __restrict__ ddb_out,
    float* __restrict__ ddtw_out, int B, int L, int D, int R) {
  extern __shared__ float4 smem4[];  // 16-byte aligned
  const int C = R + 2;
  const int Cp = pad4(C);  // xd_s's row stride
  float* dtw_s = reinterpret_cast<float*>(smem4);  // (R, kLd)
  float* ddt_s = dtw_s + R * kLd;      // (kSub, kLd): grad w.r.t. dt_raw
  float* pdtu_s = ddt_s + kSub * kLd;  // adjoint * dt * u   (dB terms)
  float* hdy_s = pdtu_s + kSub * kLd;  // h * dy             (dC terms)
  float* dwdt_s = hdy_s + kSub * kLd;  // (R, kThreads)
  float* x_s = dwdt_s + R * kThreads;  // (kChunk, kThreads): u
  float* dy_s = x_s + kChunk * kThreads;  // (kChunk, kThreads): dy
  float* xd_s = dy_s + kChunk * kThreads;  // (kChunk, Cp)

  const int nblk = (D + kThreads - 1) / kThreads;
  const int c = blockIdx.x / nblk;
  const int blk = blockIdx.x - c * nblk;
  const int d0 = blk * kThreads;
  const int b = blockIdx.y;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int d = d0 + tid;
  // Inactive lanes (d >= D) run the same code on zeros, so that every lane
  // reaches every barrier and their shared-memory entries are 0.
  const bool active = d < D;
  const int nchunks = (L + kChunk - 1) / kChunk;
  const int nt = min(kChunk, L - c * kChunk);
  const T* src = (s == 0 ? xr : xc) + static_cast<size_t>(b) * L * D;
  const size_t plane = (static_cast<size_t>(s) * B + b) * L * D;
  const size_t cplane = static_cast<size_t>(4) * B * nchunks * kPieces * D;

  for (int pass = 0; pass < 2; ++pass) {
    const int k = s + 2 * pass;
    const bool rev = pass == 1;
    const int i0 = rev ? L - c * kChunk - nt : c * kChunk;
    __syncthreads();  // the previous pass is done with the shared buffers
    stage_dtw(dtw, k, D, R, d0, kLd, dtw_s);
    for (int q = 0; q < R; ++q) dwdt_s[q * kThreads + tid] = 0.0f;
    stage_chunk(xdbl + (static_cast<size_t>(k) * B + b) * L * C, src,
                dy + plane, i0, nt, L, D, C, Cp, d0, rev, xd_s, x_s, dy_s);
    const float a = active ? A[k * D + d] : 0.0f;
    const float db = active ? dt_bias[k * D + d] : 0.0f;
    const float dskip = active ? Dv[k * D + d] : 0.0f;
    __syncthreads();

    float dA = 0.0f, dD = 0.0f, ddb = 0.0f;
    for (int j = 0; j * kSub < nt; ++j) {
      const int r0 = j * kSub;
      const int ns = min(kSub, nt - r0);
      const size_t co =
          ((static_cast<size_t>(k) * B + b) * nchunks * kPieces +
           c * kPieces + j) * D + d;
      float h = active ? carries[co] : 0.0f;
      float g = active ? carries[cplane + co] : 0.0f;
      const float* xd = xd_s + r0 * Cp;
      const float* xs = x_s + r0 * kThreads + tid;
      const float* dys = dy_s + r0 * kThreads + tid;
      float av[kSub], bv[kSub], dtv[kSub], sgv[kSub], pv[kSub], hv[kSub];
      row_terms<kSub, true>(xd, Cp, R, xs, kThreads, dtw_s + tid, kLd, db,
                            a, av, bv, dtv, sgv);
      const float h0 = h;
#pragma unroll
      for (int r = 0; r < kSub; ++r) {
        if (r < ns) {
          h = av[r] * h + bv[r];
          hv[r] = h;  // the state after row r
        }
      }
      // the adjoint chain, last row first: p[r] = C dy + a[r+1] p[r+1],
      // with the adjoint g carried in from the rows after this piece
#pragma unroll
      for (int r = kSub - 1; r >= 0; --r) {
        if (r < ns) {
          pv[r] = xd[r * Cp + R + 1] * dys[r * kThreads] + g;
          g = av[r] * pv[r];
        }
      }
      __syncthreads();  // the previous piece's sums are done
      // given the adjoint, the rows are independent again
      float ddtv[kSub];
#pragma unroll
      for (int r = kSub - 1; r >= 0; --r) {
        if (r < ns) {
          const float p = pv[r];
          const float dt = dtv[r];
          const float dyv = dys[r * kThreads];
          const float u = xs[r * kThreads];
          const float hp = r > 0 ? hv[r - 1] : h0;
          const float dloga = p * hp * av[r];
          const float ddt = (dloga * a + p * u * xd[r * Cp + R]) * sgv[r];
          dA += dloga * dt;
          dD += dyv * u;
          ddb += ddt;
          ddtv[r] = ddt;
          ddt_s[r * kLd + tid] = ddt;
          pdtu_s[r * kLd + tid] = p * dt * u;
          hdy_s[r * kLd + tid] = hv[r] * dyv;
          if (active) {
            const size_t o =
                plane +
                static_cast<size_t>(src_row(i0 + r0 + r, L, rev)) * D + d;
            const float v = dt * xd[r * Cp + R] * p + dyv * dskip;
            du[o] = rev ? du[o] + v : v;  // the forward direction wrote first
          }
        }
      }
      // dW_dt[d, q] += sum over the piece's rows of ddt * dt_r[q], four q
      // at a time (xd_s's rows are 16-byte aligned and pad4(C) long)
      for (int q0 = 0; q0 < R; q0 += 4) {
        float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int r = 0; r < kSub; ++r) {
          if (r < ns) {
            const float4 x = *reinterpret_cast<const float4*>(xd + r * Cp + q0);
            sum[0] += ddtv[r] * x.x;
            sum[1] += ddtv[r] * x.y;
            sum[2] += ddtv[r] * x.z;
            sum[3] += ddtv[r] * x.w;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (q0 + e < R) dwdt_s[(q0 + e) * kThreads + tid] += sum[e];
      }
      __syncthreads();

      // sums over this block's channels: the dt_r of each row (ns x R
      // outputs), then its dB and dC (ns x 2)
      float* part = dxdbl_part +
                    ((static_cast<size_t>(blk) * 4 + k) * B + b) * L * C;
      for (int o = tid; o < ns * C; o += kThreads) {
        int r, col;
        float sum;
        if (o < ns * R) {
          r = o / R;
          col = o - r * R;
          sum = channel_sum(ddt_s + r * kLd, dtw_s + col * kLd);
        } else {
          r = (o - ns * R) >> 1;
          col = R + ((o - ns * R) & 1);
          sum = channel_sum((col == R ? pdtu_s : hdy_s) + r * kLd, nullptr);
        }
        part[static_cast<size_t>(src_row(i0 + r0 + r, L, rev)) * C + col] =
            sum;
      }
    }

    if (active) {
      const size_t w = ((static_cast<size_t>(c) * B + b) * 4 + k) * D + d;
      dA_out[w] = dA;
      dD_out[w] = dD;
      ddb_out[w] = ddb;
      const size_t wq = ((static_cast<size_t>(c) * B + b) * 4 + k) * R * D;
      for (int q = 0; q < R; ++q)
        ddtw_out[wq + static_cast<size_t>(q) * D + d] =
            dwdt_s[q * kThreads + tid];
    }
  }
}


template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

struct FwdArgs {
  const void* xr;
  const void* xc;
  const float* xdbl;
  const float* dtw;
  const float* dt_bias;
  const float* A;
  const float* Dv;
  float* sums;     // (2, 4, B, slots, D), cut regime only
  float* carries;  // (1, 4, B, slots, D), cut regime only
  void* y;
};

// The forward: with sums and carries (cut), the piece summaries, the
// carries, then the scan a chunk a block; without (one pass), the scan
// alone.
template <typename T>
cudaError_t launch_fwd(const FwdArgs& p, int B, int L, int D, int R,
                       cudaStream_t stream) {
  const bool cut = p.carries != nullptr;
  const int nblk = (D + kThreads - 1) / kThreads;
  const int nchunks = (L + kChunk - 1) / kChunk;
  const dim3 grid((cut ? nchunks : 1) * nblk, B, 2);
  const size_t smem = static_cast<size_t>(
      fwd_smem_floats(R, sizeof(T), cut)) * sizeof(float);
  cudaError_t err = allow_smem(scan_n1_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  if (cut) {
    const size_t sums_smem = static_cast<size_t>(
        fwd_smem_floats(R, sizeof(T), false)) * sizeof(float);
    err = allow_smem(scan_n1_fwd_sums_kernel<T>, sums_smem);
    if (err != cudaSuccess) return err;
    scan_n1_fwd_sums_kernel<T><<<grid, kThreads, sums_smem, stream>>>(
        static_cast<const T*>(p.xr), static_cast<const T*>(p.xc), p.xdbl,
        p.dtw, p.dt_bias, p.A, p.sums, B, L, D, R);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int chains = 4 * B * D;
    scan_n1_fwd_carry_kernel<<<(chains + kCarryThreads - 1) / kCarryThreads,
                               kCarryThreads, 0, stream>>>(p.sums, p.carries,
                                                           B, nchunks, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  scan_n1_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(p.xr), static_cast<const T*>(p.xc), p.xdbl, p.dtw,
      p.dt_bias, p.A, p.Dv, p.carries, static_cast<T*>(p.y), B, L, D, R);
  return cudaGetLastError();
}

struct BwdArgs {
  const void* xr;
  const void* xc;
  const float* xdbl;
  const float* dtw;
  const float* dt_bias;
  const float* A;
  const float* Dv;
  const void* dy;
  float* sums;
  float* carries;
  float* du;
  float* dxdbl_part;
  float* dA;
  float* dD;
  float* ddb;
  float* ddtw;
};

// kernels 1 and 2: the chunk summaries, then the carries
template <typename T>
cudaError_t launch_carries(const BwdArgs& p, int B, int L, int D, int R,
                           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(sums_smem_floats(R)) * sizeof(float);
  cudaError_t err = allow_smem(scan_n1_bwd_sums_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int nblk = (D + kThreads - 1) / kThreads;
  const int nchunks = (L + kChunk - 1) / kChunk;
  scan_n1_bwd_sums_kernel<T><<<dim3(nchunks * nblk, B, 4), kThreads, smem,
                               stream>>>(
      static_cast<const T*>(p.xr), static_cast<const T*>(p.xc), p.xdbl, p.dtw,
      p.dt_bias, p.A, static_cast<const T*>(p.dy), p.sums, B, L, D, R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int chains = 4 * B * D;
  scan_n1_bwd_carry_kernel<<<(chains + kCarryThreads - 1) / kCarryThreads,
                             kCarryThreads, 0, stream>>>(p.sums, p.carries, B,
                                                         nchunks, D);
  return cudaGetLastError();
}

// all three kernels
template <typename T>
cudaError_t launch_bwd(const BwdArgs& p, int B, int L, int D, int R,
                       cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(grad_smem_floats(R)) * sizeof(float);
  cudaError_t err = allow_smem(scan_n1_bwd_grad_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  err = launch_carries<T>(p, B, L, D, R, stream);
  if (err != cudaSuccess) return err;
  const int nblk = (D + kThreads - 1) / kThreads;
  const int nchunks = (L + kChunk - 1) / kChunk;
  scan_n1_bwd_grad_kernel<T><<<dim3(nchunks * nblk, B, 2), kThreads, smem,
                               stream>>>(
      static_cast<const T*>(p.xr), static_cast<const T*>(p.xc), p.xdbl, p.dtw,
      p.dt_bias, p.A, p.Dv, static_cast<const T*>(p.dy), p.carries, p.du,
      p.dxdbl_part, p.dA, p.dD, p.ddb, p.ddtw, B, L, D, R);
  return cudaGetLastError();
}

// Resident blocks an SM of `kernel` at its launch's block and dynamic
// shared memory for rank R, and that shared memory in bytes.
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int threads, int floats, int* blocks,
                      int* smem_bytes) {
  *smem_bytes = floats * static_cast<int>(sizeof(float));
  const cudaError_t err = allow_smem(kernel, *smem_bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       threads, *smem_bytes);
}

// backward kernel `kernel`: 0 sums, 1 carry, 2 grad
template <typename T>
cudaError_t occupancy_bwd(int kernel, int R, int* blocks, int* smem_bytes) {
  if (kernel == 1)
    return occupancy(scan_n1_bwd_carry_kernel, kCarryThreads, 0, blocks,
                     smem_bytes);
  return kernel == 0 ? occupancy(scan_n1_bwd_sums_kernel<T>, kThreads,
                                 sums_smem_floats(R), blocks,
                                 smem_bytes)
                     : occupancy(scan_n1_bwd_grad_kernel<T>, kThreads,
                                 grad_smem_floats(R), blocks, smem_bytes);
}

// forward kernel `kernel`: 0 sums, 1 carry, 2 scan (cut: with y_s)
template <typename T>
cudaError_t occupancy_fwd(int kernel, int R, bool cut, int* blocks,
                          int* smem_bytes) {
  if (kernel == 1)
    return occupancy(scan_n1_fwd_carry_kernel, kCarryThreads, 0, blocks,
                     smem_bytes);
  return kernel == 0 ? occupancy(scan_n1_fwd_sums_kernel<T>, kThreads,
                                 fwd_smem_floats(R, sizeof(T), false),
                                 blocks, smem_bytes)
                     : occupancy(scan_n1_fwd_kernel<T>, kThreads,
                                 fwd_smem_floats(R, sizeof(T), cut), blocks,
                                 smem_bytes);
}

// The sizes fit the grids: 4 B D chains in an int, B in grid.y.
bool sizes_ok(int B, int L, int D, int R) {
  const long long nblk = (D + kThreads - 1) / kThreads;
  const long long nchunks = (L + kChunk - 1) / kChunk;
  return B >= 1 && L >= 1 && D >= 1 && R >= 1 && B <= 65535 &&
         4LL * B * D <= 0x7fffffffLL && nchunks * nblk <= 0x7fffffffLL;
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launches (0 on success).

// The forward; sums and carries are the cut regime's workspaces, both
// null for one pass.
int mia_scan_n1_fwd(const void* xr, const void* xc, int is_bf16,
                    const float* xdbl, const float* dtw, const float* dt_bias,
                    const float* A, const float* Dv, float* sums,
                    float* carries, void* y, int B, int L, int D, int R,
                    void* stream) {
  if (!sizes_ok(B, L, D, R) || (sums == nullptr) != (carries == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FwdArgs p{xr, xc, xdbl, dtw, dt_bias, A, Dv, sums, carries, y};
  return is_bf16 ? launch_fwd<__nv_bfloat16>(p, B, L, D, R, s)
                 : launch_fwd<float>(p, B, L, D, R, s);
}

// The backward's kernels 1 and 2 alone: sums and carries (the workspaces
// of mia_scan_n1_bwd), for tests of the carries.
int mia_scan_n1_bwd_carries(const void* xr, const void* xc, int is_bf16,
                            const float* xdbl, const float* dtw,
                            const float* dt_bias, const float* A,
                            const void* dy, float* sums, float* carries,
                            int B, int L, int D, int R, void* stream) {
  if (!sizes_ok(B, L, D, R)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdArgs p{xr, xc, xdbl, dtw, dt_bias, A, nullptr, dy, sums, carries,
                  nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  return is_bf16 ? launch_carries<__nv_bfloat16>(p, B, L, D, R, s)
                 : launch_carries<float>(p, B, L, D, R, s);
}

int mia_scan_n1_bwd(const void* xr, const void* xc, int is_bf16,
                    const float* xdbl, const float* dtw, const float* dt_bias,
                    const float* A, const float* Dv, const void* dy,
                    float* sums, float* carries, float* du, float* dxdbl_part,
                    float* dA, float* dD, float* ddb, float* ddtw, int B,
                    int L, int D, int R, void* stream) {
  if (!sizes_ok(B, L, D, R)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdArgs p{xr, xc, xdbl, dtw, dt_bias, A, Dv, dy, sums, carries,
                  du, dxdbl_part, dA, dD, ddb, ddtw};
  return is_bf16 ? launch_bwd<__nv_bfloat16>(p, B, L, D, R, s)
                 : launch_bwd<float>(p, B, L, D, R, s);
}

// Forward kernel `kernel`'s (0 sums, 1 carry, 2 scan) resident blocks an
// SM on the current device (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// at its launch's block and dynamic shared memory for rank R, in the cut
// regime or in one pass) into *blocks, and that shared memory in bytes
// into *smem_bytes.
int mia_scan_n1_fwd_blocks_per_sm(int kernel, int R, int is_bf16, int cut,
                                  int* blocks, int* smem_bytes) {
  if (kernel < 0 || kernel > 2 || R < 1) return cudaErrorInvalidValue;
  return is_bf16 ? occupancy_fwd<__nv_bfloat16>(kernel, R, cut != 0, blocks,
                                                smem_bytes)
                 : occupancy_fwd<float>(kernel, R, cut != 0, blocks,
                                        smem_bytes);
}

// The same for backward kernel `kernel` (0 sums, 1 carry, 2 grad).
int mia_scan_n1_bwd_blocks_per_sm(int kernel, int R, int is_bf16,
                                  int* blocks, int* smem_bytes) {
  if (kernel < 0 || kernel > 2 || R < 1) return cudaErrorInvalidValue;
  return is_bf16 ? occupancy_bwd<__nv_bfloat16>(kernel, R, blocks, smem_bytes)
                 : occupancy_bwd<float>(kernel, R, blocks, smem_bytes);
}

}  // extern "C"
