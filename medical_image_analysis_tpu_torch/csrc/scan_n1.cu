// d_state=1 four-direction VMamba scan for Hopper (sm_90a): two kernels.
//
// They replace the two Pallas TPU kernels of
// medical_image_analysis_tpu/ops/scan_n1.py:
//
//   scan_n1_fwd_kernel  <- _fwd_kernel (:89, launched at :316)
//   scan_n1_bwd_kernel  <- _bwd_kernel (:150, launched at :412)
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
// Layout of the work: one thread owns one (source, image, channel) chain
// and runs BOTH of its directions, the forward one first and then the
// reversed one, so the two directions of a source sum in the thread with
// no race and no second launch. The forward direction writes its outputs
// to y; the reversed direction reads them back and adds its own. A
// reversed direction starts at source row L-1 with a zero state; dt of a
// row is computed at that row's own position. Nothing is padded.
//
// What bounds them on the H100, and what the design does about it:
//  - Both are a chain of L dependent steps per channel (L = 3136 at stage 0
//    of vssm1_base), so latency, not bytes or FLOPs, bounds them. The block's
//    64 channels share the rows of x_dbl: a tile of them, and of the source
//    rows, is staged in shared memory so that the loads of a tile are issued
//    together and not once per dependent step. dt_proj runs in the kernel,
//    as the TPU kernel runs it in its body (the fp32 (B, 4, L, D) dt tensor
//    never exists): W_dt's R columns for the block's channels sit in shared
//    memory. Every per-row term (dt's dot product, softplus, the decay, the
//    input term; in the backward also the terms after the adjoint) is
//    computed for a whole tile at once, with the rows interleaved in
//    registers (row_terms), so that the dependent chain carries one FMA a
//    step, as the TPU kernel's does. (A first version that computed them
//    inside the chain took 2.78 ms instead of 1.78 ms at stage 0 of
//    vssm1_base, B=12, fp32, on an H100 80GB HBM3 at 700 W.) What remains
//    per tile is the staging's global-load latency with one or two warps an
//    SM; a chunked parallel scan over L is the next step.
//  - The backward walks each chain three times: forward to write the state
//    before every kChunk rows into a scratch buffer of the wrapper (the
//    forward kernel saves no carries: the context tower and validation run
//    it without a gradient, and then they would be waste), then the chunks
//    back to front, rebuilding each chunk's states in shared memory and
//    running the adjoint chain over it. dB, dC and dt_r need sums over the
//    D channels of each row: each block sums its 64 channels in a fixed
//    order from the staged values (channel_sum) and writes a per-block
//    partial that the wrapper sums. dA, dD, d dt_bias and dW_dt are written per image and
//    summed by the wrapper too. No float atomics: the gradients are the
//    same in every run.
//
// Both launch on the caller's stream, allocate nothing, and return
// cudaGetLastError() so that the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 64;       // channels per block
constexpr int kTile = 32;          // rows staged per pass
constexpr int kChunk = 16;         // rows whose states the backward rebuilds
constexpr int kS = kThreads + 1;   // padded stride of per-channel columns
static_assert(kTile % kChunk == 0, "tiles hold whole chunks");

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
  // logaddexp(x, 0), the form jax.nn.softplus uses
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
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
    const float dt = softplus(v[r]);
    av[r] = expf(dt * a);
    bv[r] = dt * x_col[r * x_stride] * xd_s[r * C + R];
    if (kGrad) {
      dtv[r] = dt;
      sgv[r] = 1.0f / (1.0f + expf(-v[r]));  // softplus'(dt_raw)
    }
  }
}

// grid (ceil(D / kThreads), B, 2 sources), block kThreads, dynamic smem
// fwd_smem_floats(R) floats.
__host__ __device__ constexpr int fwd_smem_floats(int R) {
  return R * kThreads + kTile * (R + 2) + 2 * kTile * kThreads;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) scan_n1_fwd_kernel(
    const T* __restrict__ xr, const T* __restrict__ xc,
    const float* __restrict__ xdbl, const float* __restrict__ dtw,
    const float* __restrict__ dt_bias, const float* __restrict__ A,
    const float* __restrict__ Dv, T* __restrict__ y, int B, int L, int D,
    int R) {
  extern __shared__ float smem[];
  const int C = R + 2;
  float* dtw_s = smem;                    // (R, kThreads)
  float* xd_s = dtw_s + R * kThreads;     // (kTile, C)
  float* x_s = xd_s + kTile * C;          // (kTile, kThreads)
  float* y_s = x_s + kTile * kThreads;    // (kTile, kThreads): y so far

  const int s = blockIdx.z;  // 0: row-major source, 1: column-major
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kThreads;
  const int tid = threadIdx.x;
  const int d = d0 + tid;
  const bool active = d < D;
  const T* src = (s == 0 ? xr : xc) + static_cast<size_t>(b) * L * D;
  const size_t plane = (static_cast<size_t>(s) * B + b) * L * D;

  for (int pass = 0; pass < 2; ++pass) {
    const int k = s + 2 * pass;
    const bool rev = pass == 1;
    // the previous pass is done with dtw_s, and its y writes are visible
    __syncthreads();
    for (int i = tid; i < R * kThreads; i += kThreads) {
      const int dd = i / R;
      const int q = i - dd * R;
      dtw_s[q * kThreads + dd] =
          d0 + dd < D ? dtw[(static_cast<size_t>(k) * D + d0 + dd) * R + q]
                      : 0.0f;
    }
    const float a = active ? A[k * D + d] : 0.0f;
    const float db = active ? dt_bias[k * D + d] : 0.0f;
    const float dskip = active ? Dv[k * D + d] : 0.0f;
    const float* xd_g = xdbl + (static_cast<size_t>(k) * B + b) * L * C;
    float h = 0.0f;
    for (int i0 = 0; i0 < L; i0 += kTile) {
      const int nt = min(kTile, L - i0);
      __syncthreads();  // dtw_s written / the previous tile consumed
      for (int o = tid; o < nt * C; o += kThreads) {
        const int r = o / C;
        xd_s[o] = xd_g[static_cast<size_t>(src_row(i0 + r, L, rev)) * C +
                       (o - r * C)];
      }
      for (int o = tid; o < nt * kThreads; o += kThreads) {
        const int r = o / kThreads;
        const int dd = o - r * kThreads;
        const size_t row = static_cast<size_t>(src_row(i0 + r, L, rev)) * D;
        const bool in = d0 + dd < D;
        x_s[o] = in ? to_float(src[row + d0 + dd]) : 0.0f;
        if (rev) y_s[o] = in ? to_float(y[plane + row + d0 + dd]) : 0.0f;
      }
      __syncthreads();
      if (!active) continue;
      float av[kTile], bv[kTile];
      row_terms<kTile, false>(xd_s, C, R, x_s + tid, kThreads, dtw_s + tid,
                              kThreads, db, a, av, bv, av, bv);
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        if (r < nt) {
          h = av[r] * h + bv[r];  // the only dependent chain
          const T out = from_float<T>(xd_s[r * C + R + 1] * h +
                                      dskip * x_s[r * kThreads + tid]);
          const size_t o =
              plane + static_cast<size_t>(src_row(i0 + r, L, rev)) * D + d;
          y[o] = rev ? from_float<T>(y_s[r * kThreads + tid] + to_float(out))
                     : out;
        }
      }
    }
  }
}

// sum over the block's channels of a[j] * b[j] (b null: of a[j]), in a fixed
// order: four interleaved partial sums, then their pairwise sum
__device__ __forceinline__ float channel_sum(const float* a, const float* b) {
  float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < kThreads; j += 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] += b ? a[j + e] * b[j + e] : a[j + e];
  }
  return (p[0] + p[1]) + (p[2] + p[3]);
}

// grid (ceil(D / kThreads), B, 2 sources), block kThreads, dynamic smem
// bwd_smem_floats(R) floats.
//
// Outputs (fp32): du (2, B, L, D), the gradient w.r.t. the sources through
// the scan and the D skip of both directions (the x_proj path reaches the
// sources through dxdbl, outside); dxdbl_part (nblk, 4, B, L, R+2) in
// source order; dA, dD, ddb (B, 4, D) and ddtw (B, 4, D, R), per image.
// carries is a scratch buffer of (2, B, ceil(L / kChunk), D) floats.
__host__ __device__ constexpr int bwd_smem_floats(int R) {
  return 2 * R * kS               // dtw_s, dwdt_s
         + kTile * (R + 2)        // xd_s
         + kTile * kS             // x_s
         + 5 * kChunk * kS;       // per-row values of a chunk
}

template <typename T>
__global__ void __launch_bounds__(kThreads) scan_n1_bwd_kernel(
    const T* __restrict__ xr, const T* __restrict__ xc,
    const float* __restrict__ xdbl, const float* __restrict__ dtw,
    const float* __restrict__ dt_bias, const float* __restrict__ A,
    const float* __restrict__ Dv, const T* __restrict__ dy,
    float* __restrict__ carries, float* __restrict__ du,
    float* __restrict__ dxdbl_part, float* __restrict__ dA_out,
    float* __restrict__ dD_out, float* __restrict__ ddb_out,
    float* __restrict__ ddtw_out, int B, int L, int D, int R) {
  extern __shared__ float smem[];
  const int C = R + 2;
  float* dtw_s = smem;                  // (R, kS)
  float* dwdt_s = dtw_s + R * kS;       // (R, kS)
  float* xd_s = dwdt_s + R * kS;        // (kTile, C)
  float* x_s = xd_s + kTile * C;        // (kTile, kS): u
  float* h_s = x_s + kTile * kS;        // (kChunk, kS): state after the row
  float* dy_s = h_s + kChunk * kS;      // dy
  float* ddt_s = dy_s + kChunk * kS;    // grad w.r.t. dt_raw
  float* pdtu_s = ddt_s + kChunk * kS;  // adjoint * dt * u   (dB terms)
  float* hdy_s = pdtu_s + kChunk * kS;  // h * dy             (dC terms)

  const int s = blockIdx.z;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kThreads;
  const int tid = threadIdx.x;
  const int d = d0 + tid;
  // Inactive lanes (d >= D) run the same code on zeros, so that every lane
  // reaches every barrier and their shared-memory entries are 0.
  const bool active = d < D;
  const T* src = (s == 0 ? xr : xc) + static_cast<size_t>(b) * L * D;
  const size_t plane = (static_cast<size_t>(s) * B + b) * L * D;
  const int nchunks = (L + kChunk - 1) / kChunk;
  float* car = carries + (static_cast<size_t>(s) * B + b) * nchunks * D;

  for (int pass = 0; pass < 2; ++pass) {
    const int k = s + 2 * pass;
    const bool rev = pass == 1;
    __syncthreads();  // the previous pass is done with dtw_s and dwdt_s
    for (int i = tid; i < R * kThreads; i += kThreads) {
      const int dd = i / R;
      const int q = i - dd * R;
      dtw_s[q * kS + dd] =
          d0 + dd < D ? dtw[(static_cast<size_t>(k) * D + d0 + dd) * R + q]
                      : 0.0f;
      dwdt_s[q * kS + dd] = 0.0f;
    }
    const float a = active ? A[k * D + d] : 0.0f;
    const float db = active ? dt_bias[k * D + d] : 0.0f;
    const float dskip = active ? Dv[k * D + d] : 0.0f;
    const float* xd_g = xdbl + (static_cast<size_t>(k) * B + b) * L * C;

    // ---- walk 1: the state before every chunk --------------------------
    float h = 0.0f;
    for (int i0 = 0; i0 < L; i0 += kTile) {
      const int nt = min(kTile, L - i0);
      __syncthreads();
      for (int o = tid; o < nt * C; o += kThreads) {
        const int r = o / C;
        xd_s[o] = xd_g[static_cast<size_t>(src_row(i0 + r, L, rev)) * C +
                       (o - r * C)];
      }
      for (int o = tid; o < nt * kThreads; o += kThreads) {
        const int r = o / kThreads;
        const int dd = o - r * kThreads;
        const size_t row = static_cast<size_t>(src_row(i0 + r, L, rev)) * D;
        x_s[r * kS + dd] = d0 + dd < D ? to_float(src[row + d0 + dd]) : 0.0f;
      }
      __syncthreads();
      float av[kTile], bv[kTile];
      row_terms<kTile, false>(xd_s, C, R, x_s + tid, kS, dtw_s + tid, kS, db,
                              a, av, bv, av, bv);
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        if (r < nt) {
          if (r % kChunk == 0 && active)  // kTile is a multiple of kChunk
            car[static_cast<size_t>((i0 + r) / kChunk) * D + d] = h;
          h = av[r] * h + bv[r];
        }
      }
    }

    // ---- walks 2 and 3: chunks back to front ---------------------------
    float g = 0.0f, dA = 0.0f, dD = 0.0f, ddb = 0.0f;
    for (int c = nchunks - 1; c >= 0; --c) {
      const int i0 = c * kChunk;
      const int nt = min(kChunk, L - i0);
      __syncthreads();  // the previous chunk's sums are done
      for (int o = tid; o < nt * C; o += kThreads) {
        const int r = o / C;
        xd_s[o] = xd_g[static_cast<size_t>(src_row(i0 + r, L, rev)) * C +
                       (o - r * C)];
      }
      for (int o = tid; o < nt * kThreads; o += kThreads) {
        const int r = o / kThreads;
        const int dd = o - r * kThreads;
        const size_t row = static_cast<size_t>(src_row(i0 + r, L, rev)) * D;
        const bool in = d0 + dd < D;
        x_s[r * kS + dd] = in ? to_float(src[row + d0 + dd]) : 0.0f;
        dy_s[r * kS + dd] = in ? to_float(dy[plane + row + d0 + dd]) : 0.0f;
      }
      __syncthreads();

      // rebuild the chunk's states from its carry
      const float hc = active ? car[static_cast<size_t>(c) * D + d] : 0.0f;
      float av[kChunk], bv[kChunk], dtv[kChunk], sgv[kChunk], pv[kChunk];
      row_terms<kChunk, true>(xd_s, C, R, x_s + tid, kS, dtw_s + tid, kS, db,
                              a, av, bv, dtv, sgv);
      h = hc;
#pragma unroll
      for (int r = 0; r < kChunk; ++r) {
        if (r < nt) {
          h = av[r] * h + bv[r];
          h_s[r * kS + tid] = h;
        }
      }
      // the adjoint chain, last row first: p[r] = C dy + a[r+1] p[r+1],
      // with the adjoint g carried in from the chunk after this one
#pragma unroll
      for (int r = kChunk - 1; r >= 0; --r) {
        if (r < nt) {
          pv[r] = xd_s[r * C + R + 1] * dy_s[r * kS + tid] + g;
          g = av[r] * pv[r];
        }
      }
      // given the adjoint, the rows are independent again
#pragma unroll
      for (int r = kChunk - 1; r >= 0; --r) {
        if (r < nt) {
          const float p = pv[r];
          const float dt = dtv[r];
          const float dyv = dy_s[r * kS + tid];
          const float u = x_s[r * kS + tid];
          const float hp = r > 0 ? h_s[(r - 1) * kS + tid] : hc;
          const float dloga = p * hp * av[r];
          const float ddt = (dloga * a + p * u * xd_s[r * C + R]) * sgv[r];
          dA += dloga * dt;
          dD += dyv * u;
          ddb += ddt;
          ddt_s[r * kS + tid] = ddt;
          pdtu_s[r * kS + tid] = p * dt * u;
          hdy_s[r * kS + tid] = h_s[r * kS + tid] * dyv;
          if (active) {
            const size_t o =
                plane + static_cast<size_t>(src_row(i0 + r, L, rev)) * D + d;
            const float v = dt * xd_s[r * C + R] * p + dyv * dskip;
            du[o] = rev ? du[o] + v : v;  // the forward direction wrote first
          }
        }
      }
      __syncthreads();

      // sums over this block's channels: the dt_r, dB and dC of each row
      float* part =
          dxdbl_part +
          ((static_cast<size_t>(blockIdx.x) * 4 + k) * B + b) * L * C;
      for (int o = tid; o < nt * C; o += kThreads) {
        const int r = o / C;
        const int col = o - r * C;
        const float sum =
            col < R ? channel_sum(ddt_s + r * kS, dtw_s + col * kS)
                    : channel_sum((col == R ? pdtu_s : hdy_s) + r * kS,
                                  nullptr);
        part[static_cast<size_t>(src_row(i0 + r, L, rev)) * C + col] = sum;
      }
      // dW_dt[d, q] += sum over the chunk's rows of ddt * dt_r[q]
      for (int q = 0; q < R; ++q) {
        float sum = 0.0f;
        for (int r = 0; r < nt; ++r)
          sum += ddt_s[r * kS + tid] * xd_s[r * C + q];
        dwdt_s[q * kS + tid] += sum;
      }
    }

    if (active) {
      const size_t w = (static_cast<size_t>(b) * 4 + k) * D + d;
      dA_out[w] = dA;
      dD_out[w] = dD;
      ddb_out[w] = ddb;
      for (int q = 0; q < R; ++q) ddtw_out[w * R + q] = dwdt_s[q * kS + tid];
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

template <typename T>
cudaError_t launch_fwd(const void* xr, const void* xc, const float* xdbl,
                       const float* dtw, const float* dt_bias, const float* A,
                       const float* Dv, void* y, int B, int L, int D, int R,
                       cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(fwd_smem_floats(R)) * sizeof(float);
  const cudaError_t err = allow_smem(scan_n1_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((D + kThreads - 1) / kThreads, B, 2);
  scan_n1_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xc), xdbl, dtw,
      dt_bias, A, Dv, static_cast<T*>(y), B, L, D, R);
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
  float* carries;
  float* du;
  float* dxdbl_part;
  float* dA;
  float* dD;
  float* ddb;
  float* ddtw;
};

template <typename T>
cudaError_t launch_bwd(const BwdArgs& p, int B, int L, int D, int R,
                       cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(bwd_smem_floats(R)) * sizeof(float);
  const cudaError_t err = allow_smem(scan_n1_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((D + kThreads - 1) / kThreads, B, 2);
  scan_n1_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(p.xr), static_cast<const T*>(p.xc), p.xdbl, p.dtw,
      p.dt_bias, p.A, p.Dv, static_cast<const T*>(p.dy), p.carries, p.du,
      p.dxdbl_part, p.dA, p.dD, p.ddb, p.ddtw, B, L, D, R);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success).
int mia_scan_n1_fwd(const void* xr, const void* xc, int is_bf16,
                    const float* xdbl, const float* dtw, const float* dt_bias,
                    const float* A, const float* Dv, void* y, int B, int L,
                    int D, int R, void* stream) {
  if (B < 1 || L < 1 || D < 1 || R < 1 || B > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_fwd<__nv_bfloat16>(xr, xc, xdbl, dtw, dt_bias, A,
                                             Dv, y, B, L, D, R, s)
                 : launch_fwd<float>(xr, xc, xdbl, dtw, dt_bias, A, Dv, y, B,
                                     L, D, R, s);
}

int mia_scan_n1_bwd(const void* xr, const void* xc, int is_bf16,
                    const float* xdbl, const float* dtw, const float* dt_bias,
                    const float* A, const float* Dv, const void* dy,
                    float* carries, float* du, float* dxdbl_part, float* dA,
                    float* dD, float* ddb, float* ddtw, int B, int L, int D,
                    int R, void* stream) {
  if (B < 1 || L < 1 || D < 1 || R < 1 || B > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdArgs p{xr, xc, xdbl, dtw, dt_bias, A, Dv, dy,
                  carries, du, dxdbl_part, dA, dD, ddb, ddtw};
  return is_bf16 ? launch_bwd<__nv_bfloat16>(p, B, L, D, R, s)
                 : launch_bwd<float>(p, B, L, D, R, s);
}

}  // extern "C"
