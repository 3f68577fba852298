// Fused multi-direction Mamba layer for Hopper (sm_90a): the forward's two
// x_dbl kernels and its three scan kernels, and the three kernels of the
// backward.
//
// They replace the three Pallas TPU kernels of
// medical_image_analysis_tpu/ops/mamba_fused.py:
//
//   mamba_xdbl_kernel,
//   mamba_xdbl_sum_kernel  <- _xdbl_kernel (:111, launched at :333; x_dbl =
//                                 silu(conv(x_dir) + b) @ Wx^T, see "x_dbl")
//   mamba_scan_sums_kernel,
//   mamba_scan_carry_kernel,
//   mamba_scan_kernel      <- _fused_fwd_kernel (:145, launched at :389; conv
//                                 + SiLU again, dt_proj, softplus, S6 scan,
//                                 D skip; see "the forward")
//   mamba_scan_bwd_sums_kernel,
//   mamba_scan_bwd_carry_kernel,
//   mamba_scan_bwd_grad_kernel <- _fused_bwd_kernel (:197, launched at :479;
//                                 the scan's adjoint, see "the backward")
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
// d_state: the scan kernels are built for N = 4, 16, 17 and 32 (17 is
// MambaPEFT's additional_scan width on 16, an odd N: see lane_states); the
// wrapper runs any other N up to 32 at the next of these with zero B, C and
// A in the extra states, and raises past 32. x_dbl takes any C.
//
// Direction k reads source (k >= 2 ? xc : xr); odd k scans it back to front,
// so scan row t is source row L-1-t. The TPU version flipped rows in VMEM with
// anti-identity matmuls and padded L to its chunk; here the flip is index
// arithmetic and nothing is padded: a reversed direction starts at source row
// L-1 with a zero conv carry and a zero state.
//
// What bounds them on the H100, and what the design does about it:
//  - xdbl: a (B*K*L) x C x D fp32 product (C 38 to 80 on the main paths;
//    any C runs), at vssm_tiny stage 0, B=128, 23.4 GFLOP for 0.86 GB of
//    sources read and x_dbl written: on the tensor cores in 3xTF32 (165
//    TFLOP/s) the bytes bound it (0.26 ms at 3.35 TB/s), the products all
//    but (0.14 ms). It ran on the CUDA cores, a block 8 rows of one
//    direction and a warp a column of C reduced over D by shuffles, every
//    block reading its direction's whole Wx from L2 (5.13 ms there, 0.118
//    ms at ARM-B, B=6, on an H100 80GB HBM3 at 700 W). It is now mma.sync
//    m16n8k8 in 3xTF32 over tiles of 64 or 128 source rows, both
//    directions of a source a block (D split over blocks where the grid is
//    small), the conv and SiLU computed as the operand is staged: see
//    "x_dbl" below. At these C the warps' fragment loads and splits and
//    the 3xTF32 MMAs, not the bytes, hold it.
//  - scan: a chain of L dependent steps per (b, k, d) channel, so latency,
//    not bytes or FLOPs, bounds it where the grid is small, and the
//    instructions of each element where it is large. It ran as one thread a
//    channel walking all of L, (D/64) x B*K blocks of 2 warps: 48 blocks at
//    ARM-B, B=1, 0.314 ms against a 0.002 ms bound, and at vssm_tiny (B=128,
//    a grid of 1,536 to 12,288 blocks) 16 expf, a 16-term dependent readout
//    and the dt_proj dot on one thread's path for each element, staged
//    behind two barriers every 32 rows (5.36 ms at stage 0), on an H100
//    80GB HBM3 at 700 W. It is now a chunked scan built from the backward's
//    pieces: see "the forward" below.
//  - scan backward: the same dependent chain. It ran as one thread a
//    channel walking all of L twice, with the state before every 8-row
//    chunk written to a buffer over all of L (2.47 GB at vssm_tiny stage 0,
//    B=128) and 124.5 KB of shared memory a block at ARM-B, 1 block (2
//    warps) an SM: 2.71 ms against a 0.04 ms bound on an H100 80GB HBM3 at
//    700 W. It is now a chunked scan that runs in parallel over L, in three
//    kernels, with its sums over channels in warp shuffles: see "the
//    backward" below.
//
// All launch on the caller's stream, allocate nothing (the wrapper
// allocates every workspace), and return cudaGetLastError() so that the
// Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "mma_tc.cuh"

namespace {

constexpr int kMaxTaps = 4;

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

// ---- x_dbl: the x_proj product on the tensor cores --------------------------
//
// x_dbl[b*K + k, t, :] = Wx[k] @ u_k[b, t] for scan row t of direction k,
// u_k = silu(conv_k(x) + b_k) of the scan-order source (or the source itself
// without a conv), fp32: a (B*K*L) x C x D product, C = R + 2N. A block of
// mamba_xdbl_kernel owns a tile of xdbl_rows(MW) = 64 MW rows of one image's
// source, `dirs` of the directions that read it (both, k = 2s and 2s + 1,
// the forward and the reversed scan of source s, or one), 8 NT columns of C
// (16 NT with one direction; more columns take more blocks along z) and
// one of `splits` ranges of D (more than one where the grid would leave SMs
// idle: their partial sums go to a workspace that mamba_xdbl_sum_kernel adds
// up in a fixed order). It walks its D in slices of 32:
//  - the source rows of the slice with a halo of taps - 1 rows on each side
//    (the forward direction's conv reads the rows before a row, the reversed
//    one's the rows after), each direction's Wx rows and its conv's taps and
//    bias go to shared memory by cp.async, kXdblStages - 1 slices in flight
//    while a slice is computed (plain loads where a row of D is not a
//    multiple of 16 bytes);
//  - u is computed from the staged rows into a padded fp32 tile (the conv,
//    bias and SiLU; a bf16 source converted), except for an fp32 source
//    without a conv, whose staged rows are the operand;
//  - each warp owns 16 MW rows of one direction and NT n8 tiles (all the
//    block's, or with one direction a block half of them); it loads its A
//    and B fragments by ldmatrix (a tf32 fragment is a b16 one's pair) and
//    splits them into 3xTF32 hi and lo in registers. The MMAs
//    (mma_3xtf32) of up to 7 tiles run as independent chains, each slice's
//    summed from zero and added to the accumulators in fp32 (mma_tc.cuh:
//    the tensor cores truncate inside their sums).
// The epilogue stages the tile in shared memory and writes each direction's
// rows as one run of x_dbl: a reversed direction's tile row i is scan row
// L - 1 - (s0 + i), index arithmetic only.
constexpr int kXdblThreads = 256;  // 8 warps: 4 row groups x 2
constexpr int kXdblSlice = 32;     // D a slice
constexpr int kXdblPad = kXdblSlice + 4;  // fp32 tile rows, floats
constexpr int kXdblStages = 3;     // slices staged at once
constexpr int kXdblBlocks = 2;     // resident blocks an SM (register cap)
// n8 tiles a warp (NT) the kernel is built for at 64 rows (C of 40, 48, 56,
// 80 with both directions a block); 128 rows take 5. The caller picks NT
// for its C (the wrapper's xdbl_nt); past NT's columns, more blocks along z.
constexpr int kXdblTiles[] = {5, 6, 7, 10};

__host__ __device__ constexpr int xdbl_rows(int mw) { return 64 * mw; }

// Columns of C a block takes: NT n8 tiles, twice with one direction.
__host__ __device__ inline int xdbl_block_cols(int nt, int dirs) {
  return 8 * nt * (dirs == 1 ? 2 : 1);
}

// Floats of a staged source row: fp32 kXdblPad, bf16 40 elements (16-byte
// aligned rows either way).
__host__ __device__ constexpr int xdbl_xrow(bool bf16) {
  return bf16 ? (kXdblSlice + 8) / 2 : kXdblPad;
}

// Shared memory of a block, in floats from the start: kXdblStages stages of
// (the source rows; each direction's Wx rows; with a conv each direction's
// taps and bias, kMaxTaps + 1 rows), then u (a tile a direction with a
// conv, one for a bf16 source without); the epilogue's tile reuses the
// start.
struct XdblSmem {
  int x, w, cw, stage, u, total;
};

__host__ __device__ inline XdblSmem xdbl_smem(int rows, int halo, int dirs,
                                              int cols, bool bf16,
                                              bool conv) {
  XdblSmem s;
  s.x = 0;
  s.w = (rows + 2 * halo) * xdbl_xrow(bf16);
  s.cw = s.w + dirs * cols * kXdblPad;
  s.stage = s.cw + (conv ? dirs * (kMaxTaps + 1) * kXdblSlice : 0);
  s.u = kXdblStages * s.stage;
  const int tiles = conv ? dirs : (bf16 ? 1 : 0);
  s.total = s.u + tiles * rows * kXdblPad;
  if (s.total < dirs * rows * cols) s.total = dirs * rows * cols;
  return s;
}

template <typename T>
struct XdblArgs {
  const T* xr;
  const T* xc;  // null when K < 4
  const float* conv_w;
  const float* conv_b;
  const float* wx;
  float* out;  // x_dbl, or with splits > 1 the (splits, B*K, L, C) partials
  int B, K, L, D, C, taps, use_conv, dirs, splits, vec;
};

// SiLU by the fast intrinsics (about 1e-6 relative), well inside x_dbl's
// 1e-4 checks: 7% of x_dbl's time at ARM-B, B=6, on an H100 (PERF.md).
__device__ __forceinline__ float silu_fast(float x) {
  return __fdividef(x, 1.0f + __expf(-x));
}

// The 3xTF32 split of an fp32 x (its bits) by integer ops: hi = x with its
// low 13 mantissa bits cleared, lo = x - hi (exact) rounded to tf32, to
// nearest with ties away as cvt.rna does; x - hi - lo is within 2^-21 |x|,
// as with mma_tc.cuh's split, whose two cvt.rna an element took a quarter
// of the kernel's time at vssm_tiny stages 0 and 1 on an H100 (PERF.md).
__device__ __forceinline__ void split_fast(uint32_t x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = x & 0xffffe000u;
  lo = (__float_as_uint(__uint_as_float(x) - __uint_as_float(hi)) +
        0x1000u) &
       0xffffe000u;
}

// u = silu(conv + bias) of rows i0 .. i0 + R - 1 of one direction and one
// column (x, cw and u point at it): the R + TAPS - 1 staged rows they read
// are loaded once. Staged row i + j feeds the forward scan's tap j, row
// i + 2 (TAPS - 1) - j the reversed one's.
template <int TAPS, int R, typename T>
__device__ __forceinline__ void conv_silu_rows(const T* x, int xrow,
                                               const float* cw, float* u,
                                               int i0, bool rev) {
  constexpr int H = TAPS - 1;
  float w[TAPS];
#pragma unroll
  for (int j = 0; j < TAPS; ++j) w[j] = cw[j * kXdblSlice];
  const float bias = cw[kMaxTaps * kXdblSlice];
  const T* xb = x + (i0 + (rev ? H : 0)) * xrow;
  float xv[R + H];
#pragma unroll
  for (int r = 0; r < R + H; ++r) xv[r] = to_float(xb[r * xrow]);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float acc = bias;
#pragma unroll
    for (int j = 0; j < TAPS; ++j)
      acc += w[j] * (rev ? xv[i + H - j] : xv[i + j]);
    u[(i0 + i) * kXdblPad] = silu_fast(acc);
  }
}

// x_dbl = the sum of the splits' partials, in split order: n floats each.
__global__ void mamba_xdbl_sum_kernel(const float* __restrict__ part,
                                      float* __restrict__ xdbl, int n,
                                      int splits) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float v = part[i];
    for (int z = 1; z < splits; ++z) v += part[static_cast<size_t>(z) * n + i];
    xdbl[i] = v;
  }
}

// grid (ceil(L / rows), B * K / dirs, ceil(C / xdbl_block_cols(NT, dirs)) *
// splits), block kXdblThreads, xdbl_smem(...).total floats of dynamic
// shared memory.
template <typename T, int MW, int NT>
__global__ void __launch_bounds__(kXdblThreads, kXdblBlocks)
    mamba_xdbl_kernel(const XdblArgs<T> p) {
  constexpr int M = xdbl_rows(MW);
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int E = 16 / static_cast<int>(sizeof(T));  // elements a copy
  constexpr int G = NT <= 7 ? NT : 5;  // tiles whose MMA chains interleave
  static_assert(NT % G == 0, "whole groups of tiles");
  extern __shared__ __align__(16) float xs[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = p.K / p.dirs;
  const int b = blockIdx.y / groups;
  const int k0 = (blockIdx.y - b * groups) * p.dirs;  // the first direction
  const int s0 = blockIdx.x * M;                        // the first source row
  const int cb = xdbl_block_cols(NT, p.dirs);          // padded columns
  const int ncb = (p.C + cb - 1) / cb;
  const int zs = blockIdx.z / ncb;                      // this D range
  const int c0 = (blockIdx.z - zs * ncb) * cb;          // the first column
  const int cols = min(cb, p.C - c0);
  const bool conv = p.use_conv != 0;
  const int H = conv ? p.taps - 1 : 0;
  const int xrow = xdbl_xrow(kBf16) * (kBf16 ? 2 : 1);  // in T elements
  const XdblSmem sm = xdbl_smem(M, H, p.dirs, cb, kBf16, conv);
  const T* src = (p.xc != nullptr && k0 >= 2 ? p.xc : p.xr) +
                 static_cast<size_t>(b) * p.L * p.D;
  const int slices = (p.D + kXdblSlice - 1) / kXdblSlice;
  const int per = (slices + p.splits - 1) / p.splits;
  const int sl0 = zs * per;
  const int nsl = max(0, min(slices, sl0 + per) - sl0);

  // tap j of direction k's conv, or its bias for j == taps: a row of D
  auto conv_row = [&](int k, int j) {
    return j < p.taps ? p.conv_w + (static_cast<size_t>(k) * p.taps + j) * p.D
                      : p.conv_b + static_cast<size_t>(k) * p.D;
  };
  // row c0 + r of Wx of direction slot ds
  auto w_row = [&](int ds, int r) {
    return p.wx + (static_cast<size_t>(k0 + ds) * p.C + c0 + r) * p.D;
  };
  // slice sl of the source rows s0 - H .. s0 + M + H - 1, of Wx's rows
  // c0 .. c0 + cb - 1 of each direction and of its conv into stage st,
  // zeros outside
  auto load = [&](int sl, int st) {
    const int d0 = sl * kXdblSlice;
    T* xd = reinterpret_cast<T*>(xs + st * sm.stage + sm.x);
    float* wd = xs + st * sm.stage + sm.w;
    float* cwd = xs + st * sm.stage + sm.cw;
    const int rows = M + 2 * H;
    if (p.vec) {
      constexpr int CH = kXdblSlice / E;
      for (int i = threadIdx.x; i < rows * CH; i += kXdblThreads) {
        const int r = i / CH, c = (i - r * CH) * E;
        const int s = s0 - H + r;
        const bool ok = s >= 0 && s < p.L && d0 + c < p.D;
        tc::cp_async16(xd + r * xrow + c,
                       ok ? src + static_cast<size_t>(s) * p.D + d0 + c : src,
                       ok);
      }
      for (int ds = 0; ds < p.dirs; ++ds)
        for (int i = threadIdx.x; i < cb * 8; i += kXdblThreads) {
          const int r = i >> 3, c = (i & 7) * 4;
          const bool ok = c0 + r < p.C && d0 + c < p.D;
          tc::cp_async16(wd + (ds * cb + r) * kXdblPad + c,
                         ok ? w_row(ds, r) + d0 + c : p.wx, ok);
        }
      if (conv)
        for (int i = threadIdx.x; i < p.dirs * (p.taps + 1) * 8;
             i += kXdblThreads) {
          const int r = i >> 3, c = (i & 7) * 4;
          const int ds = r / (p.taps + 1), j = r - ds * (p.taps + 1);
          const int slot = ds * (kMaxTaps + 1) + (j < p.taps ? j : kMaxTaps);
          const bool ok = d0 + c < p.D;
          tc::cp_async16(cwd + slot * kXdblSlice + c,
                         ok ? conv_row(k0 + ds, j) + d0 + c : p.conv_b, ok);
        }
      return;
    }
    for (int i = threadIdx.x; i < rows * kXdblSlice; i += kXdblThreads) {
      const int r = i >> 5, c = i & 31;
      const int s = s0 - H + r;
      const bool ok = s >= 0 && s < p.L && d0 + c < p.D;
      xd[r * xrow + c] = ok ? src[static_cast<size_t>(s) * p.D + d0 + c]
                            : from_float<T>(0.0f);
    }
    for (int ds = 0; ds < p.dirs; ++ds)
      for (int i = threadIdx.x; i < cb * kXdblSlice; i += kXdblThreads) {
        const int r = i >> 5, c = i & 31;
        wd[(ds * cb + r) * kXdblPad + c] =
            c0 + r < p.C && d0 + c < p.D ? w_row(ds, r)[d0 + c] : 0.0f;
      }
    if (conv)
      for (int i = threadIdx.x; i < p.dirs * (p.taps + 1) * kXdblSlice;
           i += kXdblThreads) {
        const int r = i >> 5, c = i & 31;
        const int ds = r / (p.taps + 1), j = r - ds * (p.taps + 1);
        const int slot = ds * (kMaxTaps + 1) + (j < p.taps ? j : kMaxTaps);
        cwd[slot * kXdblSlice + c] =
            d0 + c < p.D ? conv_row(k0 + ds, j)[d0 + c] : 0.0f;
      }
  };

  // u from stage st: the conv, bias and SiLU of each direction, or a bf16
  // source in fp32; a lane a column, a warp M / 8 rows
  auto prepare = [&](int st) {
    const T* xr = reinterpret_cast<const T*>(xs + st * sm.stage + sm.x);
    float* u = xs + sm.u;
    constexpr int rows = M / 8;
    const int i0 = warp * rows;
    if (!conv) {
      for (int i = i0; i < i0 + rows; ++i)
        u[i * kXdblPad + lane] = to_float(xr[i * xrow + lane]);
      return;
    }
    for (int ds = 0; ds < p.dirs; ++ds) {
      const bool rev = ((k0 + ds) & 1) != 0;
      const float* cw = xs + st * sm.stage + sm.cw +
                        ds * (kMaxTaps + 1) * kXdblSlice + lane;
      float* uk = u + ds * M * kXdblPad + lane;
      switch (p.taps) {
        case 1:
          conv_silu_rows<1, rows>(xr + lane, xrow, cw, uk, i0, rev);
          break;
        case 2:
          conv_silu_rows<2, rows>(xr + lane, xrow, cw, uk, i0, rev);
          break;
        case 3:
          conv_silu_rows<3, rows>(xr + lane, xrow, cw, uk, i0, rev);
          break;
        default:
          conv_silu_rows<4, rows>(xr + lane, xrow, cw, uk, i0, rev);
      }
    }
  };

  // this warp: direction slot ds, rows rg * 16 MW .., n8 tiles nb .. nb+NT-1
  const int rg = warp & 3;
  const int ds = p.dirs == 2 ? warp >> 2 : 0;
  const int nb = p.dirs == 2 ? 0 : (warp >> 2) * NT;
  const bool utile = conv || kBf16;
  float acc[MW][NT][4];
#pragma unroll
  for (int mt = 0; mt < MW; ++mt) tc::zero(acc[mt]);

#pragma unroll
  for (int i = 0; i < kXdblStages - 1; ++i) {
    if (i < nsl) load(sl0 + i, i);
    tc::cp_async_commit();
  }
  for (int it = 0; it < nsl; ++it) {
    const int st = it % kXdblStages;
    tc::cp_async_wait<kXdblStages - 2>();
    __syncthreads();  // slice it landed; slice it - 1's operands are free
    if (it + kXdblStages - 1 < nsl)
      load(sl0 + it + kXdblStages - 1, (it + kXdblStages - 1) % kXdblStages);
    tc::cp_async_commit();
    if (utile) {
      prepare(st);
      __syncthreads();
    }
    const float* A = utile ? xs + sm.u + (conv ? ds * M * kXdblPad : 0)
                           : xs + st * sm.stage + sm.x;
    // A: rows 0-7, 8-15 of an m16 tile at k 0-3, then at k 4-7;
    // B: rows n8 .. n8 + 7 of Wx at k 0-3, 4-7, 8-11, 12-15 (b0, b1 of two
    // k8 steps)
    const float* Ar = A + (16 * MW * rg + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                              kXdblPad +
                      4 * (lane >> 4);
    const float* Br = xs + st * sm.stage + sm.w +
                      ((ds * cb + 8 * nb + (lane & 7)) * kXdblPad) +
                      4 * (lane >> 3);
#pragma unroll
    for (int mt = 0; mt < MW; ++mt)
#pragma unroll
      for (int g0 = 0; g0 < NT; g0 += G) {
        float t[G][4];
        tc::zero(t);
#pragma unroll
        for (int kp = 0; kp < 2; ++kp) {  // k8 steps 2 kp, 2 kp + 1
          tc::Split<4> a[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t f[4];
            tc::ldsm_x4(f, Ar + 16 * mt * kXdblPad + 16 * kp + 8 * h);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              split_fast(f[e], a[h].hi[e], a[h].lo[e]);
          }
#pragma unroll
          for (int j = 0; j < G; ++j) {
            uint32_t f[4];
            tc::ldsm_x4(f, Br + 8 * (g0 + j) * kXdblPad + 16 * kp);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              tc::Split<2> bf;
              split_fast(f[2 * h], bf.hi[0], bf.lo[0]);
              split_fast(f[2 * h + 1], bf.hi[1], bf.lo[1]);
              tc::mma_3xtf32(t[j], a[h], bf);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < G; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][g0 + j][e] += t[j][e];
      }
  }

  __syncthreads();  // every warp's last MMAs read their operands
  float* out = xs;  // (dirs, M, cols)
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MW; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * MW * rg + 16 * mt + g + 8 * (e >> 1);
        const int col = 8 * (nb + j) + 2 * tq + (e & 1);
        if (col < cols) out[(ds * M + row) * cols + col] = acc[mt][j][e];
      }
  __syncthreads();
  const int nrows = min(M, p.L - s0);
  const int step_q = kXdblThreads / cols;
  const int step_c = kXdblThreads - step_q * cols;
  float* dst0 = p.out + static_cast<size_t>(zs) * p.B * p.K * p.L * p.C;
  for (int dd = 0; dd < p.dirs; ++dd) {
    const int k = k0 + dd;
    const bool rev = (k & 1) != 0;
    // scan rows first .. first + nrows - 1 of direction k
    const int first = rev ? p.L - s0 - nrows : s0;
    float* dst = dst0 + (static_cast<size_t>(b * p.K + k) * p.L + first) *
                            p.C + c0;
    int q = threadIdx.x / cols, c = threadIdx.x - q * cols;
    for (int e = threadIdx.x; e < nrows * cols; e += kXdblThreads) {
      const int i = rev ? nrows - 1 - q : q;
      dst[static_cast<size_t>(q) * p.C + c] = out[(dd * M + i) * cols + c];
      q += step_q;
      c += step_c;
      if (c >= cols) {
        c -= cols;
        ++q;
      }
    }
  }
}

// ---- the forward and the backward: chunked scans --------------------------
//
// The forward (mamba_scan_sums_kernel, mamba_scan_carry_kernel,
// mamba_scan_kernel; the wrapper's fwd_chunk picks the chunk): where B*K blocks
// of 32 channels give every SM a block (vssm_tiny, and ARM-B from 2 images on),
// a chunk is all of L, and mamba_scan_kernel runs alone from a zero state: what
// it saves there is instructions and staging latency, not a chain: two lanes a
// channel (N/2 states each), the terms that do not depend on n taken once per
// (row, channel) by the whole block, the decays by exp2_approx, B and C read as
// vectors, the readout in two accumulators and one shuffle, and the rows staged
// kFwdSub at a time, the next ones in flight (cp.async) while a sub-chunk is
// walked. Otherwise (an ARM-B layer serving one image) L is cut into chunks of
// kFwdCut rows (16: the fastest of 8, 16, 32 and 64 there): the summaries (S, H
// of each chunk from a zero state: the backward's kernel 1 without dy and G),
// the carries (its kernel 2's walk in scan order alone), then mamba_scan_kernel
// walks every chunk from its carried state. Workspace (fp32, of the wrapper):
// sums (B*K, nchunks, 1 + N, D), S then H (the state entering the chunk once
// the carries ran). On an H100 80GB HBM3 at 700 W: 0.048 ms at ARM-B, B=1
// (0.313 before), 0.105 at B=6 (0.326), 3.76 ms at vssm_tiny stage 0, B=128
// (5.35). Variants priced the single pass's parts: latency and instruction
// throughput bound it, not the MUFU pipe (the decays' exps 7% at stage 0); 16
// rows a stage beat 8 and 32, and the row terms' exps by exp2_approx, vector
// reads of B and C and two barriers a stage in place of three gave the rest;
// the double buffer itself about 4%.
//
// The backward: three kernels.
//
// The adjoint of mamba_scan_kernel, minus the parts the wrapper closes in
// PyTorch (the x_proj and conv transposes). For channel d and state n the
// recurrence is diagonal,
//   h_t[n] = exp(dt_t A[d,n]) h_{t-1}[n] + dt_t u_t B_t[n],
// so a run of rows acts on a state as h_out = P h_in + H, with
// P = exp(A[d,n] S) and S the run's sum of dt, and on the adjoint (walked
// back to front: p_t = C_t[n] dy_t + g_t, g_{t-1} = exp(dt_t A) p_t) as
// g_out = P g_in + G, where G sums over the run's rows the decays up to and
// including the row times C dy. A chunk is kBwdChunk scan rows of one
// (b, k); the last one of a direction is ragged. Chunks are cut in scan
// order, so a reversed direction needs nothing of its own but the index
// arithmetic of its source rows (its conv halo is the source rows after a
// chunk's first row).
//
//   1. mamba_scan_bwd_sums_kernel writes (S, H[N], G[N]) of every (b*k,
//      chunk, channel): a block a chunk, kBwdChannels channels and one b*k.
//      It recomputes the conv (with its halo of taps-1 rows), dt_proj,
//      softplus and u, as the forward does.
//   2. mamba_scan_bwd_carry_kernel gives a thread to each (b*k, n, d)
//      chain: it walks the chunks in scan order for the state entering each
//      (h = P h + H) and in reverse for the adjoint entering its last row
//      from the rows after it (g = P g + G), and writes them over H and G.
//      P is exp(A S): it is never stored N-fold, and an underflow to 0
//      forgets the state as the walk does. Nothing divides by a decay.
//   3. mamba_scan_bwd_grad_kernel is the old kernel's second pass on one
//      chunk a block (the grid as kernel 1's): from the chunk's carried
//      state it walks the chunk forward once for the state entering every
//      sub-chunk of kBwdSub rows (shared memory), then takes the sub-chunks
//      back to front, rebuilding each one's states in registers and running
//      the adjoint over its rows from the carried adjoint.
//
// Layout of the lanes: N states per channel are 48 registers with their
// adjoints and A at N=16 before the kBwdSub rows of states, which did not
// fit one thread at 4 blocks an SM. So kLanes = 2 lanes hold a channel,
// N/2 states each (a block: 64 threads, 32 channels); the rows' sums over n
// (dt's adjoint and B.p) are one shuffle. The per-row terms that do not
// depend on n (conv, SiLU, dt_proj, softplus and its derivative) are taken
// once per (row, channel) by all 64 threads together for a sub-chunk and
// staged in shared memory, so no lane repeats them and the dependent walks
// carry only the state updates. dB and dC need sums over the block's
// channels: the lanes of a warp that hold the same states sum their terms
// with a transposing reduction of warp shuffles (lane_sums, after
// selective_scan.cu's warp_sums), and the block adds its warps' sums in a
// fixed order; dt_r's column sums ddt * W_dt over the channels from shared
// memory. dxdbl is written as per-block partials and dA, dD, d dt_bias and
// dW_dt as per-(b*k, chunk) partials, summed by the wrapper in a fixed
// order: no float atomics, so two calls give the same bits.
//
// What bounds it on the H100: latency, not bytes or operations. Every
// kBwdSub rows a block stages rows from device memory behind three barriers
// and then walks them as dependent steps, at 2 warps a block. A first
// version (expf, 255 registers, 4 blocks an SM) took 39.5 ms at vssm_tiny
// stage 0, B=128 (the old walk 62.8; the call's bound 2.1 ms) and 0.89 ms
// at ARM-B, B=6 (2.70), on an H100 80GB HBM3 at 700 W. Variants with one
// part taken out priced the grad kernel at stage 0: the forward walk for
// the sub-chunk states 20%, the block sums of dt_r and dW_dt 10% (30% at
// ARM-B), expf 9%, registers for 4 blocks instead of 6 13%. So the walks
// take their decays as exp2_approx(dt A log2 e), the grad kernel is capped
// for 6 blocks (168 registers; 16 bytes of spill at N=16), dt_r sums a
// column a thread over float4 rows of ddt_s and dW_dt four columns a
// thread over float4 rows of x_dbl, and no conv halo is staged without a
// conv: 30.0 and 0.66 ms. The forward walk stays; hiding its staging
// latency (or the staging of every sub-chunk) is the next step.
//
// Workspace (fp32, of the wrapper): sums (B*K, nchunks, 1 + 2N, D): S, then
// H (the state entering the chunk once kernel 2 ran), then G (the adjoint
// entering its last row from after it once kernel 2 ran).
// Outputs (fp32): du, u, dsilu (B*K, L, D) in scan order; dxdbl_part
// (B*K, ceil(D / kBwdChannels), L, C) in scan order, columns
// [dt_r | B | C]; dA (B*K, nchunks, D, N); dD, ddb (B*K, nchunks, D);
// ddtw (B*K, nchunks, D, R). dy (B, K, L, D) in the source dtype and
// source order.
// kBwdThreads, kLanes and kBwdChannels lay out the forward's summaries and
// scan kernels too.
constexpr int kBwdThreads = 64;  // threads a block of kernels 1 and 3
constexpr int kLanes = 2;        // lanes of a channel, N / kLanes states each
constexpr int kBwdChannels = kBwdThreads / kLanes;  // channels a block
constexpr int kBwdChunk = 64;    // scan rows a chunk
constexpr int kBwdSub = 8;       // rows a lane holds the states of
constexpr int kCarryThreads = 128;  // chains a block of kernel 2
constexpr int kBwdBlocks = 6;    // kernel 3's resident blocks an SM
constexpr int kFwdBlocks = 8;    // the forward scan's resident blocks an SM
constexpr int kFwdSub = 16;      // rows the forward scan stages at once
constexpr int kFwdCut = 16;      // scan rows a chunk of the forward when cut
// the forward summaries' resident blocks an SM: one wave of ARM-B's 1,248
// at B=1 on 132 SMs (uncapped, ptxas gave them 80 registers and a spill)
constexpr int kFwdSumsBlocks = 10;
constexpr int kBwdSubs = kBwdChunk / kBwdSub;  // sub-chunks of a chunk
// rows apart the rows of a thread's (row, channel) terms
constexpr int kRowStep = kBwdThreads / kBwdChannels;
constexpr int kWLd = kBwdChannels + 1;  // dtw_s's stride: lanes read columns
constexpr int kDLd = kBwdChannels + 4;  // ddt_s's: float4 rows 4 banks apart
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kCarryBatch = 8;   // chunks whose loads kernel 2 issues ahead
static_assert(kBwdChunk % kBwdSub == 0, "chunks hold whole sub-chunks");
static_assert(kBwdChannels == 32, "a row of a staged term is one warp");

__host__ __device__ constexpr int log2i(int x) {
  return x <= 1 ? 0 : 1 + log2i(x / 2);
}

__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

// The scan kernels are built for d_state 4, 16, 17 and 32 (MIA_DISPATCH;
// the wrapper runs any other N up to 32 at the next of these, its extra
// states zero in A, B and C). A lane holds lane_states<N>() states of its
// channel, N / kLanes rounded up: at odd N (17, additional_scan's default
// width on 16) the last lane's last state is a pad, which has_state masks
// (A, B, C and the carried state and adjoint read as 0, its sums and
// gradients not written), so it stays 0 and adds nothing. At even N every
// state exists and has_state is a constant true: the code of those widths
// is as before.
template <int N>
__host__ __device__ constexpr int lane_states() {
  return (N + kLanes - 1) / kLanes;
}

template <int N>
__device__ __forceinline__ bool has_state(int n) {
  return N % kLanes == 0 || n < N;
}

// 2^x by the special-function unit (relative error under 2^-22; results
// below 2^-126 flush to 0, which forgets a state as an underflow does).
// The walks take their decays as exp2(dt A log2 e): one multiply and this,
// where expf is about eight instructions.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of kernel 1 (grad false) and kernel 3, in floats, the
// first two 16-byte aligned for float4 rows:
//   xd_s (kBwdSub, pad4(C)) a sub-chunk's x_dbl rows
//   ddt_s (kBwdSub, kDLd)   its rows' gradients w.r.t. dt_raw
//   dtw_s (R, kWLd)         W_dt of the block's channels
//   x_s (kBwdSub + 3, 32)   its source rows and the conv halo before them
//   u_s, dt_s, dtu_s, sg_s, dy_s (kBwdSub, 32)
// and kernel 3's
//   dwdt_s (R, 32)          dW_dt of the chunk so far
//   sum_s (2 warps, kBwdSub, 2N)   each warp's sums of dB and dC
//   ck_s (kBwdSubs, ceil(N / kLanes), kBwdThreads)   the state entering
//                           each sub-chunk, a column per thread
__host__ __device__ constexpr int bwd_smem_floats(int R, int C, int N,
                                                  bool grad) {
  return kBwdSub * pad4(C) + kBwdSub * kDLd + R * kWLd +
         (kBwdSub + kMaxTaps - 1) * kBwdChannels + 5 * kBwdSub * kBwdChannels +
         (grad ? R * kBwdChannels + kBwdThreads / 32 * kBwdSub * 2 * N +
                     kBwdSubs * ((N + kLanes - 1) / kLanes) * kBwdThreads
               : 0);
}

struct ScanSmem {
  float *dtw, *xd, *x, *u, *dt, *dtu, *sg, *dy, *ddt, *dwdt, *sum, *ck;
};

__device__ __forceinline__ ScanSmem bwd_smem(float* smem, int R, int C,
                                             int N) {
  ScanSmem s;
  s.xd = smem;
  s.ddt = s.xd + kBwdSub * pad4(C);
  s.dtw = s.ddt + kBwdSub * kDLd;
  s.x = s.dtw + R * kWLd;
  s.u = s.x + (kBwdSub + kMaxTaps - 1) * kBwdChannels;
  s.dt = s.u + kBwdSub * kBwdChannels;
  s.dtu = s.dt + kBwdSub * kBwdChannels;
  s.sg = s.dtu + kBwdSub * kBwdChannels;
  s.dy = s.sg + kBwdSub * kBwdChannels;
  s.dwdt = s.dy + kBwdSub * kBwdChannels;
  s.sum = s.dwdt + R * kBwdChannels;
  s.ck = s.sum + kBwdThreads / 32 * kBwdSub * 2 * N;
  return s;
}

// Where a block of kernels 1 and 3 is: its chunk, channels and (b, k).
struct ScanBlock {
  int c, blk, d0, bk, k, nchunks, t0, nt;
  bool rev;
};

__device__ __forceinline__ ScanBlock scan_block(int K, int L, int D,
                                                int chunk) {
  ScanBlock p;
  const int nblk = (D + kBwdChannels - 1) / kBwdChannels;
  p.c = blockIdx.x / nblk;
  p.blk = blockIdx.x - p.c * nblk;
  p.d0 = p.blk * kBwdChannels;
  p.bk = blockIdx.y;
  p.k = p.bk % K;
  p.rev = (p.k & 1) != 0;
  p.nchunks = (L + chunk - 1) / chunk;
  p.t0 = p.c * chunk;
  p.nt = min(chunk, L - p.t0);
  return p;
}

// W_dt of direction k for the block's channels into dtw_s (0 past D).
__device__ __forceinline__ void stage_dtw(const float* dtw, int k, int D,
                                          int R, int d0, float* dtw_s) {
  for (int i = threadIdx.x; i < R * kBwdChannels; i += kBwdThreads) {
    const int dd = i / R;
    const int q = i - dd * R;
    dtw_s[q * kWLd + dd] =
        d0 + dd < D ? dtw[(static_cast<size_t>(k) * D + d0 + dd) * R + q]
                    : 0.0f;
  }
}

// Scan rows [t0, t0 + ns) of the block's direction: their x_dbl rows into
// xd_s (row stride pad4(C)), and for the block's channels the source's scan
// rows t0 - halo .. t0 + ns - 1 into x_s (0 before scan row 0 and past D;
// halo = kMaxTaps - 1 with a conv, else 0). Scan row t is source row
// L-1-t of a reversed direction.
template <typename T>
__device__ __forceinline__ void stage_rows(const float* xdbl, const T* src,
                                           const ScanBlock& p, int t0, int ns,
                                           int L, int D, int C, int halo,
                                           const ScanSmem& s) {
  const float* xd_g = xdbl + (static_cast<size_t>(p.bk) * L + t0) * C;
  const int Cp = pad4(C);
  for (int i = threadIdx.x; i < ns * C; i += kBwdThreads) {
    const int r = i / C;
    s.xd[r * Cp + i - r * C] = xd_g[i];
  }
  for (int i = threadIdx.x; i < (ns + halo) * kBwdChannels;
       i += kBwdThreads) {
    const int r = i / kBwdChannels;
    const int dd = i - r * kBwdChannels;
    const int t = t0 + r - halo;
    const int row = p.rev ? L - 1 - t : t;
    s.x[i] = (t >= 0 && p.d0 + dd < D)
                 ? to_float(src[static_cast<size_t>(row) * D + p.d0 + dd])
                 : 0.0f;
  }
}

// The per-row terms of a staged sub-chunk that do not depend on n, for the
// calling thread's channel (tid % 32) and rows tid / 32 + kRowStep i: dt
// and dt u into dt_s and dtu_s; with kDy dy into dy_s; with kGrad also u
// and softplus'(dt_raw) into u_s and sg_s, and u and silu'(pre) to u_g and
// ds_g (the sub-chunk's first row of this b*k's u and dsilu); with kU u
// into u_s alone (the forward's D skip). A sub-chunk holds kSub rows. With
// kFast the SiLU's and the softplus's exps are exp2_approx (relative
// error near 2^-22, where expf is about eight instructions) and the
// sigmoid's division __fdividef; the softplus's log stays log1pf, which
// keeps the small exps of large negative inputs (lg2(1 + ex) would round
// them away, and with them dt). The rows' dot products over R are
// interleaved (q outer) so that they are independent.
struct RowConsts {
  float wp[kMaxTaps];  // taps right-aligned: wp[kMaxTaps-1] multiplies x[t]
  float cb, db;
  int ch, d;
  bool in;
};

template <typename T, bool kDy, bool kGrad, bool kU = false,
          int kSub = kBwdSub, bool kFast = false>
__device__ __forceinline__ void row_terms(const ScanSmem& s, const T* dy_bk,
                                          const ScanBlock& p,
                                          const RowConsts& rc, int t0, int ns,
                                          int L, int D, int C, int R,
                                          int use_conv, int delta_softplus,
                                          float* u_g, float* ds_g) {
  constexpr int kTerms = kSub / kRowStep;  // rows a thread
  static_assert(kSub % kRowStep == 0, "the row terms split evenly");
  const int r0 = threadIdx.x / kBwdChannels;
  const int Cp = pad4(C);
  float v[kTerms];
#pragma unroll
  for (int e = 0; e < kTerms; ++e) v[e] = rc.db;
  for (int q = 0; q < R; ++q) {
    const float w = s.dtw[q * kWLd + rc.ch];
#pragma unroll
    for (int e = 0; e < kTerms; ++e)
      v[e] += s.xd[(r0 + kRowStep * e) * Cp + q] * w;  // stale past ns: unused
  }
#pragma unroll
  for (int e = 0; e < kTerms; ++e) {
    const int r = r0 + kRowStep * e;
    if (r >= ns) break;
    float u, dsilu = 1.0f;
    if (use_conv) {
      float pre = rc.cb;
#pragma unroll
      for (int j = 0; j < kMaxTaps; ++j)
        pre += rc.wp[j] * s.x[(r + j) * kBwdChannels + rc.ch];
      const float sig =
          kFast ? __fdividef(1.0f, 1.0f + exp2_approx(-pre * kLog2e))
                : 1.0f / (1.0f + expf(-pre));
      u = pre * sig;
      dsilu = sig * (1.0f + pre * (1.0f - sig));
    } else {
      u = s.x[r * kBwdChannels + rc.ch];  // no halo staged
    }
    float dt = v[e], sg = 1.0f;
    if (delta_softplus) {  // softplus as softplus() computes it, its exp reused
      const float ex =
          kFast ? exp2_approx(-fabsf(v[e]) * kLog2e) : expf(-fabsf(v[e]));
      dt = fmaxf(v[e], 0.0f) + log1pf(ex);
      sg = (v[e] >= 0.0f ? 1.0f : ex) / (1.0f + ex);
    }
    const int o = r * kBwdChannels + rc.ch;
    s.dt[o] = dt;
    s.dtu[o] = dt * u;
    if (kDy) {
      const int t = t0 + r;
      const int row = p.rev ? L - 1 - t : t;
      s.dy[o] = rc.in ? to_float(dy_bk[static_cast<size_t>(row) * D + rc.d])
                      : 0.0f;
    }
    if (kGrad || kU) s.u[o] = u;
    if (kGrad) {
      s.sg[o] = sg;
      if (rc.in) {
        u_g[static_cast<size_t>(r) * D + rc.d] = u;
        ds_g[static_cast<size_t>(r) * D + rc.d] = dsilu;
      }
    }
  }
}

__device__ __forceinline__ RowConsts row_consts(const float* conv_w,
                                                const float* conv_b,
                                                const float* dt_bias,
                                                const ScanBlock& p, int D,
                                                int taps) {
  RowConsts rc;
  rc.ch = threadIdx.x % kBwdChannels;
  rc.d = p.d0 + rc.ch;
  rc.in = rc.d < D;
#pragma unroll
  for (int j = 0; j < kMaxTaps; ++j) {
    const int tap = j - (kMaxTaps - taps);
    rc.wp[j] = rc.in && tap >= 0
                   ? conv_w[(static_cast<size_t>(p.k) * taps + tap) * D + rc.d]
                   : 0.0f;
  }
  rc.cb = rc.in ? conv_b[p.k * D + rc.d] : 0.0f;
  rc.db = rc.in ? dt_bias[p.k * D + rc.d] : 0.0f;
  return rc;
}

// 1. Chunk summaries. grid (nchunks * ceil(D / kBwdChannels), B*K), block
// kBwdThreads, dynamic smem bwd_smem_floats(R, C, N, false) floats. One
// forward pass over a chunk of kChunk rows: S += dt, h = a h + b from a zero
// state, and with kAdj G += P C dy with P the decays so far, the adjoint's
// recurrence unrolled into its sum, so that one forward walk gives all
// three. A (b*k, chunk) slot of `sums` holds 1 + 2N floats a channel with
// kAdj (the backward: S, H, G) and 1 + N without (the forward: S, H).
template <typename T, int N, int kChunk, bool kAdj>
__device__ __forceinline__ void chunk_sums(
    float* smem, const T* xr, const T* xc, const float* xdbl,
    const float* conv_w, const float* conv_b, const float* dtw,
    const float* dt_bias, const float* A, const T* dy, float* sums, int K,
    int L, int D, int R, int taps, int use_conv, int delta_softplus) {
  constexpr int NL = lane_states<N>();
  constexpr int kSlot = kAdj ? 1 + 2 * N : 1 + N;
  const int C = R + 2 * N;
  const int Cp = pad4(C);
  const int halo = use_conv ? kMaxTaps - 1 : 0;
  const ScanSmem s = bwd_smem(smem, R, C, N);
  const ScanBlock p = scan_block(K, L, D, kChunk);
  const T* src = source_of(xr, xc, p.k, p.bk / K, L, D);
  const T* dy_bk = kAdj ? dy + static_cast<size_t>(p.bk) * L * D : nullptr;
  const RowConsts rc = row_consts(conv_w, conv_b, dt_bias, p, D, taps);
  const int ch = threadIdx.x / kLanes;
  const int n0 = (threadIdx.x % kLanes) * NL;  // this lane's first state
  const int d = p.d0 + ch;
  const bool in = d < D;
  float a2[NL], P[NL], H[NL], G[NL];  // a2: A log2(e)
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    a2[i] = in && has_state<N>(n0 + i)
                ? A[(static_cast<size_t>(p.k) * D + d) * N + n0 + i] * kLog2e
                : 0.0f;
    P[i] = 1.0f;
    H[i] = 0.0f;
    G[i] = 0.0f;
  }
  float S = 0.0f;
  stage_dtw(dtw, p.k, D, R, p.d0, s.dtw);
  for (int r0 = 0; r0 < p.nt; r0 += kBwdSub) {
    const int ns = min(kBwdSub, p.nt - r0);
    __syncthreads();  // dtw_s written / the previous sub-chunk consumed
    stage_rows(xdbl, src, p, p.t0 + r0, ns, L, D, C, halo, s);
    __syncthreads();
    row_terms<T, kAdj, false>(s, dy_bk, p, rc, p.t0 + r0, ns, L, D, C, R,
                              use_conv, delta_softplus, nullptr, nullptr);
    __syncthreads();
    for (int r = 0; r < ns; ++r) {
      const int o = r * kBwdChannels + ch;
      const float dt = s.dt[o], bx = s.dtu[o];
      float dyv = 0.0f;
      if constexpr (kAdj) dyv = s.dy[o];
      const float* row = s.xd + r * Cp;
      S += dt;
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const bool ok = has_state<N>(n0 + i);
        const float an = exp2_approx(dt * a2[i]);
        if constexpr (kAdj) P[i] *= an;
        H[i] = an * H[i] + bx * (ok ? row[R + n0 + i] : 0.0f);
        if constexpr (kAdj)
          G[i] += P[i] * ((ok ? row[R + N + n0 + i] : 0.0f) * dyv);
      }
    }
  }
  if (in) {
    float* out =
        sums + (static_cast<size_t>(p.bk) * p.nchunks + p.c) * kSlot * D + d;
    if (n0 == 0) out[0] = S;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      if (!has_state<N>(n0 + i)) continue;
      out[static_cast<size_t>(1 + n0 + i) * D] = H[i];
      if constexpr (kAdj) out[static_cast<size_t>(1 + N + n0 + i) * D] = G[i];
    }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kBwdThreads) mamba_scan_bwd_sums_kernel(
    const T* __restrict__ xr, const T* __restrict__ xc,
    const float* __restrict__ xdbl, const float* __restrict__ conv_w,
    const float* __restrict__ conv_b, const float* __restrict__ dtw,
    const float* __restrict__ dt_bias, const float* __restrict__ A,
    const T* __restrict__ dy, float* __restrict__ sums, int K, int L, int D,
    int R, int taps, int use_conv, int delta_softplus) {
  extern __shared__ float4 smem4[];  // 16-byte aligned
  chunk_sums<T, N, kBwdChunk, true>(reinterpret_cast<float*>(smem4), xr, xc,
                                    xdbl, conv_w, conv_b, dtw, dt_bias, A, dy,
                                    sums, K, L, D, R, taps, use_conv,
                                    delta_softplus);
}

// The forward's summaries (S, H) of chunks of kFwdCut rows.
template <typename T, int N>
__global__ void __launch_bounds__(kBwdThreads, kFwdSumsBlocks)
    mamba_scan_sums_kernel(
    const T* __restrict__ xr, const T* __restrict__ xc,
    const float* __restrict__ xdbl, const float* __restrict__ conv_w,
    const float* __restrict__ conv_b, const float* __restrict__ dtw,
    const float* __restrict__ dt_bias, const float* __restrict__ A,
    float* __restrict__ sums, int K, int L, int D, int R, int taps,
    int use_conv, int delta_softplus) {
  extern __shared__ float4 smem4[];  // 16-byte aligned
  chunk_sums<T, N, kFwdCut, false>(reinterpret_cast<float*>(smem4), xr, xc,
                                   xdbl, conv_w, conv_b, dtw, dt_bias, A,
                                   nullptr, sums, K, L, D, R, taps, use_conv,
                                   delta_softplus);
}

// 2. Carries. grid ceil(B*K*N*D / kCarryThreads), block kCarryThreads: one
// thread a (b*k, n, d) chain walks its chunks in scan order for the state
// entering each (h = exp(A S) h + H) and, with kAdj, in reverse for the
// adjoint entering each chunk's last row (g = exp(A S) g + G), one FMA a
// chunk, with the loads of kCarryBatch chunks started ahead of their FMAs.
// It writes h over H and g over G, each after reading it. Slots as
// chunk_sums' for the same kAdj.
template <bool kAdj>
__device__ __forceinline__ void chunk_carries(const float* A, float* sums,
                                              int K, int nchunks, int N,
                                              int D, int chains) {
  const int i = blockIdx.x * kCarryThreads + threadIdx.x;
  if (i >= chains) return;
  const int bk = i / (N * D);
  const int n = (i - bk * N * D) / D;
  const int d = i - (bk * N + n) * D;
  const float a = A[(static_cast<size_t>(bk % K) * D + d) * N + n];
  const size_t stride =
      static_cast<size_t>(kAdj ? 1 + 2 * N : 1 + N) * D;  // a chunk
  float* base = sums + static_cast<size_t>(bk) * nchunks * stride + d;
  float* hs = base + static_cast<size_t>(1 + n) * D;
  float h = 0.0f;
  for (int c0 = 0; c0 < nchunks; c0 += kCarryBatch) {
    float sv[kCarryBatch], xv[kCarryBatch];
#pragma unroll
    for (int e = 0; e < kCarryBatch; ++e) {
      if (c0 + e < nchunks) {
        sv[e] = base[(c0 + e) * stride];
        xv[e] = hs[(c0 + e) * stride];
      }
    }
#pragma unroll
    for (int e = 0; e < kCarryBatch; ++e) {
      if (c0 + e < nchunks) {
        hs[(c0 + e) * stride] = h;
        h = expf(a * sv[e]) * h + xv[e];
      }
    }
  }
  if constexpr (kAdj) {
    float* gs = base + static_cast<size_t>(1 + N + n) * D;
    float g = 0.0f;
    for (int c0 = nchunks - 1; c0 >= 0; c0 -= kCarryBatch) {
      float sv[kCarryBatch], xv[kCarryBatch];
#pragma unroll
      for (int e = 0; e < kCarryBatch; ++e) {
        if (c0 - e >= 0) {
          sv[e] = base[(c0 - e) * stride];
          xv[e] = gs[(c0 - e) * stride];
        }
      }
#pragma unroll
      for (int e = 0; e < kCarryBatch; ++e) {
        if (c0 - e >= 0) {
          gs[(c0 - e) * stride] = g;
          g = expf(a * sv[e]) * g + xv[e];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kCarryThreads) mamba_scan_bwd_carry_kernel(
    const float* __restrict__ A, float* __restrict__ sums, int K, int nchunks,
    int N, int D, int chains) {
  chunk_carries<true>(A, sums, K, nchunks, N, D, chains);
}

// The forward's carries: the state entering each chunk, written over H.
__global__ void __launch_bounds__(kCarryThreads) mamba_scan_carry_kernel(
    const float* __restrict__ A, float* __restrict__ sums, int K, int nchunks,
    int N, int D, int chains) {
  chunk_carries<false>(A, sums, K, nchunks, N, D, chains);
}

// 4-byte cp.async into shared memory; with `valid` false it writes 0.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Element e (a constant once unrolled) of a vector read, kept in registers.
__device__ __forceinline__ float element(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}
__device__ __forceinline__ float element(const float2& v, int e) {
  return e == 0 ? v.x : v.y;
}
__device__ __forceinline__ float element(float v, int) { return v; }

// Shared memory of the forward scan, in floats: dtw_s (R, kWLd), padded
// to 16 bytes; two buffers of a sub-chunk's x_dbl rows (kFwdSub, pad4(C)),
// each shifted by pad4(R) - R so that B and C start 16-byte aligned; two of
// its source rows with the conv halo (kFwdSub + 3, 32); u_s, dt_s, dtu_s
// (kFwdSub, 32).
__host__ __device__ constexpr int fwd_smem_floats(int R, int C) {
  return pad4(R * kWLd) + 2 * kFwdSub * pad4(C) +
         2 * (kFwdSub + kMaxTaps - 1) * kBwdChannels +
         3 * kFwdSub * kBwdChannels;
}

// Scan rows [t0, t0 + ns) of the block's direction into buffer (xd, x), as
// stage_rows lays them out, by cp.async for fp32 sources (in flight until
// cp_async_wait_all) and by loads and stores for bf16 ones.
template <typename T>
__device__ __forceinline__ void stage_rows_async(const float* xdbl,
                                                 const T* src,
                                                 const ScanBlock& p, int t0,
                                                 int ns, int L, int D, int C,
                                                 int halo, float* xd,
                                                 float* x) {
  const float* xd_g = xdbl + (static_cast<size_t>(p.bk) * L + t0) * C;
  const int Cp = pad4(C);
  int r = threadIdx.x / C, c = threadIdx.x - r * C;  // of element i
  for (int i = threadIdx.x; i < ns * C; i += kBwdThreads) {
    cp_async4(xd + r * Cp + c, xd_g + i, true);
    for (c += kBwdThreads; c >= C; c -= C) ++r;
  }
  for (int i = threadIdx.x; i < (ns + halo) * kBwdChannels;
       i += kBwdThreads) {
    const int r = i / kBwdChannels;
    const int dd = i - r * kBwdChannels;
    const int t = t0 + r - halo;
    const bool valid = t >= 0 && p.d0 + dd < D;
    const T* g = src + static_cast<size_t>(p.rev ? L - 1 - t : t) * D +
                 p.d0 + dd;
    if constexpr (sizeof(T) == sizeof(float))
      cp_async4(x + i, valid ? reinterpret_cast<const float*>(g)
                             : reinterpret_cast<const float*>(src),
                valid);
    else
      x[i] = valid ? to_float(*g) : 0.0f;
  }
  cp_async_commit();
}

// 3 (forward). The scan. grid (nchunks * ceil(D / kBwdChannels), B*K) for
// chunks of `chunk` scan rows (chunk >= L: one chunk, the whole direction),
// block kBwdThreads, dynamic smem fwd_smem_floats(R, C) floats; registers
// capped for kFwdBlocks resident blocks an SM. A lane holds N/kLanes
// states of one channel from the chunk's carried state (`sums` after the
// carry kernel; zero with no `sums`, the single pass). The block takes
// the chunk kFwdSub rows at a time: while it works on one sub-chunk, the
// next one's x_dbl and source rows are in flight into the other buffer
// (stage_rows_async); the terms that do not depend on n are taken once
// per (row, channel) (row_terms); the walk is then h = exp2(dt A log2 e) h
// + dt u B, with B and C read as vectors, and the readout C.h over a
// lane's states in two accumulators, the other lane's half added by one
// shuffle, then + D u, written in source order in the source dtype.
template <typename T, int N>
__global__ void __launch_bounds__(kBwdThreads, kFwdBlocks) mamba_scan_kernel(
    const T* __restrict__ xr, const T* __restrict__ xc,
    const float* __restrict__ xdbl, const float* __restrict__ conv_w,
    const float* __restrict__ conv_b, const float* __restrict__ dtw,
    const float* __restrict__ dt_bias, const float* __restrict__ A,
    const float* __restrict__ Dv, const float* __restrict__ sums,
    T* __restrict__ y, int K, int L, int D, int R, int taps, int use_conv,
    int delta_softplus, int chunk) {
  constexpr int NL = lane_states<N>();
  // floats a read of B and C: vectors where a lane's states and C start on
  // their size (N a multiple of 8: float4; of 4: float2), else one float
  constexpr int kVec = N % 8 == 0 ? 4 : N % 4 == 0 ? 2 : 1;
  using Vec = typename std::conditional<
      kVec == 4, float4,
      typename std::conditional<kVec == 2, float2, float>::type>::type;
  static_assert(NL % kVec == 0, "whole vectors");
  extern __shared__ float4 smem4[];  // 16-byte aligned
  const int C = R + 2 * N;
  const int Cp = pad4(C);
  const int halo = use_conv ? kMaxTaps - 1 : 0;
  float* const dtw_s = reinterpret_cast<float*>(smem4);
  float* const xd_buf = dtw_s + pad4(R * kWLd) + pad4(R) - R;  // 2 buffers
  float* const x_buf = xd_buf - (pad4(R) - R) + 2 * kFwdSub * Cp;
  ScanSmem s;
  s.dtw = dtw_s;
  s.u = x_buf + 2 * (kFwdSub + kMaxTaps - 1) * kBwdChannels;
  s.dt = s.u + kFwdSub * kBwdChannels;
  s.dtu = s.dt + kFwdSub * kBwdChannels;
  const ScanBlock p = scan_block(K, L, D, chunk);
  const T* src = source_of(xr, xc, p.k, p.bk / K, L, D);
  const RowConsts rc = row_consts(conv_w, conv_b, dt_bias, p, D, taps);
  const int ch = threadIdx.x / kLanes;
  const int n0 = (threadIdx.x % kLanes) * NL;  // this lane's first state
  const int d = p.d0 + ch;
  // Lanes of channels past D run the same code on zeros, so that every lane
  // reaches every barrier and shuffle.
  const bool in = d < D;
  const size_t slot = static_cast<size_t>(p.bk) * p.nchunks + p.c;
  float a2[NL], h[NL];  // a2: A log2(e)
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const bool ok = in && has_state<N>(n0 + i);
    a2[i] = ok ? A[(static_cast<size_t>(p.k) * D + d) * N + n0 + i] * kLog2e
               : 0.0f;
    h[i] = ok && sums != nullptr
               ? sums[(slot * (1 + N) + 1 + n0 + i) * D + d]
               : 0.0f;
  }
  const float dskip = in ? Dv[p.k * D + d] : 0.0f;
  T* y_bk = y + static_cast<size_t>(p.bk) * L * D;
  stage_dtw(dtw, p.k, D, R, p.d0, dtw_s);
  const int nsub = (p.nt + kFwdSub - 1) / kFwdSub;
  stage_rows_async(xdbl, src, p, p.t0, min(kFwdSub, p.nt), L, D, C, halo,
                   xd_buf, x_buf);
  for (int j = 0; j < nsub; ++j) {
    const int t0 = p.t0 + j * kFwdSub;
    const int ns = min(kFwdSub, p.nt - j * kFwdSub);
    const int buf = j & 1;
    cp_async_wait_all();
    __syncthreads();  // sub-chunk j staged; the previous walk is done
    if (j + 1 < nsub)
      stage_rows_async(xdbl, src, p, t0 + kFwdSub,
                       min(kFwdSub, p.nt - (j + 1) * kFwdSub), L, D, C, halo,
                       xd_buf + (buf ^ 1) * kFwdSub * Cp,
                       x_buf + (buf ^ 1) * (kFwdSub + kMaxTaps - 1) *
                                   kBwdChannels);
    s.xd = xd_buf + buf * kFwdSub * Cp;
    s.x = x_buf + buf * (kFwdSub + kMaxTaps - 1) * kBwdChannels;
    row_terms<T, false, false, true, kFwdSub, true>(
        s, nullptr, p, rc, t0, ns, L, D, C, R, use_conv, delta_softplus,
        nullptr, nullptr);
    __syncthreads();
    for (int r = 0; r < ns; ++r) {  // ns is uniform over the block
      const int o = r * kBwdChannels + ch;
      const float dt = s.dt[o], bx = s.dtu[o];
      const float* row = s.xd + r * Cp + R + n0;  // B; C N floats on
      float acc[2] = {0.0f, 0.0f};
#pragma unroll
      for (int v = 0; v < NL; v += kVec) {
        // a pad state (odd N) reads B = C = 0 and no float past its row
        const bool ok = kVec > 1 || has_state<N>(n0 + v);
        const Vec bv = ok ? *reinterpret_cast<const Vec*>(row + v) : Vec{};
        const Vec cv = ok ? *reinterpret_cast<const Vec*>(row + N + v) : Vec{};
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int i = v + e;
          h[i] = exp2_approx(dt * a2[i]) * h[i] + bx * element(bv, e);
          acc[i & 1] += element(cv, e) * h[i];
        }
      }
      float out = acc[0] + acc[1];
      out += __shfl_xor_sync(0xffffffffu, out, 1);  // the channel's lanes
      if (n0 == 0 && in) {
        const int t = t0 + r;
        const int srow = p.rev ? L - 1 - t : t;
        y_bk[static_cast<size_t>(srow) * D + d] =
            from_float<T>(out + s.u[o] * dskip);
      }
    }
  }
}

// One step of a transposing reduction over a warp, of the first 2 * Half
// of a lane's values: the lane keeps one half, sends the other to the lane
// `off` away and adds what comes back. Each step is its own instantiation,
// so that every index into v is a constant and v stays in registers.
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

// The sums over the 32 / kLanes lanes of a warp that hold the same states
// (lane % kLanes) of each of M values v[0..M-1] (M a power of two, at most
// 32 / kLanes): log2 M transposing steps from lane bit 4 down, then
// butterflies down to bit log2 kLanes. Returns, in lane l, the sum of value
// l >> (5 - log2 M) over the lanes with l's lane % kLanes. The order of the
// additions is fixed.
template <int M>
__device__ __forceinline__ float lane_sums(float (&v)[M], int lane) {
  static_assert(M <= 32 / kLanes, "one value a lane at the least");
  transpose_steps<M, M / 2>(v, lane);
  float sum = v[0];
#pragma unroll
  for (int off = 16 >> log2i(M); off >= kLanes; off /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  return sum;
}

// A row's dB and dC terms of a lane (terms[i]: state n0 + i's dB, terms[NL
// + i] its dC), each summed over the warp's lanes that hold the same
// states, into the warp's row of sum_s (dB at column n, dC at N + n): in
// groups of the binary digits of 2 NL, 16 values at most (lane_sums takes
// a power of two up to 32 / kLanes), starting at term O; a pad state's
// sums are dropped. At N = 4, 8 and 16 this is one lane_sums of all 2 NL.
template <int N, int O = 0>
__device__ __forceinline__ void row_sums(
    const float (&terms)[2 * lane_states<N>()], int lane, float* sum_row) {
  constexpr int NL = lane_states<N>();
  if constexpr (O < 2 * NL) {
    constexpr int rest = 2 * NL - O;
    constexpr int G = 1 << log2i(rest < 32 / kLanes ? rest : 32 / kLanes);
    float v[G];
#pragma unroll
    for (int j = 0; j < G; ++j) v[j] = terms[O + j];
    const float sum = lane_sums<G>(v, lane);
    // lane l holds value l >> shift of the states of lane l % kLanes
    constexpr int shift = 5 - log2i(G);
    if (((lane >> log2i(kLanes)) & ((1 << (shift - log2i(kLanes))) - 1)) ==
        0) {
      const int vi = O + (lane >> shift);
      const int n = (lane % kLanes) * NL + (vi < NL ? vi : vi - NL);
      if (has_state<N>(n)) sum_row[vi < NL ? n : N + n] = sum;
    }
    row_sums<N, O + G>(terms, lane, sum_row);
  }
}

// The gradients kernel's resident blocks an SM by its register cap: 6 up
// to N = 16 (168 registers; 16 bytes of spill at 16); past it a lane's
// sub-chunk of states (kBwdSub x ceil(N / kLanes) registers) takes more,
// so 4 (255 registers, the most a thread has).
template <int N>
constexpr int kBwdMinBlocks = N <= 16 ? kBwdBlocks : 4;

// 3. Gradients. grid and block as kernel 1's, dynamic smem
// bwd_smem_floats(R, C, N, true) floats; registers capped for
// kBwdMinBlocks<N> resident blocks an SM. A lane holds
// lane_states<N>() states of one channel.
template <typename T, int N>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks<N>)
mamba_scan_bwd_grad_kernel(
    const T* __restrict__ xr, const T* __restrict__ xc,
    const float* __restrict__ xdbl, const float* __restrict__ conv_w,
    const float* __restrict__ conv_b, const float* __restrict__ dtw,
    const float* __restrict__ dt_bias, const float* __restrict__ A,
    const float* __restrict__ Dv, const T* __restrict__ dy,
    const float* __restrict__ sums, float* __restrict__ du,
    float* __restrict__ u_out, float* __restrict__ ds_out,
    float* __restrict__ dxdbl_part, float* __restrict__ dA_out,
    float* __restrict__ dD_out, float* __restrict__ ddb_out,
    float* __restrict__ ddtw_out, int K, int L, int D, int R, int taps,
    int use_conv, int delta_softplus) {
  constexpr int NL = lane_states<N>();
  constexpr int M = 2 * NL;  // a lane's dB and dC terms of a row
  extern __shared__ float4 smem4[];  // 16-byte aligned
  const int C = R + 2 * N;
  const int Cp = pad4(C);
  const int halo = use_conv ? kMaxTaps - 1 : 0;
  const ScanSmem s = bwd_smem(reinterpret_cast<float*>(smem4), R, C, N);
  const ScanBlock p = scan_block(K, L, D, kBwdChunk);
  const int nblk = (D + kBwdChannels - 1) / kBwdChannels;
  const T* src = source_of(xr, xc, p.k, p.bk / K, L, D);
  const T* dy_bk = dy + static_cast<size_t>(p.bk) * L * D;
  const RowConsts rc = row_consts(conv_w, conv_b, dt_bias, p, D, taps);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ch = tid / kLanes;
  const int n0 = (tid % kLanes) * NL;  // this lane's first state
  const int d = p.d0 + ch;
  // Lanes of channels past D run the same code on zeros, so that every lane
  // reaches every barrier and shuffle and adds 0 to the sums.
  const bool in = d < D;
  const int nsub = (p.nt + kBwdSub - 1) / kBwdSub;
  const size_t slot = (static_cast<size_t>(p.bk) * p.nchunks + p.c);

  // a2 = A log2(e): the decays are exp2(dt a2), and dt_raw's adjoint sums
  // dloga a2, times ln 2 once a row
  float a2[NL], h[NL], g[NL], dA[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int n = n0 + i;
    const bool ok = in && has_state<N>(n);
    a2[i] = ok ? A[(static_cast<size_t>(p.k) * D + d) * N + n] * kLog2e
               : 0.0f;
    h[i] = ok ? sums[(slot * (1 + 2 * N) + 1 + n) * D + d] : 0.0f;
    g[i] = ok ? sums[(slot * (1 + 2 * N) + 1 + N + n) * D + d] : 0.0f;
    dA[i] = 0.0f;
  }
  // B and C of state n0 + i in a staged x_dbl row, 0 for a pad state
  auto b_of = [&](const float* row, int i) {
    return has_state<N>(n0 + i) ? row[R + n0 + i] : 0.0f;
  };
  auto c_of = [&](const float* row, int i) {
    return has_state<N>(n0 + i) ? row[R + N + n0 + i] : 0.0f;
  };
  const float dskip = in ? Dv[p.k * D + d] : 0.0f;
  stage_dtw(dtw, p.k, D, R, p.d0, s.dtw);
  for (int i = tid; i < R * kBwdChannels; i += kBwdThreads) s.dwdt[i] = 0.0f;

  // the chunk forward from its carried state: the state entering every
  // sub-chunk into ck_s
  for (int j = 0; j < nsub; ++j) {
#pragma unroll
    for (int i = 0; i < NL; ++i) s.ck[(j * NL + i) * kBwdThreads + tid] = h[i];
    if (j == nsub - 1) break;  // uniform: no barrier is skipped by a part
    __syncthreads();  // dtw_s written / the previous sub-chunk consumed
    stage_rows(xdbl, src, p, p.t0 + j * kBwdSub, kBwdSub, L, D, C, halo, s);
    __syncthreads();
    row_terms<T, false, false>(s, dy_bk, p, rc, p.t0 + j * kBwdSub, kBwdSub,
                               L, D, C, R, use_conv, delta_softplus, nullptr,
                               nullptr);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kBwdSub; ++r) {
      const float dt = s.dt[r * kBwdChannels + ch];
      const float bx = s.dtu[r * kBwdChannels + ch];
#pragma unroll
      for (int i = 0; i < NL; ++i)
        h[i] = exp2_approx(dt * a2[i]) * h[i] + bx * b_of(s.xd + r * Cp, i);
    }
  }

  // the sub-chunks back to front
  float dD = 0.0f, ddb = 0.0f;
  for (int j = nsub - 1; j >= 0; --j) {
    const int r0 = j * kBwdSub;
    const int ns = min(kBwdSub, p.nt - r0);
    const int t0 = p.t0 + r0;
    __syncthreads();  // the previous sub-chunk's sums are done
    stage_rows(xdbl, src, p, t0, ns, L, D, C, halo, s);
    __syncthreads();
    const size_t g0 = (static_cast<size_t>(p.bk) * L + t0) * D;
    row_terms<T, true, true>(s, dy_bk, p, rc, t0, ns, L, D, C, R, use_conv,
                             delta_softplus, u_out + g0, ds_out + g0);
    __syncthreads();

    // rebuild the sub-chunk's states: hv[r] is the state after row r
    float hv[kBwdSub][NL];
    const float* ck = s.ck + j * NL * kBwdThreads + tid;
#pragma unroll
    for (int r = 0; r < kBwdSub; ++r) {
      if (r < ns) {
        const float dt = s.dt[r * kBwdChannels + ch];
        const float bx = s.dtu[r * kBwdChannels + ch];
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          const float prev = r > 0 ? hv[r - 1][i] : ck[i * kBwdThreads];
          hv[r][i] = exp2_approx(dt * a2[i]) * prev +
                     bx * b_of(s.xd + r * Cp, i);
        }
      }
    }
    // the adjoint over the sub-chunk's rows, last row first
#pragma unroll
    for (int r = kBwdSub - 1; r >= 0; --r) {
      if (r < ns) {  // uniform over the block
        const int o = r * kBwdChannels + ch;
        const float dt = s.dt[o], dtu = s.dtu[o], dyv = s.dy[o], uv = s.u[o];
        const float* row = s.xd + r * Cp;
        float terms[M];  // p dt u for dB, h dy for dC
        float gb = 0.0f, ddt_a = 0.0f;
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          const float pv = c_of(row, i) * dyv + g[i];
          const float hp = r > 0 ? hv[r - 1][i] : ck[i * kBwdThreads];
          const float an = exp2_approx(dt * a2[i]);
          const float dloga = pv * hp * an;  // the gradient w.r.t. dt A
          dA[i] += dloga * dt;
          ddt_a += dloga * a2[i];
          gb += pv * b_of(row, i);
          g[i] = an * pv;
          terms[i] = pv * dtu;
          terms[NL + i] = hv[r][i] * dyv;
        }
#pragma unroll
        for (int off = 1; off < kLanes; off *= 2) {  // the channel's states
          gb += __shfl_xor_sync(0xffffffffu, gb, off);
          ddt_a += __shfl_xor_sync(0xffffffffu, ddt_a, off);
        }
        const float ddt = (ddt_a * kLn2 + gb * uv) * s.sg[o];
        dD += dyv * uv;
        ddb += ddt;
        if (n0 == 0) {
          s.ddt[r * kDLd + ch] = ddt;
          if (in)
            du[(static_cast<size_t>(p.bk) * L + t0 + r) * D + d] =
                dt * gb + dyv * dskip;
        }
        row_sums<N>(terms, lane, s.sum + (warp * kBwdSub + r) * 2 * N);
      }
    }
    __syncthreads();

    // sums over the block's channels of the sub-chunk's rows: dt_r's
    // column q = ddt . W_dt[:, q], a column a thread for all the rows (the
    // rows of ddt_s read as float4, channels in order); then dB and dC (the
    // warps' sums in order)
    float* part = dxdbl_part +
                  ((static_cast<size_t>(p.bk) * nblk + p.blk) * L + t0) * C;
    for (int q = tid; q < R; q += kBwdThreads) {
      float acc[kBwdSub];
#pragma unroll
      for (int r = 0; r < kBwdSub; ++r) acc[r] = 0.0f;
#pragma unroll 2
      for (int c4 = 0; c4 < kBwdChannels; c4 += 4) {
        const float* w = s.dtw + q * kWLd + c4;
        const float w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3];
#pragma unroll
        for (int r = 0; r < kBwdSub; ++r) {
          const float4 v = *reinterpret_cast<const float4*>(s.ddt + r * kDLd + c4);
          acc[r] += v.x * w0;
          acc[r] += v.y * w1;
          acc[r] += v.z * w2;
          acc[r] += v.w * w3;
        }
      }
#pragma unroll
      for (int r = 0; r < kBwdSub; ++r)
        if (r < ns) part[static_cast<size_t>(r) * C + q] = acc[r];
    }
    for (int o = tid; o < ns * 2 * N; o += kBwdThreads) {
      const int r = o / (2 * N);
      const int x = o - r * 2 * N;
      float acc = s.sum[r * 2 * N + x];
#pragma unroll
      for (int w = 1; w < kBwdThreads / 32; ++w)
        acc += s.sum[(w * kBwdSub + r) * 2 * N + x];
      part[static_cast<size_t>(r) * C + R + x] = acc;
    }
    // dW_dt[d, q] += sum over the sub-chunk's rows of ddt * dt_r[q]: a
    // channel's ddt in registers, four columns at a time from float4 rows
    // of xd_s
    {
      const int cc = tid % kBwdChannels;
      float dv[kBwdSub];
#pragma unroll
      for (int r = 0; r < kBwdSub; ++r)
        dv[r] = r < ns ? s.ddt[r * kDLd + cc] : 0.0f;
      for (int q0 = tid / kBwdChannels * 4; q0 < R;
           q0 += kBwdThreads / kBwdChannels * 4) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int r = 0; r < kBwdSub; ++r) {
          if (r < ns) {  // rows past ns hold stale x_dbl
            const float4 x = *reinterpret_cast<const float4*>(s.xd + r * Cp + q0);
            acc[0] += dv[r] * x.x;
            acc[1] += dv[r] * x.y;
            acc[2] += dv[r] * x.z;
            acc[3] += dv[r] * x.w;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (q0 + e < R) s.dwdt[(q0 + e) * kBwdChannels + cc] += acc[e];
      }
    }
  }

  if (in) {
#pragma unroll
    for (int i = 0; i < NL; ++i)
      if (has_state<N>(n0 + i)) dA_out[(slot * D + d) * N + n0 + i] = dA[i];
    if (n0 == 0) {
      dD_out[slot * D + d] = dD;
      ddb_out[slot * D + d] = ddb;
    }
  }
  __syncthreads();  // dwdt_s's last sums
  for (int o = tid; o < R * kBwdChannels; o += kBwdThreads) {
    const int q = o / kBwdChannels;
    const int cc = o - q * kBwdChannels;
    if (p.d0 + cc < D)
      ddtw_out[(slot * D + p.d0 + cc) * R + q] = s.dwdt[o];
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

struct BwdArgs {
  const void* xr;
  const void* xc;
  const float* xdbl;
  const float* conv_w;
  const float* conv_b;
  const float* dtw;
  const float* dt_bias;
  const float* A;
  const float* Dv;
  const void* dy;
  float* sums;
  float* du;
  float* u;
  float* ds;
  float* dxdbl_part;
  float* dA;
  float* dD;
  float* ddb;
  float* ddtw;
};

// The forward's arguments: the backward's inputs without dy, the
// workspace of the summaries and carries (nullptr for one chunk), and y.
struct FwdArgs {
  const void* xr;
  const void* xc;
  const float* xdbl;
  const float* conv_w;
  const float* conv_b;
  const float* dtw;
  const float* dt_bias;
  const float* A;
  const float* Dv;
  float* sums;
  void* y;
};

struct ScanShape {
  int B, K, L, D, R, taps, use_conv, delta_softplus;
};

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// kernels 1 and 2: the chunk summaries, then the carries
template <typename T, int N>
cudaError_t launch_carries(const BwdArgs& p, const ScanShape& z,
                           cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(bwd_smem_floats(z.R, z.R + 2 * N, N, false)) *
      sizeof(float);
  cudaError_t err = allow_smem(mamba_scan_bwd_sums_kernel<T, N>, smem);
  if (err != cudaSuccess) return err;
  const int nchunks = ceil_div(z.L, kBwdChunk);
  const dim3 grid(nchunks * ceil_div(z.D, kBwdChannels), z.B * z.K);
  mamba_scan_bwd_sums_kernel<T, N><<<grid, kBwdThreads, smem, stream>>>(
      static_cast<const T*>(p.xr), static_cast<const T*>(p.xc), p.xdbl,
      p.conv_w, p.conv_b, p.dtw, p.dt_bias, p.A, static_cast<const T*>(p.dy),
      p.sums, z.K, z.L, z.D, z.R, z.taps, z.use_conv, z.delta_softplus);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int chains = z.B * z.K * N * z.D;
  mamba_scan_bwd_carry_kernel<<<ceil_div(chains, kCarryThreads),
                                kCarryThreads, 0, stream>>>(
      p.A, p.sums, z.K, nchunks, N, z.D, chains);
  return cudaGetLastError();
}

// all three kernels
template <typename T, int N>
cudaError_t launch_scan_bwd(const BwdArgs& p, const ScanShape& z,
                            cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(bwd_smem_floats(z.R, z.R + 2 * N, N, true)) *
      sizeof(float);
  cudaError_t err = allow_smem(mamba_scan_bwd_grad_kernel<T, N>, smem);
  if (err != cudaSuccess) return err;
  err = launch_carries<T, N>(p, z, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(z.L, kBwdChunk) * ceil_div(z.D, kBwdChannels),
                  z.B * z.K);
  mamba_scan_bwd_grad_kernel<T, N><<<grid, kBwdThreads, smem, stream>>>(
      static_cast<const T*>(p.xr), static_cast<const T*>(p.xc), p.xdbl,
      p.conv_w, p.conv_b, p.dtw, p.dt_bias, p.A, p.Dv,
      static_cast<const T*>(p.dy), p.sums, p.du, p.u, p.ds, p.dxdbl_part,
      p.dA, p.dD, p.ddb, p.ddtw, z.K, z.L, z.D, z.R, z.taps, z.use_conv,
      z.delta_softplus);
  return cudaGetLastError();
}

// Resident blocks an SM of backward kernel `kernel` (0 sums, 1 carry,
// 2 grad) at its launch's block and dynamic shared memory.
template <typename T, int N>
cudaError_t occupancy_bwd(int kernel, int R, int* blocks, int* smem_bytes) {
  if (kernel == 1) {
    *smem_bytes = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, mamba_scan_bwd_carry_kernel, kCarryThreads, 0);
  }
  *smem_bytes = bwd_smem_floats(R, R + 2 * N, N, kernel == 2) *
                static_cast<int>(sizeof(float));
  const cudaError_t err =
      kernel == 0 ? allow_smem(mamba_scan_bwd_sums_kernel<T, N>, *smem_bytes)
                  : allow_smem(mamba_scan_bwd_grad_kernel<T, N>, *smem_bytes);
  if (err != cudaSuccess) return err;
  return kernel == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           blocks, mamba_scan_bwd_sums_kernel<T, N>,
                           kBwdThreads, *smem_bytes)
                     : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           blocks, mamba_scan_bwd_grad_kernel<T, N>,
                           kBwdThreads, *smem_bytes);
}

// The forward: cut, the summaries of chunks of kFwdCut rows, the carries
// over them, then the scan from each chunk's carried state; else the scan
// alone over all of L (one chunk), from zero.
template <typename T, int N>
cudaError_t launch_scan(const FwdArgs& p, const ScanShape& z, bool cut,
                        cudaStream_t stream) {
  const size_t scan_smem =
      static_cast<size_t>(fwd_smem_floats(z.R, z.R + 2 * N)) * sizeof(float);
  cudaError_t err = allow_smem(mamba_scan_kernel<T, N>, scan_smem);
  if (err != cudaSuccess) return err;
  const int chunk = cut ? kFwdCut : z.L;
  const int nchunks = ceil_div(z.L, chunk);
  const dim3 grid(nchunks * ceil_div(z.D, kBwdChannels), z.B * z.K);
  if (cut) {
    if (p.sums == nullptr) return cudaErrorInvalidValue;
    const size_t smem =
        static_cast<size_t>(bwd_smem_floats(z.R, z.R + 2 * N, N, false)) *
        sizeof(float);
    err = allow_smem(mamba_scan_sums_kernel<T, N>, smem);
    if (err != cudaSuccess) return err;
    mamba_scan_sums_kernel<T, N><<<grid, kBwdThreads, smem, stream>>>(
        static_cast<const T*>(p.xr), static_cast<const T*>(p.xc), p.xdbl,
        p.conv_w, p.conv_b, p.dtw, p.dt_bias, p.A, p.sums, z.K, z.L, z.D,
        z.R, z.taps, z.use_conv, z.delta_softplus);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int chains = z.B * z.K * N * z.D;
    mamba_scan_carry_kernel<<<ceil_div(chains, kCarryThreads), kCarryThreads,
                              0, stream>>>(p.A, p.sums, z.K, nchunks, N, z.D,
                                           chains);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  mamba_scan_kernel<T, N><<<grid, kBwdThreads, scan_smem, stream>>>(
      static_cast<const T*>(p.xr), static_cast<const T*>(p.xc), p.xdbl,
      p.conv_w, p.conv_b, p.dtw, p.dt_bias, p.A, p.Dv,
      cut ? p.sums : nullptr, static_cast<T*>(p.y), z.K, z.L, z.D, z.R,
      z.taps, z.use_conv, z.delta_softplus, chunk);
  return cudaGetLastError();
}

// Resident blocks an SM of forward kernel `kernel` (0 sums, 1 carry, 2
// scan) at its launch's block and dynamic shared memory.
template <typename T, int N>
cudaError_t occupancy_fwd(int kernel, int R, int* blocks, int* smem_bytes) {
  if (kernel == 1) {
    *smem_bytes = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, mamba_scan_carry_kernel, kCarryThreads, 0);
  }
  if (kernel == 2) {
    *smem_bytes =
        fwd_smem_floats(R, R + 2 * N) * static_cast<int>(sizeof(float));
    const cudaError_t err = allow_smem(mamba_scan_kernel<T, N>, *smem_bytes);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, mamba_scan_kernel<T, N>, kBwdThreads, *smem_bytes);
  }
  *smem_bytes = bwd_smem_floats(R, R + 2 * N, N, false) *
                static_cast<int>(sizeof(float));
  const cudaError_t err =
      allow_smem(mamba_scan_sums_kernel<T, N>, *smem_bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, mamba_scan_sums_kernel<T, N>, kBwdThreads, *smem_bytes);
}

// x_dbl: the shared memory of a launch, the launch (the product, then the
// sum of its splits' partials), its resident blocks an SM, and the
// dispatch over (MW, NT).
template <typename T, int MW, int NT>
size_t xdbl_smem_bytes(int dirs, int use_conv, int taps) {
  return static_cast<size_t>(
             xdbl_smem(xdbl_rows(MW), use_conv ? taps - 1 : 0, dirs,
                       xdbl_block_cols(NT, dirs), sizeof(T) == 2,
                       use_conv != 0)
                 .total) *
         sizeof(float);
}

template <typename T, int MW, int NT>
cudaError_t launch_xdbl(const XdblArgs<T>& p, float* xdbl,
                        cudaStream_t stream) {
  const size_t smem = xdbl_smem_bytes<T, MW, NT>(p.dirs, p.use_conv, p.taps);
  cudaError_t err = allow_smem(mamba_xdbl_kernel<T, MW, NT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(p.L, xdbl_rows(MW)), p.B * p.K / p.dirs,
                  ceil_div(p.C, xdbl_block_cols(NT, p.dirs)) * p.splits);
  mamba_xdbl_kernel<T, MW, NT><<<grid, kXdblThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const int n = p.B * p.K * p.L * p.C;
  const int blocks = ceil_div(n, kXdblThreads);
  mamba_xdbl_sum_kernel<<<blocks < 4096 ? blocks : 4096, kXdblThreads, 0,
                          stream>>>(p.out, xdbl, n, p.splits);
  return cudaGetLastError();
}

template <typename T, int MW, int NT>
cudaError_t occupancy_xdbl(int dirs, int use_conv, int taps, int* blocks,
                           int* smem_bytes) {
  const size_t smem = xdbl_smem_bytes<T, MW, NT>(dirs, use_conv, taps);
  *smem_bytes = static_cast<int>(smem);
  const cudaError_t err = allow_smem(mamba_xdbl_kernel<T, MW, NT>, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, mamba_xdbl_kernel<T, MW, NT>, kXdblThreads, smem);
}

// Runs fn<T, MW, NT>(args...) for the tile rows and n8 tiles a warp of a
// call (xdbl_ok has checked that the kernel is built for them).
#define MIA_XDBL_DISPATCH(fn, ...)                     \
  if (rows == xdbl_rows(2)) return fn<T, 2, 5>(__VA_ARGS__); \
  switch (nt) {                                        \
    case 5:                                            \
      return fn<T, 1, 5>(__VA_ARGS__);                 \
    case 6:                                            \
      return fn<T, 1, 6>(__VA_ARGS__);                 \
    case 7:                                            \
      return fn<T, 1, 7>(__VA_ARGS__);                 \
    default:                                           \
      return fn<T, 1, 10>(__VA_ARGS__);                \
  }

template <typename T>
cudaError_t launch_xdbl_tile(const XdblArgs<T>& p, float* xdbl, int rows,
                             int nt, cudaStream_t stream) {
  MIA_XDBL_DISPATCH(launch_xdbl, p, xdbl, stream)
}

template <typename T>
cudaError_t occupancy_xdbl_tile(int rows, int nt, int dirs, int use_conv,
                                int taps, int* blocks, int* smem_bytes) {
  MIA_XDBL_DISPATCH(occupancy_xdbl, dirs, use_conv, taps, blocks, smem_bytes)
}

// The n8 tiles a warp the kernel is built for at rows a tile.
bool xdbl_built(int rows, int nt) {
  if (rows == xdbl_rows(2)) return nt == kXdblTiles[0];
  if (rows != xdbl_rows(1)) return false;
  for (int t : kXdblTiles)
    if (nt == t) return true;
  return false;
}

// What the x_dbl kernel takes: 64 or 128 rows a tile with the n8 tiles a
// warp it is built for there, one direction a block or both of a source,
// K = 1, 2 or 4, taps <= kMaxTaps, 1 to 64 ranges of D, and grids and
// x_dbl within their limits.
bool xdbl_ok(int B, int K, int L, int D, int C, int taps, int rows, int nt,
             int dirs, int splits) {
  return B >= 1 && L >= 1 && D >= 1 && C >= 1 && taps >= 1 &&
         taps <= kMaxTaps && xdbl_built(rows, nt) &&
         (K == 1 || K == 2 || K == 4) && (dirs == 1 || dirs == 2) &&
         K % dirs == 0 && splits >= 1 && splits <= 64 &&
         static_cast<long long>(B) * K / dirs <= 65535 &&
         static_cast<long long>(B) * K * L * C <= 0x7fffffffLL &&
         static_cast<long long>(ceil_div(C, xdbl_block_cols(nt, dirs))) *
                 splits <= 65535;
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// Runs fn<T, N>(args...) for the source type and d_state of a call: the
// widths the scan kernels are built for (the wrapper's _STATE_WIDTHS; it
// pads any other N up to 32 to the next of them).
#define MIA_STATE(n, fn, ...)                                       \
  case n:                                                           \
    return is_bf16 ? fn<__nv_bfloat16, n>(__VA_ARGS__)              \
                   : fn<float, n>(__VA_ARGS__);
#define MIA_DISPATCH(fn, ...)                                       \
  switch (N) {                                                      \
    MIA_STATE(4, fn, __VA_ARGS__)                                   \
    MIA_STATE(16, fn, __VA_ARGS__)                                  \
    MIA_STATE(17, fn, __VA_ARGS__)                                  \
    MIA_STATE(32, fn, __VA_ARGS__)                                  \
    default:                                                        \
      return cudaErrorInvalidValue;                                 \
  }

// A call's sizes fit its grids and int indices: B*K in grid.y, the B*K*N*D
// chains of the carry kernel and the grid's x extent in an int, for chunks
// of `chunk` scan rows.
bool sizes_ok(const ScanShape& z, int N, int chunk) {
  const long long chunks = ceil_div(z.L, chunk);
  const long long nblk = ceil_div(z.D, kBwdChannels);
  return chunk >= 1 && z.B >= 1 && z.K >= 1 && z.L >= 1 && z.D >= 1 &&
         z.R >= 1 &&
         z.taps >= 1 && z.taps <= kMaxTaps &&
         static_cast<long long>(z.B) * z.K <= 65535 &&
         static_cast<long long>(z.B) * z.K * N * z.D <= 0x7fffffffLL &&
         chunks * nblk <= 0x7fffffffLL;
}

}  // namespace

extern "C" {

// x_dbl (B*K, L, C) in scan order; rows (64 or 128) source rows a tile,
// nt n8 tiles of C a warp (a block takes 8 nt columns, 16 nt with one
// direction), dirs (1, or 2: both directions of a source) directions a
// block, and splits ranges of D a tile, whose partial sums go to part
// ((splits, B*K, L, C) fp32; null for one). Returns the cudaError_t of the
// launches (0 on success).
int mia_mamba_xdbl(const void* xr, const void* xc, int is_bf16,
                   const float* conv_w, const float* conv_b, const float* wx,
                   float* part, float* xdbl, int B, int K, int L, int D,
                   int C, int taps, int use_conv, int rows, int nt, int dirs,
                   int splits, void* stream) {
  if (!xdbl_ok(B, K, L, D, C, taps, rows, nt, dirs, splits) ||
      (K == 4) != (xc != nullptr) || (splits > 1) != (part != nullptr))
    return cudaErrorInvalidValue;
  // 16-byte copies where every row of D starts on 16 bytes
  const int vec = D % (is_bf16 ? 8 : 4) == 0 && aligned16(xr) &&
                  (xc == nullptr || aligned16(xc)) && aligned16(conv_w) &&
                  aligned16(conv_b) && aligned16(wx);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = splits > 1 ? part : xdbl;
  if (is_bf16) {
    const XdblArgs<__nv_bfloat16> p{
        static_cast<const __nv_bfloat16*>(xr),
        static_cast<const __nv_bfloat16*>(xc), conv_w, conv_b, wx, out, B, K,
        L, D, C, taps, use_conv, dirs, splits, vec};
    return launch_xdbl_tile(p, xdbl, rows, nt, s);
  }
  const XdblArgs<float> p{static_cast<const float*>(xr),
                          static_cast<const float*>(xc), conv_w, conv_b, wx,
                          out, B, K, L, D, C, taps, use_conv, dirs, splits,
                          vec};
  return launch_xdbl_tile(p, xdbl, rows, nt, s);
}

// The x_dbl kernel's resident blocks an SM on the current device at rows,
// nt, dirs, the source type and the conv (cudaOccupancyMaxActiveBlocksPer-
// Multiprocessor at its launch's shared memory) into *blocks, and that
// shared memory in bytes into *smem_bytes.
int mia_mamba_xdbl_blocks_per_sm(int rows, int nt, int dirs, int is_bf16,
                                 int use_conv, int taps, int* blocks,
                                 int* smem_bytes) {
  if (!xdbl_ok(1, 2, 1, 1, 1, taps, rows, nt, dirs, 1))
    return cudaErrorInvalidValue;
  return is_bf16 ? occupancy_xdbl_tile<__nv_bfloat16>(
                       rows, nt, dirs, use_conv, taps, blocks, smem_bytes)
                 : occupancy_xdbl_tile<float>(rows, nt, dirs, use_conv, taps,
                                              blocks, smem_bytes);
}

// The forward scan into y (B, K, L, D). cut 0 runs one kernel over all
// of L from a zero state and takes no workspace; cut 1 runs chunks of
// kFwdCut scan rows, and sums is the (B*K, nchunks, 1 + N, D) fp32
// workspace of their summaries and carries.
int mia_mamba_scan(const void* xr, const void* xc, int is_bf16,
                   const float* xdbl, const float* conv_w,
                   const float* conv_b, const float* dtw,
                   const float* dt_bias, const float* A, const float* Dv,
                   float* sums, void* y, int B, int K, int L, int D, int N,
                   int R, int taps, int use_conv, int delta_softplus,
                   int cut, void* stream) {
  const ScanShape z{B, K, L, D, R, taps, use_conv, delta_softplus};
  if (!sizes_ok(z, N, cut ? kFwdCut : L)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FwdArgs p{xr, xc, xdbl, conv_w, conv_b, dtw, dt_bias, A, Dv, sums,
                  y};
  MIA_DISPATCH(launch_scan, p, z, cut != 0, s)
}

// Forward kernel `kernel`'s (0 sums, 1 carry, 2 scan) resident blocks an
// SM on the current device into *blocks, and its dynamic shared memory in
// bytes into *smem_bytes, for d_state N and rank R.
int mia_mamba_scan_blocks_per_sm(int kernel, int N, int R, int is_bf16,
                                 int* blocks, int* smem_bytes) {
  if (kernel < 0 || kernel > 2 || R < 1) return cudaErrorInvalidValue;
  MIA_DISPATCH(occupancy_fwd, kernel, R, blocks, smem_bytes)
}

int mia_mamba_scan_bwd(const void* xr, const void* xc, int is_bf16,
                       const float* xdbl, const float* conv_w,
                       const float* conv_b, const float* dtw,
                       const float* dt_bias, const float* A, const float* Dv,
                       const void* dy, float* sums, float* du, float* u,
                       float* ds, float* dxdbl_part, float* dA, float* dD,
                       float* ddb, float* ddtw, int B, int K, int L, int D,
                       int N, int R, int taps, int use_conv,
                       int delta_softplus, void* stream) {
  const ScanShape z{B, K, L, D, R, taps, use_conv, delta_softplus};
  if (!sizes_ok(z, N, kBwdChunk)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdArgs p{xr, xc, xdbl, conv_w, conv_b, dtw, dt_bias, A, Dv, dy,
                  sums, du, u, ds, dxdbl_part, dA, dD, ddb, ddtw};
  MIA_DISPATCH(launch_scan_bwd, p, z, s)
}

// The backward's kernels 1 and 2 alone: the summaries, then the carries
// written over them (the workspace of mia_mamba_scan_bwd), for tests of
// the carries.
int mia_mamba_scan_bwd_carries(const void* xr, const void* xc, int is_bf16,
                               const float* xdbl, const float* conv_w,
                               const float* conv_b, const float* dtw,
                               const float* dt_bias, const float* A,
                               const void* dy, float* sums, int B, int K,
                               int L, int D, int N, int R, int taps,
                               int use_conv, int delta_softplus,
                               void* stream) {
  const ScanShape z{B, K, L, D, R, taps, use_conv, delta_softplus};
  if (!sizes_ok(z, N, kBwdChunk)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdArgs p{xr, xc, xdbl, conv_w, conv_b, dtw, dt_bias, A, nullptr,
                  dy, sums, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr};
  MIA_DISPATCH(launch_carries, p, z, s)
}

// Backward kernel `kernel`'s (0 sums, 1 carry, 2 grad) resident blocks an
// SM on the current device (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// at its launch's block and dynamic shared memory for d_state N and rank
// R) into *blocks, and that shared memory in bytes into *smem_bytes.
int mia_mamba_scan_bwd_blocks_per_sm(int kernel, int N, int R, int is_bf16,
                                     int* blocks, int* smem_bytes) {
  if (kernel < 0 || kernel > 2 || R < 1) return cudaErrorInvalidValue;
  MIA_DISPATCH(occupancy_bwd, kernel, R, blocks, smem_bytes)
}

#undef MIA_DISPATCH
#undef MIA_STATE
#undef MIA_XDBL_DISPATCH

}  // extern "C"
