// Fused short-sequence attention for Hopper (sm_90a): one kernel.
//
//   fused_attention (tc::attn_tc_fwd_kernel)  <- _attn_kernel
//       (medical_image_analysis_tpu/ops/attention.py:28, pallas_call :92):
//       softmax(q k^T * scale + mask) v
//
// The kernel is attn_tc.cuh's tensor-core core (tc::attn_tc_fwd_kernel,
// without the logsumexp), whose header gives its bound on the H100, its
// instruction (mma.sync: 3xTF32 for fp32 operands, bf16 direct) and tiles,
// and its rounding (an online softmax: p rounded to v's type before P.V, the
// division by the row sum at the end).
//
// Layouts: q, k, v (B, L, H, HD) with any batch and token strides and the
// heads and head dims contiguous, so that q, k and v are read in place (the
// three (B, L, H, HD) slices of a (B, L, 3, H, HD) qkv product included);
// every row 16-byte aligned (the wrapper copies an operand that is not);
// mask (L, L) fp32 or null, broadcast over batch and heads; out (B, L, H,
// HD) contiguous. fp32 or bf16, all one type. L <= kMaxL, the JAX
// dispatch's limit (an fp32 (L, L) tile within 8 MiB), which the wrapper
// keeps.
//
// The kernel launches on the caller's stream, allocates nothing, and the C
// function returns cudaGetLastError() so that the Python wrapper can raise
// on a refused launch.

#include "attn_tc.cuh"

namespace {

constexpr int kMaxL = 1448;  // the longest L with L * L * 4 <= 8 MiB

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int mia_attention_fwd(const void* q, const void* k, const void* v,
                      const float* mask, void* out, int is_bf16, int B, int H,
                      int L, int hd, long long q_bs, long long q_ts,
                      long long k_bs, long long k_ts, long long v_bs,
                      long long v_ts, float scale, void* stream) {
  if (L > kMaxL) return cudaErrorInvalidValue;
  const tc::AttnArgs p{q,    k,    v,       q_bs,    q_ts,    k_bs,
                       k_ts, v_bs, v_ts,    mask,    out,     nullptr,
                       nullptr, nullptr, B, H, L, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? tc::attn_tc_dispatch<__nv_bfloat16, false>(hd, p, s)
                 : tc::attn_tc_dispatch<float, false>(hd, p, s);
}

}  // extern "C"
