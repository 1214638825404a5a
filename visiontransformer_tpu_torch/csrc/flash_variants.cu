// Flash-attention softmax variants for Hopper (sm_90a): kernel 6 of the
// port, replacing scripts/tune_flash2.py:_variant_kernel.
//
// Inference attention at d = 64 in bf16 with one of three softmax forms
// (`mode`), the running max updated once per key tile of `block_k` keys:
//   0 base     p = expf(s - m), the full-accuracy expf;
//   1 bf16exp  s - m rounded to bf16, exp taken in bf16 (ex2.approx.bf16x2,
//              two values per instruction) and P V fed the bf16 p as is;
//   2 exp2     p = exp2f((s - m) * log2 e), log2 e applied after the
//              subtraction as the TPU kernel does (kernel 1 instead folds it
//              into the scale before the max).
// One instantiation per (mode, block_k) that the sweep runs: 3 x {32, 64,
// 128}. The template, what bounds it at the sweep's shape and its design
// are in flash_variant_kernel.cuh.

#include "flash_variant_kernel.cuh"

using namespace vt_flash;
using namespace vt_flash::variants;

namespace {

template <int kMode>
cudaError_t by_block_k(int block_k, const void* q, const void* k,
                       const void* v, void* o, Strides sq, Strides sk,
                       Strides sv, Strides so, int batch, int heads, int n,
                       float scale, cudaStream_t s) {
  switch (block_k) {
    case 32: return launch<kMode, 32, 1, false>(q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
    case 64: return launch<kMode, 64, 1, false>(q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
    case 128: return launch<kMode, 128, 1, false>(q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// bf16 (B, H, N, 64) q, k, v (last dimension contiguous, rows 16-byte
// aligned) -> o of the same shape. Strides are in elements. Returns a
// cudaError_t.
int vt_flash_variant(int mode, int block_k, const void* q, const void* k,
                     const void* v, void* o, long long q_sb, long long q_sh,
                     long long q_sn, long long k_sb, long long k_sh,
                     long long k_sn, long long v_sb, long long v_sh,
                     long long v_sn, long long o_sb, long long o_sh,
                     long long o_sn, int batch, int heads, int n, float scale,
                     void* stream) {
  const Strides sq{q_sb, q_sh, q_sn}, sk{k_sb, k_sh, k_sn};
  const Strides sv{v_sb, v_sh, v_sn}, so{o_sb, o_sh, o_sn};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kBase: return by_block_k<kBase>(block_k, q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
    case kBf16Exp: return by_block_k<kBf16Exp>(block_k, q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
    case kExp2: return by_block_k<kExp2>(block_k, q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
