// Flash-attention softmax variants for Hopper (sm_90a): kernel 6 of the
// port, replacing scripts/tune_flash2.py:_variant_kernel (:41).
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
// 128}, all of one design ("wgmma_tma", ops/flash_variants.py:variant_path):
// consumer warpgroups of 64 query rows on wgmma products, S = Q K^T at n =
// block_k from shared memory, P V from the S accumulators as register A
// fragments, and a producer warp filling a TMA ring of K/V tiles. At
// (192, 1025, 64) the tensor cores and the exponentials bound it (0.052 ms
// of products, about as long again of exp); the design keeps both busy by
// running as many warpgroups an SM as each key tile's registers allow
// (four at 32 keys, three at 64, two at 128), whose softmax and products
// interleave on the SM, and takes the loads off the consumers' instruction
// streams. What it computes, the bound and the design in full:
// flash_variant_wgmma.cuh.

#include "flash_variant_wgmma.cuh"

using namespace vt_flash;
using namespace vt_flash::sweep;

namespace {

template <int kMode>
int by_block_k(int block_k, const void* q, const void* k, const void* v,
               void* o, Strides sq, Strides sk, Strides sv, Strides so,
               int batch, int heads, int n, float scale, cudaStream_t s) {
  switch (block_k) {
    case 32: return launch_variant<kMode, 32>(q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
    case 64: return launch_variant<kMode, 64>(q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
    case 128: return launch_variant<kMode, 128>(q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int kMode>
int info_by_block_k(int block_k, int* out) {
  switch (block_k) {
    case 32: return variant_info<kMode, 32>(out);
    case 64: return variant_info<kMode, 64>(out);
    case 128: return variant_info<kMode, 128>(out);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// bf16 (B, H, N, 64) q, k, v (last dimension contiguous, base and strides
// multiples of 16 bytes) -> o of the same shape, contiguous rows. Strides
// are in elements. Returns a cudaError_t, or an error of the tensor maps
// (vt_error_string).
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

// Registers, blocks an SM, threads, shared memory and spilled bytes of the
// (mode, block_k) instantiation (kernel_info).
int vt_flash_variant_info(int mode, int block_k, int* out) {
  switch (mode) {
    case kBase: return info_by_block_k<kBase>(block_k, out);
    case kBf16Exp: return info_by_block_k<kBf16Exp>(block_k, out);
    case kExp2: return info_by_block_k<kExp2>(block_k, out);
    default: return cudaErrorInvalidValue;
  }
}

const char* vt_error_string(int err) { return error_string(err); }

}  // extern "C"
