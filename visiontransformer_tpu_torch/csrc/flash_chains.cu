// Flash-attention schedule variants for Hopper (sm_90a): kernels 7, 8 and
// 9 of the port, replacing scripts/tune_flash3.py's
//   _multiq_kernel     chains 2 ("dualq") and 4 ("quadq"), not transposed;
//   _pvt_kernel        chains 1, transposed: S^T = K Q^T, O^T = V^T P^T;
//   _dualq_pvt_kernel  chains 2, transposed.
// All compute base-mode inference attention at d = 64 in bf16, the running
// max updated once per key tile of `block_k` keys (32 or 64); chains and
// the transpose change only the schedule. A warp owns `chains` independent
// 16-row online-softmax chains and interleaves their phases over each
// staged K/V tile, the GPU's reading of "Mosaic interleaves independent
// chains". The transposed kernels write O^T into a (B, H, 64, N) buffer.
// The template, what bounds it at the sweep's shape and its design are in
// flash_variant_kernel.cuh.

#include "flash_variant_kernel.cuh"

using namespace vt_flash;
using namespace vt_flash::variants;

namespace {

template <int kChains, bool kTransposed>
cudaError_t by_block_k(int block_k, const void* q, const void* k,
                       const void* v, void* o, Strides sq, Strides sk,
                       Strides sv, Strides so, int batch, int heads, int n,
                       float scale, cudaStream_t s) {
  switch (block_k) {
    case 32: return launch<kBase, 32, kChains, kTransposed>(q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
    case 64: return launch<kBase, 64, kChains, kTransposed>(q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// bf16 (B, H, N, 64) q, k, v (last dimension contiguous, rows 16-byte
// aligned). Not transposed: o is (B, H, N, 64), o_sn the stride of a row.
// Transposed: o is (B, H, 64, N), o_sn the stride of one of its 64 rows.
// Strides are in elements. Returns a cudaError_t.
int vt_flash_chains(int chains, int transposed, int block_k, const void* q,
                    const void* k, const void* v, void* o, long long q_sb,
                    long long q_sh, long long q_sn, long long k_sb,
                    long long k_sh, long long k_sn, long long v_sb,
                    long long v_sh, long long v_sn, long long o_sb,
                    long long o_sh, long long o_sn, int batch, int heads,
                    int n, float scale, void* stream) {
  const Strides sq{q_sb, q_sh, q_sn}, sk{k_sb, k_sh, k_sn};
  const Strides sv{v_sb, v_sh, v_sn}, so{o_sb, o_sh, o_sn};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!transposed && chains == 2) return by_block_k<2, false>(block_k, q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
  if (!transposed && chains == 4) return by_block_k<4, false>(block_k, q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
  if (transposed && chains == 1) return by_block_k<1, true>(block_k, q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
  if (transposed && chains == 2) return by_block_k<2, true>(block_k, q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
  return cudaErrorInvalidValue;
}

const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
