// Flash-attention schedule variants for Hopper (sm_90a): kernels 7, 8 and
// 9 of the port, replacing scripts/tune_flash3.py's
//   _multiq_kernel     (:51) chains 2 ("dualq") and 4 ("quadq"), not
//                      transposed;
//   _pvt_kernel        (:94) chains 1, transposed: O^T = V^T P^T;
//   _dualq_pvt_kernel  (:132) chains 2, transposed.
// All compute base-mode inference attention at d = 64 in bf16, the running
// max updated once per key tile of `block_k` keys (32 or 64); chains and
// the transpose change only the schedule. The transposed kernels write O^T
// into a (B, H, 64, N) buffer, as the TPU kernels write (bh, d, n_pad).
//
// Every instantiation runs one design, kernel 6's ("wgmma_tma",
// ops/flash_variants.py:chains_path): consumer warpgroups on wgmma
// products fed by a TMA ring from a producer warp, so that the chains and
// the transpose are the one difference from kernel 6's rows form. A chain
// is 64 query rows, one wgmma M:
//   kernel 7  two chains a warpgroup (one chain's softmax while the other's
//             S or P V product runs), two warpgroups a block; quadq orders
//             the two warpgroups' products ping-pong by named barriers, so
//             that the block's four chains interleave;
//   kernel 8  O^T = V^T P^T: the 64 features on wgmma's M and a
//             warpgroup's 64 queries on its N, V^T read MN-major from the
//             ring and P^T from a swizzled P tile;
//   kernel 9  kernel 8's form with kernel 7's two chains a warpgroup.
// At (192, 1025, 64) the tensor cores and the exponentials bound them
// (0.052 ms of products, about as long again of exp); the designs in full
// are in flash_variant_wgmma.cuh.

#include "flash_variant_wgmma.cuh"

using namespace vt_flash;
using namespace vt_flash::sweep;

namespace {

// (chains, transposed) -> the kernel's launch, or info, at block_k.
template <int kBlockK>
int launch_at(int chains, int transposed, VT_SWEEP_ARGS) {
  if (!transposed && chains == 2) return launch_chains<kBlockK, false>(VT_SWEEP_PASS);
  if (!transposed && chains == 4) return launch_chains<kBlockK, true>(VT_SWEEP_PASS);
  if (transposed && chains == 1) return launch_pvt<kBlockK>(VT_SWEEP_PASS);
  if (transposed && chains == 2) return launch_dualq_pvt<kBlockK>(VT_SWEEP_PASS);
  return cudaErrorInvalidValue;
}

template <int kBlockK>
int info_at(int chains, int transposed, int* out) {
  if (!transposed && chains == 2) return chains_info<kBlockK, false>(out);
  if (!transposed && chains == 4) return chains_info<kBlockK, true>(out);
  if (transposed && chains == 1) return pvt_info<kBlockK>(out);
  if (transposed && chains == 2) return dualq_pvt_info<kBlockK>(out);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// bf16 (B, H, N, 64) q, k, v (last dimension contiguous, base and strides
// multiples of 16 bytes). Not transposed: o is (B, H, N, 64), o_sn the
// stride of a row. Transposed: o is (B, H, 64, N), o_sn the stride of one
// of its 64 rows. Strides are in elements. Returns a cudaError_t, or an
// error of the tensor maps (vt_error_string).
int vt_flash_chains(int chains, int transposed, int block_k, const void* q,
                    const void* k, const void* v, void* o, long long q_sb,
                    long long q_sh, long long q_sn, long long k_sb,
                    long long k_sh, long long k_sn, long long v_sb,
                    long long v_sh, long long v_sn, long long o_sb,
                    long long o_sh, long long o_sn, int batch, int heads,
                    int n, float scale, void* stream_ptr) {
  const Strides sq{q_sb, q_sh, q_sn}, sk{k_sb, k_sh, k_sn};
  const Strides sv{v_sb, v_sh, v_sn}, so{o_sb, o_sh, o_sn};
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (block_k) {
    case 32: return launch_at<32>(chains, transposed, VT_SWEEP_PASS);
    case 64: return launch_at<64>(chains, transposed, VT_SWEEP_PASS);
    default: return cudaErrorInvalidValue;
  }
}

// Registers, blocks an SM, threads, shared memory and spilled bytes of the
// (chains, transposed, block_k) instantiation (sweep::kernel_info).
int vt_flash_chains_info(int chains, int transposed, int block_k, int* out) {
  switch (block_k) {
    case 32: return info_at<32>(chains, transposed, out);
    case 64: return info_at<64>(chains, transposed, out);
    default: return cudaErrorInvalidValue;
  }
}

const char* vt_error_string(int err) { return error_string(err); }

}  // extern "C"
