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
// Kernel 8 ("wgmma_tma", ops/flash_variants.py:chains_path) takes the TPU
// kernel's lever on Hopper's products: O^T = V^T P^T puts the 64 features
// on the wgmma M and a warpgroup's 64 queries on its N, V^T read MN-major
// from the TMA ring and P^T from a swizzled P tile. At (192, 1025, 64) the
// tensor cores and the exponentials bound it (0.052 ms of products, about
// as long again of exp); its design, and why S itself is not transposed,
// are in flash_variant_wgmma.cuh.
// Kernels 7 and 9 ("mma_sync") are still on the earlier template,
// flash_variant_kernel.cuh: a warp owns `chains` independent 16-row
// online-softmax chains and interleaves their phases over each staged K/V
// tile, the GPU's reading of "Mosaic interleaves independent chains".

#include "flash_variant_kernel.cuh"
#include "flash_variant_wgmma.cuh"

using namespace vt_flash;

namespace {

template <int kChains, bool kTransposed>
int by_block_k(int block_k, const void* q, const void* k, const void* v,
               void* o, Strides sq, Strides sk, Strides sv, Strides so,
               int batch, int heads, int n, float scale, cudaStream_t s) {
  using variants::launch;
  switch (block_k) {
    case 32: return launch<32, kChains, kTransposed>(q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
    case 64: return launch<64, kChains, kTransposed>(q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

int pvt_by_block_k(int block_k, const void* q, const void* k, const void* v,
                   void* o, Strides sq, Strides sk, Strides sv, Strides so,
                   int batch, int heads, int n, float scale, cudaStream_t s) {
  using sweep::launch_pvt;
  switch (block_k) {
    case 32: return launch_pvt<32>(q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
    case 64: return launch_pvt<64>(q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// bf16 (B, H, N, 64) q, k, v (last dimension contiguous, rows 16-byte
// aligned; for kernel 8 base and strides multiples of 16 bytes). Not
// transposed: o is (B, H, N, 64), o_sn the stride of a row. Transposed: o
// is (B, H, 64, N), o_sn the stride of one of its 64 rows. Strides are in
// elements. Returns a cudaError_t, or an error of kernel 8's tensor maps
// (vt_error_string).
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
  if (transposed && chains == 1) return pvt_by_block_k(block_k, q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
  if (transposed && chains == 2) return by_block_k<2, true>(block_k, q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
  return cudaErrorInvalidValue;
}

// Registers, blocks an SM, threads, shared memory and spilled bytes of
// kernel 8 at block_k (sweep::kernel_info); the mma_sync kernels 7 and 9
// are not asked.
int vt_flash_chains_info(int chains, int transposed, int block_k, int* out) {
  if (chains != 1 || !transposed) return cudaErrorInvalidValue;
  switch (block_k) {
    case 32: return sweep::pvt_info<32>(out);
    case 64: return sweep::pvt_info<64>(out);
    default: return cudaErrorInvalidValue;
  }
}

const char* vt_error_string(int err) { return sweep::error_string(err); }

}  // extern "C"
