// Pieces shared by the flash-attention kernels (forward, dQ, dK/dV):
// strides of a (B, H, N, d) view, bf16 packing, the mma.sync m16n8k16
// tensor-core product, and the Philox4x32-10 dropout mask.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vt_flash {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kPad = 8;  // bf16 padding per shared-memory row
constexpr int kVec = 8;  // bf16 per 16-byte load

// Element strides of a (B, H, N, d) tensor whose last dimension is
// contiguous.
struct Strides {
  long long b, h, n;
};

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  return pack2(__float2bfloat16(lo), __float2bfloat16(hi));
}

// D (16x8, fp32) += A (16x16, bf16, row) * B (16x8, bf16, col).
// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 * g + t. A holds
// rows g and g + 8, columns 2t, 2t + 1 (+ 8); B holds k = 2t, 2t + 1
// (+ 8) of column g; C holds rows g and g + 8, columns 2t, 2t + 1.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment (16 rows x 16 columns starting at column c0) of a
// row-major bf16 matrix with row stride `stride`; rows >= n read as zero.
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const bf16* base,
                                            long long stride, int row_lo,
                                            int n, int c0, int t) {
  const bf16 zero = __float2bfloat16(0.0f);
  const int row_hi = row_lo + 8;
  const int c = c0 + 2 * t;
  const bf16* lo = base + row_lo * stride + c;
  const bf16* hi = base + row_hi * stride + c;
  const bool vlo = row_lo < n, vhi = row_hi < n;
  a[0] = vlo ? pack2(lo[0], lo[1]) : pack2(zero, zero);
  a[1] = vhi ? pack2(hi[0], hi[1]) : pack2(zero, zero);
  a[2] = vlo ? pack2(lo[8], lo[9]) : pack2(zero, zero);
  a[3] = vhi ? pack2(hi[8], hi[9]) : pack2(zero, zero);
}

// First output word of Philox4x32-10 (Salmon et al., SC'11; the generator
// behind cuRAND's philox4_32_10) for key (k0, k1) and counter
// (c0, c1, 0, 0).
__device__ __forceinline__ uint32_t philox_word0(uint32_t k0, uint32_t k1,
                                                 uint32_t c0, uint32_t c1) {
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// Dropout keep decision of attention probability (row, col) of head `bh`:
// keyed by (seed, bh), counter (row, col); kept when the draw's top 24 bits
// fall below `threshold` = ceil(keep * 2^24), i.e. u = bits * 2^-24 < keep.
// Keying per element lets every kernel tile the matrix its own way and
// still regenerate the forward's mask.
__device__ __forceinline__ bool dropout_keep(uint32_t seed, uint32_t bh,
                                             int row, int col,
                                             uint32_t threshold) {
  return (philox_word0(seed, bh, static_cast<uint32_t>(row),
                       static_cast<uint32_t>(col)) >> 8) < threshold;
}

}  // namespace vt_flash
