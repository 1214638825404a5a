// Pieces shared by the flash-attention kernels (forward, dQ, dK/dV, and
// the tuning sweeps' variants): strides of a (B, H, N, d) view, bf16
// packing, the mma.sync m16n8k16 tensor-core product, cp.async staging of
// row-major tiles, ldmatrix fragment loads, and the Philox4x32-10 dropout
// mask.
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

__device__ __forceinline__ float2 unpack2(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

// 2^x by the special-function unit alone (results below the normal range
// flush to zero, which a probability may).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// ---------------------------------------------------------------- staging
// Shared-memory tiles are row-major with kPad bf16 of row padding: a row is
// D + 8 bf16 = (D / 2 + 4) words, so the eight 16-byte rows that one
// ldmatrix matrix reads (plain or .trans, the addressing is the same) start
// 4 banks apart modulo 32 for every supported D and never collide.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy to shared memory; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// 4-byte asynchronous copy (per-row fp32 values whose rows are not 16-byte
// aligned); src_bytes = 0 writes zero.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Every group but the newest kPending has landed.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Start the copies of `rows` rows of D bf16 (rows row0 .. row0 + rows - 1
// of a matrix with row stride `stride`) into a padded shared-memory tile;
// rows >= n are zero-filled. Called by `threads` threads, `tid` each.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long stride, int row0,
                                           int rows, int n, int tid,
                                           int threads) {
  constexpr int kVecsPerRow = D / kVec;
  for (int idx = tid; idx < rows * kVecsPerRow; idx += threads) {
    const int j = idx / kVecsPerRow;
    const int c = (idx % kVecsPerRow) * kVec;
    const int row = row0 + j;
    const int from = row < n ? row : n - 1;
    cp_async16(dst + j * (D + kPad) + c, src + from * stride + c,
               row < n ? 16 : 0);
  }
}

// Four 8x8 bf16 matrices: lanes 8i..8i+7 give the row addresses of matrix
// i, and register i receives, in lane 4g + t, its elements (g, 2t) and
// (g, 2t + 1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const bf16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)) : "memory");
}

// The same, transposed: register i receives, in lane 4g + t, elements
// (2t, g) and (2t + 1, g) of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)) : "memory");
}

// Address, for this lane, of ldmatrix_x4 over a row-major tile so that the
// registers are the B fragments (b0, b1) of n-tile `nt` and of n-tile
// nt + 1 for k-step `st`: B[k][n] = tile[n][k], i.e. S = A * tile^T.
__device__ __forceinline__ const bf16* b_frag_addr(const bf16* tile,
                                                   int stride, int nt, int st,
                                                   int lane) {
  const int mi = lane >> 3;
  return tile + ((nt + (mi >> 1)) * 8 + (lane & 7)) * stride + st * 16 +
         (mi & 1) * 8;
}

// Address of ldmatrix_x4_trans so that the registers are the B fragments
// of n-tiles `ot` and ot + 1 for the 16 rows starting at `k0`:
// B[k][n] = tile[k0 + k][n], i.e. acc += A * tile.
__device__ __forceinline__ const bf16* bt_frag_addr(const bf16* tile,
                                                    int stride, int k0, int ot,
                                                    int lane) {
  const int mi = lane >> 3;
  return tile + (k0 + (mi & 1) * 8 + (lane & 7)) * stride +
         (ot + (mi >> 1)) * 8;
}

// Address of ldmatrix_x4 so that the registers are the A fragment of rows
// row0 .. row0 + 15, columns st * 16 .. + 15 of a row-major tile.
__device__ __forceinline__ const bf16* a_frag_addr(const bf16* tile,
                                                   int stride, int row0,
                                                   int st, int lane) {
  return tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * stride +
         st * 16 + (lane >> 4) * 8;
}

// ---------------------------------------------------------------- dropout
// Philox4x32-10 (Salmon et al., SC'11; the generator behind cuRAND's
// philox4_32_10) for key (k0, k1) and counter (c0, c1, 0, 0): all four
// output words.
__device__ __forceinline__ void philox4(uint32_t k0, uint32_t k1, uint32_t c0,
                                        uint32_t c1, uint32_t (&w)[4]) {
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
  w[0] = c0;
  w[1] = c1;
  w[2] = c2;
  w[3] = c3;
}

// The dropout mask. Attention probability (row, col) of head `bh` is kept
// when the top 24 bits of its draw fall below `threshold` =
// ceil(keep * 2^24), i.e. u = bits * 2^-24 < keep. One Philox call, keyed
// by (seed, bh) with counter (row >> 1, col >> 1), draws the 2 x 2 block of
// probabilities around it: word 2 * (row & 1) + (col & 1). The mask is a
// fixed function of (seed, head, row, column), so every kernel tiles the
// matrix its own way and still regenerates the forward's mask.
//
// One probability (the scalar fp32 paths): three words go unused.
__device__ __forceinline__ bool dropout_keep(uint32_t seed, uint32_t bh,
                                             int row, int col,
                                             uint32_t threshold) {
  uint32_t w[4];
  philox4(seed, bh, static_cast<uint32_t>(row >> 1),
          static_cast<uint32_t>(col >> 1), w);
  const uint32_t lo = (col & 1) ? w[1] : w[0], hi = (col & 1) ? w[3] : w[2];
  return (((row & 1) ? hi : lo) >> 8) < threshold;
}

// The four probabilities a lane holds in one mma.sync C fragment, for one
// Philox call per lane: bit e of the result is the keep decision of
// fragment element e. The fragment's rows are r_lo = (even base) + g and
// r_lo + 8, its columns c, c + 1 with c even. kKeysOnRows = false: rows are
// query rows and columns keys (S, kernels 2 and 3); true: rows are keys and
// columns queries (S^T, kernel 4). Lanes g and g ^ 1 (4 lanes apart) hold
// the two halves of the same 2 x 2 blocks: the even-g lane draws the block
// of the low rows, the odd-g lane that of the high rows, and each passes
// the other's two words across. Every lane of the warp must call it.
template <bool kKeysOnRows>
__device__ __forceinline__ uint32_t dropout_keep_frag(uint32_t seed,
                                                      uint32_t bh, int r_lo,
                                                      int c, uint32_t threshold,
                                                      int lane) {
  const bool odd = (lane >> 2) & 1;
  const int r = odd ? r_lo + 8 : r_lo;
  uint32_t w[4];
  if (kKeysOnRows)
    philox4(seed, bh, static_cast<uint32_t>(c >> 1),
            static_cast<uint32_t>(r >> 1), w);
  else
    philox4(seed, bh, static_cast<uint32_t>(r >> 1),
            static_cast<uint32_t>(c >> 1), w);
  // Words of the block's first and second fragment row: (w0, w1), (w2, w3)
  // when rows are query rows; (w0, w2), (w1, w3) when rows are keys.
  const uint32_t a0 = w[0], a1 = kKeysOnRows ? w[2] : w[1];
  const uint32_t b0 = kKeysOnRows ? w[1] : w[2], b1 = w[3];
  // Even g owns the block's first row and sends the second; odd g owns the
  // second and sends the first.
  const uint32_t got0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 4);
  const uint32_t got1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 4);
  const uint32_t lo0 = odd ? got0 : a0, lo1 = odd ? got1 : a1;
  const uint32_t hi0 = odd ? b0 : got0, hi1 = odd ? b1 : got1;
  return ((lo0 >> 8) < threshold ? 1u : 0u) |
         ((lo1 >> 8) < threshold ? 2u : 0u) |
         ((hi0 >> 8) < threshold ? 4u : 0u) |
         ((hi1 >> 8) < threshold ? 8u : 0u);
}

}  // namespace vt_flash
