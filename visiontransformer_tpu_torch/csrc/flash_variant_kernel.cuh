// The kernels behind two of the flash-attention tuning sweeps' kernels
// (flash_chains.cu): inference attention, softmax(Q K^T * d^-1/2) V, at
// d = 64 in bf16, base mode (p = expf(s - m)), computed online over key
// tiles of kBlockK keys, one template per lever:
//
//   kBlockK      the key-tile width, which is also how often the running
//                max is updated (once per tile, as the TPU kernels update
//                it once per block_k keys);
//   kChains      independent 16-row online-softmax chains per warp
//                (kernel 7, scripts/tune_flash3.py:_multiq_kernel);
//   kTransposed  S^T = K Q^T and O^T = V^T P^T, the softmax reducing down
//                the keys of each column (kernel 9, _dualq_pvt_kernel).
//
// This is the mma.sync design ("mma_sync", ops/flash_variants.py:
// chains_path). Kernels 6 and 8 moved to warpgroup products
// (flash_variant_wgmma.cuh); kernels 7 and 9 follow on the same base.
//
// What bounds them: at the sweeps' shape (B*H = 192, N = 1025, d = 64,
// bf16) the function needs 4 * B*H*N^2*d = 51.6 GFLOP (0.052 ms at
// 989 TFLOP/s) against 4 * B*H*N*d * 2 bytes = 101 MB (0.030 ms at
// 3.35 TB/s): the tensor cores, and the exponentials and reductions
// between the two products, not memory.
//
// Design, shared by both so that the sweeps compare one lever at a time:
//   - every block owns 128 query rows of one (batch, head) and walks all of
//     its keys; a warp owns kChains tiles of 16 rows, so a block has
//     8 / kChains warps and the K/V traffic per row is the same for every
//     variant;
//   - K and V tiles (row-major, 8 bf16 of row padding so that a warp's
//     fragment loads hit 32 distinct banks) are copied to shared memory with
//     cp.async, double-buffered: tile i + 1 is in flight while tile i
//     computes. Keys past N are zero-filled by the copy (src-size 0) and
//     scored NEG_INF, so their probabilities are exactly 0; rows past N
//     compute on zero queries and are never stored. Inputs are strided
//     views read in place: nothing is padded;
//   - products are mma.sync m16n8k16 (bf16 in, fp32 accumulate); V's
//     fragments come from its row-major tile through ldmatrix.trans, and P
//     is rounded to bf16 before P V as the TPU kernels round it to v's
//     dtype;
//   - chains interleave by construction: each phase of a tile (S, scale
//     and max, exponentials, P V) runs for every chain before the next
//     phase starts, so the warp scheduler always has kChains independent
//     instruction streams, and each K and V fragment loaded from shared
//     memory feeds kChains products;
//   - the transposed form puts keys on the rows of S^T, so a query's max
//     and sum reduce over the thread's own rows, then across the eight
//     lanes that share its column (shuffles with xor 4, 8, 16). P^T, the
//     B operand of O^T = V^T P^T, needs key pairs of one query where the
//     C fragment of S^T holds query pairs of one key: movmatrix.trans
//     transposes each 8x8 half in registers. O^T is stored into a
//     (B, H, d, N) buffer, as the TPU kernel writes (bh, d, n_pad).
// The output is acc / max(l, 1e-30), divided (not multiplied by a
// reciprocal), as the TPU kernels compute it.

#pragma once

#include "flash_attention_common.cuh"

namespace vt_flash {
namespace variants {

constexpr int kD = 64;                  // the sweeps' head dim
constexpr int kBlockRows = 128;         // query rows per block
constexpr int kRowStride = kD + kPad;   // bf16 per K/V row in shared memory
constexpr int kSteps = kD / 16;         // k-steps of a product over d
constexpr int kOutTiles = kD / 8;       // n-tiles of O

template <int kBlockK, int kChains>
struct Config {
  static_assert(kBlockK % 16 == 0, "key tiles are whole k-steps of P V");
  static_assert(kBlockRows % (16 * kChains) == 0, "chains must tile a block");
  static constexpr int kWarps = kBlockRows / (16 * kChains);
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kTileElems = kBlockK * kRowStride;
  // Two buffers, each a K and a V tile.
  static constexpr int kSmemBytes = 4 * kTileElems * static_cast<int>(sizeof(bf16));
};

// The 8x8 bf16 matrix held as one pair per lane (lane 4g + t: row g,
// columns 2t, 2t + 1, the C-fragment layout of one half of an m16n8 tile),
// transposed in registers.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y) : "r"(x));
  return y;
}

// Issue the copies of one K and one V tile (keys key0 .. key0 + kBlockK - 1)
// into a buffer; keys past n are zero-filled.
template <int kBlockK, int kThreads>
__device__ __forceinline__ void stage_tile(bf16* ks, bf16* vs, const bf16* kb,
                                           const bf16* vb, Strides sk,
                                           Strides sv, int key0, int n) {
  constexpr int kVecsPerRow = kD / kVec;
  constexpr int kVecs = kBlockK * kVecsPerRow;
  constexpr int kLoads = (kVecs + kThreads - 1) / kThreads;
#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    const int idx = threadIdx.x + r * kThreads;
    if (kVecs % kThreads != 0 && idx >= kVecs) break;
    const int j = idx / kVecsPerRow;
    const int c = (idx % kVecsPerRow) * kVec;
    const int key = key0 + j;
    const int src = key < n ? key : n - 1;
    const int bytes = key < n ? 16 : 0;
    cp_async16(ks + j * kRowStride + c, kb + src * sk.n + c, bytes);
    cp_async16(vs + j * kRowStride + c, vb + src * sv.n + c, bytes);
  }
}

// ------------------------------------------------------------- row layout
// S = Q K^T with queries on the rows of the C fragment (kernel 1's layout).
template <int kBlockK, int kChains>
__global__ void __launch_bounds__(Config<kBlockK, kChains>::kThreads)
rows_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, bf16* __restrict__ o, Strides sq,
            Strides sk, Strides sv, Strides so, int heads, int n,
            float scale) {
  using Cfg = Config<kBlockK, kChains>;
  constexpr int kKeyTiles = kBlockK / 8;  // n-tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kBlockRows + (threadIdx.x / 32) * 16 * kChains;
  const bool warp_active = row0 < n;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  uint32_t qa[kChains][kSteps][4];
  float acc[kChains][kOutTiles][4];
  float m[kChains][2], l[kChains][2];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
#pragma unroll
    for (int st = 0; st < kSteps; ++st)
      load_a_frag(qa[c][st], qb, sq.n, row0 + c * 16 + g, n, st * 16, t);
#pragma unroll
    for (int ot = 0; ot < kOutTiles; ++ot)
      acc[c][ot][0] = acc[c][ot][1] = acc[c][ot][2] = acc[c][ot][3] = 0.0f;
    m[c][0] = m[c][1] = kNegInf;
    l[c][0] = l[c][1] = 0.0f;
  }

  const int num_tiles = (n + kBlockK - 1) / kBlockK;
  stage_tile<kBlockK, Cfg::kThreads>(smem, smem + Cfg::kTileElems, kb, vb, sk,
                                     sv, 0, n);
  cp_async_commit();
  for (int tile = 0; tile < num_tiles; ++tile) {
    const int key0 = tile * kBlockK;
    if (tile + 1 < num_tiles) {
      bf16* next = smem + 2 * ((tile + 1) & 1) * Cfg::kTileElems;
      stage_tile<kBlockK, Cfg::kThreads>(next, next + Cfg::kTileElems, kb, vb,
                                         sk, sv, key0 + kBlockK, n);
    }
    cp_async_commit();  // an empty group on the last tile keeps the count
    cp_async_wait<1>();
    __syncthreads();
    if (warp_active) {
      const bf16* ks = smem + 2 * (tile & 1) * Cfg::kTileElems;
      const bf16* vs = ks + Cfg::kTileElems;

      // S = Q K^T, one K fragment for every chain.
      float s[kChains][kKeyTiles][4];
#pragma unroll
      for (int c = 0; c < kChains; ++c)
#pragma unroll
        for (int nt = 0; nt < kKeyTiles; ++nt)
          s[c][nt][0] = s[c][nt][1] = s[c][nt][2] = s[c][nt][3] = 0.0f;
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
        for (int st = 0; st < kSteps; ++st) {
          const bf16* kr = ks + (nt * 8 + g) * kRowStride + st * 16 + 2 * t;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
#pragma unroll
          for (int c = 0; c < kChains; ++c) mma16816(s[c][nt], qa[c][st], b0, b1);
        }
      }

      // Scale, mask keys past N, row max over the tile.
      float mx[kChains][2];
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        mx[c][0] = mx[c][1] = kNegInf;
#pragma unroll
        for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + nt * 8 + 2 * t + (e & 1);
            s[c][nt][e] = key < n ? s[c][nt][e] * scale : kNegInf;
            mx[c][e >> 1] = fmaxf(mx[c][e >> 1], s[c][nt][e]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kChains; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[c][r] = fmaxf(mx[c][r], __shfl_xor_sync(0xffffffffu, mx[c][r], 1));
          mx[c][r] = fmaxf(mx[c][r], __shfl_xor_sync(0xffffffffu, mx[c][r], 2));
        }

      // alpha = exp(m - m_new), P = exp(S - m_new) as bf16 pairs, l.
      float alpha[kChains][2];
      uint32_t p[kChains][kKeyTiles][2];
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        const float m_new[2] = {fmaxf(m[c][0], mx[c][0]),
                                fmaxf(m[c][1], mx[c][1])};
        alpha[c][0] = expf(m[c][0] - m_new[0]);
        alpha[c][1] = expf(m[c][1] - m_new[1]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[c][r] *= alpha[c][r];
          m[c][r] = m_new[r];
        }
#pragma unroll
        for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float x0 = s[c][nt][2 * r] - m_new[r];
            const float x1 = s[c][nt][2 * r + 1] - m_new[r];
            // The full-accuracy expf (no -use_fast_math), the function
            // the TPU kernel computes.
            const float p0 = expf(x0), p1 = expf(x1);
            l[c][r] += p0 + p1;
            p[c][nt][r] = pack2f(p0, p1);
          }
        }
      }

      // acc = acc * alpha + P V; one V fragment for every chain.
#pragma unroll
      for (int c = 0; c < kChains; ++c)
#pragma unroll
        for (int ot = 0; ot < kOutTiles; ++ot) {
          acc[c][ot][0] *= alpha[c][0];
          acc[c][ot][1] *= alpha[c][0];
          acc[c][ot][2] *= alpha[c][1];
          acc[c][ot][3] *= alpha[c][1];
        }
      const int mi = lane >> 3;
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
#pragma unroll
        for (int op = 0; op < kOutTiles / 2; ++op) {
          // Matrices: keys 0-7 / 8-15 of this k-step x d columns of output
          // tiles 2op / 2op + 1; transposed they are B's b0, b1 of each.
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vs + (kk * 16 + (mi & 1) * 8 + (lane & 7)) *
                                         kRowStride +
                                     (2 * op + (mi >> 1)) * 8);
#pragma unroll
          for (int c = 0; c < kChains; ++c) {
            const uint32_t pa[4] = {p[c][2 * kk][0], p[c][2 * kk][1],
                                    p[c][2 * kk + 1][0], p[c][2 * kk + 1][1]};
            mma16816(acc[c][2 * op], pa, vf[0], vf[1]);
            mma16816(acc[c][2 * op + 1], pa, vf[2], vf[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  if (!warp_active) return;

  bf16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[c][r] += __shfl_xor_sync(0xffffffffu, l[c][r], 1);
      l[c][r] += __shfl_xor_sync(0xffffffffu, l[c][r], 2);
      l[c][r] = fmaxf(l[c][r], 1.0e-30f);
    }
    const int row_lo = row0 + c * 16 + g;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 8 * r;
      if (row >= n) continue;
#pragma unroll
      for (int ot = 0; ot < kOutTiles; ++ot) {
        *reinterpret_cast<__nv_bfloat162*>(ob + row * so.n + ot * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[c][ot][2 * r] / l[c][r],
                                  acc[c][ot][2 * r + 1] / l[c][r]);
      }
    }
  }
}

// -------------------------------------------------------- transposed layout
// S^T = K Q^T with keys on the rows and queries on the columns of the C
// fragment; O^T = V^T P^T (kernel 9; the TPU kernel uses exp).
template <int kBlockK, int kChains>
__global__ void __launch_bounds__(Config<kBlockK, kChains>::kThreads)
cols_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, bf16* __restrict__ o, Strides sq,
            Strides sk, Strides sv, Strides so, int heads, int n,
            float scale) {
  using Cfg = Config<kBlockK, kChains>;
  constexpr int kKeyTiles = kBlockK / 16;  // m-tiles of S^T (= k-steps of P V)
  constexpr int kDTiles = kD / 16;         // m-tiles of O^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kBlockRows + (threadIdx.x / 32) * 16 * kChains;
  const bool warp_active = row0 < n;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const bf16 zero = __float2bfloat16(0.0f);

  // Q^T as B fragments (k = d, n = query): query g of each 8-query n-tile.
  uint32_t qf[kChains][2][kSteps][2];
  float acc[kChains][kDTiles][2][4];    // O^T: [d m-tile][query n-tile]
  float m[kChains][2][2], l[kChains][2][2];  // [query n-tile][column 2t + i]
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int row = row0 + c * 16 + nt * 8 + g;
      const bool valid = row < n;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const bf16* qr = qb + row * sq.n + st * 16 + 2 * t;
        qf[c][nt][st][0] = valid ? pack2(qr[0], qr[1]) : pack2(zero, zero);
        qf[c][nt][st][1] = valid ? pack2(qr[8], qr[9]) : pack2(zero, zero);
      }
      m[c][nt][0] = m[c][nt][1] = kNegInf;
      l[c][nt][0] = l[c][nt][1] = 0.0f;
#pragma unroll
      for (int md = 0; md < kDTiles; ++md)
        acc[c][md][nt][0] = acc[c][md][nt][1] = acc[c][md][nt][2] =
            acc[c][md][nt][3] = 0.0f;
    }
  }

  const int num_tiles = (n + kBlockK - 1) / kBlockK;
  stage_tile<kBlockK, Cfg::kThreads>(smem, smem + Cfg::kTileElems, kb, vb, sk,
                                     sv, 0, n);
  cp_async_commit();
  for (int tile = 0; tile < num_tiles; ++tile) {
    const int key0 = tile * kBlockK;
    if (tile + 1 < num_tiles) {
      bf16* next = smem + 2 * ((tile + 1) & 1) * Cfg::kTileElems;
      stage_tile<kBlockK, Cfg::kThreads>(next, next + Cfg::kTileElems, kb, vb,
                                         sk, sv, key0 + kBlockK, n);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (warp_active) {
      const bf16* ks = smem + 2 * (tile & 1) * Cfg::kTileElems;
      const bf16* vs = ks + Cfg::kTileElems;

      // S^T = K Q^T: K's A fragment (keys x d) once for every chain.
      float s[kChains][kKeyTiles][2][4];
#pragma unroll
      for (int c = 0; c < kChains; ++c)
#pragma unroll
        for (int mt = 0; mt < kKeyTiles; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            s[c][mt][nt][0] = s[c][mt][nt][1] = s[c][mt][nt][2] =
                s[c][mt][nt][3] = 0.0f;
#pragma unroll
      for (int mt = 0; mt < kKeyTiles; ++mt) {
#pragma unroll
        for (int st = 0; st < kSteps; ++st) {
          const bf16* kr = ks + (mt * 16 + g) * kRowStride + st * 16 + 2 * t;
          const uint32_t ka[4] = {
              *reinterpret_cast<const uint32_t*>(kr),
              *reinterpret_cast<const uint32_t*>(kr + 8 * kRowStride),
              *reinterpret_cast<const uint32_t*>(kr + 8),
              *reinterpret_cast<const uint32_t*>(kr + 8 * kRowStride + 8)};
#pragma unroll
          for (int c = 0; c < kChains; ++c)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
              mma16816(s[c][mt][nt], ka, qf[c][nt][st][0], qf[c][nt][st][1]);
        }
      }

      // Scale, mask keys (rows) past N, column max: the thread's own keys,
      // then the eight lanes (xor 4, 8, 16) that share its columns.
      float mx[kChains][2][2];
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) mx[c][nt][0] = mx[c][nt][1] = kNegInf;
#pragma unroll
        for (int mt = 0; mt < kKeyTiles; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = key0 + mt * 16 + g + (e >> 1) * 8;
              s[c][mt][nt][e] = key < n ? s[c][mt][nt][e] * scale : kNegInf;
              mx[c][nt][e & 1] = fmaxf(mx[c][nt][e & 1], s[c][mt][nt][e]);
            }
      }
#pragma unroll
      for (int c = 0; c < kChains; ++c)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int x = 4; x < 32; x <<= 1)
              mx[c][nt][i] = fmaxf(mx[c][nt][i],
                                   __shfl_xor_sync(0xffffffffu, mx[c][nt][i], x));

      // alpha, P^T, l; P^T's B fragments by an in-register transpose.
      float alpha[kChains][2][2];
      uint32_t pb[kChains][kKeyTiles][2][2];
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float m_new = fmaxf(m[c][nt][i], mx[c][nt][i]);
            alpha[c][nt][i] = expf(m[c][nt][i] - m_new);
            l[c][nt][i] *= alpha[c][nt][i];
            m[c][nt][i] = m_new;
          }
#pragma unroll
        for (int mt = 0; mt < kKeyTiles; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            float pv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              pv[e] = expf(s[c][mt][nt][e] - m[c][nt][e & 1]);
              l[c][nt][e & 1] += pv[e];
            }
            // Keys g / g + 8, queries 2t, 2t + 1 -> keys 2t, 2t + 1
            // (+ 8), query g: B's b0 and b1.
            pb[c][mt][nt][0] = movmatrix_trans(pack2f(pv[0], pv[1]));
            pb[c][mt][nt][1] = movmatrix_trans(pack2f(pv[2], pv[3]));
          }
      }

      // O^T = O^T * alpha + V^T P^T; V^T's A fragment once for every chain.
#pragma unroll
      for (int c = 0; c < kChains; ++c)
#pragma unroll
        for (int md = 0; md < kDTiles; ++md)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[c][md][nt][e] *= alpha[c][nt][e & 1];
      const int mi = lane >> 3;
#pragma unroll
      for (int kk = 0; kk < kKeyTiles; ++kk) {
#pragma unroll
        for (int md = 0; md < kDTiles; ++md) {
          // Matrices: keys 0-7 / 8-15 x d 0-7 / 8-15 of this m-tile;
          // transposed they are V^T's a0 (d 0-7, keys 0-7), a1 (d 8-15),
          // a2 (keys 8-15), a3.
          uint32_t va[4];
          ldmatrix_x4_trans(va, vs + (kk * 16 + (mi >> 1) * 8 + (lane & 7)) *
                                         kRowStride +
                                     md * 16 + (mi & 1) * 8);
#pragma unroll
          for (int c = 0; c < kChains; ++c)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
              mma16816(acc[c][md][nt], va, pb[c][kk][nt][0], pb[c][kk][nt][1]);
        }
      }
    }
    __syncthreads();
  }
  if (!warp_active) return;

  bf16* ob = o + b * so.b + h * so.h;  // so.n: the stride of d in O^T
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int x = 4; x < 32; x <<= 1)
          l[c][nt][i] += __shfl_xor_sync(0xffffffffu, l[c][nt][i], x);
        l[c][nt][i] = fmaxf(l[c][nt][i], 1.0e-30f);
      }
#pragma unroll
      for (int md = 0; md < kDTiles; ++md)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + c * 16 + nt * 8 + 2 * t + (e & 1);
          const int d = md * 16 + g + (e >> 1) * 8;
          if (row < n)
            ob[d * so.n + row] =
                __float2bfloat16(acc[c][md][nt][e] / l[c][nt][e & 1]);
        }
    }
  }
}

template <typename Kernel>
cudaError_t run(Kernel kernel, int threads, int smem_bytes, const void* q,
                const void* k, const void* v, void* o, Strides sq, Strides sk,
                Strides sv, Strides so, int batch, int heads, int n,
                float scale, cudaStream_t stream) {
  if (batch <= 0 || heads <= 0 || n <= 0 || batch * heads > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((n + kBlockRows - 1) / kBlockRows, batch * heads);
  kernel<<<grid, threads, smem_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), sq, sk, sv, so,
      heads, n, scale);
  return cudaGetLastError();
}

// Launch one variant. Above 48 KB of shared memory a kernel must opt in,
// once per instantiation.
template <int kBlockK, int kChains, bool kTransposed>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   Strides sq, Strides sk, Strides sv, Strides so, int batch,
                   int heads, int n, float scale, cudaStream_t stream) {
  using Cfg = Config<kBlockK, kChains>;
  auto kernel = [] {
    if constexpr (kTransposed) return cols_kernel<kBlockK, kChains>;
    else return rows_kernel<kBlockK, kChains>;
  }();
  static const cudaError_t opt_in =
      Cfg::kSmemBytes > 48 * 1024
          ? cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 Cfg::kSmemBytes)
          : cudaSuccess;
  if (opt_in != cudaSuccess) return opt_in;
  return run(kernel, Cfg::kThreads, Cfg::kSmemBytes, q, k, v, o, sq, sk, sv,
             so, batch, heads, n, scale, stream);
}

}  // namespace variants
}  // namespace vt_flash
