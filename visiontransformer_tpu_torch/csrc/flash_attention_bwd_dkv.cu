// Flash-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces visiontransformer_tpu/ops/flash_attention.py:_bwd_dkv_kernel.
// Per key row j, over every query i (queries past N contribute nothing):
//   P = exp(q_i k_j^T * scale - lse_i),
//   dV_j = sum_i (P * mask / keep) dO_i,
//   dP = dO_i v_j^T * mask / keep,  dS = P (dP - delta_i),
//   dK_j = sum_i dS q_i * scale,
// with the dropout mask regenerated from (seed, b*H + h, query row, key
// column) as the forward drew it (flash_attention_common.cuh). Key rows
// past N are never stored.
//
// What bounds it on an H100. The function reads Q, K, V, dO and writes dK,
// dV (6 * B*H*N*d * 2 bytes, plus lse and delta) and does 8 * B*H*N^2*d
// operations (four N x N x d products). At the training micro-batch
// (B*H = 48, N = 197, d = 64) that is 7.3 MB and 1.0 GFLOP: 2.2 us of
// bytes, 1.0 us of tensor-core work, so neither bounds it; the launch and
// the serial chain "load operands, walk four query tiles, store" do
// (latency): what helps is many small blocks an SM and loads in flight
// early. From N of a few hundred on it is bound by operations: at
// (24, 3137, 64) 121 GFLOP against 58 MB, 0.122 ms of tensor-core time
// against 0.017 ms of bytes.
//
// Design (bf16), two instantiations by head dim.
//   d = 64 (every ViT configuration of the repository), dkv_wgmma_kernel:
//   one warpgroup per block of 64 keys, on warpgroup products, for every N.
//   At N = 197 it was measured no slower than an mma.sync instantiation
//   that staged the whole head at once (PERF.md); from N = 320 on it is 15
//   to 35 % faster than the mma.sync ring.
//   Other head dims (16, 32, 80, 128), dkv_bf16_kernel, on mma.sync: a
//   block is four warps; a warp owns kChains slabs of 16 keys and keeps
//   their two fp32 accumulators (dK, dV) in registers for the whole walk
//   over the head's queries. Those accumulators set the register budget,
//   so the block's K and V rows do not live in registers: they are staged
//   once in shared memory and their A fragments re-read with ldmatrix.x4 at
//   every step. Q and dO arrive as row-major 64-query tiles by cp.async
//   (queries past N zero-filled) in a ring of three tiles, the copy of tile
//   i + 2 in flight while tile i computes, one __syncthreads() per tile,
//   with the tile's lse and delta riding in the same ring slot, and are
//   never copied again: S^T = K Q^T and dP^T = V dO^T take their B
//   fragments with ldmatrix.x4, dV += (P mask / keep)^T dO and dK += dS^T Q
//   take dO and Q with ldmatrix.x4.trans from the same tiles; the row
//   padding keeps both free of bank conflicts. Each tile is consumed as two
//   32-query halves. Two chains per warp for d <= 32, one for d = 80 and
//   128. Slabs are dealt to the warps of a head's blocks round-robin (slab
//   = warp * blocks + block), so a ragged last block idles at most one
//   warp-slab less than the others.
// In both, P * mask / keep and dS are rounded to bf16 before their
// products, where the TPU kernel rounds them.
// fp32 (kept so parity can be checked on the card at fp32 tolerance) runs
// scalar FMAs with four threads per key.

#include "flash_attention_common.cuh"
#include "flash_attention_wgmma.cuh"

using namespace vt_flash;

namespace {

constexpr int kBlockK = 64;   // keys per block (fp32 path)
constexpr int kBlockQ = 32;   // queries per shared-memory tile (fp32 path)

struct DropArgs {
  const long long* seed;
  uint32_t keep_threshold;  // 2^24: no dropout
  float inv_keep;
};

// ---------------------------------------------------------------- fp32 path
constexpr int kQuad = 4;
constexpr int kF32Threads = kBlockK * kQuad;  // 256

template <int D>
__global__ void __launch_bounds__(kF32Threads)
dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, Strides sq,
               Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
               int heads, int n, float scale, DropArgs drop) {
  constexpr int kPer = D / kQuad;
  __shared__ float q_s[kBlockQ][D];
  __shared__ float do_s[kBlockQ][D];
  __shared__ float lse_s[kBlockQ];
  __shared__ float dlt_s[kBlockQ];

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int part = threadIdx.x % kQuad;
  const int key = blockIdx.x * kBlockK + threadIdx.x / kQuad;
  const bool key_valid = key < n;
  const bool dropout = drop.keep_threshold < (1u << 24);
  const uint32_t seed = dropout ? static_cast<uint32_t>(*drop.seed) : 0u;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* db = dout + b * sdo.b + h * sdo.h;
  float kr[kPer], vr[kPer], dka[kPer], dva[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = part + kQuad * i;
    kr[i] = key_valid ? k[b * sk.b + h * sk.h + key * sk.n + c] : 0.0f;
    vr[i] = key_valid ? v[b * sv.b + h * sv.h + key * sv.n + c] : 0.0f;
    dka[i] = dva[i] = 0.0f;
  }

  const int num_tiles = (n + kBlockQ - 1) / kBlockQ;
  for (int tile = 0; tile < num_tiles; ++tile) {
    const int q0 = tile * kBlockQ;
    __syncthreads();
    for (int idx = threadIdx.x; idx < kBlockQ * D; idx += kF32Threads) {
      const int i = idx / D, c = idx % D, row = q0 + i;
      q_s[i][c] = row < n ? qb[row * sq.n + c] : 0.0f;
      do_s[i][c] = row < n ? db[row * sdo.n + c] : 0.0f;
    }
    if (threadIdx.x < kBlockQ) {
      const int row = q0 + threadIdx.x;
      const long long rid = static_cast<long long>(bh) * n + row;
      lse_s[threadIdx.x] = row < n ? lse[rid] : 0.0f;
      dlt_s[threadIdx.x] = row < n ? delta[rid] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kBlockQ; ++i) {
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        s = fmaf(kr[e], q_s[i][part + kQuad * e], s);
        dp = fmaf(vr[e], do_s[i][part + kQuad * e], dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      const int row = q0 + i;
      const float p = row < n ? expf(s * scale - lse_s[i]) : 0.0f;
      float pd = p;
      if (dropout) {
        const bool keep =
            dropout_keep(seed, bh, row, key, drop.keep_threshold);
        pd = keep ? p * drop.inv_keep : 0.0f;
        dp = keep ? dp * drop.inv_keep : 0.0f;
      }
      const float ds = p * (dp - dlt_s[i]);
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        dva[e] = fmaf(pd, do_s[i][part + kQuad * e], dva[e]);
        dka[e] = fmaf(ds, q_s[i][part + kQuad * e], dka[e]);
      }
    }
  }
  if (key_valid) {
    float* ko = dk + b * sdk.b + h * sdk.h + key * sdk.n;
    float* vo = dv + b * sdv.b + h * sdv.h + key * sdv.n;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      ko[part + kQuad * e] = dka[e] * scale;
      vo[part + kQuad * e] = dva[e];
    }
  }
}

// -------------------------------------------------------- bf16 tensor cores
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;  // 128
constexpr int kTile = 64;              // queries per shared-memory tile
constexpr int kSub = 32;               // queries per compute step
constexpr int kStages = 3;             // tiles in the streaming ring

// Shared memory: the block's K rows, its V rows, then one slot per tile of
// the ring: the Q tile, the dO tile, lse[kTile] and delta[kTile].
template <int D, int kChains>
struct Layout {
  static constexpr int kStride = D + kPad;  // bf16 per row
  static constexpr int kBlockRows = kWarps * kChains * 16;
  static constexpr int kTileElems = kTile * kStride;
  static constexpr int kBlockBytes =
      2 * kBlockRows * kStride * static_cast<int>(sizeof(bf16));
  static constexpr int kSlotBytes =
      2 * kTileElems * static_cast<int>(sizeof(bf16)) +
      2 * kTile * static_cast<int>(sizeof(float));
  static constexpr int kBytes = kBlockBytes + kStages * kSlotBytes;
};

template <int D, int kChains>
__global__ void __launch_bounds__(kThreads)
dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sq,
                Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                int heads, int n, float scale, DropArgs drop) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  using L = Layout<D, kChains>;
  constexpr int kSteps = D / 16;        // k-steps of K Q^T and V dO^T
  constexpr int kOutTiles = D / 8;      // n-tiles of dK and dV
  constexpr int kSubTiles = kSub / 8;   // n-tiles of S^T and dP^T per step
  constexpr int kStride = L::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_blk = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_blk = k_blk + L::kBlockRows * kStride;
  unsigned char* slots = smem_raw + L::kBlockBytes;

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = (warp * gridDim.x + blockIdx.x) * 16 * kChains;
  const bool warp_active = key0 < n;
  const float scale_log2e = scale * kLog2e;
  const bool dropout = drop.keep_threshold < (1u << 24);
  const uint32_t seed = dropout ? static_cast<uint32_t>(*drop.seed) : 0u;

  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* db = dout + b * sdo.b + h * sdo.h;
  const float* lse_b = lse + static_cast<long long>(bh) * n;
  const float* dlt_b = delta + static_cast<long long>(bh) * n;
  const int num_tiles = (n + kTile - 1) / kTile;
  auto stage = [&](int tile, int slot) {
    bf16* qs = reinterpret_cast<bf16*>(slots + slot * L::kSlotBytes);
    stage_rows<D>(qs, qb, sq.n, tile * kTile, kTile, n, threadIdx.x, kThreads);
    stage_rows<D>(qs + L::kTileElems, db, sdo.n, tile * kTile, kTile, n,
                  threadIdx.x, kThreads);
    // lse (threads 0-63) and delta (64-127) of the tile's queries.
    float* rows = reinterpret_cast<float*>(qs + 2 * L::kTileElems);
    static_assert(kThreads == 2 * kTile, "one thread per staged value");
    const int row = tile * kTile + (threadIdx.x & (kTile - 1));
    const float* src = threadIdx.x < kTile ? lse_b : dlt_b;
    cp_async4(rows + threadIdx.x, src + (row < n ? row : n - 1),
              row < n ? 4 : 0);
  };
  // This warp's K and V rows, with the first group.
  bf16* kw = k_blk + warp * 16 * kChains * kStride;
  bf16* vw = v_blk + warp * 16 * kChains * kStride;
  stage_rows<D>(kw, k + b * sk.b + h * sk.h, sk.n, key0, 16 * kChains, n, lane,
                32);
  stage_rows<D>(vw, v + b * sv.b + h * sv.h, sv.n, key0, 16 * kChains, n, lane,
                32);
#pragma unroll
  for (int tile = 0; tile < kStages - 1; ++tile) {
    if (tile < num_tiles) stage(tile, tile);
    cp_async_commit();  // an empty group keeps the count
  }

  float dka[kChains][kOutTiles][4], dva[kChains][kOutTiles][4];
#pragma unroll
  for (int c = 0; c < kChains; ++c)
#pragma unroll
    for (int ot = 0; ot < kOutTiles; ++ot)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[c][ot][e] = dva[c][ot][e] = 0.0f;

  for (int tile = 0; tile < num_tiles; ++tile) {
    cp_async_wait<kStages - 2>();  // this thread's copies of `tile` landed
    __syncthreads();               // everyone's did; tile - 1 is consumed
    const int next = tile + kStages - 1;
    if (next < num_tiles) stage(next, next % kStages);
    cp_async_commit();
    if (!warp_active) continue;    // the warp only helps stage
    const unsigned char* slot = slots + (tile % kStages) * L::kSlotBytes;
    const bf16* qs = reinterpret_cast<const bf16*>(slot);
    const bf16* ds = qs + L::kTileElems;
    const float* lse_s = reinterpret_cast<const float*>(ds + L::kTileElems);
    const float* dlt_s = lse_s + kTile;
#pragma unroll
    for (int sub = 0; sub < kTile / kSub; ++sub) {
      const int q0 = tile * kTile + sub * kSub;
      if (q0 >= n) break;
      const bool tail = q0 + kSub > n;  // some queries of this step are past N
      const bf16* qss = qs + sub * kSub * kStride;
      const bf16* dss = ds + sub * kSub * kStride;

      // S^T = K Q^T and dP^T = V dO^T; each Q and dO fragment feeds every
      // chain.
      float s[kChains][kSubTiles][4], dp[kChains][kSubTiles][4];
#pragma unroll
      for (int c = 0; c < kChains; ++c)
#pragma unroll
        for (int nt = 0; nt < kSubTiles; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[c][nt][e] = dp[c][nt][e] = 0.0f;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        uint32_t ka[kChains][4], va[kChains][4];
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          ldmatrix_x4(ka[c], a_frag_addr(kw, kStride, c * 16, st, lane));
          ldmatrix_x4(va[c], a_frag_addr(vw, kStride, c * 16, st, lane));
        }
#pragma unroll
        for (int nt = 0; nt < kSubTiles; nt += 2) {
          uint32_t qf[4], df[4];
          ldmatrix_x4(qf, b_frag_addr(qss, kStride, nt, st, lane));
          ldmatrix_x4(df, b_frag_addr(dss, kStride, nt, st, lane));
#pragma unroll
          for (int c = 0; c < kChains; ++c) {
            mma16816(s[c][nt], ka[c], qf[0], qf[1]);
            mma16816(s[c][nt + 1], ka[c], qf[2], qf[3]);
            mma16816(dp[c][nt], va[c], df[0], df[1]);
            mma16816(dp[c][nt + 1], va[c], df[2], df[3]);
          }
        }
      }

      // s <- P * mask / keep (for dV), dp <- dS (for dK).
#pragma unroll
      for (int nt = 0; nt < kSubTiles; ++nt) {
        const int qc = sub * kSub + nt * 8 + 2 * t;  // query within the tile
        const int row = tile * kTile + qc;
        const float2 lse_q = *reinterpret_cast<const float2*>(lse_s + qc);
        const float2 dlt_q = *reinterpret_cast<const float2*>(dlt_s + qc);
        const float lse2[2] = {lse_q.x * kLog2e, lse_q.y * kLog2e};
        const float dlt[2] = {dlt_q.x, dlt_q.y};
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          uint32_t keep = 0xfu;
          if (dropout)
            keep = dropout_keep_frag<true>(seed, bh, key0 + c * 16 + g, row,
                                           drop.keep_threshold, lane);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e & 1;
            float p = fast_exp2(s[c][nt][e] * scale_log2e - lse2[i]);
            if (tail && row + i >= n) p = 0.0f;
            const bool kept = (keep >> e) & 1u;
            const float dpe = kept ? dp[c][nt][e] * drop.inv_keep : 0.0f;
            s[c][nt][e] = kept ? p * drop.inv_keep : 0.0f;
            dp[c][nt][e] = p * (dpe - dlt[i]);
          }
        }
      }

      // dV += (P mask / keep)^T dO and dK += dS^T Q, dO and Q through
      // ldmatrix.trans from the same tiles.
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t pa[kChains][4], sa[kChains][4];
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          pa[c][0] = pack2f(s[c][2 * kk][0], s[c][2 * kk][1]);
          pa[c][1] = pack2f(s[c][2 * kk][2], s[c][2 * kk][3]);
          pa[c][2] = pack2f(s[c][2 * kk + 1][0], s[c][2 * kk + 1][1]);
          pa[c][3] = pack2f(s[c][2 * kk + 1][2], s[c][2 * kk + 1][3]);
          sa[c][0] = pack2f(dp[c][2 * kk][0], dp[c][2 * kk][1]);
          sa[c][1] = pack2f(dp[c][2 * kk][2], dp[c][2 * kk][3]);
          sa[c][2] = pack2f(dp[c][2 * kk + 1][0], dp[c][2 * kk + 1][1]);
          sa[c][3] = pack2f(dp[c][2 * kk + 1][2], dp[c][2 * kk + 1][3]);
        }
#pragma unroll
        for (int ot = 0; ot < kOutTiles; ot += 2) {
          uint32_t df[4], qf[4];
          ldmatrix_x4_trans(df, bt_frag_addr(dss, kStride, kk * 16, ot, lane));
          ldmatrix_x4_trans(qf, bt_frag_addr(qss, kStride, kk * 16, ot, lane));
#pragma unroll
          for (int c = 0; c < kChains; ++c) {
            mma16816(dva[c][ot], pa[c], df[0], df[1]);
            mma16816(dva[c][ot + 1], pa[c], df[2], df[3]);
            mma16816(dka[c][ot], sa[c], qf[0], qf[1]);
            mma16816(dka[c][ot + 1], sa[c], qf[2], qf[3]);
          }
        }
      }
    }
  }
  if (!warp_active) return;

  bf16* ko = dk + b * sdk.b + h * sdk.h;
  bf16* vo = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + c * 16 + g + 8 * r;
      if (key >= n) continue;
#pragma unroll
      for (int ot = 0; ot < kOutTiles; ++ot) {
        const int col = ot * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(ko + key * sdk.n + col) =
            __floats2bfloat162_rn(dka[c][ot][2 * r] * scale,
                                  dka[c][ot][2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(vo + key * sdv.n + col) =
            __floats2bfloat162_rn(dva[c][ot][2 * r], dva[c][ot][2 * r + 1]);
      }
    }
  }
}

template <int D, int kChains>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta,
                        void* dk, void* dv, Strides sq, Strides sk, Strides sv,
                        Strides sdo, Strides sdk, Strides sdv, int bh,
                        int heads, int n, float scale, DropArgs drop,
                        cudaStream_t stream) {
  auto kernel = dkv_bf16_kernel<D, kChains>;
  constexpr int kBytes = Layout<D, kChains>::kBytes;
  // Above 48 KB a kernel must opt in, once per instantiation.
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (opt_in != cudaSuccess) return opt_in;
  const int slabs = (n + 16 * kChains - 1) / (16 * kChains);
  const dim3 grid((slabs + kWarps - 1) / kWarps, bh);
  kernel<<<grid, kThreads, kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk, sv, sdo, sdk,
      sdv, heads, n, scale, drop);
  return cudaGetLastError();
}

// ------------------------------------------------- bf16, d = 64, wgmma
// The d = 64 instantiation: one warpgroup per block of 64 keys. K and V
// of the block and a ring of Q and dO tiles (with the tile's lse and
// delta) live in 128-byte swizzled shared memory; S^T = K Q^T and
// dP^T = V dO^T are m64n64k16 products of two descriptors, P * mask / keep
// and dS go back in as A operands from registers, and dV += P^T dO,
// dK += dS^T Q read the dO and Q tiles through the descriptor's transpose
// bit. The four accumulators take 128 registers. Products and softmax of
// one block do not overlap; the blocks an SM holds overlap each other's.
// A ring slot: the Q tile, the dO tile, lse[64] and delta[64] (padded so
// that tiles stay 1024-byte aligned).
constexpr int kWgSlotBytes = 2 * wg::kTileBytes + 1024;

__global__ void __launch_bounds__(wg::kThreads)
dkv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sq,
                 Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                 int heads, int n, float scale, DropArgs drop) {
  using namespace wg;
  extern __shared__ unsigned char wg_smem_raw[];
  unsigned char* k_blk = align1024(wg_smem_raw);
  unsigned char* v_blk = k_blk + kTileBytes;
  unsigned char* slots = v_blk + kTileBytes;

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int blk_key0 = blockIdx.x * 64;
  const int key_lo = blk_key0 + warp * 16 + g;
  const float scale_log2e = scale * kLog2e;
  const bool dropout = drop.keep_threshold < (1u << 24);
  const uint32_t seed = dropout ? static_cast<uint32_t>(*drop.seed) : 0u;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* db = dout + b * sdo.b + h * sdo.h;
  const float* lse_b = lse + static_cast<long long>(bh) * n;
  const float* dlt_b = delta + static_cast<long long>(bh) * n;
  const int num_tiles = (n + wg::kTile - 1) / wg::kTile;
  auto stage = [&](int tile, int slot) {
    unsigned char* qs = slots + slot * kWgSlotBytes;
    stage_sw128(qs, qb, sq.n, tile * wg::kTile, n);
    stage_sw128(qs + kTileBytes, db, sdo.n, tile * wg::kTile, n);
    float* rows = reinterpret_cast<float*>(qs + 2 * kTileBytes);
    const int row = tile * wg::kTile + (threadIdx.x & 63);
    const float* src = threadIdx.x < 64 ? lse_b : dlt_b;
    cp_async4(rows + threadIdx.x, src + (row < n ? row : n - 1),
              row < n ? 4 : 0);
  };
  stage_sw128(k_blk, k + b * sk.b + h * sk.h, sk.n, blk_key0, n);
  stage_sw128(v_blk, v + b * sv.b + h * sv.h, sv.n, blk_key0, n);
#pragma unroll
  for (int tile = 0; tile < wg::kStages - 1; ++tile) {
    if (tile < num_tiles) stage(tile, tile);
    cp_async_commit();
  }
  float dka[32], dva[32], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.0f;
  const uint64_t kdesc = make_desc(k_blk), vdesc = make_desc(v_blk);

  for (int tile = 0; tile < num_tiles; ++tile) {
    cp_async_wait<wg::kStages - 2>();
    // The copies become visible to the asynchronous proxy through which
    // wgmma reads shared memory.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // everyone's copies landed; tile - 1 is consumed
    const int next = tile + wg::kStages - 1;
    if (next < num_tiles) stage(next, next % wg::kStages);
    cp_async_commit();

    const unsigned char* qs = slots + (tile % wg::kStages) * kWgSlotBytes;
    const uint64_t qd = make_desc(qs), dd = make_desc(qs + kTileBytes);
    const float* lse_s = reinterpret_cast<const float*>(qs + 2 * kTileBytes);
    const float* dlt_s = lse_s + 64;
    const int q0 = tile * wg::kTile;
    fence_regs(s);
    fence_regs(dp);
    wg_fence();
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      wgmma_ss(s, kdesc + 2 * st, qd + 2 * st, st > 0);
      wgmma_ss(dp, vdesc + 2 * st, dd + 2 * st, st > 0);
    }
    wg_commit();
    wg_wait();
    fence_regs(s);
    fence_regs(dp);

    const bool tail = q0 + wg::kTile > n;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int qc = nt * 8 + 2 * t;
      const int row = q0 + qc;
      const float2 lse_q = *reinterpret_cast<const float2*>(lse_s + qc);
      const float2 dlt_q = *reinterpret_cast<const float2*>(dlt_s + qc);
      const float l2[2] = {lse_q.x * kLog2e, lse_q.y * kLog2e};
      const float dl[2] = {dlt_q.x, dlt_q.y};
      uint32_t keep = 0xfu;
      if (dropout)
        keep = dropout_keep_frag<true>(seed, bh, key_lo, row,
                                       drop.keep_threshold, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e & 1;
        float p = fast_exp2(s[4 * nt + e] * scale_log2e - l2[i]);
        if (tail && row + i >= n) p = 0.0f;
        const bool kept = (keep >> e) & 1u;
        const float dpe = kept ? dp[4 * nt + e] * drop.inv_keep : 0.0f;
        s[4 * nt + e] = kept ? p * drop.inv_keep : 0.0f;
        dp[4 * nt + e] = p * (dpe - dl[i]);
      }
    }
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[kk][i] = pack2f(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
        sa[kk][i] = pack2f(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);
      }
    }
    fence_regs(dka);
    fence_regs(dva);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<1>(dva, pa[kk], dd + 128 * kk, 1);
      wgmma_rs<1>(dka, sa[kk], qd + 128 * kk, 1);
    }
    wg_commit();
    wg_wait();
    fence_regs(dka);
    fence_regs(dva);
  }

  bf16* ko = dk + b * sdk.b + h * sdk.h;
  bf16* vo = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_lo + 8 * r;
    if (key >= n) continue;
#pragma unroll
    for (int ot = 0; ot < 8; ++ot) {
      const int col = ot * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(ko + key * sdk.n + col) =
          __floats2bfloat162_rn(dka[4 * ot + 2 * r] * scale,
                                dka[4 * ot + 2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(vo + key * sdv.n + col) =
          __floats2bfloat162_rn(dva[4 * ot + 2 * r], dva[4 * ot + 2 * r + 1]);
    }
  }
}

cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse, const float* delta,
                         void* dk, void* dv, Strides sq, Strides sk, Strides sv,
                         Strides sdo, Strides sdk, Strides sdv, int bh,
                         int heads, int n, float scale, DropArgs drop,
                         cudaStream_t stream) {
  // K, V, the ring, and room to align the tiles to 1024 bytes.
  constexpr int kBytes =
      2 * wg::kTileBytes + wg::kStages * kWgSlotBytes + 1024;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      dkv_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid((n + wg::kTile - 1) / wg::kTile, bh);
  dkv_wgmma_kernel<<<grid, wg::kThreads, kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk, sv, sdo, sdk,
      sdv, heads, n, scale, drop);
  return cudaGetLastError();
}

// fp32: the scalar kernel; bf16: wgmma at d = 64, the mma.sync ring at the
// other head dims.
template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, Strides sq, Strides sk, Strides sv,
                   Strides sdo, Strides sdk, Strides sdv, int bh, int heads,
                   int n, float scale, DropArgs drop, cudaStream_t stream) {
  if (dtype == 0) {
    const dim3 grid((n + kBlockK - 1) / kBlockK, bh);
    dkv_f32_kernel<D><<<grid, kF32Threads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), sq, sk, sv,
        sdo, sdk, sdv, heads, n, scale, drop);
    return cudaGetLastError();
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  if constexpr (D == 64) {
    return launch_wgmma(q, k, v, dout, lse, delta, dk, dv, sq, sk, sv, sdo,
                        sdk, sdv, bh, heads, n, scale, drop, stream);
  } else {
    return launch_bf16<D, (D <= 32 ? 2 : 1)>(q, k, v, dout, lse, delta, dk, dv,
                                             sq, sk, sv, sdo, sdk, sdv, bh,
                                             heads, n, scale, drop, stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v, dout, dk, dv: (B, H, N, d)
// with element strides (b, h, n) and a contiguous last dimension; lse and
// delta: (B*H, N) contiguous fp32.
// seed: int64 device scalar; keep_threshold = ceil(keep * 2^24) (2^24: no
// dropout). Returns a cudaError_t.
int vt_flash_attention_bwd_dkv(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    long long q_sb, long long q_sh, long long q_sn, long long k_sb,
    long long k_sh, long long k_sn, long long v_sb, long long v_sh,
    long long v_sn, long long do_sb, long long do_sh, long long do_sn,
    long long dk_sb, long long dk_sh, long long dk_sn, long long dv_sb,
    long long dv_sh, long long dv_sn, int batch, int heads, int n, int d,
    float scale, const void* seed, unsigned int keep_threshold,
    float inv_keep, void* stream) {
  if (batch <= 0 || heads <= 0 || n <= 0 || batch * heads > 65535)
    return cudaErrorInvalidValue;
  const Strides sq{q_sb, q_sh, q_sn}, sk{k_sb, k_sh, k_sn};
  const Strides sv{v_sb, v_sh, v_sn}, sdo{do_sb, do_sh, do_sn};
  const Strides sdk{dk_sb, dk_sh, dk_sn}, sdv{dv_sb, dv_sh, dv_sn};
  const DropArgs drop{static_cast<const long long*>(seed), keep_threshold,
                      inv_keep};
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int bh = batch * heads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(dtype, q, k, v, dout, l, dl, dk, dv, sq, sk, sv, sdo, sdk, sdv, bh, heads, n, scale, drop, s);
    case 32: return launch<32>(dtype, q, k, v, dout, l, dl, dk, dv, sq, sk, sv, sdo, sdk, sdv, bh, heads, n, scale, drop, s);
    case 64: return launch<64>(dtype, q, k, v, dout, l, dl, dk, dv, sq, sk, sv, sdo, sdk, sdv, bh, heads, n, scale, drop, s);
    case 80: return launch<80>(dtype, q, k, v, dout, l, dl, dk, dv, sq, sk, sv, sdo, sdk, sdv, bh, heads, n, scale, drop, s);
    case 128: return launch<128>(dtype, q, k, v, dout, l, dl, dk, dv, sq, sk, sv, sdo, sdk, sdv, bh, heads, n, scale, drop, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
