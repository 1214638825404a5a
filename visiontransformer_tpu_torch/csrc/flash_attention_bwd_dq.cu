// Flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces visiontransformer_tpu/ops/flash_attention.py:_bwd_dq_kernel.
// Per query row i, over every key j:
//   P = exp(S - lse_i) with S = q_i k_j^T * scale (keys past N give P = 0),
//   dP = dO_i v_j^T, times mask / keep with dropout,
//   dS = P (dP - delta_i),  dQ_i = sum_j dS k_j * scale,
// where lse is the training forward's (natural log) and
// delta = rowsum(dO * O) comes from the caller, or is computed here in the
// prologue from the block's rows of dO and O and written for the dK/dV
// launch that follows on the same stream. The dropout mask is
// regenerated from (seed, b*H + h, row, column) exactly as the forward drew
// it (flash_attention_common.cuh). Nothing of size N x N is stored.
//
// What bounds it on an H100. The function reads Q, K, V, dO and writes dQ
// (5 * B*H*N*d * 2 bytes, plus lse and delta) and does 6 * B*H*N^2*d
// operations (three N x N x d products). At the training micro-batch
// (B*H = 48, N = 197, d = 64) that is 6 MB and 0.7 GFLOP: 1.8 us of bytes,
// 0.7 us of tensor-core work, so neither bounds it; the launch and the
// serial chain "load operands, walk four key tiles, store" do (latency):
// what helps is many small blocks an SM and loads in flight early.
// From N of a few hundred on it is bound by operations: at (24, 3137, 64)
// 91 GFLOP against 48 MB, 0.092 ms of tensor-core time against 0.014 ms of
// bytes.
//
// Design (bf16), two instantiations by head dim.
//   d = 64 (every ViT configuration of the repository), dq_wgmma_kernel:
//   one warpgroup per block of 64 query rows, on warpgroup products, for
//   every N. At N = 197 it runs 4 x 48 blocks of which the SM holds three,
//   and was measured no slower than an mma.sync instantiation that staged
//   the whole head at once (PERF.md); from N = 320 on it is 20 to 45 %
//   faster than the mma.sync ring.
//   Other head dims (16, 32, 80, 128), dq_bf16_kernel, on mma.sync: a
//   block is four warps; a warp owns kChains slabs of 16 query rows, whose
//   Q and dO fragments stay in registers, and walks every key of its head.
//   K and V arrive in shared memory as row-major 64-key tiles by cp.async
//   (16 bytes a thread, keys past N zero-filled) in a ring of three tiles,
//   the copy of tile i + 2 in flight while tile i computes, one
//   __syncthreads() per tile, and are never copied again: S = Q K^T and
//   dP = dO V^T take their B fragments with ldmatrix.x4, dQ += dS K takes K
//   with ldmatrix.x4.trans from the same tile, and the row padding keeps
//   both free of bank conflicts. Each tile is consumed as two 32-key halves
//   so that S, dP and the accumulators fit in registers without spills; two
//   chains per warp for d <= 32, so each K and V fragment read from shared
//   memory feeds two products, one chain for d = 80 and 128, where two
//   would spill. Slabs are dealt to the warps of a head's blocks
//   round-robin (slab = warp * blocks + block), so a ragged last block
//   idles at most one warp-slab less than the others.
// In both, dS is rounded to bf16 before its product, where the TPU kernel
// rounds it.
// fp32 (kept so parity can be checked on the card at fp32 tolerance) runs
// scalar FMAs with four threads per query row. Inputs may be strided views
// with a contiguous last dimension; rows >= N are never loaded or stored.

#include "flash_attention_common.cuh"
#include "flash_attention_wgmma.cuh"

using namespace vt_flash;

namespace {

constexpr int kBlockQ = 64;   // query rows per block (fp32 path)
constexpr int kBlockK = 32;   // keys per shared-memory tile (fp32 path)

struct DropArgs {
  const long long* seed;
  uint32_t keep_threshold;  // 2^24: no dropout
  float inv_keep;
};

// ---------------------------------------------------------------- fp32 path
constexpr int kQuad = 4;
constexpr int kF32Threads = kBlockQ * kQuad;  // 256

template <int D>
__global__ void __launch_bounds__(kF32Threads)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, Strides sq, Strides sk, Strides sv,
              Strides sdo, Strides sdq, int heads, int n, float scale,
              DropArgs drop) {
  constexpr int kPer = D / kQuad;
  __shared__ float k_s[kBlockK][D];
  __shared__ float v_s[kBlockK][D];

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int part = threadIdx.x % kQuad;
  const int row = blockIdx.x * kBlockQ + threadIdx.x / kQuad;
  const bool row_valid = row < n;
  const bool dropout = drop.keep_threshold < (1u << 24);
  const uint32_t seed = dropout ? static_cast<uint32_t>(*drop.seed) : 0u;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float qr[kPer], dor[kPer], acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = part + kQuad * i;
    qr[i] = row_valid ? q[b * sq.b + h * sq.h + row * sq.n + c] : 0.0f;
    dor[i] = row_valid ? dout[b * sdo.b + h * sdo.h + row * sdo.n + c] : 0.0f;
    acc[i] = 0.0f;
  }
  const long long rid = static_cast<long long>(bh) * n + row;
  const float lse_r = row_valid ? lse[rid] : 0.0f;
  const float dlt_r = row_valid ? delta[rid] : 0.0f;

  const int num_tiles = (n + kBlockK - 1) / kBlockK;
  for (int tile = 0; tile < num_tiles; ++tile) {
    const int key0 = tile * kBlockK;
    __syncthreads();
    for (int idx = threadIdx.x; idx < kBlockK * D; idx += kF32Threads) {
      const int j = idx / D, c = idx % D, key = key0 + j;
      k_s[j][c] = key < n ? kb[key * sk.n + c] : 0.0f;
      v_s[j][c] = key < n ? vb[key * sv.n + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        s = fmaf(qr[i], k_s[j][part + kQuad * i], s);
        dp = fmaf(dor[i], v_s[j][part + kQuad * i], dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      const int key = key0 + j;
      const float p = key < n ? expf(s * scale - lse_r) : 0.0f;
      if (dropout)
        dp = dropout_keep(seed, bh, row, key, drop.keep_threshold)
                 ? dp * drop.inv_keep : 0.0f;
      const float ds = p * (dp - dlt_r);
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] = fmaf(ds, k_s[j][part + kQuad * i], acc[i]);
    }
  }
  if (row_valid) {
    float* out = dq + b * sdq.b + h * sdq.h + row * sdq.n;
#pragma unroll
    for (int i = 0; i < kPer; ++i) out[part + kQuad * i] = acc[i] * scale;
  }
}

// -------------------------------------------------------- bf16 tensor cores
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;  // 128
constexpr int kTile = 64;              // keys per shared-memory tile
constexpr int kSub = 32;               // keys per compute step
constexpr int kStages = 3;             // tiles in the streaming ring

// Where delta comes from: `delta` is read when `out` is null; otherwise
// delta = rowsum(dO * O) is computed from `out` and written to `delta`.
struct DeltaArgs {
  float* delta;
  const bf16* out;
  Strides so;
};

template <int D, int kChains>
__global__ void __launch_bounds__(kThreads)
dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, DeltaArgs dl,
               bf16* __restrict__ dq, Strides sq, Strides sk, Strides sv,
               Strides sdo, Strides sdq, int heads, int n, float scale,
               DropArgs drop) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kSteps = D / 16;        // k-steps of the N x d products
  constexpr int kOutTiles = D / 8;      // n-tiles of dQ
  constexpr int kSubTiles = kSub / 8;   // n-tiles of S and dP per step
  constexpr int kStride = D + kPad;     // bf16 per shared-memory row
  constexpr int kTileElems = kTile * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);  // per tile: K, then V

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp * gridDim.x + blockIdx.x) * 16 * kChains;
  const bool warp_active = row0 < n;
  const float scale_log2e = scale * kLog2e;
  const bool dropout = drop.keep_threshold < (1u << 24);
  const uint32_t seed = dropout ? static_cast<uint32_t>(*drop.seed) : 0u;

  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const int num_tiles = (n + kTile - 1) / kTile;
  auto stage = [&](int tile, int slot) {
    bf16* ks = smem + 2 * slot * kTileElems;
    stage_rows<D>(ks, kb, sk.n, tile * kTile, kTile, n, threadIdx.x, kThreads);
    stage_rows<D>(ks + kTileElems, vb, sv.n, tile * kTile, kTile, n,
                  threadIdx.x, kThreads);
  };
#pragma unroll
  for (int tile = 0; tile < kStages - 1; ++tile) {
    if (tile < num_tiles) stage(tile, tile);
    cp_async_commit();  // an empty group keeps the count
  }

  // Q and dO fragments, lse (log2 domain) and delta of this warp's rows,
  // loaded while the first tiles are in flight.
  uint32_t qa[kChains][kSteps][4], da[kChains][kSteps][4];
  float lse2[kChains][2], dlt[kChains][2];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    const int row_lo = row0 + c * 16 + g;
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      load_a_frag(qa[c][st], q + b * sq.b + h * sq.h, sq.n, row_lo, n,
                  st * 16, t);
      load_a_frag(da[c][st], dout + b * sdo.b + h * sdo.h, sdo.n, row_lo, n,
                  st * 16, t);
    }
    float sum[2] = {0.0f, 0.0f};
    if (dl.out != nullptr) {
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        uint32_t oa[4];
        load_a_frag(oa, dl.out + b * dl.so.b + h * dl.so.h, dl.so.n, row_lo,
                    n, st * 16, t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 x = unpack2(da[c][st][i]), y = unpack2(oa[i]);
          sum[i & 1] += x.x * y.x + x.y * y.y;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 8 * r;
      const long long rid = static_cast<long long>(bh) * n + row;
      lse2[c][r] = row < n ? lse[rid] * kLog2e : 0.0f;
      if (dl.out != nullptr) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        dlt[c][r] = sum[r];
        if (t == 0 && row < n) dl.delta[rid] = sum[r];
      } else {
        dlt[c][r] = row < n ? dl.delta[rid] : 0.0f;
      }
    }
  }

  float acc[kChains][kOutTiles][4];
#pragma unroll
  for (int c = 0; c < kChains; ++c)
#pragma unroll
    for (int ot = 0; ot < kOutTiles; ++ot)
      acc[c][ot][0] = acc[c][ot][1] = acc[c][ot][2] = acc[c][ot][3] = 0.0f;

  for (int tile = 0; tile < num_tiles; ++tile) {
    cp_async_wait<kStages - 2>();  // this thread's copies of `tile` landed
    __syncthreads();               // everyone's did; tile - 1 is consumed
    const int next = tile + kStages - 1;
    if (next < num_tiles) stage(next, next % kStages);
    cp_async_commit();
    if (!warp_active) continue;    // the warp only helps stage
    const bf16* ks = smem + 2 * (tile % kStages) * kTileElems;
    const bf16* vs = ks + kTileElems;
#pragma unroll
    for (int sub = 0; sub < kTile / kSub; ++sub) {
      const int key0 = tile * kTile + sub * kSub;
      if (key0 >= n) break;
      const bool tail = key0 + kSub > n;  // some keys of this step are past N
      const bf16* kss = ks + sub * kSub * kStride;
      const bf16* vss = vs + sub * kSub * kStride;

      // S = Q K^T and dP = dO V^T; each B fragment feeds every chain.
      float s[kChains][kSubTiles][4], dp[kChains][kSubTiles][4];
#pragma unroll
      for (int c = 0; c < kChains; ++c)
#pragma unroll
        for (int nt = 0; nt < kSubTiles; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[c][nt][e] = dp[c][nt][e] = 0.0f;
#pragma unroll
      for (int nt = 0; nt < kSubTiles; nt += 2) {
#pragma unroll
        for (int st = 0; st < kSteps; ++st) {
          uint32_t kf[4], vf[4];
          ldmatrix_x4(kf, b_frag_addr(kss, kStride, nt, st, lane));
          ldmatrix_x4(vf, b_frag_addr(vss, kStride, nt, st, lane));
#pragma unroll
          for (int c = 0; c < kChains; ++c) {
            mma16816(s[c][nt], qa[c][st], kf[0], kf[1]);
            mma16816(s[c][nt + 1], qa[c][st], kf[2], kf[3]);
            mma16816(dp[c][nt], da[c][st], vf[0], vf[1]);
            mma16816(dp[c][nt + 1], da[c][st], vf[2], vf[3]);
          }
        }
      }

      // dS = P (dP * mask / keep - delta), into s.
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
#pragma unroll
        for (int nt = 0; nt < kSubTiles; ++nt) {
          const int key = key0 + nt * 8 + 2 * t;
          uint32_t keep = 0xfu;
          if (dropout)
            keep = dropout_keep_frag<false>(seed, bh, row0 + c * 16 + g, key,
                                            drop.keep_threshold, lane);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            float p = fast_exp2(s[c][nt][e] * scale_log2e - lse2[c][r]);
            if (tail && key + (e & 1) >= n) p = 0.0f;
            const float dpe =
                (keep >> e) & 1u ? dp[c][nt][e] * drop.inv_keep : 0.0f;
            s[c][nt][e] = p * (dpe - dlt[c][r]);
          }
        }
      }

      // dQ += dS K, K through ldmatrix.trans from the same tile.
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t pa[kChains][4];
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          pa[c][0] = pack2f(s[c][2 * kk][0], s[c][2 * kk][1]);
          pa[c][1] = pack2f(s[c][2 * kk][2], s[c][2 * kk][3]);
          pa[c][2] = pack2f(s[c][2 * kk + 1][0], s[c][2 * kk + 1][1]);
          pa[c][3] = pack2f(s[c][2 * kk + 1][2], s[c][2 * kk + 1][3]);
        }
#pragma unroll
        for (int ot = 0; ot < kOutTiles; ot += 2) {
          uint32_t kf[4];
          ldmatrix_x4_trans(kf, bt_frag_addr(kss, kStride, kk * 16, ot, lane));
#pragma unroll
          for (int c = 0; c < kChains; ++c) {
            mma16816(acc[c][ot], pa[c], kf[0], kf[1]);
            mma16816(acc[c][ot + 1], pa[c], kf[2], kf[3]);
          }
        }
      }
    }
  }
  if (!warp_active) return;

  bf16* ob = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + c * 16 + g + 8 * r;
      if (row >= n) continue;
#pragma unroll
      for (int ot = 0; ot < kOutTiles; ++ot)
        *reinterpret_cast<__nv_bfloat162*>(ob + row * sdq.n + ot * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[c][ot][2 * r] * scale,
                                  acc[c][ot][2 * r + 1] * scale);
    }
  }
}

template <int D, int kChains>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, DeltaArgs dl,
                        void* dq, Strides sq, Strides sk, Strides sv,
                        Strides sdo, Strides sdq, int bh, int heads, int n,
                        float scale, DropArgs drop, cudaStream_t stream) {
  auto kernel = dq_bf16_kernel<D, kChains>;
  // The ring: K and V of kStages tiles. Above 48 KB a kernel must opt in,
  // once per instantiation.
  constexpr int kBytes =
      kStages * 2 * kTile * (D + kPad) * static_cast<int>(sizeof(bf16));
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (opt_in != cudaSuccess) return opt_in;
  const int slabs = (n + 16 * kChains - 1) / (16 * kChains);
  const dim3 grid((slabs + kWarps - 1) / kWarps, bh);
  kernel<<<grid, kThreads, kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, dl,
      static_cast<bf16*>(dq), sq, sk, sv, sdo, sdq, heads, n, scale, drop);
  return cudaGetLastError();
}

// ------------------------------------------------- bf16, d = 64, wgmma
// The d = 64 instantiation: one warpgroup per block of 64 query rows. Q
// and dO of the block and a ring of K and V tiles live in 128-byte
// swizzled shared memory; S = Q K^T and dP = dO V^T are
// m64n64k16 products of two descriptors, dS goes back in as the A operand
// from registers, and dQ += dS K reads the same K tile through the
// descriptor's transpose bit. Products and softmax of one block do not
// overlap; the two or three blocks an SM holds overlap each other's.
__global__ void __launch_bounds__(wg::kThreads)
dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, DeltaArgs dl,
                bf16* __restrict__ dq, Strides sq, Strides sk, Strides sv,
                Strides sdo, Strides sdq, int heads, int n, float scale,
                DropArgs drop) {
  using namespace wg;
  extern __shared__ unsigned char wg_smem_raw[];
  unsigned char* q_blk = align1024(wg_smem_raw);
  unsigned char* do_blk = q_blk + kTileBytes;
  unsigned char* ring = do_blk + kTileBytes;  // per stage: K tile, V tile

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row_lo = blockIdx.x * wg::kTile + warp * 16 + g;
  const float scale_log2e = scale * kLog2e;
  const bool dropout = drop.keep_threshold < (1u << 24);
  const uint32_t seed = dropout ? static_cast<uint32_t>(*drop.seed) : 0u;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const bf16* dob = dout + b * sdo.b + h * sdo.h;
  const int num_tiles = (n + wg::kTile - 1) / wg::kTile;
  auto stage = [&](int tile, int slot) {
    stage_sw128(ring + slot * 2 * kTileBytes, kb, sk.n, tile * wg::kTile, n);
    stage_sw128(ring + slot * 2 * kTileBytes + kTileBytes, vb, sv.n,
                tile * wg::kTile, n);
  };
  stage_sw128(q_blk, q + b * sq.b + h * sq.h, sq.n, blockIdx.x * wg::kTile, n);
  stage_sw128(do_blk, dob, sdo.n, blockIdx.x * wg::kTile, n);
#pragma unroll
  for (int tile = 0; tile < wg::kStages - 1; ++tile) {
    if (tile < num_tiles) stage(tile, tile);
    cp_async_commit();  // an empty group keeps the count
  }
  const uint64_t qdesc = make_desc(q_blk), ddesc = make_desc(do_blk);

  // delta from O when the caller passed it: two threads a row, each half
  // the row of dO and O as four 16-byte loads, handed through shared memory
  // to the threads that hold the row in the products' layout (loading in
  // that layout, 32 4-byte loads a thread, cost three times as much).
  __shared__ float delta_s[wg::kTile];
  if (dl.out != nullptr) {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int row = blockIdx.x * wg::kTile + r;
    float sum = 0.0f;
    if (row < n) {
      const uint4* dv4 =
          reinterpret_cast<const uint4*>(dob + row * sdo.n) + 4 * half;
      const uint4* ov4 = reinterpret_cast<const uint4*>(
          dl.out + b * dl.so.b + h * dl.so.h + row * dl.so.n) + 4 * half;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 x = dv4[i], y = ov4[i];
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
        const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = unpack2(xs[e]), yf = unpack2(ys[e]);
          sum += xf.x * yf.x + xf.y * yf.y;
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      delta_s[r] = sum;
      if (row < n) dl.delta[static_cast<long long>(bh) * n + row] = sum;
    }
    __syncthreads();
  }
  // lse (log2 domain) and delta of this thread's two rows.
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    const long long rid = static_cast<long long>(bh) * n + row;
    lse2[r] = row < n ? lse[rid] * kLog2e : 0.0f;
    if (dl.out != nullptr)
      dlt[r] = delta_s[warp * 16 + g + 8 * r];
    else
      dlt[r] = row < n ? dl.delta[rid] : 0.0f;
  }
  float acc[32], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

  for (int tile = 0; tile < num_tiles; ++tile) {
    cp_async_wait<wg::kStages - 2>();
    // The copies become visible to the asynchronous proxy through which
    // wgmma reads shared memory.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // everyone's copies landed; tile - 1 is consumed
    const int next = tile + wg::kStages - 1;
    if (next < num_tiles) stage(next, next % wg::kStages);
    cp_async_commit();

    const unsigned char* ks = ring + (tile % wg::kStages) * 2 * kTileBytes;
    const uint64_t kd = make_desc(ks), vd = make_desc(ks + kTileBytes);
    const int key0 = tile * wg::kTile;
    fence_regs(s);
    fence_regs(dp);
    wg_fence();
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      wgmma_ss(s, qdesc + 2 * st, kd + 2 * st, st > 0);
      wgmma_ss(dp, ddesc + 2 * st, vd + 2 * st, st > 0);
    }
    wg_commit();
    wg_wait();
    fence_regs(s);
    fence_regs(dp);

    // dS = P (dP * mask / keep - delta), into s.
    const bool tail = key0 + wg::kTile > n;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int key = key0 + nt * 8 + 2 * t;
      uint32_t keep = 0xfu;
      if (dropout)
        keep = dropout_keep_frag<false>(seed, bh, row_lo, key,
                                        drop.keep_threshold, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = fast_exp2(s[4 * nt + e] * scale_log2e - lse2[r]);
        if (tail && key + (e & 1) >= n) p = 0.0f;
        const float dpe =
            (keep >> e) & 1u ? dp[4 * nt + e] * drop.inv_keep : 0.0f;
        s[4 * nt + e] = p * (dpe - dlt[r]);
      }
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = pack2f(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(acc, pa[kk], kd + 128 * kk, 1);
    wg_commit();
    wg_wait();  // the tile and pa are free again
    fence_regs(acc);
  }

  bf16* ob = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int ot = 0; ot < 8; ++ot)
      *reinterpret_cast<__nv_bfloat162*>(ob + row * sdq.n + ot * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[4 * ot + 2 * r] * scale,
                                acc[4 * ot + 2 * r + 1] * scale);
  }
}

cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse, DeltaArgs dl,
                         void* dq, Strides sq, Strides sk, Strides sv,
                         Strides sdo, Strides sdq, int bh, int heads, int n,
                         float scale, DropArgs drop, cudaStream_t stream) {
  // Q, dO, the ring, and room to align the tiles to 1024 bytes.
  constexpr int kBytes = (wg::kStages + 1) * 2 * wg::kTileBytes + 1024;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      dq_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid((n + wg::kTile - 1) / wg::kTile, bh);
  dq_wgmma_kernel<<<grid, wg::kThreads, kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, dl,
      static_cast<bf16*>(dq), sq, sk, sv, sdo, sdq, heads, n, scale, drop);
  return cudaGetLastError();
}

// fp32: the scalar kernel; bf16: wgmma at d = 64, the mma.sync ring at the
// other head dims.
template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, DeltaArgs dl, void* dq,
                   Strides sq, Strides sk, Strides sv, Strides sdo,
                   Strides sdq, int bh, int heads, int n, float scale,
                   DropArgs drop, cudaStream_t stream) {
  if (dtype == 0) {
    if (dl.out != nullptr) return cudaErrorInvalidValue;
    const dim3 grid((n + kBlockQ - 1) / kBlockQ, bh);
    dq_f32_kernel<D><<<grid, kF32Threads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        dl.delta, static_cast<float*>(dq), sq, sk, sv, sdo, sdq, heads, n,
        scale, drop);
    return cudaGetLastError();
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  if constexpr (D == 64) {
    return launch_wgmma(q, k, v, dout, lse, dl, dq, sq, sk, sv, sdo, sdq, bh,
                        heads, n, scale, drop, stream);
  } else {
    return launch_bf16<D, (D <= 32 ? 2 : 1)>(q, k, v, dout, lse, dl, dq, sq, sk,
                                             sv, sdo, sdq, bh, heads, n, scale,
                                             drop, stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v, dout, dq: (B, H, N, d) with
// element strides (b, h, n) and a contiguous last dimension; lse and delta:
// (B*H, N) contiguous fp32. out: null, and delta is read; or (bf16 only)
// the forward's output with strides (o_sb, o_sh, o_sn), and delta is
// computed from it and written. seed: int64 device scalar;
// keep_threshold = ceil(keep * 2^24) (2^24: no dropout). Returns a
// cudaError_t.
int vt_flash_attention_bwd_dq(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* delta, const void* out, void* dq,
    long long q_sb, long long q_sh, long long q_sn, long long k_sb,
    long long k_sh, long long k_sn, long long v_sb, long long v_sh,
    long long v_sn, long long do_sb, long long do_sh, long long do_sn,
    long long o_sb, long long o_sh, long long o_sn, long long dq_sb,
    long long dq_sh, long long dq_sn, int batch, int heads, int n, int d,
    float scale, const void* seed, unsigned int keep_threshold,
    float inv_keep, void* stream) {
  if (batch <= 0 || heads <= 0 || n <= 0 || batch * heads > 65535)
    return cudaErrorInvalidValue;
  const Strides sq{q_sb, q_sh, q_sn}, sk{k_sb, k_sh, k_sn};
  const Strides sv{v_sb, v_sh, v_sn}, sdo{do_sb, do_sh, do_sn};
  const Strides sdq{dq_sb, dq_sh, dq_sn};
  const DropArgs drop{static_cast<const long long*>(seed), keep_threshold,
                      inv_keep};
  const DeltaArgs dl{static_cast<float*>(delta),
                     static_cast<const bf16*>(out), Strides{o_sb, o_sh, o_sn}};
  const float* l = static_cast<const float*>(lse);
  const int bh = batch * heads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(dtype, q, k, v, dout, l, dl, dq, sq, sk, sv, sdo, sdq, bh, heads, n, scale, drop, s);
    case 32: return launch<32>(dtype, q, k, v, dout, l, dl, dq, sq, sk, sv, sdo, sdq, bh, heads, n, scale, drop, s);
    case 64: return launch<64>(dtype, q, k, v, dout, l, dl, dq, sq, sk, sv, sdo, sdq, bh, heads, n, scale, drop, s);
    case 80: return launch<80>(dtype, q, k, v, dout, l, dl, dq, sq, sk, sv, sdo, sdq, bh, heads, n, scale, drop, s);
    case 128: return launch<128>(dtype, q, k, v, dout, l, dl, dq, sq, sk, sv, sdo, sdq, bh, heads, n, scale, drop, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
