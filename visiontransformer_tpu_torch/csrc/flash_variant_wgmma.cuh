// The Hopper design of two tuning-sweep kernels: kernel 6 (flash_variants.cu,
// the softmax forms) and kernel 8 (flash_chains.cu, chains 1 transposed:
// O^T = V^T P^T). Both compute inference attention, softmax(Q K^T * d^-1/2)
// V, at d = 64 in bf16, online over key tiles of kBlockK keys: the running
// max is updated once per tile, as the TPU kernels update it once per
// block_k keys, in every instantiation.
//
// What bounds them: at the sweeps' shape (B*H = 192, N = 1025, d = 64) the
// function needs 4 * B*H*N^2*d = 51.6 GFLOP (0.052 ms at 989 TFLOP/s)
// against 4 * B*H*N*d * 2 bytes = 101 MB (0.030 ms at 3.35 TB/s), and
// B*H*N^2 = 202 M exponentials, which take about as long again on the
// special-function units (16 a clock per SM; expf adds its range
// reduction on the FMA pipes). So operations bound them: the tensor cores
// have to run one warpgroup's products while another computes its softmax,
// and the loads must never wait on the products.
//
// The shared base:
//   - consumer warpgroups on wgmma.mma_async (bf16 in, fp32 accumulated),
//     plus one producer warp that fills the shared memory by TMA;
//   - Q staged once per block as 128-byte swizzled rows (one TMA box of
//     the block's query rows); K and V in a ring of kStages swizzled tiles
//     of kBlockK keys, each stage a "full" mbarrier (the producer's arrival
//     and the TMA bytes) and an "empty" one (each consumer warp arrives
//     when its last product reading the stage is done);
//   - tensor maps of rank 4 (64, N, H, B) over the strided views, so that
//     slices of a fused (B, N, 3, H, 64) projection are read in place; rows
//     past N are filled with zeros by the TMA unit, keys past N are scored
//     NEG_INF (p = 0 exactly) and rows past N never stored;
//   - P rounded to bf16 before its product, as the TPU kernels round it to
//     v's dtype; the output divided by max(l, 1e-30), not multiplied by a
//     reciprocal.
// TMA needs a 16-byte aligned base and strides that are multiples of 16
// bytes; the wrappers (ops/flash_variants.py) refuse other views before a
// launch. cuTensorMapEncodeTiled is taken from libcuda.so.1, which the
// runtime has loaded (dlopen), so the build links nothing beyond cudart.
#pragma once

#include <cuda.h>
#include <dlfcn.h>
#include <stdio.h>

#include <type_traits>

#include "flash_attention_common.cuh"
#include "flash_attention_wgmma.cuh"

namespace vt_flash {
namespace sweep {

constexpr int kD = 64;          // the sweeps' head dim
constexpr int kRowBytes = 128;  // a bf16 row of d = 64: one swizzle atom
constexpr int kWgRows = 64;     // rows of a warpgroup's product (wgmma M)

enum Mode : int { kBase = 0, kBf16Exp = 1, kExp2 = 2 };

// Error codes above kTmaError carry the CUresult of a failed
// cuTensorMapEncodeTiled (error_string names them).
constexpr int kTmaError = 10000;

// ------------------------------------------------------------ exponentials
// 2^x of a bf16 pair, in bf16 (sm_90: one instruction for two values).
__device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// exp of x0, x1 as the TPU kernel's bf16 mode takes it: x rounded to bf16,
// then exp computed in bf16, here as the bf16 ex2 of x * log2(e) with the
// product rounded to bf16 (in fp32 first: log2(e) itself would lose 2^-9 in
// bf16). On sm_90a the ex2 is MUFU.EX2.BF16, which rounds 2^y toward zero.
// torch's bf16 exp computes in fp32 and rounds to nearest, so the kernel
// differs from its plain version by the product's rounding and the
// truncation (chip_smoke.py, BF16EXP_TOL); bf16exp_card_plain
// (ops/flash_variants.py) rounds as the kernel does (BF16EXP_CARD_TOL).
__device__ __forceinline__ uint32_t exp_bf16x2(float x0, float x1) {
  const float2 x = unpack2(pack2f(x0, x1));
  return ex2_bf16x2(pack2f(x.x * kLog2e, x.y * kLog2e));
}

// ----------------------------------------------------- mbarriers and TMA
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer's arrival, announcing `bytes` of TMA transactions.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// One box (64 columns x the map's box rows) at (row, head, batch) into
// swizzled shared memory, completing `bytes` on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int head,
                                         int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(0), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// Wait until at most kPending of this warp's wgmma groups are in flight.
template <int kPending>
__device__ __forceinline__ void wg_wait_pending() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending)
               : "memory");
}

// Barrier `id` (1-15) among `threads` threads (whole warps).
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// Generic-proxy writes to shared memory become visible to wgmma.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Compile-time switches for the phases of a tile.
constexpr std::true_type kYes{};
constexpr std::false_type kNo{};

// ------------------------------------------------------------ the softmax
// One online-softmax step over a tile of 8 * kNT keys from key0, for the
// two rows (g, g + 8) a lane holds of a wgmma accumulator (s[4 nt + e]:
// row e >> 1, key key0 + 8 nt + 2 t + (e & 1)), raw Q K^T. Scales, masks
// keys past N, updates m and this lane's part of l, returns alpha and hands
// each bf16 pair of P (keys 8 nt + 2 t, + 1 of row r) to put(nt, r, pair),
// the exponentials of kMode taken exactly as the mma.sync kernels of
// flash_variant_kernel.cuh took them:
//   kBase     alpha = expf(m - m_new), p = expf(s - m_new);
//   kExp2     exp2f((x) * log2 e), log2 e applied after the subtraction;
//   kBf16Exp  exp_bf16x2, l summing the bf16 p.
template <int kMode, int kNT, typename Put>
__device__ __forceinline__ void softmax_step(float (&s)[4 * kNT],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int key0,
                                             int t, int n, float scale,
                                             Put put) {
  const bool tail = key0 + 8 * kNT > n;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 4 * kNT; ++i) {
    const int key = key0 + (i >> 2) * 8 + 2 * t + (i & 1);
    s[i] = (!tail || key < n) ? s[i] * scale : kNegInf;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  float m_new[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    m_new[r] = fmaxf(m[r], mx[r]);
  }
  if constexpr (kMode == kBf16Exp) {
    const float2 a = unpack2(exp_bf16x2(m[0] - m_new[0], m[1] - m_new[1]));
    alpha[0] = a.x;
    alpha[1] = a.y;
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      alpha[r] = kMode == kExp2 ? exp2f((m[r] - m_new[r]) * kLog2e)
                                : expf(m[r] - m_new[r]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] *= alpha[r];
    m[r] = m_new[r];
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float x0 = s[4 * nt + 2 * r] - m[r];
      const float x1 = s[4 * nt + 2 * r + 1] - m[r];
      if constexpr (kMode == kBf16Exp) {
        const uint32_t p = exp_bf16x2(x0, x1);
        const float2 pf = unpack2(p);
        l[r] += pf.x + pf.y;
        put(nt, r, p);
      } else {
        // base: the full-accuracy expf (no -use_fast_math), the function
        // the TPU kernel computes, so that base against exp2 prices exactly
        // the lever "exp vs exp2".
        const float p0 = kMode == kExp2 ? exp2f(x0 * kLog2e) : expf(x0);
        const float p1 = kMode == kExp2 ? exp2f(x1 * kLog2e) : expf(x1);
        l[r] += p0 + p1;
        put(nt, r, pack2f(p0, p1));
      }
    }
  }
}

// Sum of l over the quad that shares a row, floored at 1e-30.
__device__ __forceinline__ void finish_l(float& l) {
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  l = fmaxf(l, 1.0e-30f);
}

// ============================================================== kernel 6
// Rows: every consumer warpgroup owns 64 query rows of one (batch, head).
// Iteration j waits for stage j, starts S_j = Q K_j^T (wgmma, both operands
// from shared memory, n = kBlockK) and P_{j-1} V_{j-1} (P from the
// accumulators of S_{j-1} as register A fragments, V read MN-major through
// the descriptor's transpose bit) as two groups, waits for both, frees
// stage j - 1, then runs tile j's softmax and rescales O. The consumer
// warpgroups of a block (two, or three at 64-key tiles) share each K/V
// tile; O leaves through the warpgroup's Q tile as 16-byte stores. The first and
// last tiles are peeled, so that every wgmma and wait sits on a path
// ptxas knows to be uniform: on a branch it must treat as divergent it
// serializes the products (warning C7520), which cost the kernel 5-20 %.
template <int kBlockK>
struct RowsCfg {
  // The S accumulator (kBlockK / 2 fp32), O (32) and P (kBlockK / 4) a
  // thread decide the warps an SM holds. Its registers are four banks of
  // 16 K, one a scheduler, and a bank takes a quarter of a block's warps,
  // rounded up, the producer warp included. At 32-key tiles two blocks of
  // two warpgroups (nine warps: 96 registers a thread); at 64, where 96
  // registers spilled and ptxas serialized the products (C7512), one block
  // of three (thirteen warps: 128); at 128, one block of two (168).
  static constexpr int kConsumers = kBlockK == 64 ? 3 : 2;
  static constexpr int kRows = kConsumers * kWgRows;  // query rows a block
  static constexpr int kThreads = kConsumers * 128 + 32;
  static constexpr int kStages = kBlockK == 32 ? 8 : 4;
  static constexpr int kMinBlocks = kBlockK == 32 ? 2 : 1;
  static constexpr int kTileBytes = kBlockK * kRowBytes;  // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kQBytes = kRows * kRowBytes;
  static constexpr int kSmemBytes =
      1024 + kQBytes + kStages * kStageBytes + (2 * kStages + 1) * 8;
};

template <int kMode, int kBlockK>
__global__ void __launch_bounds__(RowsCfg<kBlockK>::kThreads,
                                  RowsCfg<kBlockK>::kMinBlocks)
variant_rows_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    bf16* __restrict__ o, Strides so, int heads, int n,
                    float scale) {
  using Cfg = RowsCfg<kBlockK>;
  constexpr int kNT = kBlockK / 8;      // 8-key groups of S
  constexpr int kKSteps = kBlockK / 16; // k-steps of P V
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = wg::align1024(smem_raw);
  unsigned char* ring = q_s + Cfg::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Cfg::kStages *
                                                          Cfg::kStageBytes);
  uint64_t* empty = full + Cfg::kStages;
  uint64_t* q_full = empty + Cfg::kStages;

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int block_row0 = blockIdx.x * Cfg::kRows;
  const int num_tiles = (n + kBlockK - 1) / kBlockK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    // Warpgroups whose rows all lie past N leave at once: only the others
    // release stages.
    const int active = min(Cfg::kConsumers,
                           (n - block_row0 + kWgRows - 1) / kWgRows);
    for (int s = 0; s < Cfg::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * active);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * Cfg::kConsumers) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(q_full, Cfg::kQBytes);
      tma_load(q_s, &q_map, q_full, block_row0, h, b);
      for (int j = 0; j < num_tiles; ++j) {
        const int slot = j % Cfg::kStages;
        if (j >= Cfg::kStages)
          mbar_wait(&empty[slot], (j / Cfg::kStages - 1) & 1);
        unsigned char* stage = ring + slot * Cfg::kStageBytes;
        mbar_expect_tx(&full[slot], Cfg::kStageBytes);
        tma_load(stage, &k_map, &full[slot], j * kBlockK, h, b);
        tma_load(stage + Cfg::kTileBytes, &v_map, &full[slot], j * kBlockK,
                 h, b);
      }
    }
    return;
  }

  const int wgi = warp / 4, wwarp = warp % 4;
  const int g = lane >> 2, t = lane & 3;
  const int wg_row0 = block_row0 + wgi * kWgRows;
  if (wg_row0 >= n) return;
  unsigned char* q_wg = q_s + wgi * wg::kTileBytes;
  const uint64_t qdesc = wg::make_desc(q_wg);

  float acc[32], s[kBlockK / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t pa[kKSteps][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  mbar_wait(q_full, 0);

  // Iteration j: S_j (kS) and P_{j-1} V_{j-1} (kPV); both are compile-time
  // so that no wgmma sits on a path ptxas must treat as divergent (it then
  // serializes the products).
  auto tile = [&](int j, auto has_s, auto has_pv) {
    constexpr bool kS = decltype(has_s)::value, kPV = decltype(has_pv)::value;
    if constexpr (kS)
      mbar_wait(&full[j % Cfg::kStages], (j / Cfg::kStages) & 1);
    wg::fence_acc(s);
    wg::fence_acc(acc);
    wg::fence_frags(pa);
    wg::wg_fence();
    if constexpr (kS) {
      const uint64_t kd =
          wg::make_desc(ring + (j % Cfg::kStages) * Cfg::kStageBytes);
#pragma unroll
      for (int st = 0; st < 4; ++st)
        wg::wgmma_ss_n<kBlockK>(s, qdesc + 2 * st, kd + 2 * st, st > 0);
      wg::wg_commit();
    }
    if constexpr (kPV) {
      const uint64_t vd = wg::make_desc(
          ring + ((j - 1) % Cfg::kStages) * Cfg::kStageBytes +
          Cfg::kTileBytes);
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        wg::wgmma_rs<1>(acc, pa[kk], vd + 128 * kk, 1);
      wg::wg_commit();
    }
    wg::wg_wait();  // S_j and P_{j-1} V_{j-1}: acc, s and pa are free
    wg::fence_acc(s);
    wg::fence_acc(acc);
    wg::fence_frags(pa);
    if constexpr (kPV)
      if (lane == 0) mbar_arrive(&empty[(j - 1) % Cfg::kStages]);
    if constexpr (kS) {
      float alpha[2];
      // P's pair (nt, r) is A fragment register (nt & 1) * 2 + r of k-step
      // nt / 2: rows g / g + 8, keys 2t, 2t + 1 (+ 8).
      softmax_step<kMode, kNT>(
          s, m, l, alpha, j * kBlockK, t, n, scale,
          [&](int nt, int r, uint32_t p) { pa[nt >> 1][(nt & 1) * 2 + r] = p; });
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }
  };
  tile(0, kYes, kNo);
  for (int j = 1; j < num_tiles; ++j) tile(j, kYes, kYes);
  tile(num_tiles, kNo, kYes);

  // O through this warpgroup's Q tile (swizzled as it was), out as 16-byte
  // stores; each warp writes and reads its own 16 rows.
  bar_sync(1 + wgi, 128);  // every warp's last S product is done with Q
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    finish_l(l[r]);
    const int row_in = wwarp * 16 + g + 8 * r;  // row_in & 7 == g
#pragma unroll
    for (int ot = 0; ot < 8; ++ot)
      *reinterpret_cast<uint32_t*>(q_wg + row_in * kRowBytes +
                                   ((ot ^ g) << 4) + 4 * t) =
          pack2f(acc[4 * ot + 2 * r] / l[r], acc[4 * ot + 2 * r + 1] / l[r]);
  }
  __syncwarp();
  bf16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = lane + 32 * i;
    const int row_in = wwarp * 16 + (idx >> 3), c = idx & 7;
    const int row = wg_row0 + row_in;
    if (row < n)
      *reinterpret_cast<uint4*>(ob + row * so.n + c * 8) =
          *reinterpret_cast<const uint4*>(q_wg + row_in * kRowBytes +
                                          ((c ^ (row_in & 7)) << 4));
  }
}

// ============================================================== kernel 8
// Transposed output: O^T (d x queries) = V^T P^T, the lever of the TPU
// kernel, whose MXU then fills its output lanes with block_q queries
// instead of d = 64. On Hopper the output rows are the 64 features, exactly
// one wgmma M, and the queries are its N: a consumer warpgroup owns 64
// queries and takes P V as m64n64 products with V^T read MN-major (the
// descriptor's transpose bit on A, no transposed copy) and P^T read
// K-major from a swizzled P tile in shared memory, since wgmma reads B
// only from there.
// S is not transposed: S = Q K^T comes as m64 x kBlockK products, so a
// query's max and sum reduce inside its lane quad, as in kernel 6, where
// S^T = K Q^T would reduce each query across the eight lanes and four
// warps that hold its column (a shared-memory exchange of max and sum each
// tile) and would take 32-key tiles as half a wgmma M of 64. Only alpha,
// one float a query, crosses the warps each tile: the lanes that own a row
// write it to shared memory, and each lane reads the columns of O^T it
// holds.
// A block holds two warpgroups (128 queries, sharing each K/V tile) and
// one producer warp; two blocks an SM, 96 registers a thread. N = 128
// queries a warpgroup, the TPU kernel's full width, took 1.33x the time
// at (192, 1025, 64): its O^T and S pin 128 of the 168 registers of a
// block of one warpgroup, and an SM then holds eight warps to hide the
// softmax's latency instead of sixteen.
// Iteration j starts S_j and then O^T += V^T P^T of tile j - 1, waits for
// S_j and runs its softmax while the product runs, writing P into the
// other of two P tiles (and alpha into the other of two rows) than the
// product in flight reads; then it waits for the product, and one named
// barrier a tile hands P and alpha from the writers to the rescale and the
// next product. O^T leaves through shared memory as runs of queries along
// each of its 64 rows of the (B, H, 64, N) output.
template <int kBlockK>
struct PvtCfg {
  static constexpr int kQueries = kWgRows;          // a warpgroup's: N
  static constexpr int kConsumers = 2;              // warpgroups a block
  static constexpr int kRows = kConsumers * kQueries;  // queries a block
  static constexpr int kThreads = kConsumers * 128 + 32;
  static constexpr int kStages = kBlockK == 32 ? 6 : 3;
  static constexpr int kTileBytes = kBlockK * kRowBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kWgBytes = kQueries * kRowBytes;  // Q or a P tile
  // O^T staged as 64 rows of kQueries + 8 bf16 (a padded row keeps the
  // stores of a quad's pairs on distinct banks), over the P tiles.
  static constexpr int kOtStride = kQueries + 8;
  static constexpr int kSmemBytes = 1024 + 3 * kRows * kRowBytes +
                                    kStages * kStageBytes + 3 * kRows * 4 +
                                    (2 * kStages + 1) * 8;
  static_assert(kD * kOtStride * 2 <= 2 * kWgBytes, "O^T fits over P");
};

template <int kBlockK>
__global__ void __launch_bounds__(PvtCfg<kBlockK>::kThreads, 2)
pvt_kernel(const __grid_constant__ CUtensorMap q_map,
           const __grid_constant__ CUtensorMap k_map,
           const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
           Strides so, int heads, int n, float scale) {
  using Cfg = PvtCfg<kBlockK>;
  constexpr int kNT = kBlockK / 8;
  constexpr int kKSteps = kBlockK / 16;
  constexpr int kQueries = Cfg::kQueries;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = wg::align1024(smem_raw);     // Q a warpgroup
  unsigned char* p_s = q_s + Cfg::kRows * kRowBytes;  // two P a warpgroup
  unsigned char* ring = p_s + 2 * Cfg::kRows * kRowBytes;
  float* alpha_s = reinterpret_cast<float*>(ring + Cfg::kStages *
                                                       Cfg::kStageBytes);
  float* l_s = alpha_s + 2 * Cfg::kRows;
  uint64_t* full = reinterpret_cast<uint64_t*>(l_s + Cfg::kRows);
  uint64_t* empty = full + Cfg::kStages;
  uint64_t* q_full = empty + Cfg::kStages;

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * Cfg::kRows;
  const int num_tiles = (n + kBlockK - 1) / kBlockK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    // Warpgroups whose queries all lie past N leave at once: only the
    // others release stages.
    const int active = min(Cfg::kConsumers, (n - q0 + kQueries - 1) /
                                                kQueries);
    for (int s = 0; s < Cfg::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * active);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * Cfg::kConsumers) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(q_full, Cfg::kRows * kRowBytes);
      tma_load(q_s, &q_map, q_full, q0, h, b);
      for (int j = 0; j < num_tiles; ++j) {
        const int slot = j % Cfg::kStages;
        if (j >= Cfg::kStages)
          mbar_wait(&empty[slot], (j / Cfg::kStages - 1) & 1);
        unsigned char* stage = ring + slot * Cfg::kStageBytes;
        mbar_expect_tx(&full[slot], Cfg::kStageBytes);
        tma_load(stage, &k_map, &full[slot], j * kBlockK, h, b);
        tma_load(stage + Cfg::kTileBytes, &v_map, &full[slot], j * kBlockK,
                 h, b);
      }
    }
    return;
  }

  const int wgi = warp / 4, wwarp = warp % 4;
  const int g = lane >> 2, t = lane & 3;
  const int wg_q0 = q0 + wgi * kQueries;
  if (wg_q0 >= n) return;
  unsigned char* q_wg = q_s + wgi * Cfg::kWgBytes;
  unsigned char* p_wg = p_s + 2 * wgi * Cfg::kWgBytes;
  float* alpha_wg = alpha_s + 2 * wgi * kQueries;
  float* l_wg = l_s + wgi * kQueries;
  // O^T: ot[4 jj + e] is feature wwarp * 16 + g + 8 (e >> 1), query
  // wg_q0 + 8 jj + 2 t + (e & 1); S: rows wwarp * 16 + g (+ 8) of the
  // warpgroup's queries.
  const int row_lo = wwarp * 16 + g;  // row_lo & 7 == g
  float ot[kQueries / 2], s[kBlockK / 2];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kQueries / 2; ++i) ot[i] = 0.0f;
  mbar_wait(q_full, 0);
  // Iteration j: S_j (kS) and O^T += V^T P^T of tile j - 1 (kPV), both
  // compile-time so that no wgmma or wait sits on a path ptxas must treat
  // as divergent (it then serializes the products).
  auto tile = [&](int j, auto has_s, auto has_pv) {
    constexpr bool kS = decltype(has_s)::value, kPV = decltype(has_pv)::value;
    if constexpr (kS)
      mbar_wait(&full[j % Cfg::kStages], (j / Cfg::kStages) & 1);
    wg::fence_acc(s);
    wg::fence_acc(ot);
    wg::wg_fence();
    if constexpr (kS) {
      const uint64_t qd = wg::make_desc(q_wg);
      const uint64_t kd =
          wg::make_desc(ring + (j % Cfg::kStages) * Cfg::kStageBytes);
#pragma unroll
      for (int st = 0; st < 4; ++st)
        wg::wgmma_ss_n<kBlockK>(s, qd + 2 * st, kd + 2 * st, st > 0);
      wg::wg_commit();
    }
    if constexpr (kPV) {
      // A = the V tile read MN-major (16 keys = 2048 bytes a k-step), B =
      // P tile (j - 1) & 1 read K-major (16 keys = 32 bytes).
      const uint64_t vd = wg::make_desc(
          ring + ((j - 1) % Cfg::kStages) * Cfg::kStageBytes +
          Cfg::kTileBytes);
      const uint64_t pd =
          wg::make_desc(p_wg + ((j - 1) & 1) * Cfg::kWgBytes);
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        wg::wgmma_ss_n<kQueries, 1>(ot, vd + 128 * kk, pd + 2 * kk, 1);
      wg::wg_commit();
    }
    if constexpr (kS) {
      // S_j, the product of tile j - 1 still in flight; P into P tile
      // j & 1, alpha into row j & 1, which the product and the rescale of
      // tile j - 2 last read, both before the barrier of tile j - 1.
      wg_wait_pending<kPV>();
      wg::fence_acc(s);
      unsigned char* p_j = p_wg + (j & 1) * Cfg::kWgBytes;
      float alpha[2];
      softmax_step<kBase, kNT>(
          s, m, l, alpha, j * kBlockK, t, n, scale,
          [&](int nt, int r, uint32_t p) {
            *reinterpret_cast<uint32_t*>(p_j + (row_lo + 8 * r) * kRowBytes +
                                         ((nt ^ g) << 4) + 4 * t) = p;
          });
      if (t == 0) {
        float* alpha_j = alpha_wg + (j & 1) * kQueries;
        alpha_j[row_lo] = alpha[0];
        alpha_j[row_lo + 8] = alpha[1];
      }
    }
    wg::wg_wait();  // the product of tile j - 1: O^T is free, stage j - 1 too
    wg::fence_acc(ot);
    if constexpr (kPV)
      if (lane == 0) mbar_arrive(&empty[(j - 1) % Cfg::kStages]);
    if constexpr (kS) {
      fence_async_shared();  // P reaches the products' proxy
      bar_sync(1 + wgi, 128);
      const float* alpha_j = alpha_wg + (j & 1) * kQueries;
#pragma unroll
      for (int jj = 0; jj < kQueries / 8; ++jj) {
        const float2 a =
            *reinterpret_cast<const float2*>(alpha_j + 8 * jj + 2 * t);
        ot[4 * jj] *= a.x;
        ot[4 * jj + 1] *= a.y;
        ot[4 * jj + 2] *= a.x;
        ot[4 * jj + 3] *= a.y;
      }
    }
  };
  tile(0, kYes, kNo);
  for (int j = 1; j < num_tiles; ++j) tile(j, kYes, kYes);
  tile(num_tiles, kNo, kYes);

  // Every product is done (the last wait): l by query through shared
  // memory, O^T / l staged over the P tiles, then each thread stores one
  // query of every feature row.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    finish_l(l[r]);
    if (t == 0) l_wg[row_lo + 8 * r] = l[r];
  }
  bar_sync(1 + wgi, 128);
  bf16* ot_s = reinterpret_cast<bf16*>(p_wg);
#pragma unroll
  for (int jj = 0; jj < kQueries / 8; ++jj) {
    const float2 lv = *reinterpret_cast<const float2*>(l_wg + 8 * jj + 2 * t);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int d = wwarp * 16 + g + 8 * r;
      *reinterpret_cast<uint32_t*>(ot_s + d * Cfg::kOtStride + 8 * jj +
                                   2 * t) =
          pack2f(ot[4 * jj + 2 * r] / lv.x, ot[4 * jj + 2 * r + 1] / lv.y);
    }
  }
  bar_sync(1 + wgi, 128);
  bf16* ob = o + b * so.b + h * so.h + wg_q0;  // so.n: a feature row
  for (int idx = threadIdx.x % 128; idx < kD * kQueries; idx += 128) {
    const int d = idx / kQueries, col = idx % kQueries;
    if (wg_q0 + col < n) ob[d * so.n + col] = ot_s[d * Cfg::kOtStride + col];
  }
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// The rank-4 map (64, N, H, B) of a bf16 view with element strides s,
// boxes of 64 x rows, 128-byte swizzle, rows past N read as zeros.
inline int make_map(CUtensorMap* map, const void* base, Strides s,
                    int batch, int heads, int n, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return kTmaError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kD),
                              static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s.n) * 2,
                                 static_cast<cuuint64_t>(s.h) * 2,
                                 static_cast<cuuint64_t>(s.b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kD),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTmaError + static_cast<int>(r);
}

// Build the three maps, opt in to the shared memory once per
// instantiation, and launch kernel<<<(ceil(N / rows), B*H), threads>>>.
template <typename Kernel>
int launch(Kernel kernel, int rows, int block_k, int threads, int smem_bytes,
           const void* q, const void* k, const void* v, void* o, Strides sq,
           Strides sk, Strides sv, Strides so, int batch, int heads, int n,
           float scale, cudaStream_t stream, cudaError_t opt_in) {
  if (batch <= 0 || heads <= 0 || n <= 0 || batch * heads > 65535)
    return cudaErrorInvalidValue;
  if (opt_in != cudaSuccess) return opt_in;
  CUtensorMap q_map, k_map, v_map;
  int err = make_map(&q_map, q, sq, batch, heads, n, rows);
  if (!err) err = make_map(&k_map, k, sk, batch, heads, n, block_k);
  if (!err) err = make_map(&v_map, v, sv, batch, heads, n, block_k);
  if (err) return err;
  const dim3 grid((n + rows - 1) / rows, batch * heads);
  kernel<<<grid, threads, smem_bytes, stream>>>(
      q_map, k_map, v_map, static_cast<bf16*>(o), so, heads, n, scale);
  return cudaGetLastError();
}

template <int kMode, int kBlockK>
int launch_variant(const void* q, const void* k, const void* v, void* o,
                   Strides sq, Strides sk, Strides sv, Strides so, int batch,
                   int heads, int n, float scale, cudaStream_t stream) {
  using Cfg = RowsCfg<kBlockK>;
  auto kernel = variant_rows_kernel<kMode, kBlockK>;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmemBytes);
  return launch(kernel, Cfg::kRows, kBlockK, Cfg::kThreads, Cfg::kSmemBytes,
                q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, stream,
                opt_in);
}

template <int kBlockK>
int launch_pvt(const void* q, const void* k, const void* v, void* o,
               Strides sq, Strides sk, Strides sv, Strides so, int batch,
               int heads, int n, float scale, cudaStream_t stream) {
  using Cfg = PvtCfg<kBlockK>;
  auto kernel = pvt_kernel<kBlockK>;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmemBytes);
  return launch(kernel, Cfg::kRows, kBlockK, Cfg::kThreads, Cfg::kSmemBytes,
                q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, stream,
                opt_in);
}

// What the runtime makes of an instantiation: out = {registers a thread,
// blocks an SM, threads a block, dynamic shared memory, local (spilled)
// bytes a thread}.
template <typename Kernel>
int kernel_info(Kernel kernel, int threads, int smem_bytes, int* out) {
  cudaFuncAttributes attr;
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem_bytes);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = blocks;
  out[2] = threads;
  out[3] = smem_bytes;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

template <int kMode, int kBlockK>
int variant_info(int* out) {
  using Cfg = RowsCfg<kBlockK>;
  return kernel_info(variant_rows_kernel<kMode, kBlockK>, Cfg::kThreads,
                     Cfg::kSmemBytes, out);
}

template <int kBlockK>
int pvt_info(int* out) {
  using Cfg = PvtCfg<kBlockK>;
  return kernel_info(pvt_kernel<kBlockK>, Cfg::kThreads, Cfg::kSmemBytes,
                     out);
}

// Message of an error code returned by the launches.
inline const char* error_string(int err) {
  if (err < kTmaError)
    return cudaGetErrorString(static_cast<cudaError_t>(err));
  static thread_local char msg[96];
  snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed (CUresult %d)",
           err - kTmaError);
  return msg;
}

}  // namespace sweep
}  // namespace vt_flash
