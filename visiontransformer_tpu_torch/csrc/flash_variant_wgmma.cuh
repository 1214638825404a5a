// The Hopper design of the tuning-sweep kernels: kernel 6 (flash_variants.cu,
// the softmax forms) and kernels 7, 8 and 9 (flash_chains.cu: chains, the
// transposed P V, both). All compute inference attention, softmax(Q K^T *
// d^-1/2) V, at d = 64 in bf16, online over key tiles of kBlockK keys: the
// running max is updated once per tile, as the TPU kernels update it once
// per block_k keys, in every instantiation.
//
// What bounds them: at the sweeps' shape (B*H = 192, N = 1025, d = 64) the
// function needs 4 * B*H*N^2*d = 51.6 GFLOP (0.052 ms at 989 TFLOP/s)
// against 4 * B*H*N*d * 2 bytes = 101 MB (0.030 ms at 3.35 TB/s), and
// B*H*N^2 = 202 M exponentials, which take about as long again on the
// special-function units (16 a clock per SM; expf adds its range
// reduction on the FMA pipes). So operations bound them: the tensor cores
// have to run one chain's products while another computes its softmax,
// and the loads must never wait on the products.
//
// The shared base ("wgmma_tma"):
//   - consumer warpgroups on wgmma.mma_async (bf16 in, fp32 accumulated),
//     plus one producer warp (of a producer warpgroup in kernels 7 and 9)
//     that fills the shared memory by TMA;
//   - a chain is 64 query rows (one wgmma M) with their own S, O (or O^T),
//     m and l; a warpgroup holds one chain (kernels 6 and 8) or two
//     (kernels 7 and 9);
//   - Q staged once per block as 128-byte swizzled rows (TMA boxes of the
//     block's query rows, q_box); K and V in a ring of kStages swizzled tiles
//     of kBlockK keys, each stage a "full" mbarrier (the producer's arrival
//     and the TMA bytes) and an "empty" one (each consumer warp arrives
//     when its last product reading the stage is done);
//   - tensor maps of rank 4 (64, N, H, B) over the strided views, so that
//     slices of a fused (B, N, 3, H, 64) projection are read in place; rows
//     past N are filled with zeros by the TMA unit, keys past N are scored
//     NEG_INF (p = 0 exactly) and rows past N never stored; a chain whose
//     rows all lie past N computes on those zeros and stores nothing, a
//     warpgroup whose rows all do leaves at once;
//   - the first and last tiles peeled, so that every wgmma and wait sits on
//     a path ptxas knows to be uniform: on a branch it must treat as
//     divergent it serializes the products (warning C7520);
//   - P rounded to bf16 before its product, as the TPU kernels round it to
//     v's dtype; the output divided by max(l, 1e-30), not multiplied by a
//     reciprocal.
// TMA needs a 16-byte aligned base and strides that are multiples of 16
// bytes; the wrappers (ops/flash_variants.py) refuse other views before a
// launch. cuTensorMapEncodeTiled is taken from libcuda.so.1, which the
// runtime has loaded (dlopen), so the build links nothing beyond cudart.
//
// Registers decide the blocks. A thread's registers are four banks of 16 K,
// one a scheduler, and a bank takes a quarter of a block's warps, rounded
// up, the producer warp included: a block of two consumer warpgroups and
// the producer (nine warps) gets 168 registers a thread at one block an SM
// and 96 at two; one of three warpgroups (thirteen warps) 128 at one.
// Kernels 7 and 9 hold two chains a warpgroup, more than 168 registers:
// their producer is a whole warpgroup, which hands its registers to the
// consumers by setmaxnreg (consumer_regs).
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
constexpr int kChainBytes = kWgRows * kRowBytes;  // a chain's Q or P tile

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

// Barrier `id` (1-15) among `threads` threads (whole warps): bar_sync
// waits for them, bar_arrive counts this warp in and goes on.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// This warpgroup's registers a thread raised to / lowered to kRegs, from
// and to the block's own pool: what one warpgroup takes, another must have
// given. Every warp of it must take the same path from here to its end,
// else ptxas ignores the request (C7508).
template <int kRegs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

// Registers a thread of a block of `warps` warps at one block an SM (a
// bank holds 512 a lane and a quarter of the warps, rounded up), and what
// each of `consumers` warpgroups may take when a producer warpgroup lowers
// its own from there to 24: setmaxnreg moves registers within the block.
constexpr int kProducerRegs = 24;
constexpr int launch_regs(int warps) { return 512 / ((warps + 3) / 4) / 8 * 8; }
constexpr int consumer_regs(int warps, int consumers) {
  return launch_regs(warps) +
         (launch_regs(warps) - kProducerRegs) / consumers / 8 * 8;
}

// Generic-proxy writes to shared memory become visible to wgmma.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Compile-time switches for the phases of a tile.
constexpr std::true_type kYes{};
constexpr std::false_type kNo{};

// ------------------------------------------------------------ the ring
// Rows of a TMA box of a block's Q: its rows, or 128 at a time where they
// exceed TMA's 256.
__host__ __device__ constexpr int q_box(int rows) {
  return rows > 256 ? 128 : rows;
}

// A block's ring of kStages stages, each a K tile and a V tile of kBlockK
// keys, and its barriers, which lie after it: full[s], empty[s], q_full.
template <int kStages, int kBlockK>
struct Ring {
  static constexpr int kTileBytes = kBlockK * kRowBytes;  // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBytes = kStages * kStageBytes + (2 * kStages + 1) * 8;

  unsigned char* stages;
  uint64_t* full;

  __device__ explicit Ring(unsigned char* at)
      : stages(at),
        full(reinterpret_cast<uint64_t*>(at + kStages * kStageBytes)) {}
  __device__ uint64_t* empty(int s) const { return full + kStages + s; }
  __device__ uint64_t* q_full() const { return full + 2 * kStages; }
  __device__ unsigned char* k_tile(int j) const {
    return stages + (j % kStages) * kStageBytes;
  }
  __device__ unsigned char* v_tile(int j) const {
    return k_tile(j) + kTileBytes;
  }

  // Thread 0: a stage is full on the producer's arrival and its bytes,
  // empty on one arrival of each warp of the `active` consumer warpgroups
  // (the others leave at once).
  __device__ void init(int active) const {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(empty(s), 4 * active);
    }
    mbar_init(q_full(), 1);
    mbar_init_fence();
  }

  // The producer warp's lane 0: the block's Q (q_rows from row q0) once,
  // then K and V of every key tile, each into its stage once the consumers
  // have released the tile that used it before.
  __device__ void produce(unsigned char* q_s, int q_rows,
                          const CUtensorMap* q_map, const CUtensorMap* k_map,
                          const CUtensorMap* v_map, int q0, int h, int b,
                          int num_tiles) const {
    mbar_expect_tx(q_full(), q_rows * kRowBytes);
    for (int r = 0; r < q_rows; r += q_box(q_rows))
      tma_load(q_s + r * kRowBytes, q_map, q_full(), q0 + r, h, b);
    for (int j = 0; j < num_tiles; ++j) {
      const int slot = j % kStages;
      if (j >= kStages) mbar_wait(empty(slot), (j / kStages - 1) & 1);
      mbar_expect_tx(&full[slot], kStageBytes);
      tma_load(k_tile(j), k_map, &full[slot], j * kBlockK, h, b);
      tma_load(v_tile(j), v_map, &full[slot], j * kBlockK, h, b);
    }
  }

  __device__ void wait_full(int j) const {
    mbar_wait(&full[j % kStages], (j / kStages) & 1);
  }
  // A consumer warp is done with tile j.
  __device__ void release(int j, int lane) const {
    if (lane == 0) mbar_arrive(empty(j % kStages));
  }
};

// ------------------------------------------------------------ the softmax
// One online-softmax step over a tile of 8 * kNT keys from key0, for the
// two rows (g, g + 8) a lane holds of a wgmma accumulator (s[4 nt + e]:
// row e >> 1, key key0 + 8 nt + 2 t + (e & 1)), raw Q K^T. Scales, masks
// keys past N, updates m and this lane's part of l, returns alpha and hands
// each bf16 pair of P (keys 8 nt + 2 t, + 1 of row r) to put(nt, r, pair),
// the exponentials of kMode taken as follows:
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

// Base-mode softmax_step whose P goes into the swizzled P tile p_tile (a
// row a query, 8-key groups as 16-byte chunks, chunk nt of row r at nt ^
// (r & 7)): the rows (row_lo, row_lo + 8) of this lane, row_lo & 7 == g.
template <int kNT>
__device__ __forceinline__ void softmax_to_tile(
    float (&s)[4 * kNT], float (&m)[2], float (&l)[2], float (&alpha)[2],
    int key0, int g, int t, int n, float scale, unsigned char* p_tile,
    int row_lo) {
  softmax_step<kBase, kNT>(
      s, m, l, alpha, key0, t, n, scale, [&](int nt, int r, uint32_t p) {
        *reinterpret_cast<uint32_t*>(p_tile + (row_lo + 8 * r) * kRowBytes +
                                     ((nt ^ g) << 4) + 4 * t) = p;
      });
}

// S (+)= Q K_j^T of one chain at n = kBlockK, both from shared memory, as
// one commit group.
template <int kBlockK>
__device__ __forceinline__ void issue_s(float (&s)[kBlockK / 2],
                                        const unsigned char* q_tile,
                                        const unsigned char* k_tile) {
  const uint64_t qd = wg::make_desc(q_tile);
  const uint64_t kd = wg::make_desc(k_tile);
#pragma unroll
  for (int st = 0; st < 4; ++st)
    wg::wgmma_ss_n<kBlockK>(s, qd + 2 * st, kd + 2 * st, st > 0);
  wg::wg_commit();
}

// O / l of a chain's 64 rows (acc, l in the wgmma layout of warp wwarp)
// out through the chain's Q tile (swizzled as it was), as 16-byte stores
// of the rows below n from row0; each warp writes and reads its own 16
// rows. The caller has made sure no product still reads the tile.
__device__ __forceinline__ void store_rows(const float (&acc)[32],
                                           float (&l)[2], unsigned char* tile,
                                           bf16* ob, long long sn, int row0,
                                           int n, int wwarp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    finish_l(l[r]);
    const int row_in = wwarp * 16 + g + 8 * r;  // row_in & 7 == g
#pragma unroll
    for (int ot = 0; ot < 8; ++ot)
      *reinterpret_cast<uint32_t*>(tile + row_in * kRowBytes +
                                   ((ot ^ g) << 4) + 4 * t) =
          pack2f(acc[4 * ot + 2 * r] / l[r], acc[4 * ot + 2 * r + 1] / l[r]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = lane + 32 * i;
    const int row_in = wwarp * 16 + (idx >> 3), c = idx & 7;
    const int row = row0 + row_in;
    if (row < n)
      *reinterpret_cast<uint4*>(ob + row * sn + c * 8) =
          *reinterpret_cast<const uint4*>(tile + row_in * kRowBytes +
                                          ((c ^ (row_in & 7)) << 4));
  }
}

// O^T (64 features x kQ queries, wgmma layout: ot[4 jj + e] is feature
// wwarp * 16 + g + 8 (e >> 1), query 8 jj + 2 t + (e & 1)) times alpha by
// query, read from shared memory.
template <int kQ>
__device__ __forceinline__ void rescale_ot(float (&ot)[kQ / 2],
                                           const float* alpha, int t) {
#pragma unroll
  for (int jj = 0; jj < kQ / 8; ++jj) {
    const float2 a = *reinterpret_cast<const float2*>(alpha + 8 * jj + 2 * t);
    ot[4 * jj] *= a.x;
    ot[4 * jj + 1] *= a.y;
    ot[4 * jj + 2] *= a.x;
    ot[4 * jj + 3] *= a.y;
  }
}

// O^T / l of a warpgroup's kQ queries (l_q: l by query in shared memory)
// out as runs of queries along each of the 64 rows of the (B, H, 64, N)
// output from query q0: staged in ot_s (rows of kQ + 8 bf16, a padded row
// keeping the stores of a quad's pairs on distinct banks), then each
// thread stores one query of a feature row at a time. Every product is
// done; `bar` is the warpgroup's barrier.
template <int kQ>
__device__ __forceinline__ void store_ot(const float (&ot)[kQ / 2],
                                         const float* l_q, bf16* ot_s,
                                         bf16* ob, long long sn, int q0,
                                         int n, int wwarp, int lane,
                                         int bar) {
  constexpr int kStride = kQ + 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int jj = 0; jj < kQ / 8; ++jj) {
    const float2 lv = *reinterpret_cast<const float2*>(l_q + 8 * jj + 2 * t);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int d = wwarp * 16 + g + 8 * r;
      *reinterpret_cast<uint32_t*>(ot_s + d * kStride + 8 * jj + 2 * t) =
          pack2f(ot[4 * jj + 2 * r] / lv.x, ot[4 * jj + 2 * r + 1] / lv.y);
    }
  }
  bar_sync(bar, 128);
  for (int idx = threadIdx.x % 128; idx < kD * kQ; idx += 128) {
    const int d = idx / kQ, col = idx % kQ;
    if (q0 + col < n) ob[d * sn + col] = ot_s[d * kStride + col];
  }
}

// ============================================================== kernel 6
// Rows: every consumer warpgroup owns 64 query rows of one (batch, head).
// Iteration j waits for stage j, starts S_j = Q K_j^T (wgmma, both operands
// from shared memory, n = kBlockK) and P_{j-1} V_{j-1} (P from the
// accumulators of S_{j-1} as register A fragments, V read MN-major through
// the descriptor's transpose bit) as two groups, waits for both, frees
// stage j - 1, then runs tile j's softmax and rescales O. The consumer
// warpgroups of a block (two, or three at 64-key tiles) share each K/V
// tile; O leaves through the warpgroup's Q tile as 16-byte stores.
template <int kBlockK>
struct RowsCfg {
  // The S accumulator (kBlockK / 2 fp32), O (32) and P (kBlockK / 4) a
  // thread decide the warps an SM holds: at 32-key tiles two blocks of two
  // warpgroups (96 registers a thread); at 64, where 96 registers spilled
  // and ptxas serialized the products (C7512), one block of three (128);
  // at 128, one block of two (168).
  static constexpr int kConsumers = kBlockK == 64 ? 3 : 2;
  static constexpr int kRows = kConsumers * kWgRows;  // query rows a block
  static constexpr int kThreads = kConsumers * 128 + 32;
  static constexpr int kStages = kBlockK == 32 ? 8 : 4;
  static constexpr int kMinBlocks = kBlockK == 32 ? 2 : 1;
  static constexpr int kConsumerRegs = 0;  // as launched
  using Ring = sweep::Ring<kStages, kBlockK>;
  static constexpr int kQBytes = kRows * kRowBytes;
  static constexpr int kSmemBytes = 1024 + kQBytes + Ring::kBytes;
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
  const typename Cfg::Ring ring(q_s + Cfg::kQBytes);

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int block_row0 = blockIdx.x * Cfg::kRows;
  const int num_tiles = (n + kBlockK - 1) / kBlockK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0)
    ring.init(min(Cfg::kConsumers, (n - block_row0 + kWgRows - 1) / kWgRows));
  __syncthreads();

  if (warp == 4 * Cfg::kConsumers) {  // the producer warp
    if (lane == 0)
      ring.produce(q_s, Cfg::kRows, &q_map, &k_map, &v_map, block_row0, h,
                   b, num_tiles);
    return;
  }

  const int wgi = warp / 4, wwarp = warp % 4;
  const int t = lane & 3;
  const int wg_row0 = block_row0 + wgi * kWgRows;
  if (wg_row0 >= n) return;
  unsigned char* q_wg = q_s + wgi * kChainBytes;

  float acc[32], s[kBlockK / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t pa[kKSteps][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  mbar_wait(ring.q_full(), 0);

  // Iteration j: S_j (kS) and P_{j-1} V_{j-1} (kPV); both are compile-time
  // so that no wgmma sits on a path ptxas must treat as divergent.
  auto tile = [&](int j, auto has_s, auto has_pv) {
    constexpr bool kS = decltype(has_s)::value, kPV = decltype(has_pv)::value;
    if constexpr (kS) ring.wait_full(j);
    wg::fence_acc(s);
    wg::fence_acc(acc);
    wg::fence_frags(pa);
    wg::wg_fence();
    if constexpr (kS) issue_s<kBlockK>(s, q_wg, ring.k_tile(j));
    if constexpr (kPV) {
      const uint64_t vd = wg::make_desc(ring.v_tile(j - 1));
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        wg::wgmma_rs<1>(acc, pa[kk], vd + 128 * kk, 1);
      wg::wg_commit();
    }
    wg::wg_wait();  // S_j and P_{j-1} V_{j-1}: acc, s and pa are free
    wg::fence_acc(s);
    wg::fence_acc(acc);
    wg::fence_frags(pa);
    if constexpr (kPV) ring.release(j - 1, lane);
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

  bar_sync(1 + wgi, 128);  // every warp's last S product is done with Q
  store_rows(acc, l, q_wg, o + b * so.b + h * so.h, so.n, wg_row0, n, wwarp,
             lane);
}

// ============================================================== kernel 7
// Chains: each consumer warpgroup runs kChains = 2 chains of 64 query rows
// (A and B) over the same K/V tiles, the TPU kernel's lever (one chain's
// exponentials while another's products run) on one warpgroup's
// instruction stream, as FA3 overlaps within a warpgroup. Iteration j:
//   issue P_B V_{j-1}, S_A(j), S_B(j) -> wait for all but S_B -> free stage
//   j - 1 -> softmax A, rescale O_A while S_B runs -> issue P_A V_j -> wait
//   for S_B -> softmax B, rescale O_B while P_A V_j runs -> wait for it.
// Chain B's P V waits for the next tile's issue, so that no product is in
// flight across the loop's back edge: ptxas serializes every product of a
// kernel where one is (C7514). Issuing S_A before P_B V_{j-1}, so that the
// first wait covers S_A alone, gained nothing.
// Registers a thread per chain: S (kBlockK / 2), O (32), P as register A
// fragments (kBlockK / 4), m and l (4): 84 a chain at 64-key tiles. A
// block holds two such warpgroups (256 queries) and a producer warpgroup,
// one block an SM: 168 registers a thread at launch (three warps a bank),
// then the producer warpgroup gives its registers to the consumers
// (setmaxnreg: 24 and 240, FA3's split). At 168 two chains and their
// addressing spilled; P through shared memory, which fit, took 1.19x the
// time at 64-key tiles (two barriers a tile). A lone producer warp could
// give the consumers 16 registers a thread: setmaxnreg draws on the
// block's own pool alone. Three consumer warpgroups (160 registers)
// spilled at 64-key tiles and leave no pair to ping-pong.
// kPingPong (quadq: four chains) orders the two warpgroups' products by a
// pair of named barriers, FA3's inter-warpgroup schedule: a warpgroup
// issues a tile's products only after the other has issued its own, so
// that one warpgroup's softmax runs while the other's products do, and the
// four chains of a block interleave. Without it (dualq) the warp
// schedulers interleave the two warpgroups as they come.
template <int kBlockK>
struct ChainsCfg {
  static constexpr int kChains = 2;      // chains a warpgroup
  static constexpr int kConsumers = 2;   // warpgroups a block (one an SM)
  static constexpr int kWgQ = kChains * kWgRows;      // queries a warpgroup
  static constexpr int kRows = kConsumers * kWgQ;     // queries a block
  static constexpr int kThreads = kConsumers * 128 + 128;  // + producer
  static constexpr int kConsumerRegs = consumer_regs(kThreads / 32, kConsumers);
  static constexpr int kStages = kBlockK == 32 ? 8 : 4;
  using Ring = sweep::Ring<kStages, kBlockK>;
  static constexpr int kQBytes = kRows * kRowBytes;
  static constexpr int kSmemBytes = 1024 + kQBytes + Ring::kBytes;
};

template <int kBlockK, bool kPingPong>
__global__ void __launch_bounds__(ChainsCfg<kBlockK>::kThreads, 1)
chains_kernel(const __grid_constant__ CUtensorMap q_map,
              const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map,
              bf16* __restrict__ o, Strides so, int heads, int n,
              float scale) {
  using Cfg = ChainsCfg<kBlockK>;
  constexpr int kC = Cfg::kChains;
  constexpr int kNT = kBlockK / 8;
  constexpr int kKSteps = kBlockK / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = wg::align1024(smem_raw);
  const typename Cfg::Ring ring(q_s + Cfg::kQBytes);

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int block_row0 = blockIdx.x * Cfg::kRows;
  const int num_tiles = (n + kBlockK - 1) / kBlockK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int active =
      min(Cfg::kConsumers, (n - block_row0 + Cfg::kWgQ - 1) / Cfg::kWgQ);
  if (threadIdx.x == 0) ring.init(active);
  __syncthreads();

  if (warp >= 4 * Cfg::kConsumers) {  // the producer warpgroup
    reg_dealloc<kProducerRegs>();
    if (warp == 4 * Cfg::kConsumers && lane == 0)
      ring.produce(q_s, Cfg::kRows, &q_map, &k_map, &v_map, block_row0, h,
                   b, num_tiles);
    return;
  }
  reg_alloc<Cfg::kConsumerRegs>();

  const int wgi = warp / 4, wwarp = warp % 4;
  const int t = lane & 3;
  const int wg_row0 = block_row0 + wgi * Cfg::kWgQ;
  if (wg_row0 >= n) return;
  // The turn barriers (3 + warpgroup) of the ping-pong, when both
  // warpgroups run: the second lets the first go first.
  const bool pp = kPingPong && Cfg::kConsumers == 2 && active == 2;
  if (pp && wgi == 1) bar_arrive(3, 256);
  unsigned char* q_wg = q_s + wgi * kC * kChainBytes;

  float acc[kC][32], s[kC][kBlockK / 2], m[kC][2], l[kC][2];
  uint32_t pa[kC][kKSteps][4];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;
    m[c][0] = m[c][1] = kNegInf;
    l[c][0] = l[c][1] = 0.0f;
  }
  // The registers of chain c, kept from moving across the products; never
  // those of a product in flight.
  auto fence_chain = [&](int c) {
    wg::fence_acc(s[c]);
    wg::fence_acc(acc[c]);
    wg::fence_frags(pa[c]);
  };
  mbar_wait(ring.q_full(), 0);

  // Chain c's softmax of tile j: P_c into its A fragments (pair (nt, r) is
  // register (nt & 1) * 2 + r of k-step nt / 2), O_c rescaled.
  auto softmax_c = [&](int j, int c) {
    float alpha[2];
    softmax_step<kBase, kNT>(s[c], m[c], l[c], alpha, j * kBlockK, t, n,
                             scale, [&](int nt, int r, uint32_t p) {
                               pa[c][nt >> 1][(nt & 1) * 2 + r] = p;
                             });
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i >> 1) & 1];
  };
  // O_c += P_c V_j (V read MN-major), one commit group.
  auto issue_pv = [&](int j, int c) {
    const uint64_t vd = wg::make_desc(ring.v_tile(j));
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
      wg::wgmma_rs<1>(acc[c], pa[c][kk], vd + 128 * kk, 1);
    wg::wg_commit();
  };

  // Iteration j: P_B V_{j-1} and the release of stage j - 1 (kPV), S_j of
  // both chains, their softmax and P_A V_j (kS), compile-time so that no
  // wgmma or wait sits on a path ptxas must treat as divergent.
  auto tile = [&](int j, auto has_s, auto has_pv) {
    constexpr bool kS = decltype(has_s)::value, kPV = decltype(has_pv)::value;
    if constexpr (kS) ring.wait_full(j);
    if (kS && pp) bar_sync(3 + wgi, 256);  // this warpgroup's turn
    fence_chain(0);
    fence_chain(1);
    wg::wg_fence();
    if constexpr (kPV) issue_pv(j - 1, 1);
    if constexpr (kS) {
#pragma unroll
      for (int c = 0; c < kC; ++c)
        issue_s<kBlockK>(s[c], q_wg + c * kChainBytes, ring.k_tile(j));
      if (pp && (wgi == 0 || j + 1 < num_tiles)) bar_arrive(4 - wgi, 256);
      wg_wait_pending<1>();  // all but S_B(j)
    } else {
      wg::wg_wait();
    }
    fence_chain(0);
    wg::fence_acc(acc[1]);
    wg::fence_frags(pa[1]);
    if constexpr (kPV) ring.release(j - 1, lane);
    if constexpr (kS) {
      softmax_c(j, 0);
      fence_chain(0);
      wg::wg_fence();
      issue_pv(j, 0);
      wg_wait_pending<1>();  // S_B(j); P_A V_j runs on
      fence_chain(1);
      softmax_c(j, 1);
      wg::wg_wait();  // P_A V_j
      fence_chain(0);
    }
  };
  tile(0, kYes, kNo);
  for (int j = 1; j < num_tiles; ++j) tile(j, kYes, kYes);
  tile(num_tiles, kNo, kYes);

  bar_sync(1 + wgi, 128);  // every warp's last S product is done with Q
  bf16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int c = 0; c < kC; ++c)
    store_rows(acc[c], l[c], q_wg + c * kChainBytes, ob, so.n,
               wg_row0 + c * kWgRows, n, wwarp, lane);
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
  static constexpr int kConsumerRegs = 0;  // as launched
  static constexpr int kStages = kBlockK == 32 ? 6 : 3;
  using Ring = sweep::Ring<kStages, kBlockK>;
  // Q, then two P tiles a warpgroup (O^T is staged over them at the end),
  // then the ring, alpha (two rows) and l.
  static constexpr int kSmemBytes = 1024 + 3 * kRows * kRowBytes +
                                    Ring::kBytes + 3 * kRows * 4;
  static_assert(kD * (kQueries + 8) * 2 <= 2 * kChainBytes, "O^T over P");
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
  const typename Cfg::Ring ring(p_s + 2 * Cfg::kRows * kRowBytes);
  float* alpha_s =
      reinterpret_cast<float*>(ring.stages + Cfg::Ring::kBytes);
  float* l_s = alpha_s + 2 * Cfg::kRows;

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * Cfg::kRows;
  const int num_tiles = (n + kBlockK - 1) / kBlockK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0)
    ring.init(min(Cfg::kConsumers, (n - q0 + kQueries - 1) / kQueries));
  __syncthreads();

  if (warp == 4 * Cfg::kConsumers) {  // the producer warp
    if (lane == 0)
      ring.produce(q_s, Cfg::kRows, &q_map, &k_map, &v_map, q0, h, b,
                   num_tiles);
    return;
  }

  const int wgi = warp / 4, wwarp = warp % 4;
  const int g = lane >> 2, t = lane & 3;
  const int wg_q0 = q0 + wgi * kQueries;
  if (wg_q0 >= n) return;
  unsigned char* q_wg = q_s + wgi * kChainBytes;
  unsigned char* p_wg = p_s + 2 * wgi * kChainBytes;
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
  mbar_wait(ring.q_full(), 0);
  // Iteration j: S_j (kS) and O^T += V^T P^T of tile j - 1 (kPV), both
  // compile-time so that no wgmma or wait sits on a path ptxas must treat
  // as divergent.
  auto tile = [&](int j, auto has_s, auto has_pv) {
    constexpr bool kS = decltype(has_s)::value, kPV = decltype(has_pv)::value;
    if constexpr (kS) ring.wait_full(j);
    wg::fence_acc(s);
    wg::fence_acc(ot);
    wg::wg_fence();
    if constexpr (kS) issue_s<kBlockK>(s, q_wg, ring.k_tile(j));
    if constexpr (kPV) {
      // A = the V tile read MN-major (16 keys = 2048 bytes a k-step), B =
      // P tile (j - 1) & 1 read K-major (16 keys = 32 bytes).
      const uint64_t vd = wg::make_desc(ring.v_tile(j - 1));
      const uint64_t pd = wg::make_desc(p_wg + ((j - 1) & 1) * kChainBytes);
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
      float alpha[2];
      softmax_to_tile<kNT>(s, m, l, alpha, j * kBlockK, g, t, n, scale,
                           p_wg + (j & 1) * kChainBytes, row_lo);
      if (t == 0) {
        float* alpha_j = alpha_wg + (j & 1) * kQueries;
        alpha_j[row_lo] = alpha[0];
        alpha_j[row_lo + 8] = alpha[1];
      }
    }
    wg::wg_wait();  // the product of tile j - 1: O^T is free, stage j - 1 too
    wg::fence_acc(ot);
    if constexpr (kPV) ring.release(j - 1, lane);
    if constexpr (kS) {
      fence_async_shared();  // P reaches the products' proxy
      bar_sync(1 + wgi, 128);
      rescale_ot<kQueries>(ot, alpha_wg + (j & 1) * kQueries, t);
    }
  };
  tile(0, kYes, kNo);
  for (int j = 1; j < num_tiles; ++j) tile(j, kYes, kYes);
  tile(num_tiles, kNo, kYes);

  // Every product is done (the last wait): l by query through shared
  // memory, O^T / l staged over the P tiles.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    finish_l(l[r]);
    if (t == 0) l_wg[row_lo + 8 * r] = l[r];
  }
  bar_sync(1 + wgi, 128);
  store_ot<kQueries>(ot, l_wg, reinterpret_cast<bf16*>(p_wg),
                     o + b * so.b + h * so.h + wg_q0, so.n, wg_q0, n, wwarp,
                     lane, 1 + wgi);
}

// ============================================================== kernel 9
// Both levers: kernel 8's transposed O^T = V^T P^T with kernel 7's two
// chains a warpgroup. Each chain keeps its own S, untransposed (reductions
// in a lane quad), and its own m and l; their P go through kernel 8's
// swizzled P tiles, side by side, so that one m64n128 O^T product takes
// both chains' 128 queries as its N, and alpha goes through shared memory.
// Iteration j, kernel 8's order: issue S_A(j), S_B(j) and O^T += V^T P^T
// of tile j - 1 -> wait for S_A -> softmax A while S_B and that product
// run -> wait for S_B -> softmax B while the product runs -> wait for it,
// free stage j - 1 -> barrier, rescale O^T. Two m64n64 O^T products, one a
// chain issued after its softmax as in kernel 7, took 1.05-1.07x the time
// (one barrier a chain and tile instead of one a tile).
// Registers a thread: S (kBlockK / 2) a chain, O^T (64), m and l: 136 at
// 64-key tiles, which with the addressing spilled at the 168 of one block
// of two warpgroups (256 queries) and the producer an SM; as in kernel 7 a
// producer warpgroup gives its registers to the consumers (setmaxnreg: 24
// and 240). At 32-key tiles a block holds three consumer warpgroups (160
// registers after setmaxnreg; 0.91x the time of two at (192, 1025, 64)),
// at 64 they spilled.
template <int kBlockK>
struct DualPvtCfg {
  static constexpr int kChains = 2;
  static constexpr int kConsumers = kBlockK == 32 ? 3 : 2;  // one block an SM
  static constexpr int kWgQ = kChains * kWgRows;   // queries a warpgroup
  static constexpr int kRows = kConsumers * kWgQ;  // queries a block
  static constexpr int kThreads = kConsumers * 128 + 128;  // + producer
  static constexpr int kConsumerRegs = consumer_regs(kThreads / 32, kConsumers);
  static constexpr int kStages = kBlockK == 32 ? 6 : 3;
  using Ring = sweep::Ring<kStages, kBlockK>;
  // Q, then [warpgroup][tile & 1][chain] P tiles (O^T staged over a
  // warpgroup's at the end), the ring, alpha ([tile & 1][query] a
  // warpgroup) and l.
  static constexpr int kQBytes = kRows * kRowBytes;
  static constexpr int kPBytes = 2 * kRows * kRowBytes;
  static constexpr int kSmemBytes =
      1024 + kQBytes + kPBytes + Ring::kBytes + 3 * kRows * 4;
  static_assert(kD * (kWgQ + 8) * 2 <= 2 * kChains * kChainBytes,
                "O^T over P");
};

template <int kBlockK>
__global__ void __launch_bounds__(DualPvtCfg<kBlockK>::kThreads, 1)
dualq_pvt_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 bf16* __restrict__ o, Strides so, int heads, int n,
                 float scale) {
  using Cfg = DualPvtCfg<kBlockK>;
  constexpr int kC = Cfg::kChains, kWgQ = Cfg::kWgQ;
  constexpr int kNT = kBlockK / 8;
  constexpr int kKSteps = kBlockK / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = wg::align1024(smem_raw);
  unsigned char* p_s = q_s + Cfg::kQBytes;
  const typename Cfg::Ring ring(p_s + Cfg::kPBytes);
  float* alpha_s =
      reinterpret_cast<float*>(ring.stages + Cfg::Ring::kBytes);
  float* l_s = alpha_s + 2 * Cfg::kRows;

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * Cfg::kRows;
  const int num_tiles = (n + kBlockK - 1) / kBlockK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0)
    ring.init(min(Cfg::kConsumers, (n - q0 + kWgQ - 1) / kWgQ));
  __syncthreads();

  if (warp >= 4 * Cfg::kConsumers) {  // the producer warpgroup
    reg_dealloc<kProducerRegs>();
    if (warp == 4 * Cfg::kConsumers && lane == 0)
      ring.produce(q_s, Cfg::kRows, &q_map, &k_map, &v_map, q0, h, b,
                   num_tiles);
    return;
  }
  reg_alloc<Cfg::kConsumerRegs>();

  const int wgi = warp / 4, wwarp = warp % 4;
  const int g = lane >> 2, t = lane & 3;
  const int wg_q0 = q0 + wgi * kWgQ;
  if (wg_q0 >= n) return;
  unsigned char* q_wg = q_s + wgi * kC * kChainBytes;
  unsigned char* p_wg = p_s + wgi * 2 * kC * kChainBytes;
  float* alpha_wg = alpha_s + 2 * wgi * kWgQ;
  float* l_wg = l_s + wgi * kWgQ;
  const int row_lo = wwarp * 16 + g;  // S rows of a chain, row_lo & 7 == g
  // Chain c's P tile of tile j (both chains' side by side: the product's
  // B), and its row of alpha.
  auto p_tile = [&](int j, int c) {
    return p_wg + ((j & 1) * kC + c) * kChainBytes;
  };
  auto alpha_row = [&](int j, int c) {
    return alpha_wg + (j & 1) * kWgQ + c * kWgRows;
  };

  // O^T: ot[4 jj + e] is feature wwarp * 16 + g + 8 (e >> 1), query
  // wg_q0 + 8 jj + 2 t + (e & 1): chain jj / 8.
  float ot[kWgQ / 2], s[kC][kBlockK / 2], m[kC][2], l[kC][2];
#pragma unroll
  for (int i = 0; i < kWgQ / 2; ++i) ot[i] = 0.0f;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    m[c][0] = m[c][1] = kNegInf;
    l[c][0] = l[c][1] = 0.0f;
  }
  mbar_wait(ring.q_full(), 0);

  // Chain c's softmax of tile j: P into its P tile, alpha into its row.
  auto softmax_c = [&](int j, int c) {
    float alpha[2];
    softmax_to_tile<kNT>(s[c], m[c], l[c], alpha, j * kBlockK, g, t, n,
                         scale, p_tile(j, c), row_lo);
    if (t == 0) {
      alpha_row(j, c)[row_lo] = alpha[0];
      alpha_row(j, c)[row_lo + 8] = alpha[1];
    }
  };
  // Iteration j: S_j of both chains and their softmax (kS) and O^T +=
  // V^T P^T of tile j - 1 (kPV), compile-time so that no wgmma or wait
  // sits on a path ptxas must treat as divergent.
  auto tile = [&](int j, auto has_s, auto has_pv) {
    constexpr bool kS = decltype(has_s)::value, kPV = decltype(has_pv)::value;
    if constexpr (kS) ring.wait_full(j);
    wg::fence_acc(s[0]);
    wg::fence_acc(s[1]);
    wg::fence_acc(ot);
    wg::wg_fence();
    if constexpr (kS) {
#pragma unroll
      for (int c = 0; c < kC; ++c)
        issue_s<kBlockK>(s[c], q_wg + c * kChainBytes, ring.k_tile(j));
    }
    if constexpr (kPV) {
      // A = the V tile read MN-major, B = both chains' P tiles of tile
      // j - 1 read K-major.
      const uint64_t vd = wg::make_desc(ring.v_tile(j - 1));
      const uint64_t pd = wg::make_desc(p_tile(j - 1, 0));
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        wg::wgmma_ss_n<kWgQ, 1>(ot, vd + 128 * kk, pd + 2 * kk, 1);
      wg::wg_commit();
    }
    if constexpr (kS) {
      // P into P tiles j & 1, alpha into rows j & 1, which the product and
      // the rescale of tile j - 2 last read, both before the barrier of
      // tile j - 1.
      wg_wait_pending<kPV ? 2 : 1>();  // S_A(j)
      wg::fence_acc(s[0]);
      softmax_c(j, 0);
      wg_wait_pending<kPV ? 1 : 0>();  // S_B(j)
      wg::fence_acc(s[1]);
      softmax_c(j, 1);
    }
    wg::wg_wait();  // the product of tile j - 1: O^T is free, stage j - 1 too
    wg::fence_acc(ot);
    if constexpr (kPV) ring.release(j - 1, lane);
    if constexpr (kS) {
      fence_async_shared();  // P reaches the products' proxy
      bar_sync(1 + wgi, 128);
      rescale_ot<kWgQ>(ot, alpha_row(j, 0), t);
    }
  };
  tile(0, kYes, kNo);
  for (int j = 1; j < num_tiles; ++j) tile(j, kYes, kYes);
  tile(num_tiles, kNo, kYes);

#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      finish_l(l[c][r]);
      if (t == 0) l_wg[c * kWgRows + row_lo + 8 * r] = l[c][r];
    }
  bar_sync(1 + wgi, 128);
  store_ot<kWgQ>(ot, l_wg, reinterpret_cast<bf16*>(p_wg),
                 o + b * so.b + h * so.h + wg_q0, so.n, wg_q0, n, wwarp,
                 lane, 1 + wgi);
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

// The kernel's opt-in to Cfg's dynamic shared memory. Where it moves
// registers by setmaxnreg (Cfg::kConsumerRegs), the consumers may take only
// what the producer warpgroup gives at the register count the kernel was
// built with; a build that misses that would hang, so it is refused.
template <typename Cfg, typename Kernel>
cudaError_t opt_in(Kernel kernel) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmemBytes);
  if (err != cudaSuccess || Cfg::kConsumerRegs == 0) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const int given = 128 * (attr.numRegs - kProducerRegs);
  const int taken = Cfg::kConsumers * 128 * (Cfg::kConsumerRegs - attr.numRegs);
  return given >= taken ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// Build the three maps and launch kernel<<<(ceil(N / rows), B*H),
// threads>>>; opted_in is the result of the instantiation's opt_in, taken
// once.
template <typename Cfg, int kBlockK, typename Kernel>
int launch(Kernel kernel, cudaError_t opted_in, const void* q, const void* k,
           const void* v, void* o, Strides sq, Strides sk, Strides sv,
           Strides so, int batch, int heads, int n, float scale,
           cudaStream_t stream) {
  if (batch <= 0 || heads <= 0 || n <= 0 || batch * heads > 65535)
    return cudaErrorInvalidValue;
  if (opted_in != cudaSuccess) return opted_in;
  CUtensorMap q_map, k_map, v_map;
  int err = make_map(&q_map, q, sq, batch, heads, n, q_box(Cfg::kRows));
  if (!err) err = make_map(&k_map, k, sk, batch, heads, n, kBlockK);
  if (!err) err = make_map(&v_map, v, sv, batch, heads, n, kBlockK);
  if (err) return err;
  const dim3 grid((n + Cfg::kRows - 1) / Cfg::kRows, batch * heads);
  kernel<<<grid, Cfg::kThreads, Cfg::kSmemBytes, stream>>>(
      q_map, k_map, v_map, static_cast<bf16*>(o), so, heads, n, scale);
  return cudaGetLastError();
}

// What the runtime makes of an instantiation: out = {registers a thread,
// blocks an SM, threads a block, dynamic shared memory, local (spilled)
// bytes a thread}.
template <typename Cfg, typename Kernel>
int kernel_info(Kernel kernel, int* out) {
  cudaFuncAttributes attr;
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmemBytes);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, Cfg::kThreads, Cfg::kSmemBytes);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = blocks;
  out[2] = Cfg::kThreads;
  out[3] = Cfg::kSmemBytes;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// Every kernel of the sweeps as launch / info pairs over the arguments of
// the C interface; each launch opts in once.
#define VT_SWEEP_ARGS                                                      \
  const void *q, const void *k, const void *v, void *o, Strides sq,       \
      Strides sk, Strides sv, Strides so, int batch, int heads, int n,    \
      float scale, cudaStream_t stream
#define VT_SWEEP_PASS q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, stream

template <int kMode, int kBlockK>
int launch_variant(VT_SWEEP_ARGS) {
  using Cfg = RowsCfg<kBlockK>;
  const auto kernel = variant_rows_kernel<kMode, kBlockK>;
  static const cudaError_t opted_in = opt_in<Cfg>(kernel);
  return launch<Cfg, kBlockK>(kernel, opted_in, VT_SWEEP_PASS);
}
template <int kMode, int kBlockK>
int variant_info(int* out) {
  return kernel_info<RowsCfg<kBlockK>>(variant_rows_kernel<kMode, kBlockK>,
                                       out);
}

template <int kBlockK, bool kPingPong>
int launch_chains(VT_SWEEP_ARGS) {
  using Cfg = ChainsCfg<kBlockK>;
  const auto kernel = chains_kernel<kBlockK, kPingPong>;
  static const cudaError_t opted_in = opt_in<Cfg>(kernel);
  return launch<Cfg, kBlockK>(kernel, opted_in, VT_SWEEP_PASS);
}
template <int kBlockK, bool kPingPong>
int chains_info(int* out) {
  return kernel_info<ChainsCfg<kBlockK>>(chains_kernel<kBlockK, kPingPong>,
                                         out);
}

template <int kBlockK>
int launch_pvt(VT_SWEEP_ARGS) {
  using Cfg = PvtCfg<kBlockK>;
  const auto kernel = pvt_kernel<kBlockK>;
  static const cudaError_t opted_in = opt_in<Cfg>(kernel);
  return launch<Cfg, kBlockK>(kernel, opted_in, VT_SWEEP_PASS);
}
template <int kBlockK>
int pvt_info(int* out) {
  return kernel_info<PvtCfg<kBlockK>>(pvt_kernel<kBlockK>, out);
}

template <int kBlockK>
int launch_dualq_pvt(VT_SWEEP_ARGS) {
  using Cfg = DualPvtCfg<kBlockK>;
  const auto kernel = dualq_pvt_kernel<kBlockK>;
  static const cudaError_t opted_in = opt_in<Cfg>(kernel);
  return launch<Cfg, kBlockK>(kernel, opted_in, VT_SWEEP_PASS);
}
template <int kBlockK>
int dualq_pvt_info(int* out) {
  return kernel_info<DualPvtCfg<kBlockK>>(dualq_pvt_kernel<kBlockK>, out);
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
