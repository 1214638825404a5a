// Flash-attention forward for Hopper (sm_90a), inference and training.
//
// Replaces visiontransformer_tpu/ops/flash_attention.py:_fwd_kernel:
// out = softmax(Q K^T * d^-1/2) V over (B, H, N, d), computed online over
// key tiles so the N x N score matrix never reaches device memory.
// Inference also takes a key count Nk of its own (Q and O (B, H, N, d), K
// and V (B, H, Nk, d)): MiT's spatial-reduction attention, whose keys are
// the tokens reduced r x r (SegFormer-B5 at 1024^2: N = 65,536 ... 1,024
// queries against Nk = 1,024 keys). Rows, their blocks and the grid follow
// N; the key loop, the staging of K and V and the last tile's mask follow
// Nk. The training variant and kernels 2-4 keep Nk = N.
// Inference also adds SAM's decomposed relative-position bias where asked
// (vt_flash_attention_fwd_bias: fwd_stream_bias_kernel at d = 80,
// fwd_wgmma_bias_kernel at d = 64): with Nk = kh * kw keys on a kh x kw grid,
// key k of query row i adds rel_h[i, k / kw] + rel_w[i, k % kw], read as bf16
// from (B*H, N, kh) and (B*H, N, kw) in the softmax step, which adds them to
// the scaled logits in the log2 domain before the running max (RowBias,
// online_softmax); the N x Nk bias is never formed. The kernels without a
// bias take the step with NoBias and compile to the code they did before.
// SAM-H at 1024^2, batch 8: 28 windowed calls at (B*H, N) = (3200, 196) and 4
// global ones at (128, 4096), d = 80.
// Inference (kTrain = false) is need_lse=False without dropout. Training
// (kTrain = true, vt_flash_attention_fwd_train) also writes
// lse = m + log(l) (natural log, fp32, (B*H, N)) and applies attention
// dropout inside the kernel: the normalized probabilities are multiplied
// by mask / keep before P V while the softmax denominator sums the
// undropped p (as _fwd_kernel :131-143 does). The mask comes from
// Philox4x32-10 keyed by (seed, b*H + h), one call per 2 x 2 block of
// (query row, key column) (flash_attention_common.cuh), so the backward
// kernels regenerate it with their own tiling. In bf16, P * mask / keep is
// rounded to bf16 before P V, where the TPU kernel rounds it.
//
// What bounds it on an H100. The function reads Q, K, V and writes O
// (4 * B*H*N*d * 2 bytes in bf16) and does 4 * B*H*N^2*d operations in two
// products, besides B*H*N^2 exponentials. At the serving shape (B*H = 384,
// N = 197, d = 64) that is 38.7 MB against 3.8 GFLOP: 11.6 us of bytes
// against 3.9 us of tensor-core work, so bytes bound it, and what a block
// waits on is its serial chain (Q and the first K/V tile in, four key
// tiles, O out): many blocks an SM and every load issued early help. At
// (192, 1025, 64) it is 101 MB against 51.6 GFLOP: 52 us of tensor-core
// work against 30 us of bytes, and the 202 M exponentials take about as
// long again on the special-function units (16 a clock per SM), so
// operations bound it and one warpgroup's softmax has to run while the
// tensor cores serve another's products. MiT's stage 1 at 1024^2, batch 8
// (B*H = 8, N = 65,536, Nk = 1,024) is 137 GFLOP against 136 MB: operations
// bound it at 0.139 ms, and its 537 M exponentials take as long again. The
// training variant adds 4 * B*H*N bytes of lse and one Philox
// call (about 100 integer instructions) per lane and four probabilities,
// which at N = 3137 costs about as much as the rest of the kernel.
//
// Design. One block per (batch*head, query tile) streams its head's K and V
// through shared memory in 64-key tiles; the running max m, sum l and the
// output accumulator stay in fp32 registers; keys past Nk score -1e30, not
// -inf, so exp(m_old - m_new) never meets inf - inf; rows past N compute
// but are never stored. The softmax runs in the exp2 domain (log2 e folded
// into the scale) on ex2.approx.
//   bf16, d = 64 (every ViT configuration of the repository),
//   fwd_wgmma_kernel: warpgroups of 64 query rows on warpgroup products
//   (wgmma). Q is staged once into a 128-byte swizzled tile and read
//   through a descriptor. K and V arrive as swizzled 64-key tiles in a
//   cp.async ring of four, shared by the block's warpgroups, one
//   __syncthreads() per tile. S = Q K^T is four m64n64k16 products of two
//   descriptors; P is packed from the S accumulators into A fragments, and
//   O += P V is four register-A products against the V tile read MN-major
//   through the descriptor's transpose bit (no transposed copy). Iteration
//   j issues S of tile j and P V of tile j - 1 as one group. O leaves
//   through the warpgroup's freed Q tile as 16-byte stores. A block holds
//   one warpgroup or two (two share each K/V tile), chosen at launch by
//   how well each fills the card's block slots, and the register cap lets
//   an SM hold as many blocks as its shared memory does. Running the
//   softmax while P V is still in flight (the softmax-MMA overlap of
//   FlashAttention-3) was timed and won nowhere: the warp schedulers
//   already interleave the softmax of one warpgroup with the products of
//   the others on the SM, and the overlap held 36 more registers.
//   bf16, other head dims (16, 32, 80, 128), fwd_stream_kernel, on mma.sync
//   m16n8k16: four warps a block, each owning kChains slabs of 16 query
//   rows whose Q fragments stay in registers (two chains for d <= 32, so a
//   K or V fragment read from shared memory feeds two products); K and V
//   arrive as row-major 64-key tiles by cp.async in a ring of three, one
//   __syncthreads() per tile; K fragments come by ldmatrix.x4 and V's by
//   ldmatrix.x4.trans from the same tile, whose row padding keeps both free
//   of bank conflicts; O leaves through shared memory as 16-byte stores.
//   In both, P (times mask / keep) is rounded to bf16 before its product,
//   where the TPU kernel rounds it to the input dtype.
//   fp32 (kept so parity can be checked on the card at fp32 tolerance) runs
//   scalar FMAs on 64-row blocks: four threads share a query row, each
//   holding every fourth element of q and of the accumulator.
// Q, K and V may be strided views (the model passes slices of the fused QKV
// projection without a copy); only the last dimension must be contiguous,
// and for bf16 rows must be 16-byte aligned (the wrapper raises otherwise).

#include <type_traits>

#include "flash_attention_common.cuh"
#include "flash_attention_wgmma.cuh"

using namespace vt_flash;

namespace {

// fp32 path.
constexpr int kBlockQ = 64;                 // query rows per block
constexpr int kQuad = 4;                    // threads per query row
constexpr int kBlockK = 32;                 // keys per shared-memory tile
constexpr int kThreads = kBlockQ * kQuad;   // 256

// What the training variant needs besides the inference arguments.
struct TrainArgs {
  float* lse;                // (B*H, N) fp32, natural log
  const long long* seed;     // device scalar; its low 32 bits key Philox
  uint32_t keep_threshold;   // ceil(keep * 2^24); 2^24 means no dropout
  float inv_keep;            // 1 / keep
};

// ---------------------------------------------------------------- fp32 path
template <int D, bool kTrain>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     Strides sq, Strides sk, Strides sv, Strides so, int heads,
                     int n, int nk, float scale, TrainArgs train) {
  static_assert(D % kQuad == 0, "head dim must split over a quad");
  constexpr int kPer = D / kQuad;
  __shared__ float k_s[kBlockK][D];
  __shared__ float v_s[kBlockK][D];

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int part = threadIdx.x % kQuad;
  const int row = blockIdx.x * kBlockQ + threadIdx.x / kQuad;
  const bool row_valid = row < n;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  float qr[kPer];
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    qr[i] = row_valid ? qb[row * sq.n + part + kQuad * i] : 0.0f;
    acc[i] = 0.0f;
  }
  float m = kNegInf;
  float l = 0.0f;

  const int num_tiles = (nk + kBlockK - 1) / kBlockK;
  for (int t = 0; t < num_tiles; ++t) {
    const int key0 = t * kBlockK;
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = threadIdx.x; idx < kBlockK * D; idx += kThreads) {
      const int j = idx / D;
      const int c = idx % D;
      const int key = key0 + j;
      float kv = 0.0f, vv = 0.0f;
      if (key < nk) {
        kv = kb[key * sk.n + c];
        vv = vb[key * sv.n + c];
      }
      k_s[j][c] = kv;
      v_s[j][c] = vv;
    }
    __syncthreads();

    float s[kBlockK];
    float m_tile = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) dot = fmaf(qr[i], k_s[j][part + kQuad * i], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      s[j] = (key0 + j < nk) ? dot * scale : kNegInf;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    float l_tile = 0.0f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      s[j] = expf(s[j] - m_new);
      l_tile += s[j];
    }
    l = l * alpha + l_tile;
    if constexpr (kTrain) {
      // The denominator above summed the undropped p; only P V drops.
      if (train.keep_threshold < (1u << 24)) {
        const uint32_t seed = static_cast<uint32_t>(*train.seed);
#pragma unroll
        for (int j = 0; j < kBlockK; ++j)
          s[j] = dropout_keep(seed, blockIdx.y, row, key0 + j,
                              train.keep_threshold)
                     ? s[j] * train.inv_keep : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] = fmaf(s[j], v_s[j][part + kQuad * i], acc[i]);
    }
    m = m_new;
  }

  if (row_valid) {
    float* ob = o + b * so.b + h * so.h + row * so.n;
    const float inv = 1.0f / fmaxf(l, 1.0e-30f);
#pragma unroll
    for (int i = 0; i < kPer; ++i) ob[part + kQuad * i] = acc[i] * inv;
    if constexpr (kTrain) {
      if (part == 0)
        train.lse[static_cast<long long>(blockIdx.y) * n + row] =
            m + logf(fmaxf(l, 1.0e-30f));
    }
  }
}

// ------------------------------------------------ bf16 tensor-core pieces
// The dropout state of one thread of a training launch.
struct Dropout {
  bool on;
  uint32_t seed, bh, threshold;
  float inv_keep;
  __device__ __forceinline__ Dropout(const TrainArgs& a, uint32_t bh_)
      : on(a.keep_threshold < (1u << 24)),
        seed(on ? static_cast<uint32_t>(*a.seed) : 0u), bh(bh_),
        threshold(a.keep_threshold), inv_keep(a.inv_keep) {}
};

// SAM's decomposed relative-position bias (the inference kernel's bias
// instantiations, vt_flash_attention_fwd_bias): with Nk = kh * kw keys on a
// kh x kw grid, key k of query row q adds rel_h[q, k / kw] + rel_w[q, k % kw]
// to its scaled logit. rel_h (B*H, N, kh) and rel_w (B*H, N, kw) are
// contiguous bf16; kw is even, so Nk is even and a lane's key pair (c, c + 1)
// (c even) never straddles a grid row: one bf16 of rel_h and one bf16 pair of
// rel_w a row and pair.
struct BiasArgs {
  const bf16* rel_h;
  const bf16* rel_w;
  int kh, kw;
  float inv_kw;  // 1 / kw: (c + 0.5) * inv_kw truncates to c / kw exactly
                 // while (kh + 1) * kw < 2^22 (the wrapper holds Nk <= 2^20)
};

// The instantiations without a bias.
struct NoBias {};

// The bias of the two query rows a lane holds (row_lo and row_lo + 8, rows
// past n reading row n - 1, whose logits are never stored).
struct RowBias {
  const bf16* h;
  const bf16* w;
  int kh, kw;
  float inv_kw;
  int r0, r1;  // rows of (B*H, N); the wrapper holds B*H*N*kh, *kw < 2^31
  __device__ __forceinline__ RowBias(const BiasArgs& a, int bh, int row_lo,
                                     int n)
      : h(a.rel_h), w(a.rel_w), kh(a.kh), kw(a.kw), inv_kw(a.inv_kw),
        r0(bh * n + min(row_lo, n - 1)), r1(bh * n + min(row_lo + 8, n - 1)) {}
  // The biases of keys c and c + 1 (c even, c < Nk) of both rows, in the
  // log2 domain: b[2 * row + j] for key c + j.
  __device__ __forceinline__ void load(int c, float (&b)[4]) const {
    const int kr = __float2int_rz((static_cast<float>(c) + 0.5f) * inv_kw);
    const int kc = c - kr * kw;
    const float h0 = __bfloat162float(__ldg(h + r0 * kh + kr));
    const float h1 = __bfloat162float(__ldg(h + r1 * kh + kr));
    const float2 w0 = __bfloat1622float2(__ldg(
        reinterpret_cast<const __nv_bfloat162*>(w + r0 * kw + kc)));
    const float2 w1 = __bfloat1622float2(__ldg(
        reinterpret_cast<const __nv_bfloat162*>(w + r1 * kw + kc)));
    b[0] = (h0 + w0.x) * kLog2e;
    b[1] = (h0 + w0.y) * kLog2e;
    b[2] = (h1 + w1.x) * kLog2e;
    b[3] = (h1 + w1.y) * kLog2e;
  }
};

__device__ __forceinline__ NoBias row_bias(const NoBias&, int, int, int) {
  return {};
}
__device__ __forceinline__ RowBias row_bias(const BiasArgs& a, int bh,
                                            int row_lo, int n) {
  return RowBias(a, bh, row_lo, n);
}

// One step of the online softmax over a tile of 8 * kNT keys starting at
// key0, for the two rows a lane holds: s is in the mma.sync C layout
// (s[4 * nt + e]: row e >> 1, key key0 + 8 nt + 2 t + (e & 1)), raw Q K^T.
// Keys >= nk are masked; m (log2 domain) and l (this lane's part of the sum
// of the undropped p) are updated; s becomes p = exp2(s * scale_log2e - m);
// alpha is the factor the accumulator's rows take. With a RowBias, each
// logit takes its bias in the log2 domain before the running max: s becomes
// p = exp2(s * scale_log2e + bias * log2 e - m). NoBias compiles to the
// step without it.
template <int kNT, class Bias = NoBias>
__device__ __forceinline__ void online_softmax(float (&s)[4 * kNT],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int key0,
                                               int t, int nk,
                                               float scale_log2e,
                                               const Bias& bias = Bias{}) {
  constexpr bool kBias = std::is_same<Bias, RowBias>::value;
  const bool tail = key0 + 8 * kNT > nk;  // some keys of the tile are past Nk
  float mx[2] = {kNegInf, kNegInf};
  if constexpr (kBias) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      // Nk is even: key c + 1 is past it exactly when c is.
      const int c = key0 + 8 * nt + 2 * t;
      float b[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (c < nk) bias.load(c, b);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * nt + e;
        s[i] = (tail && c >= nk) ? kNegInf : fmaf(s[i], scale_log2e, b[e]);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[i]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) {
      if (tail && key0 + (i >> 2) * 8 + 2 * t + (i & 1) >= nk) s[i] = kNegInf;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // The scale is positive, so the max commutes with it; the biased logits
    // are in the log2 domain already.
    const float m_new = fmaxf(m[r], kBias ? mx[r] : mx[r] * scale_log2e);
    alpha[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 4 * kNT; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = fast_exp2(kBias ? s[i] - m[r] : fmaf(s[i], scale_log2e, -m[r]));
    l[r] += s[i];
  }
}

// p * mask / keep for the fragment of online_softmax; rows r_lo, r_lo + 8.
template <int kNT>
__device__ __forceinline__ void apply_dropout(float (&s)[4 * kNT],
                                              const Dropout& drop, int r_lo,
                                              int key0, int t, int lane) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const uint32_t keep = dropout_keep_frag<false>(
        drop.seed, drop.bh, r_lo, key0 + nt * 8 + 2 * t, drop.threshold, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[4 * nt + e] = (keep >> e) & 1u ? s[4 * nt + e] * drop.inv_keep : 0.0f;
  }
}

// Sum of l over the quad that shares a row, and its reciprocal.
__device__ __forceinline__ void finish_rows(float (&l)[2], float (&inv)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1.0e-30f);
    inv[r] = 1.0f / l[r];
  }
}

// -------------------------------------------- bf16, other head dims, mma.sync
constexpr int kStreamWarps = 4;
constexpr int kStreamThreads = 32 * kStreamWarps;  // 128
constexpr int kKeyTile = 64;                       // keys per shared tile
constexpr int kRing = 3;                           // tiles in the ring

// The kernel's body; Bias is NoBias (fwd_stream_kernel) or BiasArgs
// (fwd_stream_bias_kernel, one chain).
template <int D, int kChains, bool kTrain, class Bias>
__device__ __forceinline__ void fwd_stream_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, Strides sq, Strides sk,
    Strides sv, Strides so, int heads, int n, int nk, float scale,
    const TrainArgs& train, const Bias& bias) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static_assert(std::is_same<Bias, NoBias>::value || (kChains == 1 && !kTrain),
                "the bias instantiation is inference with one chain");
  constexpr int kSteps = D / 16;           // k-steps of Q K^T
  constexpr int kOutTiles = D / 8;         // n-tiles of O
  constexpr int kKeyTiles = kKeyTile / 8;  // n-tiles of S
  constexpr int kStride = D + kPad;        // bf16 per shared-memory row
  constexpr int kTileElems = kKeyTile * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);  // per tile: K, then V

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // Slabs are dealt to the warps of a head's blocks round-robin, so a
  // ragged last block idles at most one warp-slab less than the others.
  const int row0 = (warp * gridDim.x + blockIdx.x) * 16 * kChains;
  const bool warp_active = row0 < n;
  const float scale_log2e = scale * kLog2e;

  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const int num_tiles = (nk + kKeyTile - 1) / kKeyTile;
  auto stage = [&](int tile, int slot) {
    bf16* ks = smem + 2 * slot * kTileElems;
    stage_rows<D>(ks, kb, sk.n, tile * kKeyTile, kKeyTile, nk, threadIdx.x,
                  kStreamThreads);
    stage_rows<D>(ks + kTileElems, vb, sv.n, tile * kKeyTile, kKeyTile, nk,
                  threadIdx.x, kStreamThreads);
  };
#pragma unroll
  for (int tile = 0; tile < kRing - 1; ++tile) {
    if (tile < num_tiles) stage(tile, tile);
    cp_async_commit();  // an empty group keeps the count
  }

  // Q fragments of this warp's rows, loaded while the first tiles land.
  uint32_t qa[kChains][kSteps][4];
#pragma unroll
  for (int c = 0; c < kChains; ++c)
#pragma unroll
    for (int st = 0; st < kSteps; ++st)
      load_a_frag(qa[c][st], q + b * sq.b + h * sq.h, sq.n, row0 + c * 16 + g,
                  n, st * 16, t);

  float acc[kChains][kOutTiles][4];
  float m[kChains][2], l[kChains][2];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    m[c][0] = m[c][1] = kNegInf;
    l[c][0] = l[c][1] = 0.0f;
#pragma unroll
    for (int ot = 0; ot < kOutTiles; ++ot)
      acc[c][ot][0] = acc[c][ot][1] = acc[c][ot][2] = acc[c][ot][3] = 0.0f;
  }

  // The dropout state (dead code in the inference instantiation).
  const Dropout drop(train, bh);
  const auto rb = row_bias(bias, bh, row0 + g, n);  // chain 0's rows
  for (int tile = 0; tile < num_tiles; ++tile) {
    cp_async_wait<kRing - 2>();  // this thread's copies of `tile` landed
    __syncthreads();             // everyone's did; tile - 1 is consumed
    const int next = tile + kRing - 1;
    if (next < num_tiles) stage(next, next % kRing);
    cp_async_commit();
    if (!warp_active) continue;  // the warp only helps stage
    const bf16* ks = smem + 2 * (tile % kRing) * kTileElems;
    const bf16* vs = ks + kTileElems;
    const int key0 = tile * kKeyTile;

    // S = Q K^T; each K fragment feeds every chain.
    float s[kChains][4 * kKeyTiles];
#pragma unroll
    for (int c = 0; c < kChains; ++c)
#pragma unroll
      for (int i = 0; i < 4 * kKeyTiles; ++i) s[c][i] = 0.0f;
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; nt += 2) {
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        uint32_t kf[4];
        ldmatrix_x4(kf, b_frag_addr(ks, kStride, nt, st, lane));
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          float(&s0)[4] = *reinterpret_cast<float(*)[4]>(&s[c][4 * nt]);
          float(&s1)[4] = *reinterpret_cast<float(*)[4]>(&s[c][4 * nt + 4]);
          mma16816(s0, qa[c][st], kf[0], kf[1]);
          mma16816(s1, qa[c][st], kf[2], kf[3]);
        }
      }
    }

#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      float alpha[2];
      online_softmax<kKeyTiles>(s[c], m[c], l[c], alpha, key0, t, nk,
                                scale_log2e, rb);
      if constexpr (kTrain) {
        if (drop.on)
          apply_dropout<kKeyTiles>(s[c], drop, row0 + c * 16 + g, key0, t,
                                   lane);
      }
#pragma unroll
      for (int ot = 0; ot < kOutTiles; ++ot) {
        acc[c][ot][0] *= alpha[0];
        acc[c][ot][1] *= alpha[0];
        acc[c][ot][2] *= alpha[1];
        acc[c][ot][3] *= alpha[1];
      }
    }

    // O += P V, V through ldmatrix.trans from the same row-major tile.
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk) {
      uint32_t pa[kChains][4];
#pragma unroll
      for (int c = 0; c < kChains; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pa[c][i] = pack2f(s[c][8 * kk + 2 * i], s[c][8 * kk + 2 * i + 1]);
#pragma unroll
      for (int ot = 0; ot < kOutTiles; ot += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, bt_frag_addr(vs, kStride, kk * 16, ot, lane));
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          mma16816(acc[c][ot], pa[c], vf[0], vf[1]);
          mma16816(acc[c][ot + 1], pa[c], vf[2], vf[3]);
        }
      }
    }
  }

  // O through this warp's part of the freed ring, out as 16-byte stores.
  __syncthreads();
  if (!warp_active) return;
  bf16* o_s = smem + warp * kChains * 16 * kStride;
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    float inv[2];
    finish_rows(l[c], inv);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row_in = c * 16 + g + 8 * r;
#pragma unroll
      for (int ot = 0; ot < kOutTiles; ++ot)
        *reinterpret_cast<uint32_t*>(o_s + row_in * kStride + ot * 8 + 2 * t) =
            pack2f(acc[c][ot][2 * r] * inv[r], acc[c][ot][2 * r + 1] * inv[r]);
      if constexpr (kTrain) {
        // lse in natural-log units: m lives in the log2 domain.
        const int row = row0 + row_in;
        if (t == 0 && row < n)
          train.lse[static_cast<long long>(bh) * n + row] =
              m[c][r] * kLn2 + logf(l[c][r]);
      }
    }
  }
  __syncwarp();
  bf16* ob = o + b * so.b + h * so.h;
  constexpr int kRowVecs = D / kVec;
#pragma unroll
  for (int idx = lane; idx < kChains * 16 * kRowVecs; idx += 32) {
    const int r = idx / kRowVecs, c8 = (idx % kRowVecs) * kVec;
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(ob + (row0 + r) * so.n + c8) =
          *reinterpret_cast<const uint4*>(o_s + r * kStride + c8);
  }
}

template <int D, int kChains, bool kTrain>
__global__ void __launch_bounds__(kStreamThreads)
fwd_stream_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  Strides sq, Strides sk, Strides sv, Strides so, int heads,
                  int n, int nk, float scale, TrainArgs train) {
  fwd_stream_body<D, kChains, kTrain>(q, k, v, o, sq, sk, sv, so, heads, n,
                                      nk, scale, train, NoBias{});
}

// Inference with SAM's decomposed bias (BiasArgs), at d = 80.
template <int D>
__global__ void __launch_bounds__(kStreamThreads)
fwd_stream_bias_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       int heads, int n, int nk, float scale, BiasArgs bias) {
  fwd_stream_body<D, 1, false>(q, k, v, o, sq, sk, sv, so, heads, n, nk, scale,
                               TrainArgs{nullptr, nullptr, 1u << 24, 1.0f},
                               bias);
}

// Bias: NoBias launches fwd_stream_kernel, BiasArgs fwd_stream_bias_kernel.
template <int D, bool kTrain, class Bias = NoBias>
cudaError_t launch_stream(const void* q, const void* k, const void* v,
                          void* o, Strides sq, Strides sk, Strides sv,
                          Strides so, int bh, int heads, int n, int nk,
                          float scale, TrainArgs train, cudaStream_t stream,
                          const Bias& bias = Bias{}) {
  constexpr bool kBias = std::is_same<Bias, BiasArgs>::value;
  constexpr int kChains = D <= 32 && !kBias ? 2 : 1;
  // The ring: K and V of kRing tiles. Above 48 KB a kernel must opt in,
  // once per instantiation.
  constexpr int kBytes =
      kRing * 2 * kKeyTile * (D + kPad) * static_cast<int>(sizeof(bf16));
  const int slabs = (n + 16 * kChains - 1) / (16 * kChains);
  const dim3 grid((slabs + kStreamWarps - 1) / kStreamWarps, bh);
  if constexpr (kBias) {
    auto kernel = fwd_stream_bias_kernel<D>;
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (opt_in != cudaSuccess) return opt_in;
    kernel<<<grid, kStreamThreads, kBytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), sq, sk, sv, so,
        heads, n, nk, scale, bias);
  } else {
    auto kernel = fwd_stream_kernel<D, kChains, kTrain>;
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (opt_in != cudaSuccess) return opt_in;
    kernel<<<grid, kStreamThreads, kBytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), sq, sk, sv, so,
        heads, n, nk, scale, train);
  }
  return cudaGetLastError();
}

// ------------------------------------------------- bf16, d = 64, wgmma
constexpr int kRingStages = 4;  // K/V tiles in the d = 64 ring

// Dynamic shared memory of a block: its Q tiles, the ring, and room to
// align the tiles to 1024 bytes. Two warpgroups (82 KB) leave room for two
// blocks an SM, one (74 KB) for three.
template <int kWarpgroups>
constexpr int wgmma_smem_bytes() {
  return (kWarpgroups + 2 * kRingStages) * wg::kTileBytes + 1024;
}

// kWarpgroups warpgroups of 64 query rows a block. The register cap lets
// an SM hold as many blocks as its shared memory does (at two warpgroups,
// 128 registers a thread; the training variant spills nothing there).
// The kernel's body; Bias is NoBias (fwd_wgmma_kernel) or BiasArgs
// (fwd_wgmma_bias_kernel).
template <int kWarpgroups, bool kTrain, class Bias>
__device__ __forceinline__ void fwd_wgmma_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, Strides sq, Strides sk,
    Strides sv, Strides so, int heads, int n, int nk, float scale,
    const TrainArgs& train, const Bias& bias) {
  using namespace wg;
  constexpr int kBlockThreads = kWarpgroups * wg::kThreads;
  extern __shared__ unsigned char wg_smem_raw[];
  unsigned char* q_blk = align1024(wg_smem_raw);  // a Q tile per warpgroup
  unsigned char* ring = q_blk + kWarpgroups * kTileBytes;  // K, V per stage

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int wgi = threadIdx.x / wg::kThreads;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wg_row0 = (blockIdx.x * kWarpgroups + wgi) * wg::kTile;
  const bool wg_active = wg_row0 < n;  // else the warpgroup only stages
  const int row_lo = wg_row0 + warp * 16 + g;
  const float scale_log2e = scale * kLog2e;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const int num_tiles = (nk + wg::kTile - 1) / wg::kTile;
  auto slot = [&](int tile) {
    return ring + (tile % kRingStages) * 2 * kTileBytes;
  };
  auto stage = [&](int tile) {
    stage_sw128<kBlockThreads>(slot(tile), kb, sk.n, tile * wg::kTile, nk);
    stage_sw128<kBlockThreads>(slot(tile) + kTileBytes, vb, sv.n,
                               tile * wg::kTile, nk);
  };
  // Every warpgroup's Q goes with the first K/V tile. While tile j's S is
  // computed, tile j - 1's slot still holds the V that P V of tile j - 1
  // reads, so the ring runs kRingStages - 2 tiles ahead.
#pragma unroll
  for (int w = 0; w < kWarpgroups; ++w)
    stage_sw128<kBlockThreads>(q_blk + w * kTileBytes, qb, sq.n,
                               (blockIdx.x * kWarpgroups + w) * wg::kTile, n);
#pragma unroll
  for (int tile = 0; tile < kRingStages - 2; ++tile) {
    if (tile < num_tiles) stage(tile);
    cp_async_commit();  // an empty group keeps the count
  }
  const uint64_t qdesc = make_desc(q_blk + wgi * kTileBytes);

  float acc[32], s[32], m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  uint32_t pa[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  const Dropout drop(train, bh);  // dead code in the inference instantiation
  const auto rb = row_bias(bias, bh, row_lo, n);

  // Iteration j issues S of tile j and P V of tile j - 1, waits for both,
  // and runs tile j's softmax; the last iteration only adds P V. Running
  // the softmax while P V is still in flight was timed no faster; one
  // commit group and one wait for both products, with the rescale of acc
  // and the packing of P left unfenced, 4-13 % slower (PERF.md).
  for (int j = 0; j <= num_tiles; ++j) {
    const bool has_s = j < num_tiles;
    if (has_s) {
      cp_async_wait<kRingStages - 3>();  // this thread's copies of j landed
      // The copies become visible to the asynchronous proxy through which
      // wgmma reads shared memory.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // everyone's did, and P V of tile j - 2 is done
      if (j + kRingStages - 2 < num_tiles) stage(j + kRingStages - 2);
      cp_async_commit();
    }
    if (!wg_active) continue;
    fence_regs(s);
    fence_regs(acc);
    fence_regs(pa);
    wg_fence();
    if (has_s) {
      const uint64_t kd = make_desc(slot(j));
#pragma unroll
      for (int st = 0; st < 4; ++st)
        wgmma_ss(s, qdesc + 2 * st, kd + 2 * st, st > 0);
      wg_commit();
    }
    if (j > 0) {
      const uint64_t vd = make_desc(slot(j - 1) + kTileBytes);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(acc, pa[kk], vd + 128 * kk, 1);
      wg_commit();
    }
    float alpha[2];
    if (has_s) {
      wg_wait();
      fence_regs(s);
      const int key0 = j * wg::kTile;
      online_softmax<8>(s, m, l, alpha, key0, t, nk, scale_log2e, rb);
      // l above summed the undropped p; only P V drops.
      if constexpr (kTrain)
        if (drop.on) apply_dropout<8>(s, drop, row_lo, key0, t, lane);
    }
    wg_wait();  // both products are done: acc and pa are free
    fence_regs(acc);
    fence_regs(pa);
    if (has_s) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pa[kk][i] = pack2f(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
    }
  }

  // O through this warpgroup's Q tile (swizzled as it was), out as 16-byte
  // stores; each warp writes and reads its own 16 rows.
  __syncthreads();  // every product of the block is done with its Q tile
  if (!wg_active) return;
  float inv[2];
  finish_rows(l, inv);
  unsigned char* o_s = q_blk + wgi * kTileBytes;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row_in = warp * 16 + g + 8 * r;  // row_in & 7 == g
#pragma unroll
    for (int ot = 0; ot < 8; ++ot)
      *reinterpret_cast<uint32_t*>(o_s + row_in * 128 + ((ot ^ g) << 4) +
                                   4 * t) =
          pack2f(acc[4 * ot + 2 * r] * inv[r], acc[4 * ot + 2 * r + 1] * inv[r]);
    if constexpr (kTrain) {
      // lse in natural-log units: m lives in the log2 domain.
      const int row = wg_row0 + row_in;
      if (t == 0 && row < n)
        train.lse[static_cast<long long>(bh) * n + row] =
            m[r] * kLn2 + logf(l[r]);
    }
  }
  __syncwarp();
  bf16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = lane + 32 * i;
    const int row_in = warp * 16 + (idx >> 3), c = idx & 7;
    const int row = wg_row0 + row_in;
    if (row < n)
      *reinterpret_cast<uint4*>(ob + row * so.n + c * 8) =
          *reinterpret_cast<const uint4*>(o_s + row_in * 128 +
                                          ((c ^ (row_in & 7)) << 4));
  }
}

template <int kWarpgroups, bool kTrain>
__global__ void __launch_bounds__(kWarpgroups * wg::kThreads,
                                  kWarpgroups == 1 ? 3 : 2)
fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 Strides sq, Strides sk, Strides sv, Strides so, int heads,
                 int n, int nk, float scale, TrainArgs train) {
  fwd_wgmma_body<kWarpgroups, kTrain>(q, k, v, o, sq, sk, sv, so, heads, n, nk,
                                      scale, train, NoBias{});
}

// Inference with SAM's decomposed bias (BiasArgs).
template <int kWarpgroups>
__global__ void __launch_bounds__(kWarpgroups * wg::kThreads,
                                  kWarpgroups == 1 ? 3 : 2)
fwd_wgmma_bias_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      Strides sq, Strides sk, Strides sv, Strides so,
                      int heads, int n, int nk, float scale, BiasArgs bias) {
  fwd_wgmma_body<kWarpgroups, false>(
      q, k, v, o, sq, sk, sv, so, heads, n, nk, scale,
      TrainArgs{nullptr, nullptr, 1u << 24, 1.0f}, bias);
}

// The wgmma kernel of an instantiation: with SAM's bias (kBias, inference)
// or without (kTrain or not).
template <int kWarpgroups, bool kTrain, bool kBias>
auto wgmma_kernel() {
  if constexpr (kBias)
    return fwd_wgmma_bias_kernel<kWarpgroups>;
  else
    return fwd_wgmma_kernel<kWarpgroups, kTrain>;
}

// Block slots of the card for an instantiation (blocks an SM holds, times
// SMs), asked once; 0 and *err set if the runtime refuses.
template <int kWarpgroups, bool kTrain, bool kBias = false>
long long wgmma_slots(cudaError_t* err) {
  static cudaError_t status = cudaSuccess;
  static const long long slots = [] {
    auto kernel = wgmma_kernel<kWarpgroups, kTrain, kBias>();
    constexpr int kBytes = wgmma_smem_bytes<kWarpgroups>();
    int dev = 0, sms = 0, per_sm = 0;
    // Above 48 KB a kernel must opt in, once per instantiation.
    status = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (status == cudaSuccess) status = cudaGetDevice(&dev);
    if (status == cudaSuccess)
      status = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
    if (status == cudaSuccess)
      status = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kWarpgroups * wg::kThreads, kBytes);
    return static_cast<long long>(per_sm) * sms;
  }();
  *err = slots > 0 ? cudaSuccess
                   : (status != cudaSuccess ? status : cudaErrorInvalidValue);
  return slots;
}

template <int kWarpgroups, bool kTrain, class Bias>
cudaError_t launch_wgmma_blocks(const void* q, const void* k, const void* v,
                                void* o, Strides sq, Strides sk, Strides sv,
                                Strides so, int bh, int heads, int n, int nk,
                                float scale, TrainArgs train,
                                cudaStream_t stream, const Bias& bias) {
  constexpr int kRows = kWarpgroups * wg::kTile;
  const dim3 grid((n + kRows - 1) / kRows, bh);
  if constexpr (std::is_same<Bias, BiasArgs>::value)
    fwd_wgmma_bias_kernel<kWarpgroups>
        <<<grid, kWarpgroups * wg::kThreads, wgmma_smem_bytes<kWarpgroups>(),
           stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), static_cast<bf16*>(o), sq,
                     sk, sv, so, heads, n, nk, scale, bias);
  else
    fwd_wgmma_kernel<kWarpgroups, kTrain>
        <<<grid, kWarpgroups * wg::kThreads, wgmma_smem_bytes<kWarpgroups>(),
           stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), static_cast<bf16*>(o), sq,
                     sk, sv, so, heads, n, nk, scale, train);
  return cudaGetLastError();
}

// 64-row blocks (one warpgroup, three an SM) or 128-row blocks (two, two an
// SM, sharing each K/V tile). Both compute the same bh * ceil(N / 64)
// warpgroups of rows; a wave of blocks that fills the card's slots only in
// part wastes the rest. Timed on the H100 (PERF.md), 128-row blocks
// are ahead where both fill the card alike, 64-row blocks where they fill
// it more than 10 % better: (48, 197), (48, 321), (48, 785) against
// (384, 197), (48, 1025), (192, 1025), (24, 3137).
template <bool kTrain, bool kBias = false>
cudaError_t wgmma_warpgroups(int bh, int n, int* warpgroups) {
  cudaError_t err1, err2;
  const long long slots1 = wgmma_slots<1, kTrain, kBias>(&err1);
  const long long slots2 = wgmma_slots<2, kTrain, kBias>(&err2);
  if (err1 != cudaSuccess) return err1;
  if (err2 != cudaSuccess) return err2;
  const long long blocks1 = static_cast<long long>(bh) * ((n + 63) / 64);
  const long long blocks2 = static_cast<long long>(bh) * ((n + 127) / 128);
  const long long waves1 = (blocks1 + slots1 - 1) / slots1;
  const long long waves2 = (blocks2 + slots2 - 1) / slots2;
  // Fill: blocks1 / (waves1 * slots1) against blocks1 / (2 * waves2 * slots2).
  *warpgroups = 20 * waves2 * slots2 > 11 * waves1 * slots1 ? 1 : 2;
  return cudaSuccess;
}

// Bias: NoBias launches fwd_wgmma_kernel, BiasArgs fwd_wgmma_bias_kernel,
// each by its own fill.
template <bool kTrain, class Bias = NoBias>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, Strides sq, Strides sk, Strides sv,
                         Strides so, int bh, int heads, int n, int nk,
                         float scale, TrainArgs train, cudaStream_t stream,
                         const Bias& bias = Bias{}) {
  constexpr bool kBias = std::is_same<Bias, BiasArgs>::value;
  int warpgroups = 0;
  const cudaError_t err = wgmma_warpgroups<kTrain, kBias>(bh, n, &warpgroups);
  if (err != cudaSuccess) return err;
  if (warpgroups == 1)
    return launch_wgmma_blocks<1, kTrain>(q, k, v, o, sq, sk, sv, so, bh,
                                          heads, n, nk, scale, train, stream,
                                          bias);
  return launch_wgmma_blocks<2, kTrain>(q, k, v, o, sq, sk, sv, so, bh, heads,
                                        n, nk, scale, train, stream, bias);
}

// fp32: the scalar kernel; bf16: wgmma at d = 64, the mma.sync ring at the
// other head dims.
template <int D, bool kTrain>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, Strides sq, Strides sk, Strides sv, Strides so,
                   int batch, int heads, int n, int nk, float scale,
                   TrainArgs train, cudaStream_t stream) {
  if (dtype == 0) {
    const dim3 grid((n + kBlockQ - 1) / kBlockQ, batch * heads);
    flash_fwd_f32_kernel<D, kTrain><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), sq, sk, sv, so,
        heads, n, nk, scale, train);
    return cudaGetLastError();
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  if constexpr (D == 64) {
    return launch_wgmma<kTrain>(q, k, v, o, sq, sk, sv, so, batch * heads,
                                heads, n, nk, scale, train, stream);
  } else {
    return launch_stream<D, kTrain>(q, k, v, o, sq, sk, sv, so, batch * heads,
                                    heads, n, nk, scale, train, stream);
  }
}

template <bool kTrain>
int dispatch(int dtype, const void* q, const void* k, const void* v, void* o,
             Strides sq, Strides sk, Strides sv, Strides so, int batch,
             int heads, int n, int nk, int d, float scale, TrainArgs train,
             cudaStream_t s) {
  if (batch <= 0 || heads <= 0 || n <= 0 || nk <= 0 || batch * heads > 65535)
    return cudaErrorInvalidValue;
  switch (d) {
    case 16: return launch<16, kTrain>(dtype, q, k, v, o, sq, sk, sv, so, batch, heads, n, nk, scale, train, s);
    case 32: return launch<32, kTrain>(dtype, q, k, v, o, sq, sk, sv, so, batch, heads, n, nk, scale, train, s);
    case 64: return launch<64, kTrain>(dtype, q, k, v, o, sq, sk, sv, so, batch, heads, n, nk, scale, train, s);
    case 80: return launch<80, kTrain>(dtype, q, k, v, o, sq, sk, sv, so, batch, heads, n, nk, scale, train, s);
    case 128: return launch<128, kTrain>(dtype, q, k, v, o, sq, sk, sv, so, batch, heads, n, nk, scale, train, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// dimension of every tensor is contiguous, and in bfloat16 every row starts
// on a 16-byte boundary. q and o hold n rows a head, k and v n_k. Returns a
// cudaError_t.
int vt_flash_attention_fwd(int dtype, const void* q, const void* k,
                           const void* v, void* o, long long q_sb,
                           long long q_sh, long long q_sn, long long k_sb,
                           long long k_sh, long long k_sn, long long v_sb,
                           long long v_sh, long long v_sn, long long o_sb,
                           long long o_sh, long long o_sn, int batch,
                           int heads, int n, int n_k, int d, float scale,
                           void* stream) {
  const Strides sq{q_sb, q_sh, q_sn}, sk{k_sb, k_sh, k_sn};
  const Strides sv{v_sb, v_sh, v_sn}, so{o_sb, o_sh, o_sn};
  return dispatch<false>(dtype, q, k, v, o, sq, sk, sv, so, batch, heads, n,
                         n_k, d, scale, TrainArgs{nullptr, nullptr, 1u << 24, 1.0f},
                         static_cast<cudaStream_t>(stream));
}

// The training forward: as vt_flash_attention_fwd at n_k = n, plus lse
// (B*H, N) fp32 and dropout keyed by the int64 device scalar *seed;
// keep_threshold = ceil(keep * 2^24) (2^24: no dropout), inv_keep = 1 / keep.
int vt_flash_attention_fwd_train(
    int dtype, const void* q, const void* k, const void* v, void* o,
    void* lse, long long q_sb, long long q_sh, long long q_sn, long long k_sb,
    long long k_sh, long long k_sn, long long v_sb, long long v_sh,
    long long v_sn, long long o_sb, long long o_sh, long long o_sn,
    int batch, int heads, int n, int d, float scale, const void* seed,
    unsigned int keep_threshold, float inv_keep, void* stream) {
  const Strides sq{q_sb, q_sh, q_sn}, sk{k_sb, k_sh, k_sn};
  const Strides sv{v_sb, v_sh, v_sn}, so{o_sb, o_sh, o_sn};
  const TrainArgs train{static_cast<float*>(lse),
                        static_cast<const long long*>(seed), keep_threshold,
                        inv_keep};
  return dispatch<true>(dtype, q, k, v, o, sq, sk, sv, so, batch, heads, n, n,
                        d, scale, train, static_cast<cudaStream_t>(stream));
}

// Inference with SAM's decomposed relative-position bias (bfloat16 only):
// as vt_flash_attention_fwd with n_k = kh * kw keys, and key k of query row
// i of head (b, h) adding rel_h[b*H + h, i, k / kw] + rel_w[b*H + h, i,
// k % kw] to its scaled logit; rel_h (B*H, n, kh) and rel_w (B*H, n, kw)
// contiguous bfloat16, kw even, n_k <= 2^20 and B*H*n*max(kh, kw) < 2^31.
// d = 64 runs the wgmma kernel, d = 80 the mma.sync ring; any other head dim
// returns cudaErrorInvalidValue. Returns a cudaError_t.
int vt_flash_attention_fwd_bias(const void* q, const void* k, const void* v,
                                void* o, const void* rel_h, const void* rel_w,
                                long long q_sb, long long q_sh, long long q_sn,
                                long long k_sb, long long k_sh, long long k_sn,
                                long long v_sb, long long v_sh, long long v_sn,
                                long long o_sb, long long o_sh, long long o_sn,
                                int batch, int heads, int n, int kh, int kw,
                                int d, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || n <= 0 || kh <= 0 || kw <= 0 || kw % 2 ||
      batch * heads > 65535 || static_cast<long long>(kh) * kw > (1 << 20) ||
      static_cast<long long>(batch) * heads * n * (kh > kw ? kh : kw) >=
          (1LL << 31))
    return cudaErrorInvalidValue;
  const Strides sq{q_sb, q_sh, q_sn}, sk{k_sb, k_sh, k_sn};
  const Strides sv{v_sb, v_sh, v_sn}, so{o_sb, o_sh, o_sn};
  const BiasArgs bias{static_cast<const bf16*>(rel_h),
                      static_cast<const bf16*>(rel_w), kh, kw, 1.0f / kw};
  const TrainArgs none{nullptr, nullptr, 1u << 24, 1.0f};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nk = kh * kw;
  switch (d) {
    case 64: return launch_wgmma<false>(q, k, v, o, sq, sk, sv, so, batch * heads, heads, n, nk, scale, none, s, bias);
    case 80: return launch_stream<80, false>(q, k, v, o, sq, sk, sv, so, batch * heads, heads, n, nk, scale, none, s, bias);
    default: return cudaErrorInvalidValue;
  }
}

// The rows a block of the inference kernel's wgmma instantiation (bfloat16,
// d = 64) takes at bh = batch * heads and n query rows on the current
// device: 64 or 128, by launch_wgmma's fill rule. Returns a cudaError_t.
int vt_flash_attention_fwd_block_rows(int bh, int n, int* rows) {
  if (bh <= 0 || n <= 0) return cudaErrorInvalidValue;
  int warpgroups = 0;
  const cudaError_t err = wgmma_warpgroups<false>(bh, n, &warpgroups);
  *rows = 64 * warpgroups;
  return err;
}

const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
