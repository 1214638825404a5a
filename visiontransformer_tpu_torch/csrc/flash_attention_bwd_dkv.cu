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
// What bounds it: at the training micro-batch (B*H = 48, N = 197, d = 64,
// bf16) it reads Q, K, V, dO and writes dK, dV (6 * B*H*N*d * 2 bytes) plus
// lse and delta, against 8 * B*H*N^2*d operations (four N x N x d
// products): bytes, on the H100.
//
// Design. One block per (b*H + h, 64-key tile); Q and dO stream through
// shared memory in 32-query tiles (with lse and delta), fetched one tile
// ahead as 16-byte vectors. bf16: four warps of 16 keys each; K and V
// fragments stay in registers; mma.sync m16n8k16 computes S^T = K Q^T and
// dP^T = V dO^T from Q and dO row-major in shared memory, and dV += P^T dO,
// dK += dS^T Q from transposed copies; P * mask / keep and dS are rounded
// to bf16 before those products, where the TPU kernel rounds them. The two
// fp32 accumulators (dK, dV) stay in registers. fp32 (kept so parity can be
// checked on the card at fp32 tolerance) runs scalar FMAs with four threads
// per key.

#include "flash_attention_common.cuh"

using namespace vt_flash;

namespace {

constexpr int kBlockK = 64;   // keys per block
constexpr int kBlockQ = 32;   // queries per shared-memory tile

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
constexpr int kWarps = kBlockK / 16;   // 4 warps of 16 keys
constexpr int kThreads = 32 * kWarps;  // 128

template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sq,
                Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                int heads, int n, float scale, DropArgs drop) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kSteps = D / 16;            // k-steps of K Q^T and V dO^T
  constexpr int kOutTiles = D / 8;          // n-tiles of dK and dV
  constexpr int kQueryTiles = kBlockQ / 8;  // n-tiles of S^T and dP^T
  __shared__ __align__(16) bf16 q_s[kBlockQ][D + kPad];
  __shared__ __align__(16) bf16 do_s[kBlockQ][D + kPad];
  __shared__ __align__(16) bf16 qt_s[D][kBlockQ + kPad];
  __shared__ __align__(16) bf16 dot_s[D][kBlockQ + kPad];
  __shared__ float lse2_s[kBlockQ];
  __shared__ float dlt_s[kBlockQ];

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int warp_key0 = blockIdx.x * kBlockK + (threadIdx.x / 32) * 16;
  const bool warp_active = warp_key0 < n;
  const int key_lo = warp_key0 + g, key_hi = key_lo + 8;
  const int keys[2] = {key_lo, key_hi};
  const float scale_log2e = scale * kLog2e;
  const bool dropout = drop.keep_threshold < (1u << 24);
  const uint32_t seed = dropout ? static_cast<uint32_t>(*drop.seed) : 0u;

  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* db = dout + b * sdo.b + h * sdo.h;

  uint32_t ka[kSteps][4], va[kSteps][4];
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    load_a_frag(ka[st], k + b * sk.b + h * sk.h, sk.n, key_lo, n, st * 16, t);
    load_a_frag(va[st], v + b * sv.b + h * sv.h, sv.n, key_lo, n, st * 16, t);
  }

  float dka[kOutTiles][4], dva[kOutTiles][4];
#pragma unroll
  for (int ot = 0; ot < kOutTiles; ++ot) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[ot][e] = dva[ot][e] = 0.0f;
  }

  constexpr int kVecs = kBlockQ * D / kVec;
  constexpr int kLoads = (kVecs + kThreads - 1) / kThreads;
  uint4 q_next[kLoads], d_next[kLoads];
  auto fetch = [&](int q0) {
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int idx = threadIdx.x + r * kThreads;
      const int row = q0 + idx / (D / kVec);
      const int c = (idx % (D / kVec)) * kVec;
      q_next[r] = d_next[r] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < kVecs && row < n) {
        q_next[r] = *reinterpret_cast<const uint4*>(qb + row * sq.n + c);
        d_next[r] = *reinterpret_cast<const uint4*>(db + row * sdo.n + c);
      }
    }
  };

  const int num_tiles = (n + kBlockQ - 1) / kBlockQ;
  fetch(0);
  for (int tile = 0; tile < num_tiles; ++tile) {
    const int q0 = tile * kBlockQ;
    __syncthreads();  // every warp is done with the previous tile
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int idx = threadIdx.x + r * kThreads;
      if (idx < kVecs) {
        const int i = idx / (D / kVec);
        const int c = (idx % (D / kVec)) * kVec;
        *reinterpret_cast<uint4*>(&q_s[i][c]) = q_next[r];
        *reinterpret_cast<uint4*>(&do_s[i][c]) = d_next[r];
        const bf16* qe = reinterpret_cast<const bf16*>(&q_next[r]);
        const bf16* de = reinterpret_cast<const bf16*>(&d_next[r]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          qt_s[c + e][i] = qe[e];
          dot_s[c + e][i] = de[e];
        }
      }
    }
    if (threadIdx.x < kBlockQ) {
      const int row = q0 + threadIdx.x;
      const long long rid = static_cast<long long>(bh) * n + row;
      lse2_s[threadIdx.x] = row < n ? lse[rid] * kLog2e : 0.0f;
      dlt_s[threadIdx.x] = row < n ? delta[rid] : 0.0f;
    }
    __syncthreads();
    if (tile + 1 < num_tiles) fetch(q0 + kBlockQ);
    if (!warp_active) continue;

    // S^T (keys x queries) and dP^T for this warp's 16 keys.
    float s[kQueryTiles][4], dp[kQueryTiles][4];
#pragma unroll
    for (int nt = 0; nt < kQueryTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const bf16* qr = &q_s[nt * 8 + g][st * 16 + 2 * t];
        mma16816(s[nt], ka[st], *reinterpret_cast<const uint32_t*>(qr),
                 *reinterpret_cast<const uint32_t*>(qr + 8));
        const bf16* dr = &do_s[nt * 8 + g][st * 16 + 2 * t];
        mma16816(dp[nt], va[st], *reinterpret_cast<const uint32_t*>(dr),
                 *reinterpret_cast<const uint32_t*>(dr + 8));
      }
    }
    // s <- P * mask / keep (for dV), dp <- dS (for dK).
#pragma unroll
    for (int nt = 0; nt < kQueryTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + 2 * t + (e & 1);
        const int row = q0 + qc;
        const float p =
            row < n ? exp2f(s[nt][e] * scale_log2e - lse2_s[qc]) : 0.0f;
        float pd = p, dpe = dp[nt][e];
        if (dropout) {
          const bool keep = dropout_keep(seed, bh, row, keys[e >> 1],
                                         drop.keep_threshold);
          pd = keep ? p * drop.inv_keep : 0.0f;
          dpe = keep ? dpe * drop.inv_keep : 0.0f;
        }
        s[nt][e] = pd;
        dp[nt][e] = p * (dpe - dlt_s[qc]);
      }
    }
#pragma unroll
    for (int ks = 0; ks < kBlockQ / 16; ++ks) {
      const uint32_t pa[4] = {
          pack2f(s[2 * ks][0], s[2 * ks][1]), pack2f(s[2 * ks][2], s[2 * ks][3]),
          pack2f(s[2 * ks + 1][0], s[2 * ks + 1][1]),
          pack2f(s[2 * ks + 1][2], s[2 * ks + 1][3])};
      const uint32_t sa[4] = {
          pack2f(dp[2 * ks][0], dp[2 * ks][1]),
          pack2f(dp[2 * ks][2], dp[2 * ks][3]),
          pack2f(dp[2 * ks + 1][0], dp[2 * ks + 1][1]),
          pack2f(dp[2 * ks + 1][2], dp[2 * ks + 1][3])};
#pragma unroll
      for (int ot = 0; ot < kOutTiles; ++ot) {
        const bf16* dr = &dot_s[ot * 8 + g][ks * 16 + 2 * t];
        mma16816(dva[ot], pa, *reinterpret_cast<const uint32_t*>(dr),
                 *reinterpret_cast<const uint32_t*>(dr + 8));
        const bf16* qr = &qt_s[ot * 8 + g][ks * 16 + 2 * t];
        mma16816(dka[ot], sa, *reinterpret_cast<const uint32_t*>(qr),
                 *reinterpret_cast<const uint32_t*>(qr + 8));
      }
    }
  }

  bf16* ko = dk + b * sdk.b + h * sdk.h;
  bf16* vo = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int ot = 0; ot < kOutTiles; ++ot) {
    const int c = ot * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (keys[r] < n) {
        ko[keys[r] * sdk.n + c] = __float2bfloat16(dka[ot][2 * r] * scale);
        ko[keys[r] * sdk.n + c + 1] =
            __float2bfloat16(dka[ot][2 * r + 1] * scale);
        vo[keys[r] * sdv.n + c] = __float2bfloat16(dva[ot][2 * r]);
        vo[keys[r] * sdv.n + c + 1] = __float2bfloat16(dva[ot][2 * r + 1]);
      }
    }
  }
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, Strides sq, Strides sk, Strides sv,
                   Strides sdo, Strides sdk, Strides sdv, int bh, int heads,
                   int n, float scale, DropArgs drop, cudaStream_t stream) {
  const dim3 grid((n + kBlockK - 1) / kBlockK, bh);
  if (dtype == 0) {
    dkv_f32_kernel<D><<<grid, kF32Threads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), sq, sk, sv,
        sdo, sdk, sdv, heads, n, scale, drop);
  } else if (dtype == 1) {
    dkv_bf16_kernel<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk, sv,
        sdo, sdk, sdv, heads, n, scale, drop);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v, dout, dk, dv: (B, H, N, d)
// with element strides (b, h, n) and a contiguous last dimension; lse and
// delta: (B*H, N) contiguous fp32. seed: int64 device scalar;
// keep_threshold = ceil(keep * 2^24) (2^24: no dropout). Returns a
// cudaError_t.
int vt_flash_attention_bwd_dkv(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, long long q_sb,
    long long q_sh, long long q_sn, long long k_sb, long long k_sh,
    long long k_sn, long long v_sb, long long v_sh, long long v_sn,
    long long do_sb, long long do_sh, long long do_sn, long long dk_sb,
    long long dk_sh, long long dk_sn, long long dv_sb, long long dv_sh,
    long long dv_sn, int batch, int heads, int n, int d, float scale,
    const void* seed, unsigned int keep_threshold, float inv_keep,
    void* stream) {
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
