// Flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces visiontransformer_tpu/ops/flash_attention.py:_bwd_dq_kernel.
// Per query row i, over every key j:
//   P = exp(S - lse_i) with S = q_i k_j^T * scale (keys past N give P = 0),
//   dP = dO_i v_j^T, times mask / keep with dropout,
//   dS = P (dP - delta_i),  dQ_i = sum_j dS k_j * scale,
// where lse is the training forward's (natural log) and
// delta = rowsum(dO * O) comes from the caller. The dropout mask is
// regenerated from (seed, b*H + h, row, column) exactly as the forward drew
// it (flash_attention_common.cuh). Nothing of size N x N is stored.
//
// What bounds it: at the training micro-batch (B*H = 48, N = 197, d = 64,
// bf16) it reads Q, K, V, dO and writes dQ (5 * B*H*N*d * 2 bytes) plus lse
// and delta, against 6 * B*H*N^2*d operations (three N x N x d products):
// bytes, on the H100.
//
// Design. One block per (b*H + h, 64-row query tile); K and V stream
// through shared memory in 32-key tiles, fetched one tile ahead as 16-byte
// vectors. bf16: four warps of 16 query rows each; Q and dO fragments stay
// in registers; mma.sync m16n8k16 computes S = Q K^T and dP = dO V^T from
// K and V row-major in shared memory, and dQ += dS K from a transposed copy
// of K; dS is rounded to bf16 before that product, where the TPU kernel
// rounds it. fp32 (kept so parity can be checked on the card at fp32
// tolerance) runs scalar FMAs with four threads per query row. Inputs may
// be strided views with a contiguous last dimension; rows >= N are never
// loaded or stored.

#include "flash_attention_common.cuh"

using namespace vt_flash;

namespace {

constexpr int kBlockQ = 64;   // query rows per block
constexpr int kBlockK = 32;   // keys per shared-memory tile

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
constexpr int kWarps = kBlockQ / 16;   // 4 warps of 16 query rows
constexpr int kThreads = 32 * kWarps;  // 128

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dq, Strides sq, Strides sk, Strides sv,
               Strides sdo, Strides sdq, int heads, int n, float scale,
               DropArgs drop) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kSteps = D / 16;          // k-steps of the N x d products
  constexpr int kOutTiles = D / 8;        // n-tiles of dQ
  constexpr int kKeyTiles = kBlockK / 8;  // n-tiles of S and dP
  __shared__ __align__(16) bf16 k_s[kBlockK][D + kPad];
  __shared__ __align__(16) bf16 v_s[kBlockK][D + kPad];
  __shared__ __align__(16) bf16 kt_s[D][kBlockK + kPad];

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int warp_row0 = blockIdx.x * kBlockQ + (threadIdx.x / 32) * 16;
  const bool warp_active = warp_row0 < n;
  const int row_lo = warp_row0 + g, row_hi = row_lo + 8;
  const int rows[2] = {row_lo, row_hi};
  const float scale_log2e = scale * kLog2e;
  const bool dropout = drop.keep_threshold < (1u << 24);
  const uint32_t seed = dropout ? static_cast<uint32_t>(*drop.seed) : 0u;

  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  uint32_t qa[kSteps][4], da[kSteps][4];
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    load_a_frag(qa[st], q + b * sq.b + h * sq.h, sq.n, row_lo, n, st * 16, t);
    load_a_frag(da[st], dout + b * sdo.b + h * sdo.h, sdo.n, row_lo, n,
                st * 16, t);
  }
  // Per row: lse in the log2 domain, and delta.
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long rid = static_cast<long long>(bh) * n + rows[r];
    lse2[r] = rows[r] < n ? lse[rid] * kLog2e : 0.0f;
    dlt[r] = rows[r] < n ? delta[rid] : 0.0f;
  }

  float acc[kOutTiles][4];
#pragma unroll
  for (int ot = 0; ot < kOutTiles; ++ot)
    acc[ot][0] = acc[ot][1] = acc[ot][2] = acc[ot][3] = 0.0f;

  constexpr int kVecs = kBlockK * D / kVec;
  constexpr int kLoads = (kVecs + kThreads - 1) / kThreads;
  uint4 k_next[kLoads], v_next[kLoads];
  auto fetch = [&](int key0) {
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int idx = threadIdx.x + r * kThreads;
      const int key = key0 + idx / (D / kVec);
      const int c = (idx % (D / kVec)) * kVec;
      k_next[r] = v_next[r] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < kVecs && key < n) {
        k_next[r] = *reinterpret_cast<const uint4*>(kb + key * sk.n + c);
        v_next[r] = *reinterpret_cast<const uint4*>(vb + key * sv.n + c);
      }
    }
  };

  const int num_tiles = (n + kBlockK - 1) / kBlockK;
  fetch(0);
  for (int tile = 0; tile < num_tiles; ++tile) {
    const int key0 = tile * kBlockK;
    __syncthreads();  // every warp is done with the previous tile
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int idx = threadIdx.x + r * kThreads;
      if (idx < kVecs) {
        const int j = idx / (D / kVec);
        const int c = (idx % (D / kVec)) * kVec;
        *reinterpret_cast<uint4*>(&k_s[j][c]) = k_next[r];
        *reinterpret_cast<uint4*>(&v_s[j][c]) = v_next[r];
        const bf16* ke = reinterpret_cast<const bf16*>(&k_next[r]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) kt_s[c + e][j] = ke[e];
      }
    }
    __syncthreads();
    if (tile + 1 < num_tiles) fetch(key0 + kBlockK);
    if (!warp_active) continue;

    float s[kKeyTiles][4], dp[kKeyTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const bf16* kr = &k_s[nt * 8 + g][st * 16 + 2 * t];
        mma16816(s[nt], qa[st], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
        const bf16* vr = &v_s[nt * 8 + g][st * 16 + 2 * t];
        mma16816(dp[nt], da[st], *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 8));
      }
    }
    // dS = P (dP * mask / keep - delta), into s.
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = key0 + nt * 8 + 2 * t + (e & 1);
        const float p =
            key < n ? exp2f(s[nt][e] * scale_log2e - lse2[r]) : 0.0f;
        float dpe = dp[nt][e];
        if (dropout)
          dpe = dropout_keep(seed, bh, rows[r], key, drop.keep_threshold)
                    ? dpe * drop.inv_keep : 0.0f;
        s[nt][e] = p * (dpe - dlt[r]);
      }
    }
#pragma unroll
    for (int ks = 0; ks < kBlockK / 16; ++ks) {
      const uint32_t pa[4] = {
          pack2f(s[2 * ks][0], s[2 * ks][1]), pack2f(s[2 * ks][2], s[2 * ks][3]),
          pack2f(s[2 * ks + 1][0], s[2 * ks + 1][1]),
          pack2f(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int ot = 0; ot < kOutTiles; ++ot) {
        const bf16* kr = &kt_s[ot * 8 + g][ks * 16 + 2 * t];
        mma16816(acc[ot], pa, *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
  }

  bf16* out = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int ot = 0; ot < kOutTiles; ++ot) {
    const int c = ot * 8 + 2 * t;
    if (row_lo < n) {
      out[row_lo * sdq.n + c] = __float2bfloat16(acc[ot][0] * scale);
      out[row_lo * sdq.n + c + 1] = __float2bfloat16(acc[ot][1] * scale);
    }
    if (row_hi < n) {
      out[row_hi * sdq.n + c] = __float2bfloat16(acc[ot][2] * scale);
      out[row_hi * sdq.n + c + 1] = __float2bfloat16(acc[ot][3] * scale);
    }
  }
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, Strides sq, Strides sk, Strides sv, Strides sdo,
                   Strides sdq, int bh, int heads, int n, float scale,
                   DropArgs drop, cudaStream_t stream) {
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, bh);
  if (dtype == 0) {
    dq_f32_kernel<D><<<grid, kF32Threads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), sq, sk, sv, sdo, sdq, heads, n, scale,
        drop);
  } else if (dtype == 1) {
    dq_bf16_kernel<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dq), sq, sk, sv, sdo, sdq, heads, n, scale,
        drop);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v, dout, dq: (B, H, N, d) with
// element strides (b, h, n) and a contiguous last dimension; lse and delta:
// (B*H, N) contiguous fp32. seed: int64 device scalar; keep_threshold =
// ceil(keep * 2^24) (2^24: no dropout). Returns a cudaError_t.
int vt_flash_attention_bwd_dq(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, long long q_sb,
    long long q_sh, long long q_sn, long long k_sb, long long k_sh,
    long long k_sn, long long v_sb, long long v_sh, long long v_sn,
    long long do_sb, long long do_sh, long long do_sn, long long dq_sb,
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
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
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
