// Flash-attention forward, inference variant, for Hopper (sm_90a).
//
// Replaces visiontransformer_tpu/ops/flash_attention.py:_fwd_kernel with
// need_lse=False and no dropout: out = softmax(Q K^T * d^-1/2) V over
// (B, H, N, d), computed online over key tiles so the N x N score matrix
// never reaches device memory.
//
// What bounds it: at the serving shape (B*H = 384, N = 197, d = 64, bf16)
// the kernel must move 4 * B*H*N*d * 2 bytes (Q, K, V read, O written:
// 38.7 MB) against 4 * B*H*N^2*d = 3.8 GFLOP, so on an H100 it is bound by
// memory bytes, not by the tensor cores.
//
// Design. The TPU kernel kept all of one head's K/V in VMEM and walked the
// grid in order; here blocks run in parallel, each with a few KB of static
// shared memory, so both paths below:
//   - give one block to each (batch*head, query tile) and stream K and V
//     through shared memory in 32-key tiles (N = 197 then pads to 224
//     keys, not 256);
//   - keep the running max m, sum l and the output accumulator in fp32
//     registers;
//   - score keys past N as -1e30, not -inf, so exp(m_old - m_new) never
//     meets inf - inf; padded query rows compute but are never stored.
// bf16 (the serving path) runs on the tensor cores: a block holds 128
// query rows, each of its eight warps owns 16 and issues mma.sync
// m16n8k16 (bf16 in, fp32 accumulate) for S = Q K^T and for O += P V,
// with P rounded to bf16 in registers as the TPU kernel rounds it to the
// input dtype. Q fragments stay in registers for the whole key loop; K/V
// tiles are fetched one tile ahead as 16-byte vectors into registers, then
// stored to shared memory, K row-major and V transposed, both with 8
// elements of row padding so the fragment loads of a warp hit 32 distinct
// banks. The softmax runs in the exp2 domain with log2(e) folded into the
// scale, and a warp whose rows all lie past N only helps stage tiles.
// fp32 (kept so parity can be checked on the card at fp32 tolerance) runs
// scalar FMAs on 64-row blocks: four threads share a query row, each
// holding every fourth element of q and of the accumulator. wgmma + TMA
// are later changes. Q, K and V may be strided views (the model passes
// slices of the fused QKV projection without a copy); only the last
// dimension must be contiguous, and for bf16 rows must be 16-byte aligned
// (the wrapper raises otherwise).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;                 // query rows per block
constexpr int kQuad = 4;                    // threads per query row
constexpr int kBlockK = 32;                 // keys per shared-memory tile
constexpr int kThreads = kBlockQ * kQuad;   // 256
constexpr float kNegInf = -1.0e30f;

struct Strides {
  long long b, h, n;
};

// ---------------------------------------------------------------- fp32 path
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     Strides sq, Strides sk, Strides sv, Strides so, int heads,
                     int n, float scale) {
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

  const int num_tiles = (n + kBlockK - 1) / kBlockK;
  for (int t = 0; t < num_tiles; ++t) {
    const int key0 = t * kBlockK;
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = threadIdx.x; idx < kBlockK * D; idx += kThreads) {
      const int j = idx / D;
      const int c = idx % D;
      const int key = key0 + j;
      float kv = 0.0f, vv = 0.0f;
      if (key < n) {
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
      s[j] = (key0 + j < n) ? dot * scale : kNegInf;
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
  }
}

// -------------------------------------------------------- bf16 tensor cores
using bf16 = __nv_bfloat16;
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaBlockQ = 16 * kMmaWarps;  // 128 query rows per block
constexpr int kPad = 8;                     // bf16 padding per smem row
constexpr int kVec = 8;                     // bf16 per 16-byte load

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  return pack2(__float2bfloat16(lo), __float2bfloat16(hi));
}

// D (16x8, fp32) += A (16x16, bf16, row) * B (16x8, bf16, col).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 * g + t. A holds
// rows g and g + 8, columns 2t, 2t + 1 (+ 8); B holds k = 2t, 2t + 1
// (+ 8) of column g; C holds rows g and g + 8, columns 2t, 2t + 1.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      Strides sq, Strides sk, Strides sv, Strides so,
                      int heads, int n, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kSteps = D / 16;          // k-steps of Q K^T
  constexpr int kOutTiles = D / 8;        // n-tiles of O
  constexpr int kKeyTiles = kBlockK / 8;  // n-tiles of S
  __shared__ __align__(16) bf16 k_s[kBlockK][D + kPad];
  __shared__ __align__(16) bf16 vt_s[D][kBlockK + kPad];

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int warp_row0 = blockIdx.x * kMmaBlockQ + (threadIdx.x / 32) * 16;
  const bool warp_active = warp_row0 < n;
  const int row_lo = warp_row0 + g;
  const int row_hi = row_lo + 8;
  // Scores live in the log2 domain: exp(x) = exp2(x * log2(e)), with the
  // factor folded into the softmax scale.
  const float scale_log2e = scale * 1.4426950408889634f;

  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const bf16 zero = __float2bfloat16(0.0f);

  uint32_t qa[kSteps][4];
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    const int c = st * 16 + 2 * t;
    const bf16* lo = qb + row_lo * sq.n + c;
    const bf16* hi = qb + row_hi * sq.n + c;
    const bool vlo = row_lo < n, vhi = row_hi < n;
    qa[st][0] = vlo ? pack2(lo[0], lo[1]) : pack2(zero, zero);
    qa[st][1] = vhi ? pack2(hi[0], hi[1]) : pack2(zero, zero);
    qa[st][2] = vlo ? pack2(lo[8], lo[9]) : pack2(zero, zero);
    qa[st][3] = vhi ? pack2(hi[8], hi[9]) : pack2(zero, zero);
  }

  float acc[kOutTiles][4];
#pragma unroll
  for (int ot = 0; ot < kOutTiles; ++ot)
    acc[ot][0] = acc[ot][1] = acc[ot][2] = acc[ot][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};

  // K/V tiles move as 16-byte vectors (the wrapper guarantees 16-byte
  // aligned rows), loaded into registers one tile ahead so the global
  // loads of tile i + 1 are in flight while tile i computes.
  constexpr int kVecs = kBlockK * D / kVec;
  constexpr int kLoads = (kVecs + kMmaThreads - 1) / kMmaThreads;
  uint4 k_next[kLoads], v_next[kLoads];
  auto fetch = [&](int key0) {
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int idx = threadIdx.x + r * kMmaThreads;
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
      const int idx = threadIdx.x + r * kMmaThreads;
      if (idx < kVecs) {
        const int j = idx / (D / kVec);
        const int c = (idx % (D / kVec)) * kVec;
        *reinterpret_cast<uint4*>(&k_s[j][c]) = k_next[r];
        const bf16* ve = reinterpret_cast<const bf16*>(&v_next[r]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) vt_s[c + e][j] = ve[e];
      }
    }
    __syncthreads();
    if (tile + 1 < num_tiles) fetch(key0 + kBlockK);
    // A warp whose 16 rows all lie past N only helps stage the tiles.
    if (!warp_active) continue;

    float s[kKeyTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const bf16* kr = &k_s[nt * 8 + g][st * 16 + 2 * t];
        mma16816(s[nt], qa[st], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + nt * 8 + 2 * t + (e & 1);
        s[nt][e] = key < n ? s[nt][e] * scale_log2e : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m[e >> 1]);
        l[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int ot = 0; ot < kOutTiles; ++ot) {
      acc[ot][0] *= alpha[0];
      acc[ot][1] *= alpha[0];
      acc[ot][2] *= alpha[1];
      acc[ot][3] *= alpha[1];
    }

#pragma unroll
    for (int ks = 0; ks < kBlockK / 16; ++ks) {
      const uint32_t pa[4] = {
          pack2f(s[2 * ks][0], s[2 * ks][1]), pack2f(s[2 * ks][2], s[2 * ks][3]),
          pack2f(s[2 * ks + 1][0], s[2 * ks + 1][1]),
          pack2f(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int ot = 0; ot < kOutTiles; ++ot) {
        const bf16* vr = &vt_s[ot * 8 + g][ks * 16 + 2 * t];
        mma16816(acc[ot], pa, *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv_lo = 1.0f / fmaxf(l[0], 1.0e-30f);
  const float inv_hi = 1.0f / fmaxf(l[1], 1.0e-30f);
  bf16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int ot = 0; ot < kOutTiles; ++ot) {
    const int c = ot * 8 + 2 * t;
    if (row_lo < n) {
      ob[row_lo * so.n + c] = __float2bfloat16(acc[ot][0] * inv_lo);
      ob[row_lo * so.n + c + 1] = __float2bfloat16(acc[ot][1] * inv_lo);
    }
    if (row_hi < n) {
      ob[row_hi * so.n + c] = __float2bfloat16(acc[ot][2] * inv_hi);
      ob[row_hi * so.n + c + 1] = __float2bfloat16(acc[ot][3] * inv_hi);
    }
  }
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, Strides sq, Strides sk, Strides sv, Strides so,
                   int batch, int heads, int n, float scale,
                   cudaStream_t stream) {
  if (dtype == 0) {
    const dim3 grid((n + kBlockQ - 1) / kBlockQ, batch * heads);
    flash_fwd_f32_kernel<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), sq, sk, sv, so,
        heads, n, scale);
  } else if (dtype == 1) {
    const dim3 grid((n + kMmaBlockQ - 1) / kMmaBlockQ, batch * heads);
    flash_fwd_bf16_kernel<D><<<grid, kMmaThreads, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), sq, sk, sv, so,
        heads, n, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// dimension of every tensor is contiguous. Returns a cudaError_t.
int vt_flash_attention_fwd(int dtype, const void* q, const void* k,
                           const void* v, void* o, long long q_sb,
                           long long q_sh, long long q_sn, long long k_sb,
                           long long k_sh, long long k_sn, long long v_sb,
                           long long v_sh, long long v_sn, long long o_sb,
                           long long o_sh, long long o_sn, int batch,
                           int heads, int n, int d, float scale,
                           void* stream) {
  const Strides sq{q_sb, q_sh, q_sn}, sk{k_sb, k_sh, k_sn};
  const Strides sv{v_sb, v_sh, v_sn}, so{o_sb, o_sh, o_sn};
  if (batch <= 0 || heads <= 0 || n <= 0 || batch * heads > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(dtype, q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
    case 32: return launch<32>(dtype, q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
    case 64: return launch<64>(dtype, q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
    case 80: return launch<80>(dtype, q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
    case 128: return launch<128>(dtype, q, k, v, o, sq, sk, sv, so, batch, heads, n, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
