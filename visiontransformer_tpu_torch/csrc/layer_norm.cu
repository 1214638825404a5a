// Row-wise LayerNorm over the last axis, alone or after a bias and a
// residual add, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the TPU package leaves its LayerNorm to XLA,
// which fuses it. The port's plain version (ops/layer_norm.py) runs it as
// eager PyTorch ops, about eleven passes over (rows, C) in fp32: the
// widening, two means, two subtractions, a square, the products by the
// reciprocal root and the scale, the shift, and the cast back. This kernel
// takes their place on the serving path, in two forms:
//
//   y = LN(x)                          (t == NULL)
//   s = x + (t + b), y = LN(s)         (t != NULL; b may be NULL)
//
// where t is a linear layer's product without its bias, so the bias add,
// the residual add and the LayerNorm that follows them are one pass. The
// roundings are those of the plain code: t + b is rounded to the activation
// type (b rounded to it first), then added to x and rounded again, so s
// equals the plain residual stream bit for bit; the statistics are taken
// of the rounded s.
//
// What bounds it on this card: bytes. Each input is read once and each
// output written once; at ViT-B/16's serving bucket (32 x 197 rows of 768
// bf16) the residual form moves 4 x 9.7 MB, 11.6 us at 3.35 TB/s. The
// arithmetic (about ten fp32 operations a value) is far below the fp32
// rate.
//
// What the design does about it:
// - Every access is a 16-byte vector (8 bf16 or 4 fp32 values); lane j of
//   a row's lanes holds vectors j, j + L, j + 2L, ..., so the L lanes of a
//   row read L neighbouring vectors with one instruction.
// - A row lives in registers from its load to its store: the two-pass
//   statistics (the mean, then the mean of squared deviations, as the plain
//   code takes them) cost no second read of device memory.
// - L, the lanes a row, adapts to C: the largest power of two up to 32
//   that divides the row's vectors (C = 768 bf16: 96 vectors, one warp a
//   row, 3 vectors a lane; MiT's C = 64: 8 lanes, 4 rows a warp; C = 320:
//   8 lanes, 5 vectors a lane), so no lane idles; where that would leave
//   more than kMaxVpl vectors a lane, 32 lanes with the last vectors masked.
//   The statistics are summed across a row's lanes by butterfly shuffles,
//   which stay inside the row's group of L lanes.
// - Products and sums are rounded one at a time (__fmul_rn, __fadd_rn), so
//   nvcc contracts nothing into an FMA and both forms give the same y for
//   the same s, bit for bit.
// - The bias, scale and shift are fp32 (C,) vectors, read through the
//   read-only cache; the launch allocates nothing and runs on the caller's
//   stream, so CUDA graphs capture it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVpl = 8;

// 16-byte vectors of fp32: 4 values.
struct F32 {
  static constexpr int kPer = 4;
  __device__ static __forceinline__ void unpack(uint4 r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static __forceinline__ float round(float v) { return v; }
};

// 16-byte vectors of bf16: 8 values, two a 32-bit word (the first in the
// low half). Widening is exact: the bf16 bits are a float's upper half.
struct BF16 {
  static constexpr int kPer = 8;
  __device__ static __forceinline__ void unpack_word(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static __forceinline__ uint32_t pack_word(float lo, float hi) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
            << 16);
  }
  __device__ static __forceinline__ void unpack(uint4 r, float* f) {
    unpack_word(r.x, f);
    unpack_word(r.y, f + 2);
    unpack_word(r.z, f + 4);
    unpack_word(r.w, f + 6);
  }
  __device__ static __forceinline__ uint4 pack(const float* f) {
    return make_uint4(pack_word(f[0], f[1]), pack_word(f[2], f[3]),
                      pack_word(f[4], f[5]), pack_word(f[6], f[7]));
  }
  // Round to the nearest bf16 (ties to even) and widen back.
  __device__ static __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// kPer consecutive fp32 values of a (C,) parameter vector.
template <int kPer>
__device__ __forceinline__ void load_params(const float* p, int col,
                                            float* f) {
#pragma unroll
  for (int i = 0; i < kPer; i += 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p + col + i));
    f[i] = q.x;
    f[i + 1] = q.y;
    f[i + 2] = q.z;
    f[i + 3] = q.w;
  }
}

// Sum over the L lanes of a row (L a power of two; the groups of L lanes
// are aligned, so offsets below L stay inside the group).
__device__ __forceinline__ float row_sum(float v, int lanes) {
  for (int offset = lanes / 2; offset > 0; offset /= 2)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, offset));
  return v;
}

// One row a group of `lanes` lanes, 32 / lanes rows a warp. x, t, s, y:
// (rows, cols) in the activation type, 16-byte aligned rows of nv vectors;
// b (may be null), scale, shift: (cols,) fp32.
template <typename Tr, int kVpl, bool kResidual>
__global__ void __launch_bounds__(kThreads)
    layer_norm_kernel(const uint4* __restrict__ x, const uint4* __restrict__ t,
                      const float* __restrict__ b,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift, uint4* __restrict__ s,
                      uint4* __restrict__ y, long long rows, int nv, int lanes,
                      int cols, float eps) {
  constexpr int kPer = Tr::kPer;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);
  const int rows_a_warp = 32 / lanes;
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (warp * rows_a_warp >= rows) return;  // the whole warp: no shuffle
  const long long row = warp * rows_a_warp + lane / lanes;
  const bool live = row < rows;  // lanes past the end still shuffle
  const long long base = row * nv;

  float v[kVpl][kPer];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kVpl; ++j) {
    const int idx = j * lanes + sub;
    if (live && idx < nv) {
      Tr::unpack(x[base + idx], v[j]);
      if constexpr (kResidual) {
        float u[kPer];
        Tr::unpack(t[base + idx], u);
        if (b != nullptr) {
          float bb[kPer];
          load_params<kPer>(b, idx * kPer, bb);
#pragma unroll
          for (int e = 0; e < kPer; ++e)
            u[e] = Tr::round(__fadd_rn(u[e], Tr::round(bb[e])));
        }
#pragma unroll
        for (int e = 0; e < kPer; ++e)
          v[j][e] = Tr::round(__fadd_rn(v[j][e], u[e]));
        s[base + idx] = Tr::pack(v[j]);
      }
#pragma unroll
      for (int e = 0; e < kPer; ++e) sum = __fadd_rn(sum, v[j][e]);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) v[j][e] = 0.f;
    }
  }
  const float inv_cols = 1.f / static_cast<float>(cols);
  const float mean = __fmul_rn(row_sum(sum, lanes), inv_cols);

  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < kVpl; ++j) {
    if (live && j * lanes + sub < nv) {
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        v[j][e] = __fsub_rn(v[j][e], mean);
        sq = __fadd_rn(sq, __fmul_rn(v[j][e], v[j][e]));
      }
    }
  }
  const float var = __fmul_rn(row_sum(sq, lanes), inv_cols);
  const float rstd = rsqrtf(__fadd_rn(var, eps));

#pragma unroll
  for (int j = 0; j < kVpl; ++j) {
    const int idx = j * lanes + sub;
    if (live && idx < nv) {
      float g[kPer], h[kPer];
      load_params<kPer>(scale, idx * kPer, g);
      load_params<kPer>(shift, idx * kPer, h);
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        v[j][e] = __fadd_rn(__fmul_rn(__fmul_rn(v[j][e], rstd), g[e]), h[e]);
      y[base + idx] = Tr::pack(v[j]);
    }
  }
}

// (lanes a row, vectors a lane) for a row of nv vectors; vpl 0 where a
// row exceeds 32 * kMaxVpl vectors.
void shape_of(int nv, int* lanes, int* vpl) {
  int l = 32;
  while (l > 1 && nv % l) l /= 2;
  if (nv / l > kMaxVpl) l = 32;
  *lanes = l;
  *vpl = (nv + l - 1) / l;
  if (*vpl > kMaxVpl) *vpl = 0;
}

template <typename Tr, int kVpl>
cudaError_t launch_vpl(const void* x, const void* t, const float* b,
                       const float* scale, const float* shift, void* s,
                       void* y, long long rows, int nv, int lanes, int cols,
                       float eps, cudaStream_t stream) {
  const long long rows_a_block = static_cast<long long>(kWarps) * (32 / lanes);
  const long long blocks = (rows + rows_a_block - 1) / rows_a_block;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  const uint4* xv = static_cast<const uint4*>(x);
  if (t != nullptr)
    layer_norm_kernel<Tr, kVpl, true><<<grid, kThreads, 0, stream>>>(
        xv, static_cast<const uint4*>(t), b, scale, shift,
        static_cast<uint4*>(s), static_cast<uint4*>(y), rows, nv, lanes, cols,
        eps);
  else
    layer_norm_kernel<Tr, kVpl, false><<<grid, kThreads, 0, stream>>>(
        xv, nullptr, nullptr, scale, shift, nullptr, static_cast<uint4*>(y),
        rows, nv, lanes, cols, eps);
  return cudaGetLastError();
}

// The smallest instantiation that holds vpl vectors a lane.
template <typename Tr>
cudaError_t launch(const void* x, const void* t, const float* b,
                   const float* scale, const float* shift, void* s, void* y,
                   long long rows, int cols, float eps, cudaStream_t stream) {
  const int nv = cols / Tr::kPer;
  int lanes, vpl;
  shape_of(nv, &lanes, &vpl);
#define VT_LN_CASE(V)                                                      \
  if (vpl <= V)                                                            \
    return launch_vpl<Tr, V>(x, t, b, scale, shift, s, y, rows, nv, lanes, \
                             cols, eps, stream);
  VT_LN_CASE(1)
  VT_LN_CASE(2)
  VT_LN_CASE(3)
  VT_LN_CASE(4)
  VT_LN_CASE(5)
  VT_LN_CASE(6)
  VT_LN_CASE(8)
#undef VT_LN_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype 0: fp32, 1: bf16. x, t (may be null), s, y: (rows, cols)
// contiguous, 16-byte aligned; b (may be null; ignored without t), scale,
// shift: (cols,) fp32, 16-byte aligned. Without t, y = LN(x) and s is not
// written; with t, s = x + (t + b) and y = LN(s). cols must be a multiple
// of 8 and at most 32 * 8 vectors (2,048 bf16, 1,024 fp32 values).
// Returns a cudaError_t.
int vt_layer_norm(int dtype, const void* x, const void* t, const float* b,
                  const float* scale, const float* shift, void* s, void* y,
                  long long rows, int cols, float eps, void* stream) {
  if (rows <= 0 || cols <= 0 || cols % 8 || (t != nullptr && s == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<F32>(x, t, b, scale, shift, s, y, rows, cols, eps, st);
  if (dtype == 1)
    return launch<BF16>(x, t, b, scale, shift, s, y, rows, cols, eps, st);
  return cudaErrorInvalidValue;
}

const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
