// Fused bilinear upsample + argmax over classes (the seg-head epilogue),
// for Hopper (sm_90a).
//
// Replaces visiontransformer_tpu/ops/upsample_argmax.py:_kernel, which ran
// the W-stage interpolation product and the class argmax on the TPU (its
// H-stage ran outside, :89). Here both stages and the argmax are fused:
// (B, h, w, C) fp32 or bf16 grid logits -> (B, H, W) int32 or uint8 class
// map. The first class wins ties (strict '>' in ascending class order, as
// argmax and the TPU kernel's `where(z >= m, ...)` min do), and the
// (B, H, W, C) fp32 logits are never formed.
//
// What bounds it on this card: not bytes. At B = 32, 14^2 -> 512^2,
// C = 17 the output is 33.5 MB as int32 (0.0101 ms at 3.35 TB/s) and
// 8.4 MB as uint8 (0.0026 ms); the input, 0.4 MB, stays in L2. The W-stage
// and argmax need 0.57 G (class, output pixel) steps of two products, a sum
// and a comparison: 0.0087 ms at the fp32 rate of 67 TFLOP/s. Measured on
// an H100 (PERF.md, kernel 5) it runs about 7x that, 0.061 ms, issuing at
// about half the card's rate; fewer shared-memory reads, fewer
// instructions a step and more independent work a thread each left that
// time where it was, so what holds it is still open.
//
// What the design does about it:
// - A 2-D grid, blockIdx.y = image, blockIdx.x = a tile of hb output rows
//   (hb chosen at launch from the shared-memory budget and the card's SM
//   count, so that every SM gets two blocks); offsets are 32-bit inside an image, and the loop over the
//   tile's pixels advances without a division.
// - The H-stage, t[Y][j][c] = wy0 * x[r0][j][c] + wy1 * x[r1][j][c], once
//   per (image, output row, input column, class), into shared memory, from
//   coalesced loads of the two contiguous w * C input rows (16 bytes a
//   thread where the row length allows, four rows' loads in flight).
// - The W-stage: each thread computes runs of 4 neighbouring pixels of one
//   row, a warp 32 neighbouring runs, so that the warp's 16-byte reads of
//   the two tap columns (4 classes each) touch few columns of t; the
//   column stride (column_stride) keeps 8 different columns on 8 different
//   bank groups. A run is one 16-byte int32 store or one 4-byte uint8 word
//   (a warp writes 128 contiguous bytes); scalar stores at a row's tail and
//   where W is not a multiple of 4. Runs of 16 pixels for one 16-byte uint8
//   store spread a warp over a whole 512-pixel row and ran 1.8x slower.
// - The argmax in class chunks (all 17 at once for the repository's head, a
//   fully unrolled instantiation; chunks of 8 for any other C): the chunk's
//   max by fmaxf, and where it is strictly above the running best, the
//   chunk's first class equal to it, so ties go to the first class across
//   chunk boundaries too, without a predicate per class for ptxas to keep.
// - The mask type is written directly (uint8 for the serving path), and
//   bf16 logits are widened as they are read (exact), so neither a cast
//   pass nor a widening pass runs around the kernel.
//
// Taps and weights come from the host, taken from the rows of the
// float64-derived bilinear_matrix (ops/resize.py), so the device never
// recomputes coordinates in fp32; an edge row whose two taps coincide
// carries one merged weight and a zero. Products and sums use
// __fmul_rn / __fadd_rn so nvcc cannot contract them into FMAs, in the
// order H-stage, then z = wx0 * t0 + wx1 * t1: the masks equal those of the
// interpolation-matrix product evaluated without FMA bit for bit, and
// differ from a BLAS product only by the 1-ulp contractions that can flip
// an argmax at an exact near-tie.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Row tiles: at most kHbMax output rows a block (8 ran 1-8 % faster than 16
// on the H100, 32 slower), fewer while the tile's H-stage exceeds
// kSmemBudget, which lets the four blocks an SM of the launch bounds fit,
// or while the grid gives fewer than two blocks to each SM.
constexpr int kHbMax = 8;
constexpr int kSmemBudget = 48 * 1024;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Column stride of the H-stage table in shared memory: C rounded up to a
// multiple of 4 (one 16-byte load holds 4 classes) with an odd number of
// 16-byte words, so up to 8 different columns read by a quarter-warp fall
// on 8 different groups of 4 banks.
__host__ __device__ __forceinline__ int column_stride(int classes) {
  const int cs = (classes + 3) & ~3;
  return (cs / 4) % 2 ? cs : cs + 4;
}

// t[r][j * cs + c] = wy0 * x[r0][j][c] + wy1 * x[r1][j][c] for the block's
// rows. Each thread keeps its elements of an input row (V at a time, one
// 16-byte load where the row length allows) and walks the rows, four in
// flight, so the offsets into t are divided out once.
template <int kC, typename In>
__device__ __forceinline__ void h_stage(const In* __restrict__ xb,
                                        const int2* __restrict__ h_idx,
                                        const float2* __restrict__ h_w,
                                        float* t, int y0, int rows, int in_w,
                                        int classes, int cs, bool vec_in) {
  const int C = kC ? kC : classes;
  const int wc = in_w * C;
  const int row_t = in_w * cs;
  constexpr int V = 16 / sizeof(In);
  if (vec_in) {
    for (int e = threadIdx.x * V; e < wc; e += kThreads * V) {
      int off[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int j = (e + i) / C;
        off[i] = j * cs + (e + i - j * C);
      }
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const int2 taps = __ldg(&h_idx[y0 + r]);
        const float2 wy = __ldg(&h_w[y0 + r]);
        const uint4 a =
            __ldg(reinterpret_cast<const uint4*>(xb + taps.x * wc + e));
        const uint4 b =
            __ldg(reinterpret_cast<const uint4*>(xb + taps.y * wc + e));
        const In* av = reinterpret_cast<const In*>(&a);
        const In* bv = reinterpret_cast<const In*>(&b);
        float* tr = t + r * row_t;
#pragma unroll
        for (int i = 0; i < V; ++i)
          tr[off[i]] = __fadd_rn(__fmul_rn(wy.x, widen(av[i])),
                                 __fmul_rn(wy.y, widen(bv[i])));
      }
    }
  } else {
    for (int e = threadIdx.x; e < wc; e += kThreads) {
      const int j = e / C;
      const int off = j * cs + (e - j * C);
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const int2 taps = __ldg(&h_idx[y0 + r]);
        const float2 wy = __ldg(&h_w[y0 + r]);
        t[r * row_t + off] =
            __fadd_rn(__fmul_rn(wy.x, widen(__ldg(xb + taps.x * wc + e))),
                      __fmul_rn(wy.y, widen(__ldg(xb + taps.y * wc + e))));
      }
    }
  }
}

// Argmax class of one output pixel from its two tap columns (offsets b0,
// b1 into the H-stage row tr, weights w0, w1). Classes go in ascending
// chunks of K, 4 a 16-byte load: z for the chunk, its max m by fmaxf, and
// where m is strictly above the running best, the chunk's first class whose
// z equals m. That is the first class of the largest z, as a strict '>' in
// ascending class order gives (NaN never wins; all -inf gives class 0),
// without a predicate carried per class.
constexpr int kChunk = 8;  // classes a chunk, generic instantiation

template <int kC>
__device__ __forceinline__ int pixel_argmax(const float* tr, int b0, int b1,
                                            float w0, float w1, int classes) {
  constexpr int K = kC ? kC : kChunk;
  constexpr int KV = (K + 3) / 4;
  const int C = kC ? kC : classes;
  float best = -INFINITY;
  int arg = 0;
#pragma unroll
  for (int c0 = 0; c0 < C; c0 += K) {  // one chunk for a fixed C
    float z[KV * 4];
#pragma unroll
    for (int v = 0; v < KV; ++v) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (c0 + 4 * v < C) {  // column_stride(C) holds the whole vector
        a = *reinterpret_cast<const float4*>(tr + b0 + c0 + 4 * v);
        b = *reinterpret_cast<const float4*>(tr + b1 + c0 + 4 * v);
      }
      z[4 * v] = __fadd_rn(__fmul_rn(w0, a.x), __fmul_rn(w1, b.x));
      z[4 * v + 1] = __fadd_rn(__fmul_rn(w0, a.y), __fmul_rn(w1, b.y));
      z[4 * v + 2] = __fadd_rn(__fmul_rn(w0, a.z), __fmul_rn(w1, b.z));
      z[4 * v + 3] = __fadd_rn(__fmul_rn(w0, a.w), __fmul_rn(w1, b.w));
    }
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (c0 + k < C) m = fmaxf(m, z[k]);
    if (m > best) {
      best = m;
#pragma unroll
      for (int k = K - 1; k >= 0; --k)
        if (c0 + k < C && z[k] == m) arg = c0 + k;
    }
  }
  return arg;
}

// Pixels a thread computes together: 4, one 16-byte int32 store or one
// 4-byte uint8 word.
constexpr int kGroup = 4;

template <int kC, typename In, typename Out>
__global__ void __launch_bounds__(kThreads, 4)  // 64 registers at most
upsample_argmax_kernel(const In* __restrict__ x,
                       const int2* __restrict__ h_idx,
                       const float2* __restrict__ h_w,
                       const int2* __restrict__ w_idx,
                       const float2* __restrict__ w_w, Out* __restrict__ out,
                       int in_h, int in_w, int classes, int out_h, int out_w,
                       int hb, bool vec_in) {
  extern __shared__ __align__(16) float t[];
  const int C = kC ? kC : classes;
  const int cs = column_stride(C);
  const int y0 = blockIdx.x * hb;
  const int rows = min(hb, out_h - y0);
  const In* xb = x + static_cast<size_t>(blockIdx.y) * in_h * in_w * C;
  Out* ob = out + (static_cast<size_t>(blockIdx.y) * out_h + y0) * out_w;

  h_stage<kC>(xb, h_idx, h_w, t, y0, rows, in_w, classes, cs, vec_in);
  __syncthreads();

  // Runs of kGroup pixels, a warp over 32 neighbouring runs of one row, so
  // its 16-byte shared-memory reads span few tap columns.
  const int runs = (out_w + kGroup - 1) / kGroup;
  const bool vec_out = out_w % kGroup == 0;
  int r = threadIdx.x / runs;
  int q = threadIdx.x - r * runs;
  const int step_r = kThreads / runs, step_q = kThreads - step_r * runs;
  for (; r < rows; r += step_r, q += step_q) {
    if (q >= runs) {
      q -= runs;
      ++r;
      if (r >= rows) break;
    }
    const float* tr = t + r * in_w * cs;
    const int x0 = q * kGroup;
    int arg[kGroup];
#pragma unroll
    for (int p = 0; p < kGroup; ++p) {
      const int X = min(x0 + p, out_w - 1);
      const int2 j = __ldg(&w_idx[X]);
      const float2 wx = __ldg(&w_w[X]);
      arg[p] = pixel_argmax<kC>(tr, j.x * cs, j.y * cs, wx.x, wx.y, classes);
    }
    Out* dst = ob + r * out_w + x0;
    if (vec_out) {
      if constexpr (sizeof(Out) == 1)
        *reinterpret_cast<uint32_t*>(dst) =
            static_cast<uint32_t>(arg[0]) |
            static_cast<uint32_t>(arg[1]) << 8 |
            static_cast<uint32_t>(arg[2]) << 16 |
            static_cast<uint32_t>(arg[3]) << 24;
      else
        *reinterpret_cast<int4*>(dst) = make_int4(arg[0], arg[1], arg[2],
                                                  arg[3]);
    } else {
#pragma unroll
      for (int p = 0; p < kGroup; ++p)
        if (x0 + p < out_w) dst[p] = static_cast<Out>(arg[p]);
    }
  }
}

template <int kC, typename In, typename Out>
cudaError_t launch(const void* x, const int* h_idx, const float* h_w,
                   const int* w_idx, const float* w_w, void* out, int batch,
                   int in_h, int in_w, int classes, int out_h, int out_w,
                   cudaStream_t stream) {
  int dev = 0, sms = 0, smem_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t row_bytes =
      static_cast<size_t>(in_w) * column_stride(classes) * sizeof(float);
  if (row_bytes > static_cast<size_t>(smem_optin))
    return cudaErrorInvalidValue;  // one row of the H-stage does not fit
  int hb = kHbMax;
  while (hb > 1 && (hb * row_bytes > kSmemBudget ||
                    static_cast<long long>(batch) * ((out_h + hb - 1) / hb) <
                        2LL * sms))
    hb /= 2;
  const size_t smem = hb * row_bytes;
  auto kernel = upsample_argmax_kernel<kC, In, Out>;
  if (smem > 48 * 1024) {  // above the default limit, on the current device
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  constexpr int V = 16 / sizeof(In);
  const bool vec_in =
      (static_cast<long long>(in_w) * classes) % V == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid((out_h + hb - 1) / hb, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const In*>(x), reinterpret_cast<const int2*>(h_idx),
      reinterpret_cast<const float2*>(h_w),
      reinterpret_cast<const int2*>(w_idx),
      reinterpret_cast<const float2*>(w_w), static_cast<Out*>(out), in_h,
      in_w, classes, out_h, out_w, hb, vec_in);
  return cudaGetLastError();
}

template <typename In, typename Out>
cudaError_t dispatch_classes(const void* x, const int* h_idx,
                             const float* h_w, const int* w_idx,
                             const float* w_w, void* out, int batch, int in_h,
                             int in_w, int classes, int out_h, int out_w,
                             cudaStream_t stream) {
  if (classes == 17)
    return launch<17, In, Out>(x, h_idx, h_w, w_idx, w_w, out, batch, in_h,
                               in_w, classes, out_h, out_w, stream);
  return launch<0, In, Out>(x, h_idx, h_w, w_idx, w_w, out, batch, in_h,
                            in_w, classes, out_h, out_w, stream);
}

}  // namespace

extern "C" {

// x: (batch, in_h, in_w, classes), contiguous, fp32 (in_dtype 0) or bf16
// (1). h_idx/h_w: (out_h, 2) taps and weights, w_idx/w_w: (out_w, 2).
// out: (batch, out_h, out_w), int32 (out_dtype 0) or uint8 (1, classes
// <= 256). Returns a cudaError_t (cudaErrorInvalidValue where one output
// row's H-stage exceeds a block's shared memory).
int vt_upsample_argmax(int in_dtype, int out_dtype, const void* x,
                       const int* h_idx, const float* h_w, const int* w_idx,
                       const float* w_w, void* out, int batch, int in_h,
                       int in_w, int classes, int out_h, int out_w,
                       void* stream) {
  if (batch <= 0 || batch > 65535 || in_h <= 0 || in_w <= 0 ||
      classes <= 0 || out_h <= 0 || out_w <= 0 ||
      (out_dtype == 1 && classes > 256) ||
      static_cast<long long>(in_h) * in_w * classes > 2147483647LL ||
      static_cast<long long>(out_h) * out_w > 2147483647LL - 16)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return dispatch_classes<float, int>(x, h_idx, h_w, w_idx, w_w, out, batch,
                                        in_h, in_w, classes, out_h, out_w, s);
  if (in_dtype == 0 && out_dtype == 1)
    return dispatch_classes<float, uint8_t>(x, h_idx, h_w, w_idx, w_w, out,
                                            batch, in_h, in_w, classes, out_h,
                                            out_w, s);
  if (in_dtype == 1 && out_dtype == 0)
    return dispatch_classes<__nv_bfloat16, int>(x, h_idx, h_w, w_idx, w_w, out,
                                                batch, in_h, in_w, classes,
                                                out_h, out_w, s);
  if (in_dtype == 1 && out_dtype == 1)
    return dispatch_classes<__nv_bfloat16, uint8_t>(
        x, h_idx, h_w, w_idx, w_w, out, batch, in_h, in_w, classes, out_h,
        out_w, s);
  return cudaErrorInvalidValue;
}

const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
